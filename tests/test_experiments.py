"""End-to-end smoke + physics tests for all five experiment families."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.experiments.laser_cooling import (
    CoolingConfig, initial_state, resume_state, run as run_cooling)
from mdqtplasmasims_tpu.experiments.frozen_tagging import (
    FrozenTagConfig, run as run_frozen)
from mdqtplasmasims_tpu.experiments.mc_qt_tagging import (
    MCTagConfig, run as run_mctag)
from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import (
    MCTransportConfig, run as run_transport)
from mdqtplasmasims_tpu.experiments.three_state import (
    ThreeStateConfig, run as run_three)


class TestCooling:
    def test_energy_audit_and_outputs(self, tmp_path):
        cfg = CoolingConfig(n0=96, tmax=0.4, sample_freq=10,
                            dtype="float64",
                            save_directory=str(tmp_path))
        final, res = run_cooling(cfg)
        outs = res["outs"]
        # energy audit: Ekin growth is funded by Epot during DIH; the
        # residual is the (physical) laser work, small vs the DIH scale
        de = (outs["ekin"].sum(-1) + outs["epot"] - res["epot0"])
        assert np.abs(de).max() < 0.1 * outs["ekin"][-1].sum()
        # DIH: kinetic energy rises from the frozen start
        assert outs["ekin"][-1].sum() > 10 * outs["ekin"][0].sum()
        # populations present: P/D states get occupied by the lasers
        assert outs["pops"][-1][:, 1:].sum() > 0
        d = next(p for p in tmp_path.rglob("energies.dat"))
        e = np.loadtxt(d)
        assert e.shape[1] == 7

    def test_renormalize_end_to_end(self):
        """reNormalizewvFns=1 path (SpeedUp.cpp:74,706-712): with the
        explicit per-tick renormalization the wavefunction norms stay at
        exactly 1 over a full run, and the physics (energies) stays within
        the stochastic envelope of the default path."""
        cfg = CoolingConfig(n0=64, tmax=0.3, sample_freq=30,
                            renormalize=True)
        final, res = run_cooling(cfg)
        norms = np.linalg.norm(np.asarray(final.psi), axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)
        outs = res["outs"]
        assert np.isfinite(outs["ekin"]).all()
        # DIH still happens and the energy audit still balances
        de = (outs["ekin"].sum(-1) + outs["epot"] - res["epot0"])
        assert np.abs(de).max() < 0.2 * outs["ekin"][-1].sum()

    def test_checkpoint_resume_roundtrip(self, tmp_path):
        cfg = CoolingConfig(n0=64, tmax=0.2, sample_freq=10,
                            save_directory=str(tmp_path))
        final, res = run_cooling(cfg)
        d = str(next(tmp_path.rglob("ions_timestep*.dat")).parent)
        c0 = int(round(cfg.tmax / cfg.timestep)) - 1
        st = resume_state(d, c0, cfg)
        assert st.R.shape == (64, 3)
        np.testing.assert_allclose(np.asarray(st.R),
                                   np.asarray(final.R), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(st.psi),
                                   np.asarray(final.psi), rtol=1e-4,
                                   atol=1e-6)


class TestFrozenTagging:
    def test_run_ensemble_matches_sequential(self, tmp_path):
        """Batched tagging jobs (one vmapped program) must reproduce each
        job's sequential single-trajectory result bit-for-bit (f64), and
        write the same per-job .dat tree as a SLURM array would."""
        import dataclasses
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            run_ensemble, initial_state, run_phase_a, run_phase_b,
            measure, tag_instant_output)
        from mdqtplasmasims_tpu.ops.yukawa import (best_forces_fn,
                                                   yukawa_potential)
        from mdqtplasmasims_tpu.units import PlasmaUnits
        from mdqtplasmasims_tpu.core.init import frozen_gas_init
        from mdqtplasmasims_tpu.state import make_state

        cfg = FrozenTagConfig(variant="422linear", n0=48, tstart=0.1,
                              tmax=0.4, tpump_seconds=1e-7,
                              sample_freq=10,
                              dtype="float64",
                              save_directory=str(tmp_path))
        results = run_ensemble(cfg, n_jobs=2, seed=3)
        assert len(results) == 2
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 2

        # sequential replay of member 1 with the same key
        cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
        pu = PlasmaUnits(cfg.density, cfg.ge)
        L = PlasmaUnits.box_length(cfg.n0)
        keys = jax.random.split(jax.random.PRNGKey(3), 2)
        k_init, k_run = jax.random.split(keys[1])
        R, V, psi, _ = frozen_gas_init(k_init, cfg.n0,
                                       n_states=cfg.n_states,
                                       exact_n=True, dtype=cfg.np_dtype)
        st = make_state(R, V, psi, k_run, dtype=cfg.np_dtype)
        fn = best_forces_fn(cfg.n0, L, pu.debye_length)
        st = st._replace(F=fn(st.R)[0])
        epot0 = yukawa_potential(st.R, L, pu.debye_length)
        n_md_a = int(np.ceil(cfg.tend / cfg.timestep))
        st = run_phase_a(cfg_run, st, n_md_a)
        st, spin_up, vholder = measure(cfg_run, st)
        n_md_total = int(round(cfg.tmax / cfg.timestep))
        first = cfg.sample_freq - (n_md_a % cfg.sample_freq)
        seg_lengths = (first,) + (cfg.sample_freq,) * max(
            0, (n_md_total - n_md_a - first) // cfg.sample_freq)
        st, outs = run_phase_b(cfg_run, st, spin_up, vholder, epot0,
                               seg_lengths)

        res1 = results[1]
        np.testing.assert_array_equal(np.asarray(res1["spin_up"]),
                                      np.asarray(spin_up))
        np.testing.assert_array_equal(np.asarray(res1["final"].R),
                                      np.asarray(st.R))
        # trajectories are bit-exact; the output-block reductions
        # reassociate under vmap (different sum order) -> 1e-12
        np.testing.assert_allclose(
            np.asarray(res1["outs"]["energies"]),
            np.asarray(outs["energies"]), rtol=1e-11, atol=1e-13)
        # members differ from each other
        assert not np.allclose(np.asarray(results[0]["final"].R),
                               np.asarray(results[1]["final"].R))

    @pytest.mark.parametrize("variant", ["422linear", "408quad", "408linear"])
    def test_smoke(self, variant, tmp_path):
        cfg = FrozenTagConfig(variant=variant, n0=64, tstart=0.1, tmax=0.5,
                              tpump_seconds=1e-7, sample_freq=10,
                              save_directory=str(tmp_path))
        final, res = run_frozen(cfg)
        frac = res["spin_up"].mean()
        if variant == "408quad":
            # the quad scheme (det=0, Om=2) pumps population OUT of the
            # spin-up states: expect a small tag fraction (can be 0 of 64)
            assert frac < 0.3
        else:
            assert 0.0 < frac < 1.0
        # pumping moved population out of the initial S superposition
        pops = np.abs(np.asarray(final.psi)) ** 2
        assert pops[:, 2:].sum() > 0
        files = {p.name for p in tmp_path.rglob("*.dat")}
        assert "energies.dat" in files and "taggedMoments.dat" in files
        if variant == "408quad":
            assert "vSquareAutoCorr.dat" in files
        else:
            assert "VAF.dat" in files

    @pytest.mark.parametrize("variant", ["422linear", "408linear"])
    def test_tag_instant_row(self, variant, tmp_path):
        """The reference emits outputs the moment t >= tendV0: a tau=0
        VAF row for every variant (Zfunc(0); printVAF —
        randomFrozenStartTag422Linear.cpp:1000-1005) and, in the 408
        variants only, a full output() row too."""
        cfg = FrozenTagConfig(variant=variant, n0=64, tstart=0.1, tmax=0.5,
                              tpump_seconds=1e-7, sample_freq=10,
                              save_directory=str(tmp_path))
        final, res = run_frozen(cfg)
        vaf = np.loadtxt(next(tmp_path.rglob("VAF.dat")))
        n_b = res["outs"]["t"].shape[0]
        assert vaf.shape[0] == n_b + 1
        # tau=0 normalization row: VAF(0) = <vx^2> at the tag instant
        t_tag = res["out_tag"]["t"]
        np.testing.assert_allclose(vaf[0, 0], t_tag, rtol=1e-6)
        np.testing.assert_allclose(vaf[0, 1], res["out_tag"]["vaf"],
                                   rtol=1e-5)
        assert vaf[1, 0] > vaf[0, 0]
        energies = np.loadtxt(next(tmp_path.rglob("energies.dat")))
        moments = np.loadtxt(next(tmp_path.rglob("taggedMoments.dat")))
        extra = 1 if variant != "422linear" else 0
        assert energies.shape[0] == n_b + extra
        assert moments.shape[0] == n_b + extra
        if extra:
            np.testing.assert_allclose(energies[0, 0], t_tag, rtol=1e-6)

    def test_resume_run_roundtrip(self, tmp_path):
        """resume_run restores R/V (to %g file precision), the spin-up
        list exactly, and the reference's c0 -> t reconstruction
        (randomFrozenStartTag422Linear.cpp:676-764)."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            frozen_tag_dir, resume_run)
        cfg = FrozenTagConfig(variant="422linear", n0=48, tstart=0.1,
                              tmax=0.5, tpump_seconds=1e-7, sample_freq=10,
                              save_directory=str(tmp_path))
        final, res = run_frozen(cfg)
        d = frozen_tag_dir(cfg.save_directory,
                           tpump_seconds=cfg.tpump_seconds,
                           tstart=cfg.tstart, detuning=cfg.detuning,
                           om=cfg.om, density=cfg.density, ge=cfg.ge,
                           n0=cfg.n0, job=cfg.job)
        c0 = int(round(cfg.tmax / cfg.timestep)) - 1
        st, spin_up = resume_run(d, c0, cfg)
        np.testing.assert_allclose(np.asarray(st.R), np.asarray(final.R),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(st.V), np.asarray(final.V),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(spin_up),
                                      res["spin_up"])

    def test_resume_continue_matches_uninterrupted(self, tmp_path):
        """run(resume=True) with an extended tmax reproduces the
        uninterrupted run: continued energies/taggedMoments/VAF rows
        match bit-for-bit (native checkpoint restores the exact f32
        state incl. vholder and epot0, and post-tag MD is
        deterministic), per-timestep vel_dist files appear, and the
        terminal checkpoint advances."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            frozen_tag_dir)
        # tmax values deliberately NOT on the sample grid (310 % 20 = 10,
        # 530 % 20 = 10): both windows end with tail MD steps past the
        # last sample gate, which the checkpoint (labeled n_md_total-1)
        # must include — the original implementation skipped them and
        # every resumed row came out 10 MD steps behind
        base = dict(variant="422linear", n0=48, tstart=1.0,
                    timestep=0.01, sample_freq=20, tpump_seconds=2e-7)
        cfg1 = FrozenTagConfig(**base, tmax=3.1,
                               save_directory=str(tmp_path / "chained"))
        run_frozen(cfg1)
        cfg2 = dc.replace(cfg1, tmax=5.3)
        final2, res2 = run_frozen(cfg2, resume=True)
        cfg_full = FrozenTagConfig(**base, tmax=5.3,
                                   save_directory=str(tmp_path / "full"))
        run_frozen(cfg_full)

        def tree(root):
            return frozen_tag_dir(str(root), tpump_seconds=cfg1.tpump_seconds,
                                  tstart=cfg1.tstart, detuning=cfg1.detuning,
                                  om=cfg1.om, density=cfg1.density,
                                  ge=cfg1.ge, n0=cfg1.n0, job=1)
        dc_dir, full_dir = tree(tmp_path / "chained"), tree(tmp_path / "full")
        for fname in ("energies.dat", "taggedMoments.dat", "VAF.dat"):
            a = np.loadtxt(os.path.join(dc_dir, fname))
            b = np.loadtxt(os.path.join(full_dir, fname))
            np.testing.assert_array_equal(a, b, err_msg=fname)
        for lab in res2["labels"]:
            assert os.path.exists(os.path.join(
                dc_dir, f"vel_distX_timestep{lab:06d}.dat")), lab
        c0f = int(round(cfg2.tmax / cfg2.timestep)) - 1
        n_chain, counter_chain = __import__(
            "mdqtplasmasims_tpu.io.checkpoint", fromlist=["read_ions"]
        ).read_ions(dc_dir, c0f)
        assert n_chain == cfg1.n0
        n_rows = np.loadtxt(os.path.join(full_dir, "energies.dat")).shape[0]
        assert counter_chain == n_rows

    def test_ensemble_resume_chains_every_job(self, tmp_path):
        """run_ensemble(resume=True) continues every job directory of a
        batched array through an extended tmax: full row counts and an
        advanced terminal checkpoint per job."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            run_ensemble)
        from mdqtplasmasims_tpu.io.checkpoint import read_ions
        cfg1 = FrozenTagConfig(variant="422linear", n0=48, tstart=1.0,
                               tmax=3.0, timestep=0.01, sample_freq=20,
                               tpump_seconds=2e-7,
                               save_directory=str(tmp_path))
        run_ensemble(cfg1, 3, seed=4)
        cfg2 = dc.replace(cfg1, tmax=4.0)
        res = run_ensemble(cfg2, 3, resume=True)
        assert len(res) == 3
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 3
        c0f = int(round(cfg2.tmax / cfg2.timestep)) - 1
        for d in job_dirs:
            e = np.loadtxt(os.path.join(d, "energies.dat"))
            n, counter = read_ions(d, c0f)
            assert n == cfg1.n0 and counter == e.shape[0]

    def test_resume_tail_only_extension(self, tmp_path):
        """A tmax extension that adds no new sample gate still advances
        the state and republishes the terminal checkpoint (the reference
        binary would step to the new tmax regardless of the grid); a
        no-op extension still raises."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            frozen_tag_dir)
        from mdqtplasmasims_tpu.io.checkpoint import read_ions
        cfg1 = FrozenTagConfig(variant="422linear", n0=48, tstart=1.0,
                               tmax=3.1, timestep=0.01, sample_freq=20,
                               tpump_seconds=2e-7,
                               save_directory=str(tmp_path))
        run_frozen(cfg1)
        d = frozen_tag_dir(cfg1.save_directory,
                           tpump_seconds=cfg1.tpump_seconds,
                           tstart=cfg1.tstart, detuning=cfg1.detuning,
                           om=cfg1.om, density=cfg1.density, ge=cfg1.ge,
                           n0=cfg1.n0, job=1)
        rows1 = np.loadtxt(os.path.join(d, "energies.dat")).shape[0]
        final2, res2 = run_frozen(dc.replace(cfg1, tmax=3.15), resume=True)
        assert res2["labels"] == [] and res2["outs"] is None
        assert np.loadtxt(os.path.join(d, "energies.dat")).shape[0] == rows1
        c0f = int(round(3.15 / cfg1.timestep)) - 1
        n, counter = read_ions(d, c0f)
        assert n == cfg1.n0
        with pytest.raises(ValueError, match="already covers"):
            run_frozen(dc.replace(cfg1, tmax=3.15), resume=True)

    def test_resume_before_tag_rejected(self, tmp_path):
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            frozen_tag_dir)
        from mdqtplasmasims_tpu.io import checkpoint as ckpt
        cfg = FrozenTagConfig(variant="422linear", n0=32, tstart=2.0,
                              tmax=3.0, timestep=0.01, sample_freq=20,
                              tpump_seconds=2e-7,
                              save_directory=str(tmp_path))
        with pytest.raises(FileNotFoundError):
            run_frozen(cfg, resume=True)
        # a checkpoint from before the pump end must be refused: the
        # schema never persists mid-pump wavefunctions
        d = frozen_tag_dir(cfg.save_directory,
                           tpump_seconds=cfg.tpump_seconds,
                           tstart=cfg.tstart, detuning=cfg.detuning,
                           om=cfg.om, density=cfg.density, ge=cfg.ge,
                           n0=cfg.n0, job=cfg.job)
        os.makedirs(d, exist_ok=True)
        ckpt.save_native(d, 50, R=np.zeros((32, 3)), V=np.zeros((32, 3)),
                         psi=np.zeros((32, 5), np.complex64), counter=0,
                         spin_up=np.zeros(32, np.int64))
        with pytest.raises(ValueError, match="pump end"):
            run_frozen(cfg, resume=True)

    def test_pump_window_gating(self):
        """Wavefunctions must be frozen outside the pump window."""
        cfg = FrozenTagConfig(variant="422linear", n0=32, tstart=5.0,
                              tmax=0.3, tpump_seconds=1e-7)
        # run only phase A up to t=0.3 < tstart: psi unchanged
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            initial_state, run_phase_a)
        st = initial_state(cfg)
        out = run_phase_a(cfg, st, 100)
        np.testing.assert_array_equal(np.asarray(out.psi),
                                      np.asarray(st.psi))
        assert not np.array_equal(np.asarray(out.R), np.asarray(st.R))


class TestMCTagging:
    def test_smoke(self, tmp_path):
        cfg = MCTagConfig(variant="422linear", n=64, mc_steps=300,
                          pre_record_md_steps=5, record_steps=20,
                          gr_every_record=10, save_directory=str(tmp_path))
        res = run_mctag(cfg)
        assert 0.0 <= res["tags"].mean() <= 1.0
        assert res["vaf"].shape == (20,)
        files = {p.name for p in tmp_path.rglob("*.dat")}
        assert "taggedMoments.dat" in files
        assert "vel_distX_timestep000000.dat" in files

    @pytest.mark.parametrize("crash_after", [2, 5, 8])
    def test_crash_resume_bit_identical(self, tmp_path, crash_after):
        """Crash-resume through every stage of the MC->pump->tag->record
        pipeline (the three crash points land mid-MC, mid-pump and
        mid-record at this config) reproduces the uninterrupted run
        bit-for-bit, including the live mid-pump SimState (psi, t_part,
        per-ion clocks, RNG)."""
        import dataclasses as dc
        cfg1 = MCTagConfig(variant="422linear", n=27, mc_steps=300,
                           mc_chunk_steps=100, pre_record_md_steps=5,
                           record_steps=20, gr_every_record=10,
                           dtype="float64",
                           save_directory=str(tmp_path / "a"),
                           checkpoint_every_chunks=1)
        ref = run_mctag(cfg1, seed=5)
        cfg2 = dc.replace(cfg1, save_directory=str(tmp_path / "b"))
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_mctag(cfg2, seed=5,
                      _crash_after_checkpoints=crash_after)
        res = run_mctag(cfg2, seed=5, resume=True)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]),
                                          np.asarray(res[k]), err_msg=k)

    def test_run_ensemble_batched(self, tmp_path):
        """The whole MC->pump->tag->record pipeline vmapped over a job
        axis: per-job .dat trees, independent members, finite physics."""
        from mdqtplasmasims_tpu.experiments.mc_qt_tagging import (
            run_ensemble)
        cfg = MCTagConfig(variant="422linear", n=64, mc_steps=300,
                          pre_record_md_steps=5, record_steps=20,
                          gr_every_record=10,
                          save_directory=str(tmp_path))
        results = run_ensemble(cfg, n_jobs=2, seed=1)
        assert len(results) == 2
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("taggedMoments.dat"))
        assert len(job_dirs) == 2
        for res in results:
            assert res["vaf"].shape == (20,)
            assert np.isfinite(res["moments"]).all()
        assert not np.allclose(results[0]["V"], results[1]["V"])
        assert not np.array_equal(results[0]["tags"], results[1]["tags"])


class TestTransport:
    def test_pipeline_smoke(self):
        cfg = MCTransportConfig(n=27, mc_steps=500, gr_every_mc=250,
                                pre_record_md_steps=10, record_steps=40,
                                gr_every_record=20, instant_aniso_steps=20,
                                reequil_steps=10, aniso_relax_steps=20,
                                aniso_time_us=1.0)
        res = run_transport(cfg)
        assert res["vaf"].shape == (40,)
        # VAF(0) = <v^2> ~ 3/gamma within thermal fluctuations
        assert 0.3 < res["vaf"][0] < 3.0
        assert res["temps_inst"].shape == (20, 3)

    _RESUME_CFG = dict(n=27, mc_steps=400, gr_every_mc=100,
                       pre_record_md_steps=10, record_steps=40,
                       gr_every_record=20, instant_aniso_steps=20,
                       reequil_steps=10, aniso_relax_steps=20,
                       aniso_time_us=0.2, dtype="float64")

    def test_run_matches_vmapped_pipeline(self):
        """The host-chunked resumable runner and the single-program
        traced pipeline (the batched/sweep fold member) are the same
        math — only XLA fusion across the dispatch boundaries differs,
        so f64 agreement at 1e-12 pins the two paths together."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import (
            _pipeline)
        cfg = MCTransportConfig(**self._RESUME_CFG)
        res = run_transport(cfg, seed=3)
        pip = jax.jit(lambda k: _pipeline(cfg, k))(jax.random.PRNGKey(3))
        for k in res:
            np.testing.assert_allclose(
                np.asarray(res[k]), np.asarray(pip[k]), rtol=1e-12,
                atol=1e-12, err_msg=k)

    def test_crash_resume_bit_identical(self, tmp_path):
        """A run killed mid-pipeline (simulated crash after the K-th
        checkpoint publish) resumes from the newest native pipeline
        checkpoint and reproduces the uninterrupted run bit-for-bit —
        the framework's L7 standard, which the reference cannot meet
        here (writeConditions exists only in the cooling and frozen-tag
        programs)."""
        import dataclasses as dc
        cfg1 = MCTransportConfig(**self._RESUME_CFG,
                                 save_directory=str(tmp_path / "a"),
                                 checkpoint_every_chunks=1)
        ref = run_transport(cfg1, seed=3)
        cfg2 = dc.replace(cfg1, save_directory=str(tmp_path / "b"))
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_transport(cfg2, seed=3, _crash_after_checkpoints=3)
        res = run_transport(cfg2, seed=3, resume=True)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]),
                                          np.asarray(res[k]), err_msg=k)
        # the resumed job's .dat tree equals the uninterrupted one
        a = sorted(p.relative_to(tmp_path / "a")
                   for p in (tmp_path / "a").rglob("*.dat"))
        b = sorted(p.relative_to(tmp_path / "b")
                   for p in (tmp_path / "b").rglob("*.dat"))
        assert a == b and a
        for rel in a:
            assert ((tmp_path / "a" / rel).read_bytes()
                    == (tmp_path / "b" / rel).read_bytes()), rel
        # resume on a completed run rebuilds the results from the
        # terminal pipeline checkpoint (no recompute, same values)
        res2 = run_transport(cfg2, seed=3, resume=True)
        np.testing.assert_array_equal(res2["vaf"], ref["vaf"])

    def test_resume_guards(self, tmp_path):
        """Meta mismatches and missing checkpoints are refused with
        diagnostics instead of splicing silently."""
        import dataclasses as dc
        cfg = MCTransportConfig(**self._RESUME_CFG,
                                save_directory=str(tmp_path),
                                checkpoint_every_chunks=2)
        with pytest.raises(ValueError, match="no pipeline checkpoint"):
            run_transport(cfg, seed=3, resume=True)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_transport(cfg, seed=3, _crash_after_checkpoints=1)
        # a different seed (or any config field outside the directory
        # encoding) must refuse to splice
        with pytest.raises(ValueError, match="refusing to splice"):
            run_transport(cfg, seed=4, resume=True)
        with pytest.raises(ValueError, match="needs save_directory"):
            run_transport(dc.replace(cfg, save_directory=None), seed=3,
                          resume=True)


class TestThreeState:
    def test_doppler_cooling(self):
        cfg = ThreeStateConfig(n0=400, tmax=1500.0, sample_freq=500,
                               temperature_k=0.01)
        res = run_three(cfg)
        # cooling: x kinetic energy decreases substantially
        assert res["ekin_x"][-1] < 0.75 * res["ekin_x"][0]

    def test_no_force_flag(self):
        cfg = ThreeStateConfig(n0=300, tmax=500.0, sample_freq=100,
                               apply_force=False)
        res = run_three(cfg)
        # without kicks the velocity distribution is untouched
        assert abs(res["ekin_x"][-1] - res["ekin_x"][0]) < 1e-9

    def test_dispatch_groups_bit_identical(self):
        """Splitting the run into device-dispatch groups (fixed-length
        programs shared across tmax) must not change anything: the carry
        stays on device and the per-segment op sequence is identical."""
        base = dict(n0=64, tmax=60.0, sample_freq=100, temperature_k=0.01)
        res_one = run_three(ThreeStateConfig(**base))          # one group
        res_split = run_three(ThreeStateConfig(
            **base, dispatch_segments=2))                      # 3 groups
        np.testing.assert_array_equal(res_one["ekin_x"],
                                      res_split["ekin_x"])
        np.testing.assert_array_equal(res_one["V"], res_split["V"])


class TestEnsembleCompiled:
    def test_batched_ensemble_matches_physics(self):
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_compiled_ensemble, _initial_state_from_key, canonical_run_cfg)
        import dataclasses
        cfg = dataclasses.replace(
            canonical_run_cfg(CoolingConfig(n0=48, sample_freq=5)))
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        states = jax.vmap(lambda k: _initial_state_from_key(cfg, k))(keys)
        final, outs = run_compiled_ensemble(cfg, states, 4)
        assert outs["ekin"].shape == (3, 4, 3)
        # jobs are independent trajectories
        assert not np.allclose(outs["ekin"][0], outs["ekin"][1])
        # all heat (DIH) from the frozen start
        assert np.all(outs["ekin"][:, -1].sum(-1) > outs["ekin"][:, 0].sum(-1))

    def test_three_state_run_ensemble(self, tmp_path):
        from mdqtplasmasims_tpu.experiments.three_state import (
            ThreeStateConfig, run_ensemble)
        cfg = ThreeStateConfig(n0=64, tmax=40.0, sample_freq=100,
                               dispatch_segments=2,
                               save_directory=str(tmp_path))
        res = run_ensemble(cfg, n_jobs=3, seed=2)
        assert res["ekin_x"].shape == (3, 40)
        assert np.isfinite(res["ekin_x"]).all()
        assert not np.allclose(res["ekin_x"][0], res["ekin_x"][1])
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 3
        for d in job_dirs:
            e = np.loadtxt(os.path.join(d, "energies.dat")).reshape(-1, 2)
            assert e.shape[0] == 40


def test_sequential_jobs_share_compiled_program():
    """job/save_directory are canonicalized out of the jit-static config,
    so a --jobs array reuses one compiled program (each recompile costs
    seconds to a minute) while still drawing per-job seeds."""
    from mdqtplasmasims_tpu.experiments import three_state as ts
    cfg1 = ThreeStateConfig(n0=64, tmax=50.0, sample_freq=50, job=1)
    before = ts.run_compiled._cache_size()
    r1 = run_three(cfg1)
    import dataclasses
    r2 = run_three(dataclasses.replace(cfg1, job=2))
    after = ts.run_compiled._cache_size()
    assert after - before <= 1          # second job hit the jit cache
    assert r1["ekin_x"][0] != r2["ekin_x"][0]   # but got its own seed


def test_golden_regression_small_cooling():
    """Fixed-seed golden regression (SURVEY.md section 4's gap-to-fill):
    a tiny f64 CPU cooling run must reproduce recorded observables.  This
    guards the whole stack — init draws, scheduler semantics, QT engine,
    forces, diagnostics — against silent semantic drift.  Tolerances are
    loose enough to survive XLA/jax version changes but tight enough to
    catch any physics change."""
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        canonical_run_cfg, initial_state, run_compiled)
    cfg = CoolingConfig(n0=64, sample_freq=20,
                        dtype="float64", job=3)
    state = initial_state(cfg)
    final, outs = run_compiled(canonical_run_cfg(cfg), state, 3)
    # sample instants are the reference's exact output gate: one quantum
    # tick into MD step k*sample_freq-1 (SpeedUp.cpp:1365-1368), i.e.
    # t_k = ((k*f-1)*ratio+1)*qdt — NOT the MD-boundary k*f*dt
    ratio = cfg.ratio
    qdt = cfg.timestep / ratio
    np.testing.assert_allclose(
        np.asarray(outs["t"]),
        [((k * 20 - 1) * ratio + 1) * qdt for k in (1, 2, 3)], rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(outs["ekin"]),
        [[0.00391699, 0.00723123, 0.00220188],
         [0.01321803, 0.02312572, 0.00858976],
         [0.02377958, 0.03917001, 0.01791934]], rtol=2e-4)
    np.testing.assert_allclose(
        np.asarray(outs["epot"]),
        [2.63584751, 2.60864226, 2.57208545], rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(outs["pops"][-1])[0],
        [0.74950915, 0.22094716, 0.03004742], atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(final.R[0]),
        [3.56570615, 4.46742066, 3.63364762], rtol=1e-5)


def test_interval_vaf_and_lccf_outputs(tmp_path):
    """The pre-SpeedUp generation's active diagnostics: interval VAF and
    the LCCF current transform J(k) must be recorded and written
    (LaserCoolingPlusExpansionMDQT.cpp's Zfunc/LCCF outputs)."""
    cfg = CoolingConfig(n0=48, tmax=0.4, sample_freq=10,
                        vaf_intervals=(0.1, 0.25), record_lccf=True,
                        dtype="float64",
                        save_directory=str(tmp_path))
    final, res = run_cooling(cfg)
    files = {p.name for p in tmp_path.rglob("*.dat")}
    assert any(f.startswith("VAF_interval") for f in files), files
    assert "J_interval0.dat" in files
    vaf = np.loadtxt(next(tmp_path.rglob("VAF_interval*.dat")))
    assert np.isfinite(vaf).all()
    j = np.loadtxt(next(tmp_path.rglob("J_interval0.dat")))
    assert np.isfinite(j).all() and j.size > 0


def test_periodic_checkpoint_and_resume(tmp_path):
    """Walltime chaining: a run with checkpoint_every_segments publishes
    native checkpoints mid-run, and run(resume=True) continues from the
    newest one to the (longer) tmax instead of restarting."""
    import dataclasses
    import glob
    cfg1 = CoolingConfig(n0=48, tmax=0.2, sample_freq=10,
                         checkpoint_every_segments=1,
                         dtype="float64", save_directory=str(tmp_path))
    final1, res1 = run_cooling(cfg1)
    d = str(next(tmp_path.rglob("checkpoint_*.npz")).parent)
    cks = sorted(glob.glob(os.path.join(d, "checkpoint_*.npz")))
    assert cks, "no mid-run checkpoints written"

    # "next walltime window": same run directory, longer tmax
    cfg2 = dataclasses.replace(cfg1, tmax=0.4)
    final2, res2 = run_cooling(cfg2, resume=True)
    n_md = int(round(cfg2.tmax / cfg2.timestep))
    assert float(final2.t) == pytest.approx(n_md * cfg2.timestep, rel=1e-6)
    # only the remaining segments were computed in the resumed call
    n_total = n_md // cfg2.sample_freq
    assert res2["outs"]["t"].shape[0] < n_total
    # and the full energies.dat now covers the whole run
    e = np.loadtxt(os.path.join(d, "energies.dat"))
    assert e.shape[0] == n_total


def test_offgrid_tmax_chaining_matches_fresh_grid(tmp_path):
    """tmax off the sample grid: the run simulates the trailing
    sub-segment to tmax (reference main loop: while t<=tmax+0.0009,
    SpeedUp.cpp:1247), the terminal checkpoint at c0=n_md-1 holds the
    true state, and a chained window realigns to the *global* output
    gate ((c0+1)%sampleFreq==0, :1365) so the chained run's sample and
    VAF grids match an uninterrupted run's exactly."""
    import dataclasses
    iv = (0.06, 0.3)
    cfg1 = CoolingConfig(n0=48, tmax=0.25, sample_freq=10,
                         dtype="float64",
                         vaf_intervals=iv, save_directory=str(tmp_path))
    final1, _ = run_cooling(cfg1, seed=5)
    # 125 MD steps: 12 samples + a 5-step tail the run must still cover
    assert float(final1.t) == pytest.approx(0.25, rel=1e-9)
    d = str(next(tmp_path.rglob("energies.dat")).parent)
    e1 = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
    assert e1.shape[0] == 12
    # terminal checkpoint labeled with the true final step
    assert os.path.exists(os.path.join(d, "checkpoint_000124.npz"))

    cfg2 = dataclasses.replace(cfg1, tmax=0.5)
    final2, _ = run_cooling(cfg2, resume=True)
    assert float(final2.t) == pytest.approx(0.5, rel=1e-9)

    cfgf = dataclasses.replace(cfg1, tmax=0.5,
                               save_directory=str(tmp_path / "fresh"))
    run_cooling(cfgf, seed=5)
    df = str(next((tmp_path / "fresh").rglob("energies.dat")).parent)
    ef = np.loadtxt(os.path.join(df, "energies.dat"), ndmin=2)
    ec = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
    # chained grid == fresh grid (the splice realignment segment)
    np.testing.assert_allclose(ec[:, 0], ef[:, 0], rtol=1e-9)
    # pre-splice rows bit-identical (appended once, never rewritten)
    np.testing.assert_array_equal(ec[:12], e1)
    for k in range(len(iv)):
        ac = np.loadtxt(os.path.join(d, f"VAF_interval{k}.dat"), ndmin=2)
        af = np.loadtxt(os.path.join(df, f"VAF_interval{k}.dat"), ndmin=2)
        np.testing.assert_allclose(ac[:, 0], af[:, 0], rtol=1e-9,
                                   err_msg=f"VAF_interval{k} grid")
        assert np.all(np.diff(ac[:, 0]) > 0)


def test_ensemble_ascii_resume_newest_wins(tmp_path):
    """Cross-format resume at ensemble scale: when only the ASCII
    checkpoints are present/newer (a reference binary continued each job
    of the array — interop chaining), run_ensemble(resume=True) rebuilds
    the fold from conditions_/wvFns_/ions_ with reference newRun=0
    semantics (Epot0=0, Vholder from VZERO) instead of replaying a stale
    native .npz."""
    import dataclasses
    import glob
    from mdqtplasmasims_tpu.experiments.laser_cooling import run_ensemble
    cfg1 = CoolingConfig(n0=32, tmax=0.2, sample_freq=10,
                         dtype="float64",
                         vaf_intervals=(0.05,),
                         save_directory=str(tmp_path))
    run_ensemble(cfg1, n_jobs=2, seed=3)
    dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(dirs) == 2
    # simulate the binary-continued state: only ASCII checkpoints remain
    for d in dirs:
        for p in glob.glob(os.path.join(d, "checkpoint_*.npz")):
            os.remove(p)

    cfg2 = dataclasses.replace(cfg1, tmax=0.4)
    final2, outs2 = run_ensemble(cfg2, n_jobs=2, resume=True)
    assert float(final2.t[0]) == pytest.approx(0.4, rel=1e-9)
    assert outs2["t"].shape[1] == 10          # only the remaining half
    for d in dirs:
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 20
        np.testing.assert_allclose(np.diff(e[:, 0]), 0.02, rtol=1e-9)
        v = np.loadtxt(os.path.join(d, "VAF_interval0.dat"), ndmin=2)
        # the restored vholder keeps the interval streaming to the last
        # sample, which sits at the reference's output instant: one
        # quantum tick into the final MD step (SpeedUp.cpp:1365-1368)
        t_last = 0.4 - cfg2.timestep + cfg2.timestep / cfg2.ratio
        assert v[-1, 0] == pytest.approx(t_last, abs=1e-6)
        assert np.all(np.diff(v[:, 0]) > 0)


def test_ensemble_ascii_resume_poisson_n(tmp_path):
    """ASCII fold rebuild with *unequal* member N (Poissonian ensembles,
    reference SpeedUp.cpp:289-348): members pad on host to max N and the
    per-member mask is rebuilt from the checkpoint row counts."""
    import dataclasses
    import glob
    from mdqtplasmasims_tpu.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_tpu.io import checkpoint as ckpt
    cfg1 = CoolingConfig(n0=32, tmax=0.2, sample_freq=10,
                         dtype="float64",
                         exact_n=False,
                         save_directory=str(tmp_path))
    run_ensemble(cfg1, n_jobs=2, seed=5)
    dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(dirs) == 2
    c0 = ckpt.latest_ascii_checkpoint(dirs[0])
    n_js = [ckpt.read_conditions(d, c0)[0].shape[0] for d in dirs]
    assert n_js[0] != n_js[1]       # the seed must give a real spread
    for d in dirs:
        for p in glob.glob(os.path.join(d, "checkpoint_*.npz")):
            os.remove(p)

    cfg2 = dataclasses.replace(cfg1, tmax=0.4)
    final2, _ = run_ensemble(cfg2, n_jobs=2, resume=True)
    assert float(final2.t[0]) == pytest.approx(0.4, rel=1e-9)
    for d, nj in zip(dirs, n_js):
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 20 and np.isfinite(e).all()
        np.testing.assert_allclose(np.diff(e[:, 0]), 0.02, rtol=1e-9)
        # the continued job keeps its own Poissonian N
        R2, _ = ckpt.read_conditions(d, ckpt.latest_ascii_checkpoint(d))
        assert R2.shape[0] == nj


def test_offgrid_tmax_ensemble_chaining(tmp_path):
    """run_ensemble with tmax off the sample grid: the trailing
    sub-segment is folded into the final group (tail=), so per-job
    terminal checkpoints at c0=n_md-1 hold the true tmax state, and a
    chained (extended-tmax) ensemble realigns to the global gate."""
    import dataclasses
    from mdqtplasmasims_tpu.experiments.laser_cooling import run_ensemble
    cfg1 = CoolingConfig(n0=32, tmax=0.25, sample_freq=10,
                         dtype="float64",
                         save_directory=str(tmp_path))
    run_ensemble(cfg1, n_jobs=2, seed=3)
    dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(dirs) == 2
    for d in dirs:
        assert os.path.exists(os.path.join(d, "checkpoint_000124.npz"))

    cfg2 = dataclasses.replace(cfg1, tmax=0.5)
    final2, _ = run_ensemble(cfg2, n_jobs=2, resume=True)
    assert float(final2.t[0]) == pytest.approx(0.5, rel=1e-9)
    for d in dirs:
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 25
        # one uniform global grid across the splice (realignment seg)
        np.testing.assert_allclose(np.diff(e[:, 0]), 0.02, rtol=1e-9)


def test_ensemble_tail_only_extension(tmp_path):
    """run_ensemble covers the trailing sub-segment even when no sampled
    segment is left to fold it into: a resumed window whose extended
    tmax adds only post-gate steps, and a fresh tmax below one sample
    period, must both advance to tmax and publish the terminal
    checkpoint (the reference runs to tmax regardless of sample-grid
    alignment, SpeedUp.cpp:1247) — run() already did; this pins the
    ensemble path."""
    import dataclasses
    from mdqtplasmasims_tpu.experiments.laser_cooling import run_ensemble
    cfg1 = CoolingConfig(n0=32, tmax=0.25, sample_freq=10,
                         dtype="float64",
                         save_directory=str(tmp_path))
    run_ensemble(cfg1, n_jobs=2, seed=3)
    dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))

    # tmax 0.25 -> 0.258: n_segments stays 12 (the loop body never runs),
    # only 4 more MD steps past the last gate
    cfg2 = dataclasses.replace(cfg1, tmax=0.258)
    final2, outs2 = run_ensemble(cfg2, n_jobs=2, resume=True)
    assert outs2 is None                     # no new samples — correct
    assert float(final2.t[0]) == pytest.approx(0.258, rel=1e-9)
    for d in dirs:
        assert os.path.exists(os.path.join(d, "checkpoint_000128.npz"))
        e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        assert e.shape[0] == 12              # no duplicate rows appended

    # fresh run below one sample period: n_segments == 0
    cfg3 = CoolingConfig(n0=32, tmax=0.01, sample_freq=10,
                         dtype="float64",
                         save_directory=str(tmp_path / "short"))
    final3, outs3 = run_ensemble(cfg3, n_jobs=2, seed=3)
    assert outs3 is None
    assert float(final3.t[0]) == pytest.approx(0.01, rel=1e-9)
    d3 = sorted(str(p.parent) for p in
                (tmp_path / "short").rglob("checkpoint_000004.npz"))
    assert len(d3) == 2


def test_ensemble_uniform_tick_guard():
    """The fold precondition (one shared tick across members) is enforced
    at the eager wrapper, before the jit boundary — under jit the guard
    could never fire (tick is a tracer on trace, and the traced Python
    body does not re-run on cached calls)."""
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, _initial_state_from_key, canonical_run_cfg,
        run_compiled_ensemble)
    cfg = canonical_run_cfg(CoolingConfig(n0=16, sample_freq=4,
                                          dtype="float64"))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    states = jax.jit(jax.vmap(
        lambda k: _initial_state_from_key(cfg, k)))(keys)
    states = states._replace(
        tick=jnp.asarray([0, 7], jnp.int32))       # divergent checkpoints
    with pytest.raises(ValueError, match="uniform tick"):
        run_compiled_ensemble(cfg, states, 1)


def test_ensemble_partial_checkpoint_guards(tmp_path):
    """Resume refuses to proceed when checkpoints cover only part of the
    fold: (a) a reference binary advanced only SOME jobs' ASCII
    checkpoints past the common native point — resuming from the native
    point would replay the advanced jobs' steps; (b) checkpoints missing
    for a subset of jobs entirely — restarting the fold from scratch
    would duplicate every .dat row."""
    import dataclasses
    import glob
    from mdqtplasmasims_tpu.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_tpu.io import checkpoint as ckpt
    cfg1 = CoolingConfig(n0=32, tmax=0.2, sample_freq=10,
                         dtype="float64",
                         save_directory=str(tmp_path))
    run_ensemble(cfg1, n_jobs=2, seed=3)
    dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    cfg2 = dataclasses.replace(cfg1, tmax=0.4)

    # (a) fabricate a newer ASCII checkpoint for job 1 only (as if the
    # binary chained that job alone)
    c0 = ckpt.latest_ascii_checkpoint(dirs[0])
    R, V = ckpt.read_conditions(dirs[0], c0)
    psi = ckpt.read_wvfns(dirs[0], c0)
    n, counter = ckpt.read_ions(dirs[0], c0)
    ckpt.write_ions(dirs[0], c0 + 50, n, counter + 5)
    ckpt.write_conditions(dirs[0], c0 + 50, R, V)
    ckpt.write_wvfns(dirs[0], c0 + 50, psi)
    with pytest.raises(ValueError, match="newer than the native"):
        run_ensemble(cfg2, n_jobs=2, resume=True)
    for name in ("ions", "conditions", "wvFns"):
        os.remove(os.path.join(dirs[0], f"{name}_timestep{c0 + 50:06d}.dat"))

    # (b) job 2 loses all its checkpoints (both formats)
    for p in (glob.glob(os.path.join(dirs[1], "checkpoint_*.npz"))
              + glob.glob(os.path.join(dirs[1], "*_timestep*.dat"))):
        os.remove(p)
    with pytest.raises(ValueError, match="subset of jobs"):
        run_ensemble(cfg2, n_jobs=2, resume=True)


class TestPoissonEnsemble:
    """Per-member Poissonian ion counts inside one fixed-shape fold
    (reference init draws a fresh N per array job, SpeedUp.cpp:289-348;
    previously ensembles pinned N=N0 — PARITY delta #6, now closed)."""

    def test_masked_member_matches_exact_shape(self):
        """A member with n=56 real ions inside a padded [1,64] fold must
        reproduce the exact-shape n=56 run bit-for-bit, and the padded
        lanes must stay exactly at R=V=psi=0 (inert)."""
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            _initial_state_from_key, run_compiled_ensemble)
        cfg = CoolingConfig(n0=64, fused_interpret=True,
                            sample_freq=3)
        key = jax.random.PRNGKey(3)
        st = _initial_state_from_key(cfg, key, n=56)

        def pad_to(a, n):
            out = jnp.zeros((n,) + a.shape[1:], a.dtype)
            return out.at[:a.shape[0]].set(a)
        st_pad = st._replace(R=pad_to(st.R, 64), V=pad_to(st.V, 64),
                             F=pad_to(st.F, 64), psi=pad_to(st.psi, 64),
                             t_part=pad_to(st.t_part, 64))
        stack = lambda s: jax.tree.map(lambda a: a[None], s)
        mask = jnp.zeros((1, 64), jnp.float32).at[0, :56].set(1.0)

        fe, oe = run_compiled_ensemble(cfg, stack(st), 2)
        fp, op = run_compiled_ensemble(cfg, stack(st_pad), 2, mask=mask)
        for name in ("R", "V", "psi", "t_part"):
            a = np.asarray(getattr(fe, name)[0])
            b = np.asarray(getattr(fp, name)[0])
            np.testing.assert_array_equal(a, b[:56], err_msg=name)
            if name != "t_part":   # t_part ticks forward on every lane
                assert not np.any(b[56:]), f"padded lanes of {name} moved"
        for k in ("ekin", "epot", "vx_mean", "pvel"):
            np.testing.assert_allclose(np.asarray(oe[k]), np.asarray(op[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)

    def test_counts_poissonian(self):
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            _poisson_member_states)
        cfg = CoolingConfig(n0=400)
        states, mask, n_js = _poisson_member_states(cfg, 16, seed=2)
        n_js = np.asarray(n_js)
        assert states.R.shape == (16, n_js.max(), 3)
        np.testing.assert_array_equal(np.asarray(mask).sum(1), n_js)
        # Binomial(729*400, 1/729): mean 400, sd ~20 — draws spread
        assert n_js.std() > 5 and abs(n_js.mean() - 400) < 25
        assert len(set(n_js.tolist())) > 4

    def test_run_ensemble_poisson_end_to_end(self, tmp_path):
        """exact_n=False ensembles run, write per-job files sized to each
        member's real N, and chain through checkpoint/resume."""
        import dataclasses
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_ensemble)
        cfg1 = CoolingConfig(n0=48, tmax=0.2, sample_freq=10,
                             exact_n=False, checkpoint_every_segments=1,
                             dtype="float64",
                             save_directory=str(tmp_path))
        final1, outs1 = run_ensemble(cfg1, n_jobs=3, seed=9)
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 3
        n_seen = []
        for d in job_dirs:
            e = np.loadtxt(os.path.join(d, "energies.dat"))
            assert np.isfinite(e).all()
            c0 = int(round(cfg1.tmax / cfg1.timestep)) - 1
            cond = np.loadtxt(
                os.path.join(d, f"conditions_timestep{c0:06d}.dat"))
            n_seen.append(cond.shape[0])
        assert len(set(n_seen)) > 1, f"members all drew N={n_seen[0]}"

        cfg2 = dataclasses.replace(cfg1, tmax=0.4)
        final2, outs2 = run_ensemble(cfg2, n_jobs=3, seed=9, resume=True)
        n_total = int(round(cfg2.tmax / cfg2.timestep)) // cfg2.sample_freq
        for d, nj in zip(job_dirs, n_seen):
            e = np.loadtxt(os.path.join(d, "energies.dat"))
            assert e.shape[0] == n_total, d
            c0f = int(round(cfg2.tmax / cfg2.timestep)) - 1
            cond = np.loadtxt(
                os.path.join(d, f"conditions_timestep{c0f:06d}.dat"))
            assert cond.shape[0] == nj  # member keeps its drawn N


class TestFrozenTagPoissonEnsemble:
    """Per-member Poissonian ion counts in the frozen-tag batched fold
    (reference init draws a fresh N per array job,
    randomFrozenStartTag422Linear.cpp:245-303; previously tagging
    ensembles pinned N=N0)."""

    CFG = dict(variant="422linear", n0=48, tstart=1.0, tmax=3.0,
               timestep=0.01, sample_freq=20, tpump_seconds=2e-7)

    def test_ones_mask_equals_unmasked(self):
        """The mask plumbing is physics-neutral: an all-ones mask fold
        reproduces the unmasked fold.  Equality is to f32
        fusion-rounding tolerance, not bitwise — the mask multiplies
        change XLA's FMA contraction in the force sums, and the DIH
        dynamics amplify that rounding slightly over the run."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            _run_batched)
        import dataclasses as dc
        cfg = FrozenTagConfig(**self.CFG)
        keys = jax.random.split(jax.random.PRNGKey(5), 3)
        mcfgs = [dc.replace(cfg, job=j + 1) for j in range(3)]
        a = _run_batched(cfg, mcfgs, keys)
        b = _run_batched(cfg, mcfgs, keys,
                         mask=jnp.ones((3, cfg.n0), jnp.float32))
        for j in range(3):
            for k in ("moments", "energies", "vaf", "long_kin"):
                np.testing.assert_allclose(
                    np.asarray(a[j]["outs"][k]), np.asarray(b[j]["outs"][k]),
                    rtol=5e-4, atol=1e-5, err_msg=k)
            same = np.mean(a[j]["spin_up"] == b[j]["spin_up"])
            assert same > 0.95, f"job {j}: spin tags diverged ({same:.2%})"
            np.testing.assert_allclose(np.asarray(a[j]["final"].R),
                                       np.asarray(b[j]["final"].R),
                                       rtol=1e-3, atol=1e-4)

    def test_padded_lanes_inert(self):
        """Padded lanes stay exactly R=V=psi=0 through init, DIH MD, the
        pump window, measurement, and recording."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            _run_batched)
        import dataclasses as dc
        cfg = FrozenTagConfig(**self.CFG)
        keys = jax.random.split(jax.random.PRNGKey(7), 2)
        mcfgs = [dc.replace(cfg, job=j + 1) for j in range(2)]
        m = np.ones((2, cfg.n0), np.float32)
        m[0, 40:] = 0.0
        m[1, 35:] = 0.0
        res = _run_batched(cfg, mcfgs, keys, mask=jnp.asarray(m))
        # results are sliced to each member's real N...
        assert res[0]["final"].R.shape[0] == 40
        assert res[1]["spin_up"].shape[0] == 35
        assert res[0]["n_ions"] == 40 and res[1]["n_ions"] == 35
        # ...so re-run the fold's member function to inspect raw lanes
        out = jax.tree.map(np.asarray, res[0]["outs"])
        for k in ("moments", "energies", "vaf", "long_kin"):
            assert np.isfinite(out[k]).all(), k

    def test_sweep_with_poisson_counts(self):
        """exact_n=False sweeps combine per-member QTParams (detuning
        grid) with per-member Poissonian masks in one fold.  A sweep at
        cfg's own (detuning, om) with the same seed draws the same masks
        as run_ensemble and must reproduce it bit-for-bit (the 422
        tables scale exactly under the unit-scheme identity)."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            run_ensemble, run_sweep)
        cfg = FrozenTagConfig(**{**self.CFG, "n0": 64}, exact_n=False)
        res, mcfgs = run_sweep(
            cfg, [{"detuning": cfg.detuning, "om": cfg.om}],
            jobs_per_point=3, seed=13)
        ens = run_ensemble(cfg, 3, seed=13)
        n_js = [r["n_ions"] for r in res]
        assert n_js == [r["n_ions"] for r in ens] and len(set(n_js)) > 1
        for j in range(3):
            assert res[j]["spin_up"].shape[0] == n_js[j]
            np.testing.assert_array_equal(res[j]["outs"]["moments"],
                                          ens[j]["outs"]["moments"])
            np.testing.assert_array_equal(res[j]["spin_up"],
                                          ens[j]["spin_up"])

    def test_poisson_fold_over_mesh(self):
        """Poissonian masks compose with member_sharded: the masked fold
        spread over the mesh's ens axis is bit-exact vs single-device."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            run_ensemble)
        from mdqtplasmasims_tpu.parallel.mesh import make_mesh
        if jax.device_count() < 8:
            pytest.skip("needs 8 virtual devices")
        cfg = FrozenTagConfig(**{**self.CFG, "n0": 64}, exact_n=False)
        a = run_ensemble(cfg, 8, seed=21)
        b = run_ensemble(cfg, 8, seed=21,
                         mesh=make_mesh(n_ens=8, n_ions=1))
        for j in range(8):
            assert a[j]["n_ions"] == b[j]["n_ions"]
            np.testing.assert_array_equal(a[j]["outs"]["moments"],
                                          b[j]["outs"]["moments"])
            np.testing.assert_array_equal(a[j]["spin_up"], b[j]["spin_up"])

    def test_run_ensemble_poisson_end_to_end(self, tmp_path):
        """exact_n=False tagging ensembles draw spread Poissonian counts,
        write per-job trees sized to each member's real N, and produce
        physical outputs."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            run_ensemble)
        cfg = FrozenTagConfig(**{**self.CFG, "n0": 64},
                              exact_n=False,
                              save_directory=str(tmp_path))
        res = run_ensemble(cfg, 6, seed=11)
        n_js = [r["n_ions"] for r in res]
        assert len(set(n_js)) > 1, f"members all drew N={n_js[0]}"
        assert abs(np.mean(n_js) - 64) < 64 * 0.5
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 6
        c0 = int(round(cfg.tmax / cfg.timestep)) - 1
        for d, r in zip(job_dirs, res):
            e = np.loadtxt(os.path.join(d, "energies.dat"))
            assert np.isfinite(e).all()
            cond = np.loadtxt(
                os.path.join(d, f"conditions_timestep{c0:06d}.dat"))
            assert cond.shape[0] == r["n_ions"]
            spins = np.loadtxt(os.path.join(
                d, f"spinUpIonsList_timestep{c0:06d}.dat"))
            assert spins.shape[0] == r["n_ions"]
            # DIH heats every member to the same correlation temperature
            # scale regardless of its drawn N
            assert 0.05 < e[-1, 1] < 2.0, (d, e[-1])


def test_ensemble_checkpoint_resume(tmp_path):
    """Per-job walltime chaining for batched ensembles: every job
    directory gets periodic native checkpoints (with its RNG key), .dat
    rows stream group-by-group, and run_ensemble(resume=True) rebuilds
    the fold from the newest common checkpoint (reference: README.md:
    51-53 chains 8-h windows per array job)."""
    import dataclasses
    import glob
    from mdqtplasmasims_tpu.experiments.laser_cooling import run_ensemble
    cfg1 = CoolingConfig(n0=48, tmax=0.2, sample_freq=10,
                         checkpoint_every_segments=1,
                         dtype="float64", save_directory=str(tmp_path))
    run_ensemble(cfg1, n_jobs=2, seed=5)
    job_dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(job_dirs) == 2
    for d in job_dirs:
        assert glob.glob(os.path.join(d, "checkpoint_*.npz")), d

    cfg2 = dataclasses.replace(cfg1, tmax=0.4)
    final2, outs2 = run_ensemble(cfg2, n_jobs=2, seed=5, resume=True)
    n_total = int(round(cfg2.tmax / cfg2.timestep)) // cfg2.sample_freq
    # only the remaining segments were computed in the resumed call
    assert outs2["t"].shape == (2, n_total - 10)
    for d in job_dirs:
        e = np.loadtxt(os.path.join(d, "energies.dat"))
        assert e.shape[0] == n_total, d
        np.testing.assert_allclose(np.diff(e[:, 0]),
                                   cfg2.sample_freq * cfg2.timestep,
                                   rtol=1e-6)
    # members stay independent through the splice (restored per-job keys)
    assert not np.allclose(np.asarray(final2.R[0]),
                           np.asarray(final2.R[1]))
    assert float(final2.t[0]) == pytest.approx(cfg2.tmax, rel=1e-6)


def test_vholder_restored_across_resume(tmp_path):
    """VAF intervals that began before a walltime splice keep streaming
    after resume from the restored v0 (the reference re-reads VZERO into
    Vholder on restart, SpeedUp.cpp:901-909).  Before the fix, the
    post-splice rows were missing and the final VZERO files were zeros."""
    import dataclasses
    cfg1 = CoolingConfig(n0=48, tmax=0.2, sample_freq=10,
                         vaf_intervals=(0.1,),
                         checkpoint_every_segments=2,
                         dtype="float64", save_directory=str(tmp_path))
    run_cooling(cfg1)
    d = str(next(tmp_path.rglob("VAF_interval0.dat")).parent)
    vaf1 = np.loadtxt(os.path.join(d, "VAF_interval0.dat")).reshape(-1, 2)
    c0_leg1 = int(round(cfg1.tmax / cfg1.timestep)) - 1
    vzero1 = np.loadtxt(os.path.join(
        d, f"VZERO_timestep{c0_leg1:06d}_interval0.dat"))
    assert np.any(vzero1), "leg-1 v0 snapshot missing"

    cfg2 = dataclasses.replace(cfg1, tmax=0.4)
    run_cooling(cfg2, resume=True)

    vaf = np.loadtxt(os.path.join(d, "VAF_interval0.dat")).reshape(-1, 2)
    n_total = int(round(cfg2.tmax / cfg2.timestep)) // cfg2.sample_freq
    n_expected = n_total - int(np.argmin(np.abs(
        np.arange(1, n_total + 1) * cfg2.sample_freq * cfg2.timestep - 0.1)))
    assert vaf.shape[0] == n_expected, (vaf.shape, n_expected)
    # leg-1 rows untouched, continuation seamless in time
    np.testing.assert_array_equal(vaf[:vaf1.shape[0]], vaf1)
    assert np.all(np.diff(vaf[:, 0]) > 0)
    np.testing.assert_allclose(
        np.diff(vaf[:, 0]), cfg2.sample_freq * cfg2.timestep, rtol=1e-6)
    # the terminal VZERO carries the same v0 the interval started with
    c0_final = int(round(cfg2.tmax / cfg2.timestep)) - 1
    vzero2 = np.loadtxt(os.path.join(
        d, f"VZERO_timestep{c0_final:06d}_interval0.dat"))
    np.testing.assert_allclose(vzero2, vzero1, rtol=1e-5, atol=1e-12)
    # post-splice rows really use the restored v0: recompute the first
    # continuation row from the files
    v_t = vaf[vaf1.shape[0], 0]
    assert vaf[vaf1.shape[0], 1] != 0.0
    assert abs(v_t - (vaf1[-1, 0] + cfg2.sample_freq * cfg2.timestep)) < 1e-9


def test_transport_run_ensemble(tmp_path):
    """The staged transport pipeline vmapped over a job axis."""
    from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import run_ensemble
    cfg = MCTransportConfig(n=27, mc_steps=500, gr_every_mc=250,
                            pre_record_md_steps=10, record_steps=40,
                            gr_every_record=20, instant_aniso_steps=20,
                            reequil_steps=10, aniso_relax_steps=20,
                            aniso_time_us=1.0, save_directory=str(tmp_path))
    results = run_ensemble(cfg, n_jobs=2, seed=4)
    assert len(results) == 2
    for res in results:
        assert res["vaf"].shape == (40,)
        assert 0.3 < res["vaf"][0] < 3.0
        assert res["temps_inst"].shape == (20, 3)
    assert not np.allclose(results[0]["V"], results[1]["V"])
    job_dirs = sorted(str(p.parent) for p in tmp_path.rglob("VAF.dat"))
    assert len(job_dirs) == 2


class TestDetuningSweep:
    """Detuning sweeps folded into one fused dispatch (run_ensemble
    sweep= / run_sweep): where the reference user recompiles the binary
    per (detSP, detDP) point (SpeedUp.cpp:66-67), the framework runs the
    grid as one compiled program with per-lane diagonal energies
    (core/qt_fused.py per_lane_e0)."""

    BASE = dict(n0=96, tmax=0.16, sample_freq=2,
                fused_interpret=True)

    def test_sweep_member_matches_uniform_fold(self):
        """Member j of a sweep fold must reproduce — bit for bit — the
        same member inside a uniform fold whose *config* detunings equal
        member j's sweep point (same seed, same keys, same rolls)."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            _initial_state_from_key, build_engine, run_compiled_ensemble)
        base = CoolingConfig(**self.BASE)
        dets = [(-1.0, 1.0), (-0.5, 0.4)]
        keys = jax.random.split(jax.random.PRNGKey(3), len(dets))
        states = jax.jit(jax.vmap(
            lambda k: _initial_state_from_key(base, k)))(keys)
        e0s = jnp.asarray(np.stack(
            [build_engine(dc.replace(base, detuning=d,
                                     detuning_dp=dd)).scheme.e0
             for d, dd in dets]), jnp.float32)
        fs, os_ = run_compiled_ensemble(base, states, 2, sweep_e0=e0s)
        for j, (d, dd) in enumerate(dets):
            cfg_j = dc.replace(base, detuning=d, detuning_dp=dd)
            fu, ou = run_compiled_ensemble(cfg_j, states, 2)
            for name in ("R", "V", "psi", "t_part"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(fs, name)[j]),
                    np.asarray(getattr(fu, name)[j]), err_msg=name)
            np.testing.assert_array_equal(np.asarray(os_["ekin"][j]),
                                          np.asarray(ou["ekin"][j]))

    def test_run_sweep_writes_per_point_dirs(self, tmp_path):
        """Each sweep point's members land in that point's param-encoded
        directory — the layout separate reference builds would produce —
        and the dark-state physics differs between points."""
        from mdqtplasmasims_tpu.experiments.laser_cooling import run_sweep
        cfg = CoolingConfig(save_directory=str(tmp_path), **self.BASE)
        points = [(-1.0, 1.0), (-0.5, 0.4)]
        final, outs, mcfgs = run_sweep(cfg, points, jobs_per_point=2,
                                       seed=5)
        assert np.asarray(outs["ekin"]).shape[0] == 4
        assert len(mcfgs) == 4
        assert [c.job for c in mcfgs] == [1, 2, 1, 2]
        import glob
        import os
        dirs = sorted(glob.glob(str(tmp_path / "*")))
        assert len(dirs) == 2
        assert any("DetSP-100DetDP100" in d for d in dirs)
        assert any("DetSP-50DetDP40" in d for d in dirs)
        for d in dirs:
            jobs = sorted(glob.glob(os.path.join(d, "job*")))
            assert [os.path.basename(j) for j in jobs] == ["job1", "job2"]
            assert os.path.exists(os.path.join(jobs[0], "energies.dat"))

    def test_sweep_validation(self):
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_ensemble)
        cfg = CoolingConfig(**self.BASE)
        with pytest.raises(ValueError, match="entries"):
            run_ensemble(cfg, 3, sweep=[{"detuning": -1.0}])
        with pytest.raises(ValueError, match="density"):
            run_ensemble(cfg, 1, sweep=[{"density": 2.0}])

    def test_sweep_requires_fused_path(self):
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            _initial_state_from_key, run_compiled_ensemble)
        cfg = CoolingConfig(n0=96, fused_interpret=False,
                            sample_freq=2)
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        states = jax.jit(jax.vmap(
            lambda k: _initial_state_from_key(cfg, k)))(keys)
        e0s = jnp.zeros((2, 12), jnp.float32)
        with pytest.raises(ValueError, match="fused"):
            run_compiled_ensemble(cfg, states, 1, sweep_e0=e0s)


class TestRabiSweep:
    """Rabi-frequency (OmSP/OmDP) sweeps folded into one fused dispatch:
    H is *linear* in each Rabi frequency (levels.py:172-211 — SP
    couplings and SP force weights ∝ om; DP couplings, beat-note
    coefficients and DP force weights ∝ om_dp), so the kernel scales two
    fixed base patterns by per-lane (om, om_dp) rows
    (core/qt_fused.py per_lane_om) instead of recompiling per point the
    way the reference user rebuilds the binary (SpeedUp.cpp:68-69)."""

    BASE = dict(n0=96, tmax=0.16, sample_freq=2,
                fused_interpret=True)

    def test_om_split_reconstructs_scheme(self):
        """om*pattern_sp + om_dp*pattern_dp must rebuild the full scheme
        exactly — coupling matrix, beat-note coefficients, and recoiled
        Ehrenfest force weights — for generic (om, om_dp)."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            build_engine, om_split_schemes)
        om, om_dp = 1.7, 0.6
        cfg = CoolingConfig(om=om, om_dp=om_dp, **self.BASE)
        full = build_engine(cfg).scheme
        ssp, sdp = om_split_schemes(cfg)
        np.testing.assert_allclose(
            om * ssp.coupling + om_dp * sdp.coupling, full.coupling,
            rtol=0, atol=1e-14)
        assert ssp.tdep_coefs == tuple(0.0 * c for c in full.tdep_coefs)
        assert sdp.tdep_rows == full.tdep_rows
        assert sdp.tdep_cols == full.tdep_cols
        assert sdp.tdep_freq == full.tdep_freq
        np.testing.assert_allclose(
            om_dp * np.asarray(sdp.tdep_coefs),
            np.asarray(full.tdep_coefs), rtol=0, atol=1e-14)
        np.testing.assert_allclose(
            om * np.asarray(ssp.force_w) + om_dp * np.asarray(sdp.force_w),
            np.asarray(full.force_w), rtol=0, atol=1e-14)
        # the splits zero the other group so the kernel's fw==0 skip and
        # per-group scaling are exact, not approximate
        assert all((ws == 0.0) or (wd == 0.0)
                   for ws, wd in zip(ssp.force_w, sdp.force_w))

    # The split path computes om*(C_sp . psi) + om_dp*(C_dp . psi) while
    # a uniform fold contracts the prefolded matrix in ONE accumulation;
    # P rows carry couplings from both groups, so the two summation
    # orders round differently at the f32 ulp (~1e-7 relative).  The
    # contract is therefore tight-tolerance agreement, not bit equality
    # (the detuning sweep *is* bit-exact because per-lane e0 is the same
    # arithmetic as the broadcast column).
    TOL = dict(rtol=1e-5, atol=1e-6)

    def test_om_sweep_member_matches_uniform_fold(self):
        """Member j of an Om-sweep fold must reproduce the same member
        inside a uniform fold whose *config* Rabi frequencies equal
        member j's sweep point, to f32 accumulation-order tolerance."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            _initial_state_from_key, run_compiled_ensemble)
        base = CoolingConfig(**self.BASE)
        oms = [(1.0, 1.0), (1.6, 0.5)]
        keys = jax.random.split(jax.random.PRNGKey(7), len(oms))
        states = jax.jit(jax.vmap(
            lambda k: _initial_state_from_key(base, k)))(keys)
        om_rows = jnp.asarray(oms, jnp.float32)
        fs, os_ = run_compiled_ensemble(base, states, 2, sweep_om=om_rows)
        for j, (om, om_dp) in enumerate(oms):
            cfg_j = dc.replace(base, om=om, om_dp=om_dp)
            fu, ou = run_compiled_ensemble(cfg_j, states, 2)
            for name in ("R", "V", "psi", "t_part"):
                np.testing.assert_allclose(
                    np.asarray(getattr(fs, name)[j]),
                    np.asarray(getattr(fu, name)[j]), err_msg=name,
                    **self.TOL)
            np.testing.assert_allclose(np.asarray(os_["ekin"][j]),
                                       np.asarray(ou["ekin"][j]),
                                       **self.TOL)
        # the sweep took effect: member 1 evolved different physics
        assert np.abs(np.asarray(fs.psi[1]) -
                      np.asarray(fs.psi[0])).max() > 0

    def test_joint_det_om_sweep_matches_uniform(self):
        """Detuning and Rabi lanes compose: a joint (detSP, detDP, om,
        om_dp) sweep reproduces per-member uniform folds to f32
        accumulation-order tolerance (see TOL)."""
        import dataclasses as dc
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            _initial_state_from_key, build_engine, run_compiled_ensemble)
        base = CoolingConfig(**self.BASE)
        pts = [dict(detuning=-1.0, detuning_dp=1.0, om=1.0, om_dp=1.0),
               dict(detuning=-0.5, detuning_dp=0.4, om=1.4, om_dp=0.7)]
        keys = jax.random.split(jax.random.PRNGKey(9), len(pts))
        states = jax.jit(jax.vmap(
            lambda k: _initial_state_from_key(base, k)))(keys)
        e0s = jnp.asarray(np.stack(
            [build_engine(dc.replace(base, **p)).scheme.e0
             for p in pts]), jnp.float32)
        om_rows = jnp.asarray([[p["om"], p["om_dp"]] for p in pts],
                              jnp.float32)
        fs, os_ = run_compiled_ensemble(base, states, 2, sweep_e0=e0s,
                                        sweep_om=om_rows)
        for j, p in enumerate(pts):
            fu, ou = run_compiled_ensemble(dc.replace(base, **p),
                                           states, 2)
            for name in ("R", "V", "psi", "t_part"):
                np.testing.assert_allclose(
                    np.asarray(getattr(fs, name)[j]),
                    np.asarray(getattr(fu, name)[j]), err_msg=name,
                    **self.TOL)
            np.testing.assert_allclose(np.asarray(os_["ekin"][j]),
                                       np.asarray(ou["ekin"][j]),
                                       **self.TOL)

    def test_run_sweep_dict_points_write_om_dirs(self, tmp_path):
        """Dict sweep points carrying Om overrides land in OmSP/OmDP
        param-encoded directories — the layout separate reference builds
        would produce."""
        from mdqtplasmasims_tpu.experiments.laser_cooling import run_sweep
        cfg = CoolingConfig(save_directory=str(tmp_path), **self.BASE)
        points = [{"om": 1.0, "om_dp": 1.0}, {"om": 0.5, "om_dp": 1.3}]
        final, outs, mcfgs = run_sweep(cfg, points, seed=3)
        assert [(c.om, c.om_dp) for c in mcfgs] == [(1.0, 1.0),
                                                    (0.5, 1.3)]
        import glob
        import os
        dirs = sorted(glob.glob(str(tmp_path / "*")))
        assert len(dirs) == 2
        assert any("OmSP100OmDP100" in d for d in dirs)
        assert any("OmSP50OmDP130" in d for d in dirs)
        for d in dirs:
            assert os.path.exists(os.path.join(d, "job1", "energies.dat"))


class TestTransportSweep:
    """(Gamma, kappa) phase-diagram sweeps folded into one vmapped
    transport program (run_sweep): Gamma and the screening length enter
    the traced pipeline as per-member scalars — the pair forces take
    the member's traced ldeb — where
    the reference rebuilds the binary per (Gamma, kappa) point
    (MonteCarloFollowedByMDAndTempAnisotropy.cpp:64-65)."""

    BASE = dict(n=27, mc_steps=400, gr_every_mc=200,
                pre_record_md_steps=10, record_steps=40,
                gr_every_record=20, instant_aniso_steps=10,
                reequil_steps=10, aniso_relax_steps=10, aniso_time_us=1.0)

    def test_traced_overrides_match_static_single_step(self):
        """One MD step with traced (gamma, ldeb) equal to cfg's values
        reproduces the static-cfg step to f32 rounding tolerance — pins
        the override plumbing deterministically (longer runs diverge
        chaotically from the 1-ulp sqrt(1/gamma) rounding difference)."""
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import md_stage
        cfg = MCTransportConfig(**self.BASE)
        key = jax.random.PRNGKey(3)
        kl, kr = jax.random.split(key)
        from mdqtplasmasims_tpu.core.init import lattice_init
        R, V = lattice_init(kl, cfg.n, cfg.gamma, cfg.L,
                            dtype=cfg.np_dtype)
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import _forces
        A = _forces(cfg)(R)
        (Rs_, Vs_, As_, _), _ = md_stage(cfg, R, V, A, kr, 1,
                                         collision_freq=cfg.collision_freq)
        (Rt_, Vt_, At_, _), _ = md_stage(
            cfg, R, V, A, kr, 1, collision_freq=cfg.collision_freq,
            gamma=jnp.asarray(cfg.gamma, cfg.np_dtype),
            ldeb=jnp.asarray(cfg.ldeb, cfg.np_dtype))
        np.testing.assert_allclose(np.asarray(Rt_), np.asarray(Rs_),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(Vt_), np.asarray(Vs_),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(At_), np.asarray(As_),
                                   rtol=1e-5, atol=1e-5)

    def test_gamma_sets_member_temperature(self):
        """Members at different Gamma in ONE fold keep their own thermal
        scale: recorded <v^2> tracks 1/Gamma per member."""
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import run_sweep
        cfg = MCTransportConfig(**self.BASE)
        results, mcfgs = run_sweep(
            cfg, [{"gamma": 0.5}, {"gamma": 30.0}], seed=5)
        t_hot = results[0]["temps"].mean()
        t_cold = results[1]["temps"].mean()
        assert t_hot > 5 * t_cold, (t_hot, t_cold)
        # both in the right absolute range (correlation effects shift
        # <v^2> from 1/Gamma by O(10%), not O(2x))
        assert 0.8 < t_hot / (1.0 / 0.5) < 1.6, t_hot
        assert 0.5 < t_cold / (1.0 / 30.0) < 2.5, t_cold
        assert [m.gamma for m in mcfgs] == [0.5, 30.0]

    def test_kappa_sets_member_screening(self):
        """Members at different kappa in one fold feel different forces:
        weak screening (small kappa) at the same Gamma couples harder, so
        its MC acceptance is lower."""
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import run_sweep
        cfg = MCTransportConfig(**self.BASE)
        results, _ = run_sweep(
            cfg, [{"kappa": 0.3}, {"kappa": 3.0}], seed=6)
        acc_strong = int(results[0]["mc_accepted"])
        acc_weak = int(results[1]["mc_accepted"])
        assert acc_weak > acc_strong, (acc_strong, acc_weak)

    def test_run_sweep_writes_per_point_dirs(self, tmp_path):
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import run_sweep
        cfg = MCTransportConfig(save_directory=str(tmp_path), **self.BASE)
        results, mcfgs = run_sweep(
            cfg, [{"gamma": 1.0, "kappa": 0.5},
                  {"gamma": 10.0, "kappa": 1.0}],
            jobs_per_point=2, seed=7)
        assert len(results) == 4
        import glob
        dirs = sorted(os.path.basename(d)
                      for d in glob.glob(str(tmp_path / "*")))
        assert set(dirs) == {"Gamma100Kappa50NumIons27",
                             "Gamma1000Kappa100NumIons27"}
        for d in dirs:
            for j in (1, 2):
                jd = tmp_path / d / f"job{j}"
                assert (jd / "VAF.dat").exists()
                assert (jd / "temperature.dat").exists()

    def test_sweep_validation(self):
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import run_sweep
        cfg = MCTransportConfig(**self.BASE)
        with pytest.raises(ValueError, match="override"):
            run_sweep(cfg, [{"n": 64}])


class TestTaggingSweeps:
    """Pump-laser (detuning, om) sweeps folded into one batched program
    for the tagging families and the 3-state toy: per-member traced
    QTParams (core/qt.sweep_qt_params) replace the reference's per-point
    binary rebuild (randomFrozenStartTag422Linear.cpp:55-57,
    MonteCarloFollowedByQTTagging408Quad.cpp:96-100,
    laserCoolNoPlasmaThreeState.cpp:85-87)."""

    def test_frozen_sweep_identity_member_matches_ensemble(self):
        """A sweep member at cfg's own (detuning, om) reproduces the
        plain ensemble member bit-for-bit (the 422 tables scale exactly:
        det*(-1) and om*(-om_unit/2) round identically)."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            run_ensemble, run_sweep)
        cfg = FrozenTagConfig(variant="422linear", n0=48, tstart=1.0,
                              tmax=3.0, timestep=0.01, sample_freq=20,
                              tpump_seconds=2e-7)
        res, mcfgs = run_sweep(
            cfg, [{"detuning": cfg.detuning, "om": cfg.om},
                  {"detuning": -6.0}], seed=2)
        ens = run_ensemble(cfg, 1, seed=2)
        np.testing.assert_array_equal(res[0]["outs"]["moments"],
                                      ens[0]["outs"]["moments"])
        np.testing.assert_array_equal(res[0]["spin_up"], ens[0]["spin_up"])
        assert [m.detuning for m in mcfgs] == [cfg.detuning, -6.0]

    def test_frozen_sweep_detuning_changes_pumping(self, tmp_path):
        """Far-detuned pump moves the spin-up fraction toward the
        unpumped 50/50 baseline; near-resonant pumping polarizes away
        from it.  Each point writes its own detuning-encoded .dat tree."""
        from mdqtplasmasims_tpu.experiments.frozen_tagging import run_sweep
        cfg = FrozenTagConfig(variant="422linear", n0=128, tstart=1.0,
                              tmax=3.0, timestep=0.01, sample_freq=20,
                              tpump_seconds=2e-7,
                              save_directory=str(tmp_path))
        res, _ = run_sweep(cfg, [{"detuning": -1.0}, {"detuning": -12.0}],
                           seed=3)
        near = abs(res[0]["spin_up"].mean() - 0.5)
        far = abs(res[1]["spin_up"].mean() - 0.5)
        assert near > far + 0.02, (near, far)
        import glob
        dirs = glob.glob(str(tmp_path / "*"))
        assert len(dirs) == 2
        for d in dirs:
            assert os.path.exists(os.path.join(d, "job1", "energies.dat"))

    def test_mctag_sweep_identity_and_om_effect(self):
        from mdqtplasmasims_tpu.experiments.mc_qt_tagging import (
            run_ensemble, run_sweep)
        cfg = MCTagConfig(variant="408quad", n=27, mc_steps=300,
                          pre_record_md_steps=10, record_steps=40,
                          gr_every_record=20)
        res, mcfgs = run_sweep(
            cfg, [{"detuning": cfg.detuning, "om": cfg.om},
                  {"om": 0.05}], seed=9)
        ens = run_ensemble(cfg, 1, seed=9)
        np.testing.assert_array_equal(res[0]["moments"], ens[0]["moments"])
        np.testing.assert_array_equal(res[0]["tags"], ens[0]["tags"])
        # om=2 (reference value) pumps the tagged class nearly empty;
        # om=0.05 barely pumps, leaving ~the initial 50/50 superposition
        assert res[0]["tags"].mean() < 0.15
        assert res[1]["tags"].mean() > 0.3
        with pytest.raises(ValueError, match="override"):
            run_sweep(cfg, [{"gamma": 1.0}])

    def test_three_state_sweep_identity_and_doppler_trend(self, tmp_path):
        from mdqtplasmasims_tpu.experiments.three_state import (
            run_ensemble, run_sweep)
        cfg = ThreeStateConfig(n0=64, tmax=50.0, sample_freq=100,
                               dispatch_segments=10,
                               save_directory=str(tmp_path))
        res, mcfgs = run_sweep(
            cfg, [{"detuning": cfg.detuning, "om": cfg.om},
                  {"detuning": -2.0, "om": 1.0}], seed=4)
        ens = run_ensemble(cfg, 1, seed=4)
        np.testing.assert_array_equal(res["ekin_x"][0], ens["ekin_x"][0])
        import glob
        # layout: Om<om*100>/Det<det*100>.../job<j>/energies.dat
        files = sorted(glob.glob(str(tmp_path / "Om*" / "Det*" / "job1"
                                     / "energies.dat")))
        assert len(files) == 2, files
        assert any("Om50/" in f for f in files), files     # cfg.om = 0.5
        assert any("Om100/" in f for f in files), files    # swept om = 1.0
