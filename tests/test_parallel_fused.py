"""Multi-device sharding of the production (fused tick-kernel) program.

The sharded path runs the same fused tick-block kernel + XLA pair forces
a single device runs.  These tests run that exact program on the virtual
8-device CPU mesh with the kernel in the Pallas interpreter
(``fused_interpret=True``) and pin down:

- layout invariance: a folded fused ensemble step gives bit-identical
  trajectories however the ensemble axis is split across devices
  (per-member RNG streams, scheduler.py soa_ens_md_step
  per_member_rolls);
- the ion-sharded "gather" force schedule == the unsharded forces;
- the ion-sharded fused step produces reference forces in situ;
- run_compiled_sharded end-to-end equality across mesh layouts,
  diagnostics included.

Reference basis: ensembles of 10-99 independent jobs are the reference's
production mode (exampleSlurmFile.slurm:3, README.md:63).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.core.init import frozen_gas_init
from mdqtplasmasims_tpu.experiments.laser_cooling import (
    CoolingConfig, build_scheduler, run_compiled_sharded)
from mdqtplasmasims_tpu.parallel.ensemble import (
    batched_initial_states, make_sharded_fused_step, shard_keys)
from mdqtplasmasims_tpu.parallel.mesh import make_mesh
from mdqtplasmasims_tpu.state import make_state
from mdqtplasmasims_tpu.units import PlasmaUnits

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")


def _fused_cfg(**kw):
    kw.setdefault("n0", 48)
    kw.setdefault("fused_interpret", True)  # the fused program on the CPU
    return CoolingConfig(**kw)


def _small_sched(cfg):
    """Production scheduler on the fused path."""
    sched = build_scheduler(cfg)
    assert sched.fused_spec is not None
    return sched


def _members(cfg, n_ens, n_ions, seed=0):
    def init_one(key):
        kinit, krun = jax.random.split(key)
        R, V, psi, _ = frozen_gas_init(kinit, cfg.n0, n_states=12,
                                       exact_n=True)
        return make_state(R, V, psi, krun)
    keys = shard_keys(jax.random.PRNGKey(seed), n_ens, n_ions)
    states = batched_initial_states(init_one, keys[:, 0])
    return states._replace(key=keys)


def _fold_rp(R):
    """[E, npad, 3] positions -> folded [3, E*npad] lane layout."""
    e, npad, _ = R.shape
    return jnp.swapaxes(jnp.swapaxes(R, 1, 2), 0, 1).reshape(3, e * npad)


@needs_devices
class TestFusedSharded:
    def test_layout_invariance(self):
        """4 fused ensemble members advanced 3 MD steps must be
        bit-identical whether the ens axis spans 4, 2, or 1 device(s):
        per-member RNG + the batched kernels make each member's
        trajectory independent of its fold position and device."""
        cfg = _fused_cfg()
        pu = PlasmaUnits(cfg.density, cfg.ge)
        sched = _small_sched(cfg)
        n_ens = 4

        outs = []
        for n_dev in (4, 2, 1):
            mesh = make_mesh(n_dev, 1)
            step = make_sharded_fused_step(sched, pu.debye_length, mesh,
                                           n_steps=3)
            states = _members(cfg, n_ens, 1, seed=7)
            outs.append(jax.device_get(step(states)))

        for other in outs[1:]:
            for name in ("R", "V", "F", "t_part", "psi", "tick"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(outs[0], name)),
                    np.asarray(getattr(other, name)), err_msg=name)
        # and the members actually moved / evolved
        start = _members(cfg, n_ens, 1, seed=7)
        assert not np.allclose(np.asarray(outs[0].R), np.asarray(start.R))

    def test_cols_gather_matches_member_forces(self):
        """Rows x cols forces (the cross-shard path) == the member-batched
        forces when the column set is the member's full ion set."""
        from mdqtplasmasims_tpu.ops.yukawa import (
            yukawa_forces_soa_batched, yukawa_forces_soa_cols_batched)

        e, npad, n = 2, 128, 100
        L = PlasmaUnits.box_length(n)
        ldeb = PlasmaUnits(2.0, 0.1).debye_length
        R = jax.random.uniform(jax.random.PRNGKey(1), (e, npad, 3),
                               jnp.float64, 0, L)
        mask = jnp.zeros((npad,), jnp.float64).at[:n].set(1.0)
        R = R * mask[None, :, None]   # padded lanes at origin, masked out
        Rp = _fold_rp(R)
        masks = jnp.broadcast_to(mask[None], (e, npad))

        F_mem = yukawa_forces_soa_batched(Rp, mask[None], e, L, ldeb)
        F_cols = yukawa_forces_soa_cols_batched(Rp, R, masks, masks, e, L,
                                                ldeb)
        np.testing.assert_allclose(np.asarray(F_cols), np.asarray(F_mem),
                                   rtol=1e-11, atol=1e-12)

    @pytest.mark.parametrize("n_ions", [2, 3, 4])
    def test_gather_forces_match_unsharded(self, n_ions):
        """The gather schedule under shard_map (parallel/ensemble.
        gather_soa_forces: all_gather of positions + masks, local rows)
        == the unsharded member forces, with padded lanes on every
        shard."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_soa_batched
        from mdqtplasmasims_tpu.parallel.ensemble import gather_soa_forces
        from mdqtplasmasims_tpu.parallel.mesh import ION_AXIS

        e, n_loc, npad = 2, 24, 32
        L = PlasmaUnits.box_length(n_loc * n_ions)
        ldeb = PlasmaUnits(2.0, 0.1).debye_length
        mesh = make_mesh(1, n_ions)
        R = jax.random.uniform(jax.random.PRNGKey(5), (e, n_ions * npad, 3),
                               jnp.float64, 0, L)
        mask = jnp.zeros((n_ions * npad,), jnp.float64)
        for s in range(n_ions):                  # n_loc real ions/shard
            mask = mask.at[s * npad: s * npad + n_loc].set(1.0)
        R = R * mask[None, :, None]
        mrows = jnp.zeros((1, npad), jnp.float64).at[0, :n_loc].set(1.0)

        def local(R_block):                      # [E, npad, 3] local
            F = gather_soa_forces(L, ldeb, e, npad, mrows)(_fold_rp(R_block))
            return jnp.swapaxes(F.reshape(3, e, npad), 0, 1)

        F_sh = shard_map(local, mesh=mesh, in_specs=(P(None, ION_AXIS),),
                         out_specs=P(None, None, ION_AXIS))(R)
        F_ref = yukawa_forces_soa_batched(
            _fold_rp(R), jnp.broadcast_to(mask[None], (e, n_ions * npad)),
            e, L, ldeb)
        F_ref = jnp.swapaxes(F_ref.reshape(3, e, n_ions * npad), 0, 1)
        np.testing.assert_allclose(np.asarray(F_sh), np.asarray(F_ref),
                                   rtol=1e-10, atol=1e-12)

    def test_ion_sharded_forces_in_situ(self):
        """On an (ens=2, ions=2) mesh the fused step computes each
        member's start-of-step forces with the gathered rows x cols
        kernel; they must match the unsharded reference kernel."""
        from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential

        cfg = _fused_cfg(n0=64)
        pu = PlasmaUnits(cfg.density, cfg.ge)
        sched = _small_sched(cfg)
        mesh = make_mesh(2, 2)
        step = make_sharded_fused_step(sched, pu.debye_length, mesh,
                                       n_steps=1)
        states = _members(cfg, 2, 2, seed=3)
        out = jax.device_get(step(states))
        for i in range(2):
            F_ref, _ = yukawa_forces_potential(
                jnp.asarray(states.R[i], jnp.float32), sched.L,
                pu.debye_length)
            np.testing.assert_allclose(np.asarray(out.F[i]),
                                       np.asarray(F_ref),
                                       rtol=2e-4, atol=1e-5)
        assert int(out.tick[0]) == cfg.ratio

    def test_run_compiled_sharded_layout_invariant(self):
        """End-to-end production runner (segments + diagnostics) equal
        across mesh layouts — the multi-chip path IS the production
        program, just laid out over more devices."""
        cfg = _fused_cfg(sample_freq=3)
        n_ens = 2

        results = []
        for n_dev in (2, 1):
            mesh = make_mesh(n_dev, 1)
            states = _members(cfg, n_ens, 1, seed=11)
            final, outs = run_compiled_sharded(cfg, mesh, states,
                                               n_segments=2)
            results.append((jax.device_get(final), jax.device_get(outs)))

        (f0, o0), (f1, o1) = results
        for name in ("R", "V", "psi", "t_part"):
            np.testing.assert_array_equal(np.asarray(getattr(f0, name)),
                                          np.asarray(getattr(f1, name)),
                                          err_msg=name)
        # trajectories are BIT-identical (above); the sampled diagnostics
        # are computed from the returned mid-step state under GSPMD,
        # whose fusion/reduction order may differ per mesh layout — allow
        # f32 ulp
        for k in o0:
            np.testing.assert_allclose(np.asarray(o0[k]),
                                       np.asarray(o1[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        # diagnostics sane: energies positive, populations normalized
        assert (np.asarray(o0["ekin"]) >= 0).all()
        np.testing.assert_allclose(np.asarray(o0["pops"]).sum(-1), 1.0,
                                   atol=5e-4)  # f32 norm drift per tick

    def test_run_ensemble_on_mesh_end_to_end(self, tmp_path):
        """The user-facing production entry point: run_ensemble(mesh=...)
        steps the ensemble over the device mesh on the fused kernels and
        writes each job's .dat tree + checkpoints exactly like the
        single-device runner, including walltime-chained resume."""
        import dataclasses
        import os
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_ensemble)
        cfg1 = _fused_cfg(tmax=0.1, sample_freq=5,
                          checkpoint_every_segments=5,
                          save_directory=str(tmp_path))
        mesh = make_mesh(2, 1)
        final1, outs1 = run_ensemble(cfg1, n_jobs=2, seed=4, mesh=mesh)
        assert outs1["t"].shape == (2, 10)
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 2
        for d in job_dirs:
            e = np.loadtxt(os.path.join(d, "energies.dat"))
            assert e.shape[0] == 10 and np.isfinite(e).all()

        cfg2 = dataclasses.replace(cfg1, tmax=0.2)
        final2, outs2 = run_ensemble(cfg2, n_jobs=2, seed=4, resume=True,
                                     mesh=mesh)
        assert outs2["t"].shape == (2, 10)   # only the remaining half
        for d in job_dirs:
            e = np.loadtxt(os.path.join(d, "energies.dat"))
            assert e.shape[0] == 20
        assert not np.allclose(np.asarray(final2.R[0]),
                               np.asarray(final2.R[1]))

    def test_offgrid_tmax_on_mesh(self, tmp_path):
        """Off-grid tmax on the sharded production path: the trailing
        sub-segment runs through the shard_map tail leg
        (run_compiled_sharded tail=), terminal checkpoints hold the true
        tmax state, and a chained mesh window realigns to the global
        gate (seg_len=) — one uniform grid across the splice."""
        import dataclasses
        import os
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_ensemble)
        # tmax=0.11, f=5, dt=0.002 -> 55 MD steps: 10 samples + 5 tail
        cfg1 = _fused_cfg(tmax=0.11, sample_freq=5,
                          save_directory=str(tmp_path))
        mesh = make_mesh(2, 1)
        final1, _ = run_ensemble(cfg1, n_jobs=2, seed=4, mesh=mesh)
        assert float(final1.t[0]) == pytest.approx(0.11, rel=1e-6)
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 2
        for d in job_dirs:
            assert os.path.exists(os.path.join(d, "checkpoint_000054.npz"))

        cfg2 = dataclasses.replace(cfg1, tmax=0.2)   # 100 steps, aligned
        final2, _ = run_ensemble(cfg2, n_jobs=2, seed=4, resume=True,
                                 mesh=mesh)
        assert float(final2.t[0]) == pytest.approx(0.2, rel=1e-6)
        for d in job_dirs:
            e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
            assert e.shape[0] == 20
            np.testing.assert_allclose(np.diff(e[:, 0]), 0.01, rtol=1e-5)

    def test_ascii_resume_onto_mesh(self, tmp_path):
        """Cross-mode AND cross-format: an ensemble continued by the
        reference binary (ASCII-only checkpoints, newRun=0 per job)
        resumes onto a 2x2 (ens x ions) mesh — run_ensemble rebuilds the
        fold from conditions_/wvFns_/ions_, pads members to the
        ion-shard multiple, and splits the [E,2] keys to per-(job,
        ion-shard) [E,I,2] streams."""
        import dataclasses
        import glob
        import os
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_ensemble)
        cfg1 = _fused_cfg(tmax=0.1, sample_freq=5,
                          save_directory=str(tmp_path))
        run_ensemble(cfg1, n_jobs=2, seed=4)
        job_dirs = sorted(str(p.parent)
                          for p in tmp_path.rglob("energies.dat"))
        assert len(job_dirs) == 2
        # simulate binary continuation: only ASCII checkpoints remain
        for d in job_dirs:
            for p in glob.glob(os.path.join(d, "checkpoint_*.npz")):
                os.remove(p)

        cfg2 = dataclasses.replace(cfg1, tmax=0.2)
        final2, outs2 = run_ensemble(cfg2, n_jobs=2, resume=True,
                                     mesh=make_mesh(n_ens=2, n_ions=2))
        assert float(final2.t[0]) == pytest.approx(0.2, rel=1e-6)
        assert outs2["t"].shape == (2, 10)   # only the remaining half
        for d in job_dirs:
            e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
            assert e.shape[0] == 20
            np.testing.assert_allclose(np.diff(e[:, 0]), 0.01,
                                       rtol=1e-5)

    def test_cross_mode_resume(self, tmp_path):
        """Walltime chains can move between device counts: a single-device
        ensemble checkpoint resumes onto a mesh and a mesh checkpoint
        resumes single-device (run_ensemble normalizes the per-job key
        payload [2] vs [I,2] to the mode it runs in)."""
        import dataclasses
        import os
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_ensemble)

        # single-device first half -> mesh second half
        cfg1 = _fused_cfg(tmax=0.1, sample_freq=5,
                          checkpoint_every_segments=5,
                          save_directory=str(tmp_path / "a"))
        run_ensemble(cfg1, n_jobs=2, seed=4)
        cfg2 = dataclasses.replace(cfg1, tmax=0.2)
        _, outs2 = run_ensemble(cfg2, n_jobs=2, seed=4, resume=True,
                                mesh=make_mesh(2, 1))
        assert outs2["t"].shape == (2, 10)    # only the remaining half
        # mesh first half -> single-device second half
        cfg3 = _fused_cfg(tmax=0.1, sample_freq=5,
                          checkpoint_every_segments=5,
                          save_directory=str(tmp_path / "b"))
        run_ensemble(cfg3, n_jobs=2, seed=4, mesh=make_mesh(2, 1))
        cfg4 = dataclasses.replace(cfg3, tmax=0.2)
        _, outs4 = run_ensemble(cfg4, n_jobs=2, seed=4, resume=True)
        assert outs4["t"].shape == (2, 10)
        for sub in ("a", "b"):
            for p in sorted((tmp_path / sub).rglob("energies.dat")):
                e = np.loadtxt(p)
                assert e.shape[0] == 20 and np.isfinite(e).all()

    def test_poisson_members_on_mesh(self, tmp_path):
        """Poissonian-N members (per-member masks) run on the sharded
        production path too: layout-invariant across mesh splits, padded
        lanes exactly inert, and run_ensemble(mesh=..., exact_n=False)
        writes per-job files sized to each member's real N."""
        import os
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            run_compiled_sharded, run_ensemble, _poisson_member_states)
        cfg = _fused_cfg(sample_freq=3, exact_n=False)
        states, mask, n_js = _poisson_member_states(cfg, 2, seed=6)
        states = states._replace(key=jax.vmap(
            lambda k: jax.random.split(k, 1))(states.key))

        results = []
        for n_dev in (2, 1):
            mesh = make_mesh(n_dev, 1)
            final, outs = run_compiled_sharded(cfg, mesh, states, 2,
                                               mask=mask)
            results.append((jax.device_get(final), jax.device_get(outs)))
        (f0, o0), (f1, o1) = results
        for name in ("R", "V", "psi"):
            np.testing.assert_array_equal(np.asarray(getattr(f0, name)),
                                          np.asarray(getattr(f1, name)),
                                          err_msg=name)
            # padded lanes inert
            for j, nj in enumerate(n_js):
                assert not np.any(np.asarray(getattr(f0, name))[j, nj:]), \
                    f"padded lanes of {name} moved (member {j})"
        np.testing.assert_array_equal(np.asarray(o0["ekin"]),
                                      np.asarray(o1["ekin"]))

        # end-to-end with files
        cfg2 = _fused_cfg(tmax=0.05, sample_freq=5, exact_n=False,
                          save_directory=str(tmp_path))
        run_ensemble(cfg2, n_jobs=2, seed=6, mesh=make_mesh(2, 1))
        n_seen = []
        for p in sorted(tmp_path.rglob("conditions_timestep*.dat")):
            n_seen.append(np.loadtxt(p).shape[0])
        assert sorted(n_seen) == sorted(n_js), (n_seen, n_js)

    def test_tick_uniformity_guard(self):
        """Folding members at different ticks must raise (scheduler.py
        check_uniform_tick) instead of silently mis-timing dynamics."""
        cfg = _fused_cfg()
        sched = _small_sched(cfg)
        states = _members(cfg, 2, 1, seed=0)
        states = states._replace(
            key=states.key[:, 0],
            tick=states.tick.at[1].set(states.tick[1] + cfg.ratio))
        with pytest.raises(ValueError, match="uniform tick"):
            sched.soa_ens_init(states)


class TestShardedSweep:
    """Detuning sweeps over a device mesh: sweep_e0 shards over the
    ``ens`` axis with the members, so a multi-chip detuning grid runs
    the same per-lane-e0 fused kernel a single chip runs."""

    @needs_devices
    def test_sharded_sweep_layout_invariant(self):
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            build_engine)
        cfg = _fused_cfg(sample_freq=3)
        dets = [(-1.0, 1.0), (-0.8, 0.8), (-0.5, 0.4), (-0.3, 0.2)]
        e0s = jnp.asarray(np.stack(
            [build_engine(dataclasses.replace(cfg, detuning=d,
                                              detuning_dp=dd)).scheme.e0
             for d, dd in dets]), jnp.float32)
        results = []
        for n_dev in (4, 1):
            mesh = make_mesh(n_dev, 1)
            states = _members(cfg, len(dets), 1, seed=11)
            final, outs = run_compiled_sharded(cfg, mesh, states,
                                               n_segments=2, sweep_e0=e0s)
            results.append((jax.device_get(final), jax.device_get(outs)))
        (f0, o0), (f1, o1) = results
        for name in ("R", "V", "psi", "t_part"):
            np.testing.assert_array_equal(np.asarray(getattr(f0, name)),
                                          np.asarray(getattr(f1, name)),
                                          err_msg=name)
        # states bit-identical (above); sampled diagnostics may differ
        # at f32 ulp across mesh layouts (GSPMD fusion order)
        for k in o0:
            np.testing.assert_allclose(np.asarray(o0[k]),
                                       np.asarray(o1[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        # the sweep actually took effect: different points evolve
        # different wavefunctions from identical-seed inits? members have
        # distinct seeds anyway, so instead assert against the uniform
        # fold: point 3's member differs from a no-sweep run of member 3
        mesh = make_mesh(1, 1)
        states = _members(cfg, len(dets), 1, seed=11)
        f_uni, _ = run_compiled_sharded(cfg, mesh, states, n_segments=2)
        assert np.abs(np.asarray(f0.psi[3]) -
                      np.asarray(f_uni.psi[3])).max() > 1e-4

    @needs_devices
    def test_sharded_om_sweep_layout_invariant(self):
        """Rabi sweeps shard like detuning sweeps: sweep_om rides the
        ``ens`` axis into the per-lane-om fused kernel, and the result is
        independent of the mesh layout."""
        cfg = _fused_cfg(sample_freq=3)
        oms = [(1.0, 1.0), (1.4, 0.8), (0.7, 1.2), (0.4, 0.3)]
        om_rows = jnp.asarray(oms, jnp.float32)
        results = []
        for n_dev in (4, 1):
            mesh = make_mesh(n_dev, 1)
            states = _members(cfg, len(oms), 1, seed=13)
            final, outs = run_compiled_sharded(cfg, mesh, states,
                                               n_segments=2,
                                               sweep_om=om_rows)
            results.append((jax.device_get(final), jax.device_get(outs)))
        (f0, o0), (f1, o1) = results
        for name in ("R", "V", "psi", "t_part"):
            np.testing.assert_array_equal(np.asarray(getattr(f0, name)),
                                          np.asarray(getattr(f1, name)),
                                          err_msg=name)
        # states bit-identical (above); sampled diagnostics may differ
        # at f32 ulp across mesh layouts (GSPMD fusion order)
        for k in o0:
            np.testing.assert_allclose(np.asarray(o0[k]),
                                       np.asarray(o1[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        # the sweep took effect vs a uniform (om=om_dp=1) fold
        mesh = make_mesh(1, 1)
        states = _members(cfg, len(oms), 1, seed=13)
        f_uni, _ = run_compiled_sharded(cfg, mesh, states, n_segments=2)
        assert np.abs(np.asarray(f0.psi[3]) -
                      np.asarray(f_uni.psi[3])).max() > 1e-4
