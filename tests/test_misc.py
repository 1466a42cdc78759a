"""Coverage for KDE, analysis aggregation, CLI parsing, presets, profiling."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.ops.kde import (KDE_NORM, centered_bins, folded_bins,
                                        gaussian_kde)
from mdqtplasmasims_tpu.experiments.presets import PRESETS
from mdqtplasmasims_tpu.profiling import PhaseTimer, throughput


class TestKDE:
    def test_matches_reference_formula(self):
        """Direct transcription of output()'s kernel sums
        (laserCooling...SpeedUp.cpp:957-979)."""
        rng = np.random.default_rng(0)
        v = rng.normal(0, 0.1, 40)
        bins = np.asarray(folded_bins(jnp.float64))
        V2 = 1.0 / (2 * 0.002 * 0.002)
        ref = np.zeros_like(bins)
        for vi in v:
            ref += (np.exp(-V2 * (bins - vi) ** 2)
                    + np.exp(-V2 * (bins + vi) ** 2))
        ref /= 6.0 * np.sqrt(2 * np.pi * 0.002 ** 2)
        out = np.asarray(gaussian_kde(jnp.asarray(v), jnp.asarray(bins),
                                      folded=True))
        assert np.abs(out - ref).max() < 1e-9

    def test_weighted_centered(self):
        v = jnp.asarray([0.5, -0.5])
        w = jnp.asarray([1.0, 0.0])
        bins = centered_bins(jnp.float64)
        out = np.asarray(gaussian_kde(v, bins, folded=False, weights=w,
                                      normalize=False))
        i_pos = int(np.argmin(np.abs(np.asarray(bins) - 0.5)))
        i_neg = int(np.argmin(np.abs(np.asarray(bins) + 0.5)))
        assert out[i_pos] == pytest.approx(1.0, abs=1e-6)
        assert out[i_neg] == pytest.approx(0.0, abs=1e-12)


class TestAnalysis:
    def test_average_dat(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import average_dat
        for j, val in ((1, 1.0), (2, 3.0)):
            d = tmp_path / f"job{j}"
            d.mkdir()
            with open(d / "x.dat", "w") as f:
                f.write("0.1\t%g\n0.2\t%g\n" % (val, val * 2))
        avg = average_dat(str(tmp_path), "x.dat")
        assert np.allclose(avg, [[0.1, 2.0], [0.2, 4.0]])

    def test_truncates_short_jobs(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import average_dat
        (tmp_path / "job1").mkdir()
        (tmp_path / "job2").mkdir()
        with open(tmp_path / "job1" / "x.dat", "w") as f:
            f.write("0.1\t1\n0.2\t2\n0.3\t3\n")
        with open(tmp_path / "job2" / "x.dat", "w") as f:
            f.write("0.1\t3\n0.2\t4\n")          # killed by walltime
        avg = average_dat(str(tmp_path), "x.dat")
        assert avg.shape == (2, 2)
        assert np.allclose(avg[:, 1], [2.0, 3.0])


class TestStatePopulationProfile:
    """analysis.state_population_profile: dark-state dip extraction from
    emitted statePopulationsVsVTime*.dat snapshots (reference
    README.md:110-118 column schema)."""

    @staticmethod
    def _write_snapshot(path, v, s, p, d):
        rows = np.stack([v, s, p, d], axis=-1)
        np.savetxt(path, rows, fmt="%.6f", delimiter="\t")

    def test_bins_population_against_folded_speed(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import state_population_profile
        # P population = |v| / 3 exactly, on both signs of v: the folded
        # profile must recover the identity line at bin centers.
        v = np.concatenate([np.linspace(-2.95, -0.05, 300),
                            np.linspace(0.05, 2.95, 300)])
        p = np.abs(v) / 3.0
        self._write_snapshot(tmp_path / "statePopulationsVsVTime5.dat",
                             v, 1.0 - p, p, np.zeros_like(v))
        centers, prof = state_population_profile(str(tmp_path), nbins=10)
        assert centers.shape == prof.shape == (10,)
        assert np.allclose(prof, centers / 3.0, atol=0.02)

    def test_last_k_and_state_col(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import state_population_profile
        v = np.linspace(0.05, 2.95, 200)
        # older snapshot has P=1 everywhere; the two recent ones P=0.25 —
        # last_k=2 must exclude the old one.  File order is lexicographic
        # over the zero-padded reference naming.
        self._write_snapshot(tmp_path / "statePopulationsVsVTime1.dat",
                             v, np.zeros_like(v), np.ones_like(v),
                             np.zeros_like(v))
        for k in (2, 3):
            self._write_snapshot(
                tmp_path / f"statePopulationsVsVTime{k}.dat",
                v, np.full_like(v, 0.5), np.full_like(v, 0.25),
                np.full_like(v, 0.25))
        _, prof = state_population_profile(str(tmp_path), nbins=5,
                                           last_k=2, min_count=1)
        assert np.allclose(prof, 0.25)
        # state_col=3 selects the D column instead
        _, prof_d = state_population_profile(str(tmp_path), nbins=5,
                                             last_k=2, min_count=1,
                                             state_col=3)
        assert np.allclose(prof_d, 0.25)

    def test_vel_scale_and_sparse_bins_nan(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import state_population_profile
        # 50 ions at plasma-unit speed 0.1 -> gamma/k speed 2.0 with
        # vel_scale=20: only the bin containing 2.0 is populated, all
        # other bins NaN (below min_count).
        v = np.full(50, 0.1)
        self._write_snapshot(tmp_path / "statePopulationsVsVTime0.dat",
                             v, np.full_like(v, 0.4), np.full_like(v, 0.6),
                             np.zeros_like(v))
        centers, prof = state_population_profile(
            str(tmp_path), vel_scale=20.0, vmax=3.0, nbins=6, min_count=10)
        hit = int(np.digitize(2.0, np.linspace(0, 3.0, 7))) - 1
        assert prof[hit] == pytest.approx(0.6)
        assert np.isnan(np.delete(prof, hit)).all()

    def test_missing_files_raise(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import state_population_profile
        with pytest.raises(FileNotFoundError):
            state_population_profile(str(tmp_path))


class TestCLI:
    def test_parser_builds_configs(self):
        from mdqtplasmasims_tpu.cli import _add_dataclass_args, _build_cfg
        import argparse
        from mdqtplasmasims_tpu.experiments.laser_cooling import CoolingConfig
        p = argparse.ArgumentParser()
        _add_dataclass_args(p, CoolingConfig)
        ns = p.parse_args(["--n0", "128", "--tmax", "2.5",
                           "--renormalize", "true",
                           "--vaf-intervals", "3,5,7"])
        cfg = _build_cfg(CoolingConfig, ns)
        assert cfg.n0 == 128 and cfg.tmax == 2.5
        assert cfg.renormalize is True
        assert cfg.vaf_intervals == (3.0, 5.0, 7.0)


class TestPresets:
    def test_all_presets_construct(self):
        for name, fn in PRESETS.items():
            cfg = fn()
            assert cfg is not None, name

    def test_pre_speedup_has_interval_diags(self):
        cfg = PRESETS["pre-speedup"]()
        assert len(cfg.vaf_intervals) == 13
        assert cfg.record_lccf


class TestProfiling:
    def test_phase_timer(self):
        t = PhaseTimer()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        assert t.counts["a"] == 2
        assert "a" in t.report()
        json.loads(t.as_json())

    def test_throughput(self):
        m = throughput(3500, 25000, 2.0)
        assert m["ion_qt_updates_per_sec"] == pytest.approx(3500 * 12500)


class TestPooledStatistics:
    """analysis.py pooled-statistics helpers shared by the
    cross-validation harnesses (VERDICT r2 weak #6)."""

    def test_two_sample_z(self):
        from mdqtplasmasims_tpu.analysis import two_sample_z
        a = np.array([1.0, 2.0, 3.0, 4.0])
        b = np.array([1.5, 2.5, 3.5, 4.5])
        # means differ by 0.5; se = sqrt(var/4 + var/4), var = 5/3
        se = np.sqrt(2 * (5.0 / 3.0) / 4)
        assert two_sample_z(a, b) == pytest.approx(-0.5 / se)
        assert two_sample_z(a, a) == 0.0

    def test_two_sample_z_columns(self):
        from mdqtplasmasims_tpu.analysis import (two_sample_z,
                                                 two_sample_z_columns)
        rng = np.random.default_rng(0)
        a = rng.normal(size=(8, 5))
        b = rng.normal(size=(8, 5)) + 0.1
        z = two_sample_z_columns(a, b)
        assert z.shape == (5,)
        for c in range(5):
            assert z[c] == pytest.approx(two_sample_z(a[:, c], b[:, c]))

    def test_weighted_pooled_mean(self):
        from mdqtplasmasims_tpu.analysis import weighted_pooled_mean
        # two jobs: 10 tags with mean 2.0, 30 tags with mean 4.0
        assert weighted_pooled_mean([2.0, 4.0], [10, 30]) == \
            pytest.approx(3.5)

    def test_compare_job_pools(self, capsys):
        from mdqtplasmasims_tpu.analysis import compare_job_pools
        rng = np.random.default_rng(1)
        refs = [dict(x=float(v)) for v in rng.normal(size=8)]
        same = [dict(x=float(v)) for v in rng.normal(size=8)]
        far = [dict(x=float(v)) for v in rng.normal(loc=50.0, size=8)]
        assert compare_job_pools(refs, same, ("x",))
        assert not compare_job_pools(refs, far, ("x",))
        assert "observable" in capsys.readouterr().out


class TestSweepTable:
    def test_pools_point_major_replicas(self):
        import dataclasses
        from mdqtplasmasims_tpu.analysis import sweep_table

        @dataclasses.dataclass(frozen=True)
        class C:
            detuning: float
            om: float
            job: int

        # 2 points x 2 reps, point-major (run_sweep's member order)
        cfgs = [C(-1.0, 0.5, 1), C(-1.0, 0.5, 2),
                C(-2.0, 0.5, 1), C(-2.0, 0.5, 2)]
        rows = sweep_table(cfgs, [1.0, 3.0, 10.0, 10.0], keys=("detuning",))
        assert rows == [
            dict(detuning=-1.0, mean=2.0, sd=np.sqrt(2.0), n=2),
            dict(detuning=-2.0, mean=10.0, sd=0.0, n=2)]

    def test_multi_key_single_rep(self):
        import dataclasses
        from mdqtplasmasims_tpu.analysis import sweep_table

        @dataclasses.dataclass(frozen=True)
        class C:
            gamma: float
            kappa: float

        cfgs = [C(1.0, 0.5), C(1.0, 1.0), C(3.0, 0.5)]
        rows = sweep_table(cfgs, [0.1, 0.2, 0.3], keys=("gamma", "kappa"))
        assert [r["mean"] for r in rows] == [0.1, 0.2, 0.3]
        assert rows[1] == dict(gamma=1.0, kappa=1.0, mean=0.2, sd=0.0, n=1)


class TestSweepPointsParsing:
    """cli._sweep_points: zipped grids broadcast length-1 entries and
    reject ragged lengths; --cross takes the cartesian product."""

    def _parser(self):
        import argparse

        class P(argparse.ArgumentParser):
            def error(self, message):
                raise ValueError(message)
        return P()

    def test_zip_with_broadcast(self):
        from mdqtplasmasims_tpu.cli import _sweep_points
        pts = _sweep_points(self._parser(),
                            {"detuning": [-1.0, -2.0], "om": [0.5]},
                            cross=False)
        assert pts == [{"detuning": -1.0, "om": 0.5},
                       {"detuning": -2.0, "om": 0.5}]

    def test_cross_product(self):
        from mdqtplasmasims_tpu.cli import _sweep_points
        pts = _sweep_points(self._parser(),
                            {"gamma": [1.0, 3.0], "kappa": [0.5, 1.0]},
                            cross=True)
        assert len(pts) == 4
        assert {"gamma": 3.0, "kappa": 0.5} in pts

    def test_ragged_zip_rejected(self):
        from mdqtplasmasims_tpu.cli import _sweep_points
        with pytest.raises(ValueError, match="equal-length"):
            _sweep_points(self._parser(),
                          {"a": [1.0, 2.0], "b": [1.0, 2.0, 3.0]},
                          cross=False)


class TestSweepCLI:
    def test_three_state_sweep_end_to_end(self, tmp_path):
        """The cheapest family end-to-end through the CLI sweep path:
        grid parsing, run_sweep dispatch, per-point directory writes."""
        from mdqtplasmasims_tpu.cli import main
        rc = main(["three-state-sweep", "--n0", "16", "--tmax", "10",
                   "--sample-freq", "100", "--dispatch-segments", "5",
                   "--det-values=-0.5,-2.0", "--om-values", "1.0",
                   "--save-directory", str(tmp_path)])
        assert not rc
        import glob
        files = glob.glob(str(tmp_path / "Om*" / "Det*" / "job1"
                              / "energies.dat"))
        assert len(files) == 2, files

    def test_mesh_flag_end_to_end(self, tmp_path):
        """--mesh-ens routes the sweep through member_sharded: same
        outputs as the single-device path, bit-exact."""
        import glob
        import numpy as np
        from mdqtplasmasims_tpu.cli import main
        argv = ["three-state-sweep", "--n0", "16", "--tmax", "10",
                "--sample-freq", "100", "--dispatch-segments", "5",
                "--det-values=-0.5,-2.0", "--om-values", "1.0"]
        a, b = tmp_path / "a", tmp_path / "b"
        assert not main(argv + ["--save-directory", str(a)])
        assert not main(argv + ["--save-directory", str(b),
                                "--mesh-ens", "2"])
        fa = sorted(glob.glob(str(a / "Om*" / "Det*" / "job1"
                                  / "energies.dat")))
        fb = sorted(glob.glob(str(b / "Om*" / "Det*" / "job1"
                                  / "energies.dat")))
        assert len(fa) == len(fb) == 2
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(np.loadtxt(x), np.loadtxt(y))


class TestQuicklook:
    def test_plot_run_renders_panels(self, tmp_path):
        """mdqt plot (quicklook.py; tools/plot_run.py is a shim) turns a
        job directory's .dat tree into a quicklook PNG: the recognized
        observables become panels and the append-mode restart (two runs
        in one energies.dat) keeps only the newest run's rows."""
        from mdqtplasmasims_tpu import quicklook
        from mdqtplasmasims_tpu.experiments.laser_cooling import (
            CoolingConfig, run)
        pytest.importorskip("matplotlib")
        cfg = CoolingConfig(n0=16, tmax=0.04, sample_freq=10,
                            dtype="float64",
                            vaf_intervals=(0.02,),
                            save_directory=str(tmp_path))
        run(cfg, seed=0)
        d = str(next(tmp_path.rglob("energies.dat")).parent)

        titles = [t for t, _ in quicklook.collect_panels(d)]
        assert "Kinetic energies" in titles
        assert any("Velocity distribution" in t for t in titles)
        assert any("autocorrelation" in t for t in titles)

        # append a second (restarted) run: quicklook must show only it
        e1 = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
        with open(os.path.join(d, "energies.dat"), "a") as f:
            np.savetxt(f, e1[:1])
        e2 = quicklook._load(os.path.join(d, "energies.dat"),
                             time_indexed=True)
        assert e2.shape[0] == 1

        # through the console entry point
        from mdqtplasmasims_tpu.cli import main as cli_main
        out = os.path.join(str(tmp_path), "ql.png")
        assert cli_main(["plot", d, "-o", out]) == 0
        assert os.path.getsize(out) > 10_000

        # an empty directory is a clean CLI error, not a traceback
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(SystemExit):
            cli_main(["plot", str(empty)])


class TestLCCFSpectrum:
    def _write_j(self, d, omegas_by_shell, S=256, lam=3, sf=40,
                 dt=0.002, noise=0.0, seed=0):
        """Synthesize J_interval0.dat in the emitted schema: one fixed
        k-block per sample, J(k,t) = k_hat cos(omega_shell t) (purely
        longitudinal)."""
        rng = np.random.default_rng(seed)
        ks = np.stack(np.meshgrid(*[np.arange(lam)] * 3,
                                  indexing="ij"), -1).reshape(-1, 3)
        k2 = (ks ** 2).sum(1)
        khat = np.where(k2[:, None] > 0,
                        ks / np.sqrt(np.maximum(k2, 1))[:, None], 0.0)
        rows = []
        for s in range(S):
            t = s * sf * dt
            amp = np.array([np.cos(omegas_by_shell.get(q, 0.0) * t)
                            for q in k2])
            J = khat * amp[:, None] + noise * rng.standard_normal(
                (ks.shape[0], 3))
            block = np.zeros((ks.shape[0], 10))
            block[:, 0] = s * sf
            block[:, 1:4] = ks
            block[:, 4:10:2] = J
            rows.append(block)
        np.savetxt(os.path.join(d, "J_interval0.dat"),
                   np.concatenate(rows))

    def test_recovers_per_shell_frequencies(self, tmp_path):
        """The spectral pipeline recovers each shell's injected
        longitudinal frequency to within one FFT bin."""
        from mdqtplasmasims_tpu.analysis import lccf_spectrum
        om = {1: 1.7, 2: 1.4, 3: 1.1, 4: 0.9, 5: 0.8, 6: 0.7, 8: 0.6,
              9: 0.5, 12: 0.4}
        self._write_j(str(tmp_path), om, noise=0.02)
        out = lccf_spectrum(str(tmp_path))
        dw = out["omega"][1] - out["omega"][0]
        assert set(out["k_int2"]) == set(om)
        for q, pk in zip(out["k_int2"], out["omega_peak"]):
            assert abs(pk - om[q]) <= dw + 1e-12, (q, pk, om[q])

    @staticmethod
    def _write_transverse_j(d, signal, S=128, lam=2, sf=40, dt=0.002):
        """J(k,t) = perp_hat(k) * signal(t): purely transverse current."""
        ks = np.stack(np.meshgrid(*[np.arange(lam)] * 3,
                                  indexing="ij"), -1).reshape(-1, 3)
        rows = []
        for s in range(S):
            t = s * sf * dt
            # a vector orthogonal to k for every k (swap-negate trick on
            # the first two components; k=(0,0,z) handled by (1,0,0))
            perp = np.stack([-ks[:, 1], ks[:, 0],
                             np.zeros(len(ks))], -1).astype(float)
            degen = np.abs(perp).sum(1) == 0
            perp[degen] = [1.0, 0.0, 0.0]
            perp /= np.linalg.norm(perp, axis=1, keepdims=True)
            block = np.zeros((ks.shape[0], 10))
            block[:, 0] = s * sf
            block[:, 1:4] = ks
            block[:, 4:10:2] = perp * signal(t)
            rows.append(block)
        np.savetxt(os.path.join(d, "J_interval0.dat"),
                   np.concatenate(rows))

    def test_transverse_current_is_silent(self, tmp_path):
        """A purely transverse J leaves the longitudinal spectrum at the
        noise floor — the k_hat projection really selects the
        longitudinal mode — while the transverse branch recovers the
        injected shear frequency."""
        from mdqtplasmasims_tpu.analysis import lccf_spectrum
        d = str(tmp_path)
        self._write_transverse_j(d, lambda t: np.cos(1.3 * t))
        out = lccf_spectrum(d)
        assert float(out["spectrum"].max()) < 1e-12
        dw = out["omega"][1] - out["omega"][0]
        assert np.all(np.abs(out["omega_peak_t"] - 1.3) <= dw + 1e-12)

    def test_longitudinal_current_leaves_transverse_silent(self, tmp_path):
        """The converse projection check: a purely longitudinal J puts
        nothing in the transverse residual."""
        from mdqtplasmasims_tpu.analysis import lccf_spectrum
        d = str(tmp_path)
        self._write_j(d, {1: 1.7, 2: 1.4, 3: 1.1}, noise=0.0)
        out = lccf_spectrum(d)
        assert float(out["spectrum_t"].max()) < 1e-12

    def test_nonpropagating_shear_peaks_at_zero(self, tmp_path):
        """An overdamped (monotone-relaxing) transverse current reports
        omega_peak_t = 0 — the physical no-propagating-shear answer the
        omega=0 bin is kept in the transverse search for."""
        from mdqtplasmasims_tpu.analysis import lccf_spectrum
        d = str(tmp_path)
        self._write_transverse_j(d, lambda t: np.exp(-0.1 * t))
        out = lccf_spectrum(d)
        assert np.all(out["omega_peak_t"] == 0.0)

    def test_append_mode_restart_uses_newest_run(self, tmp_path):
        """An append-mode J_interval0.dat holding two runs (the
        reference's fopen-"a" convention; the step counter resets at the
        restart) is analyzed from the newest run only — the stale run's
        different frequency must not leak in, and dt must not be averaged
        across the reset."""
        from mdqtplasmasims_tpu.analysis import lccf_spectrum
        d = str(tmp_path)
        self._write_j(d, {1: 0.4, 2: 0.4, 3: 0.4}, S=64, lam=2)
        stale = np.loadtxt(os.path.join(d, "J_interval0.dat"), ndmin=2)
        self._write_j(d, {1: 1.7, 2: 1.4, 3: 1.1}, S=128, lam=2)
        fresh = np.loadtxt(os.path.join(d, "J_interval0.dat"), ndmin=2)
        np.savetxt(os.path.join(d, "J_interval0.dat"),
                   np.concatenate([stale, fresh]))
        out = lccf_spectrum(d)
        om = {1: 1.7, 2: 1.4, 3: 1.1}
        dw = out["omega"][1] - out["omega"][0]
        assert out["omega"].size == 1 + 128 // 2  # S from the new run
        for q, pk in zip(out["k_int2"], out["omega_peak"]):
            assert abs(pk - om[q]) <= dw + 1e-12, (q, pk, om[q])


class TestGreenKuboDiffusion:
    def test_exponential_vaf_analytic(self, tmp_path):
        """VAF(t) = (3/Gamma) exp(-nu t)  =>  D = 1/(Gamma nu)."""
        from mdqtplasmasims_tpu.analysis import green_kubo_diffusion
        gamma, nu = 3.0, 2.0
        t = np.linspace(0.0, 20.0, 2001)
        vaf = np.stack([t, (3.0 / gamma) * np.exp(-nu * t)], -1)
        r = green_kubo_diffusion(vaf)
        assert abs(r["d"] - 1.0 / (gamma * nu)) < 2e-4
        assert r["drift"] < 1e-3
        assert r["d_of_t"].shape == t.shape and r["d_of_t"][0] == 0.0

        # path form (the VAF.dat schema)
        p = tmp_path / "VAF.dat"
        np.savetxt(p, vaf)
        assert abs(green_kubo_diffusion(str(p))["d"] - r["d"]) < 1e-12

    def test_guards(self):
        from mdqtplasmasims_tpu.analysis import green_kubo_diffusion
        # duplicate time inside a segment
        with pytest.raises(ValueError, match="increasing"):
            green_kubo_diffusion(
                np.array([[0.0, 1.0], [1.0, 0.5], [1.0, 0.2], [2.0, 0.1]]))
        with pytest.raises(ValueError, match=r"\[T>=4, 2\]"):
            green_kubo_diffusion(np.zeros((2, 2)))
        # a time reset splits segments; 2-row segments are too short
        with pytest.raises(ValueError, match="as short as"):
            green_kubo_diffusion(
                np.array([[0.0, 1.0], [1.0, 0.5], [0.5, 0.2], [2.0, 0.1]]))
        # appended segments with different lag spacings can't be pooled
        a = np.stack([np.linspace(0, 2, 5), np.ones(5)], -1)
        b = np.stack([np.linspace(0, 4, 5), np.ones(5)], -1)
        with pytest.raises(ValueError, match="mismatched lag"):
            green_kubo_diffusion(np.concatenate([a, b]))

    def test_appended_intervals_are_pooled(self):
        """The reference's interval-VAF convention — several segments
        appended to one file, each time axis starting at its interval's
        absolute start — is pooled: C(tau) averaged across segments
        (frozen-tag VAF.dat holds exactly this)."""
        from mdqtplasmasims_tpu.analysis import green_kubo_diffusion
        nu = 2.0
        t = np.linspace(0.0, 20.0, 2001)
        seg = lambda t0, A: np.stack(
            [t0 + t, A * np.exp(-nu * t)], -1)
        pooled = green_kubo_diffusion(
            np.concatenate([seg(15.0, 0.8), seg(10.0, 1.2)]))
        assert pooled["n_segments"] == 2
        # mean amplitude 1.0: D = A/(3 nu)
        assert abs(pooled["d"] - 1.0 / (3.0 * nu)) < 2e-4
        assert pooled["t"][0] == 0.0            # lag-rebased axis

    def test_transport_soak_artifact_plateaus(self):
        """The committed production transport soak (Gamma=3, kappa=0.5,
        N=4096) yields a converged positive D."""
        import glob
        from mdqtplasmasims_tpu.analysis import green_kubo_diffusion
        hits = glob.glob(os.path.join(
            os.path.dirname(__file__), os.pardir, "artifacts", "soak",
            "transport", "*", "job1", "VAF.dat"))
        if not hits:
            pytest.skip("soak artifact not present")
        r = green_kubo_diffusion(hits[0])
        assert 0.0 < r["d"] < 3.0
        assert r["drift"] < 0.1


class TestStaticStructureFactor:
    def test_ideal_gas_is_unity(self):
        """Uncorrelated positions: S(k) = 1 for every k != 0 (up to
        1/sqrt(K N-ish) sampling noise), and the on-device ops kernel
        matches the host numpy twin."""
        from mdqtplasmasims_tpu.analysis import structure_factor_shells
        from mdqtplasmasims_tpu.ops.structure import (k_grid,
                                                      static_structure_factor)
        from mdqtplasmasims_tpu.units import PlasmaUnits
        n = 4096
        L = PlasmaUnits.box_length(n)
        rng = np.random.default_rng(3)
        R = rng.uniform(0.0, L, size=(n, 3))
        out = structure_factor_shells(R, L)
        mean = float(np.mean(out["s"]))
        assert abs(mean - 1.0) < 0.1

        kvecs = k_grid(L)
        s_dev = np.asarray(static_structure_factor(jnp.asarray(R),
                                                   jnp.asarray(kvecs)))
        # rebuild the same shell average from the device values
        n_int = np.rint(kvecs * (L / (2 * np.pi))).astype(int)
        k2 = (n_int ** 2).sum(1)
        s_avg = np.array([s_dev[k2 == q].mean() for q in out["k_int2"]])
        np.testing.assert_allclose(s_avg, out["s"], rtol=1e-8, atol=1e-8)

    def test_lattice_bragg_peaks(self):
        """A perfect 8^3 cubic lattice: S = N exactly on the Bragg
        shells (|n| multiple of 8) and 0 elsewhere."""
        from mdqtplasmasims_tpu.analysis import structure_factor_shells
        from mdqtplasmasims_tpu.units import PlasmaUnits
        m = 8
        n = m ** 3
        L = PlasmaUnits.box_length(n)
        g = (np.arange(m) + 0.5) * (L / m)
        R = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                     -1).reshape(-1, 3)
        out = structure_factor_shells(R, L)
        # every n-component must be 0 mod 8: (8,0,0), (8,8,0), (8,8,8)
        bragg = np.isin(out["k_int2"], [64, 128, 192])
        assert bragg.sum() == 3
        np.testing.assert_allclose(out["s"][bragg], n, rtol=1e-9)
        assert np.all(out["s"][~bragg] < 1e-6)

    def test_from_cooling_checkpoint(self):
        """The committed cooled-plasma checkpoint shows the
        strongly-coupled OCP signature: a correlation peak near
        k a ~ 4.4 and suppressed long-wavelength fluctuations."""
        import glob
        from mdqtplasmasims_tpu.analysis import (
            structure_factor_from_checkpoint)
        hits = glob.glob(os.path.join(
            os.path.dirname(__file__), os.pardir, "artifacts", "soak",
            "cooling", "*", "job1"))
        if not hits:
            pytest.skip("soak artifact not present")
        out = structure_factor_from_checkpoint(hits[0], n0=3500)
        i = int(np.argmax(out["s"]))
        assert 3.5 < out["k"][i] < 5.5       # first peak position
        assert out["s"][i] > 1.5             # strongly coupled
        assert np.all(out["s"][1:5] < 0.5)   # small-k suppression

    def test_missing_checkpoint_raises(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import (
            structure_factor_from_checkpoint)
        with pytest.raises(ValueError, match="no ions_timestep"):
            structure_factor_from_checkpoint(str(tmp_path))


class TestAnalyzeJob:
    """analysis.analyze_job / mdqt analyze: the one-call numeric report."""

    def _make_tree(self, d):
        """A synthetic job dir with known-answer observables."""
        t = np.linspace(0.0, 10.0, 201)
        # energies.dat cooling schema: t EkinX EkinY EkinZ Epot dE vxAvg
        e = np.stack([t, 0.5 + 0 * t, 0.6 + 0 * t, 0.7 + 0 * t,
                      -1.0 + 0 * t, -0.01 * t, 0 * t], -1)
        np.savetxt(os.path.join(d, "energies.dat"), e)
        # VAF = A exp(-t/tau): D = A*tau/3 analytically
        A, tau = 0.9, 1.5
        np.savetxt(os.path.join(d, "VAF.dat"),
                   np.stack([t, A * np.exp(-t / tau)], -1))
        np.savetxt(os.path.join(d, "taggedMoments.dat"),
                   np.stack([t[:5], 0.1 + 0 * t[:5], 0.2 + 0 * t[:5]], -1))
        # longitudinal current with a known per-shell frequency
        TestLCCFSpectrum._write_j(TestLCCFSpectrum(), d,
                                  {1: 1.7, 2: 1.4, 3: 1.1}, S=64, lam=2)

    def test_report_sections_and_numbers(self, tmp_path):
        from mdqtplasmasims_tpu.analysis import (analyze_job,
                                                 format_job_report)
        d = str(tmp_path)
        self._make_tree(d)
        rep = analyze_job(d)
        assert rep["energies"]["n_samples"] == 201
        assert rep["energies"]["ekin_final"] == [0.5, 0.6, 0.7]
        assert rep["energies"]["audit_final"] == pytest.approx(-0.1)
        # Green-Kubo against the analytic integral (window cut < 0.2%)
        assert rep["diffusion"]["d"] == pytest.approx(0.9 * 1.5 / 3.0,
                                                      rel=5e-3)
        assert rep["diffusion"]["vaf0"] == pytest.approx(0.9)
        om = dict(zip(rep["dispersion"]["k_int2"],
                      rep["dispersion"]["omega_peak"]))
        dw = rep["dispersion"]["d_omega"]
        for q, target in {1: 1.7, 2: 1.4, 3: 1.1}.items():
            assert abs(om[q] - target) <= dw + 1e-12
        assert rep["tagged"]["final"] == [pytest.approx(0.1),
                                          pytest.approx(0.2)]

        text = format_job_report(rep)
        assert "diffusion" in text and "omega_L" in text
        assert "tagged" in text and "audit" in text

    def test_partial_tree_reports_notes_not_exceptions(self, tmp_path):
        """A directory with only a too-short J file yields a note, and a
        directory with nothing recognized is a clean ValueError."""
        from mdqtplasmasims_tpu.analysis import analyze_job
        d = str(tmp_path)
        np.savetxt(os.path.join(d, "energies.dat"),
                   np.stack([np.arange(3.0), np.ones(3)], -1))
        TestLCCFSpectrum._write_j(TestLCCFSpectrum(), d, {1: 1.0},
                                  S=4, lam=2)   # < 8 samples
        rep = analyze_job(d)
        assert "dispersion" not in rep
        assert any("dispersion skipped" in n for n in rep["notes"])
        assert rep["energies"]["ekin_final"] == [1.0]

        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(ValueError, match="no recognized"):
            analyze_job(str(empty))

    def test_half_written_checkpoint_is_a_note(self, tmp_path):
        """A crash between write_ions and write_conditions leaves an
        ions_ file with no matching conditions_ — the structure section
        must degrade to a note, not leak FileNotFoundError."""
        from mdqtplasmasims_tpu.analysis import analyze_job
        d = str(tmp_path)
        np.savetxt(os.path.join(d, "energies.dat"),
                   np.stack([np.arange(3.0), np.ones(3)], -1))
        np.savetxt(os.path.join(d, "ions_timestep000099.dat"),
                   np.zeros((5, 6)))
        rep = analyze_job(d)
        assert "structure" not in rep
        assert any("structure skipped" in n for n in rep["notes"])

    def test_cli_analyze(self, tmp_path):
        import json
        from mdqtplasmasims_tpu.cli import main as cli_main
        d = str(tmp_path)
        self._make_tree(d)
        assert cli_main(["analyze", d]) == 0
        # --json emits a parseable report (captured via a pipe file)
        import contextlib
        import io as _io
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli_main(["analyze", d, "--json"]) == 0
        rep = json.loads(buf.getvalue())
        assert rep["energies"]["n_samples"] == 201
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(SystemExit):
            cli_main(["analyze", str(empty)])

    def test_analyze_ensemble_pools_scalars(self, tmp_path):
        """A parameter directory (job* subdirs) pools scalar observables
        across jobs; the CLI auto-detects it."""
        from mdqtplasmasims_tpu.analysis import (analyze_ensemble,
                                                 format_ensemble_report)
        for j in (1, 2, 3):
            d = tmp_path / f"job{j}"
            d.mkdir()
            self._make_tree(str(d))
        rep = analyze_ensemble(str(tmp_path))
        assert len(rep["jobs"]) == 3
        assert rep["pooled"]["diffusion.d"]["n"] == 3
        assert rep["pooled"]["diffusion.d"]["mean"] == pytest.approx(
            0.9 * 1.5 / 3.0, rel=5e-3)
        assert rep["pooled"]["diffusion.d"]["sd"] == pytest.approx(0.0)
        text = format_ensemble_report(rep)
        assert "ensemble:" in text and "diffusion.d" in text

        from mdqtplasmasims_tpu.cli import main as cli_main
        import contextlib
        import io as _io
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli_main(["analyze", str(tmp_path)]) == 0
        assert "3 jobs" in buf.getvalue()

        # a job dir that fails to parse becomes a note, not a crash
        bad = tmp_path / "job4"
        bad.mkdir()
        rep = analyze_ensemble(str(tmp_path))
        assert any("skipped" in n for j in rep["jobs"]
                   for n in j.get("notes", []))
