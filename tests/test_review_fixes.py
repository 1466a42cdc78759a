"""Regression tests for the round-3 review findings: renormalize NaN
guard on the non-fused path, newest-checkpoint-wins across formats,
RNG-key continuity through mid-run checkpoints, Poisson resume under an
ion-sharded mesh, and edge-of-grid VAF intervals."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.experiments.laser_cooling import (
    CoolingConfig, run as run_cooling)
from mdqtplasmasims_tpu.experiments.frozen_tagging import (
    FrozenTagConfig, run as run_frozen)


def test_step_sm_renormalize_zero_norm_guard():
    """Padded Poissonian lanes carry psi == 0; renormalize=True on the
    XLA (non-fused) path must keep them exactly zero instead of
    dividing 0/0 into NaN (the fused kernel already guards this)."""
    from mdqtplasmasims_tpu.core.qt import QTEngine
    from mdqtplasmasims_tpu.levels import tag422
    scheme = tag422()
    S, n = scheme.n_states, 8
    eng = QTEngine(scheme, h=0.00985, dt_plasma=8e-5,
                   plas_to_quant_vel=1.327, gamma_to_einstein=123.1,
                   apply_force=False, renormalize=True)
    key = jax.random.PRNGKey(3)
    psi = jnp.zeros((S, n), jnp.complex64).at[0, :].set(1.0)
    psi = psi.at[:, n // 2:].set(0.0)          # padded half
    vx = jnp.zeros((n,), jnp.float32)
    tp = jnp.zeros((n,), jnp.float32)
    for _ in range(5):
        psi, vx, tp = eng.step_sm(psi, vx, tp, key=key)
    psi = np.asarray(psi)
    assert np.isfinite(psi).all()
    np.testing.assert_array_equal(psi[:, n // 2:], 0.0)
    # real lanes stay normalized
    np.testing.assert_allclose(
        np.sum(np.abs(psi[:, :n // 2]) ** 2, axis=0), 1.0, rtol=1e-5)


def _cooling_dir(root):
    return str(next(root.rglob("energies.dat")).parent)


def test_run_resume_prefers_newer_ascii(tmp_path):
    """After the reference binary continues a framework run (interop
    chaining), only the ASCII conditions_/wvFns_/ions_ files advance;
    run(resume=True) must resume from the newer ASCII checkpoint, not
    replay from the stale native .npz."""
    base = dict(n0=32, sample_freq=10,
                dtype="float64")
    cfg1 = CoolingConfig(**base, tmax=0.2,
                         save_directory=str(tmp_path / "one"))
    run_cooling(cfg1)
    d1 = _cooling_dir(tmp_path / "one")
    rows1 = np.loadtxt(os.path.join(d1, "energies.dat")).shape[0]

    # stand-in for the binary's continuation: a full run to the longer
    # tmax whose terminal ASCII files we splice into the first tree
    cfg_full = CoolingConfig(**base, tmax=0.4,
                             save_directory=str(tmp_path / "two"))
    run_cooling(cfg_full)
    d2 = _cooling_dir(tmp_path / "two")
    c0b = int(round(cfg_full.tmax / cfg_full.timestep)) - 1
    for stem in ("ions_timestep", "conditions_timestep", "wvFns_timestep"):
        shutil.copy(os.path.join(d2, f"{stem}{c0b:06d}.dat"), d1)

    final, res = run_cooling(dataclasses.replace(cfg1, tmax=0.4),
                             resume=True)
    # nothing left to simulate: the ASCII checkpoint already covers tmax
    assert res["outs"] is None
    assert float(final.t) == pytest.approx(0.4, rel=1e-6)
    # and no duplicate rows were appended
    assert np.loadtxt(os.path.join(d1, "energies.dat")).shape[0] == rows1


def test_run_resume_continues_from_ascii(tmp_path):
    """The interop chain with work remaining: resume from a newer ASCII
    checkpoint mid-run and simulate only the segments past it."""
    base = dict(n0=32, sample_freq=10,
                dtype="float64")
    cfg1 = CoolingConfig(**base, tmax=0.2,
                         save_directory=str(tmp_path / "one"))
    run_cooling(cfg1)
    d1 = _cooling_dir(tmp_path / "one")
    cfg_mid = CoolingConfig(**base, tmax=0.3,
                            save_directory=str(tmp_path / "two"))
    run_cooling(cfg_mid)
    d2 = _cooling_dir(tmp_path / "two")
    c0m = int(round(cfg_mid.tmax / cfg_mid.timestep)) - 1
    for stem in ("ions_timestep", "conditions_timestep", "wvFns_timestep"):
        shutil.copy(os.path.join(d2, f"{stem}{c0m:06d}.dat"), d1)

    final, res = run_cooling(dataclasses.replace(cfg1, tmax=0.4),
                             resume=True)
    # only the 5 segments past the ASCII c0=149 were simulated; samples
    # land at the reference's exact output instant — one quantum tick
    # into the sampling MD step (SpeedUp.cpp:1365-1368), i.e. the MD
    # boundary minus (dt - qdt)
    off = cfg1.timestep - cfg1.timestep / cfg1.ratio
    assert res["outs"]["t"].shape[0] == 5
    assert float(res["outs"]["t"][0]) == pytest.approx(0.32 - off,
                                                       rel=1e-6)
    assert float(final.t) == pytest.approx(0.4, rel=1e-6)
    e = np.loadtxt(os.path.join(d1, "energies.dat"))
    # 10 leg-1 rows + 5 continuation rows (the binary's own rows for
    # (0.2, 0.3] live in its tree and were not copied)
    assert e.shape[0] == 15
    np.testing.assert_allclose(e[-5:, 0],
                               0.32 - off + 0.02 * np.arange(5),
                               rtol=1e-6)


def test_frozen_resume_prefers_newer_ascii(tmp_path):
    """Same newest-wins rule for the frozen-tag family, whose interop
    chaining is the documented walltime workflow."""
    from mdqtplasmasims_tpu.experiments.frozen_tagging import frozen_tag_dir
    base = dict(variant="422linear", n0=32, tstart=1.0, timestep=0.01,
                sample_freq=20, tpump_seconds=2e-7)
    cfg1 = FrozenTagConfig(**base, tmax=3.1,
                           save_directory=str(tmp_path / "one"))
    run_frozen(cfg1)
    cfg_full = FrozenTagConfig(**base, tmax=4.1,
                               save_directory=str(tmp_path / "two"))
    run_frozen(cfg_full)

    def tree(root):
        return frozen_tag_dir(str(root), tpump_seconds=cfg1.tpump_seconds,
                              tstart=cfg1.tstart, detuning=cfg1.detuning,
                              om=cfg1.om, density=cfg1.density,
                              ge=cfg1.ge, n0=cfg1.n0, job=1)
    d1, d2 = tree(tmp_path / "one"), tree(tmp_path / "two")
    c0b = int(round(cfg_full.tmax / cfg_full.timestep)) - 1
    for stem in ("ions_timestep", "conditions_timestep",
                 "spinUpIonsList_timestep"):
        shutil.copy(os.path.join(d2, f"{stem}{c0b:06d}.dat"), d1)

    final, res = run_frozen(dataclasses.replace(cfg1, tmax=5.3),
                            resume=True)
    # the continuation starts after the ASCII c0=409, not the native 309
    assert res["labels"], "no continuation labels"
    assert min(res["labels"]) > c0b


def test_midrun_checkpoint_carries_rng_key(tmp_path):
    """run()'s periodic mid-run checkpoints must carry the RNG key so a
    crash-resume continues the checkpointed stream: the chained run is
    bit-identical to the uninterrupted one."""
    base = dict(n0=32, sample_freq=10, checkpoint_every_segments=1,
                dtype="float64")
    cfg1 = CoolingConfig(**base, tmax=0.2,
                         save_directory=str(tmp_path / "chained"))
    run_cooling(cfg1)
    final2, _ = run_cooling(dataclasses.replace(cfg1, tmax=0.4),
                            resume=True)
    cfg_full = CoolingConfig(**base, tmax=0.4,
                             save_directory=str(tmp_path / "full"))
    final_full, _ = run_cooling(cfg_full)
    np.testing.assert_array_equal(np.asarray(final2.R),
                                  np.asarray(final_full.R))
    np.testing.assert_array_equal(np.asarray(final2.V),
                                  np.asarray(final_full.V))
    np.testing.assert_array_equal(np.asarray(final2.psi),
                                  np.asarray(final_full.psi))
    a = np.loadtxt(os.path.join(_cooling_dir(tmp_path / "chained"),
                                "energies.dat"))
    b = np.loadtxt(os.path.join(_cooling_dir(tmp_path / "full"),
                                "energies.dat"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(len(jax.devices()) < 4,
                    reason="needs 4 virtual devices")
def test_poisson_mesh_resume_rounds_to_ion_shards(tmp_path):
    """Resuming an ion-sharded Poissonian ensemble must round the padded
    lane count back up to a multiple of the mesh's ion shards (the
    checkpoints store each member's real, generally odd, N)."""
    from mdqtplasmasims_tpu.core.init import poisson_member_mask
    from mdqtplasmasims_tpu.experiments.laser_cooling import run_ensemble
    from mdqtplasmasims_tpu.parallel.mesh import make_mesh
    shards = 2
    seed = next(s for s in range(50)
                if max(poisson_member_mask(48, 2, s)[1]) % shards)
    mesh = make_mesh(n_ens=2, n_ions=shards)
    cfg1 = CoolingConfig(n0=48, tmax=0.1, sample_freq=5,
                         checkpoint_every_segments=5, exact_n=False,
                         fused_interpret=True,
                         save_directory=str(tmp_path))
    run_ensemble(cfg1, n_jobs=2, seed=seed, mesh=mesh)
    cfg2 = dataclasses.replace(cfg1, tmax=0.2)
    final2, outs2 = run_ensemble(cfg2, n_jobs=2, seed=seed, resume=True,
                                 mesh=mesh)
    assert outs2["t"].shape[0] == 2
    job_dirs = sorted(str(p.parent) for p in tmp_path.rglob("energies.dat"))
    assert len(job_dirs) == 2
    counts = poisson_member_mask(48, 2, seed)[1]
    c0 = int(round(cfg2.tmax / cfg2.timestep)) - 1
    for d, nj in zip(job_dirs, counts):
        e = np.loadtxt(os.path.join(d, "energies.dat"))
        assert e.shape[0] == 20 and np.isfinite(e).all()
        cond = np.loadtxt(os.path.join(d, f"conditions_timestep{c0:06d}.dat"))
        assert cond.shape[0] == nj


def test_vaf_interval_before_first_sample(tmp_path):
    """An interval whose tstart precedes the first output sample snaps
    its origin to sample 0 on a fresh run (nearest-sample convention at
    the grid edge) instead of being silently dropped."""
    cfg = CoolingConfig(n0=32, tmax=0.1, sample_freq=10,
                        vaf_intervals=(0.01,),
                        dtype="float64", save_directory=str(tmp_path))
    run_cooling(cfg)
    d = _cooling_dir(tmp_path)
    vaf = np.loadtxt(os.path.join(d, "VAF_interval0.dat")).reshape(-1, 2)
    n_samples = int(round(cfg.tmax / cfg.timestep)) // cfg.sample_freq
    assert vaf.shape[0] == n_samples
    # origin = first sample: row 0 is <|v(t0)|^2> > 0 at t0 — the
    # reference's exact output instant (one tick into the sampling MD
    # step, SpeedUp.cpp:1365-1368)
    t0 = (cfg.sample_freq - 1) * cfg.timestep + cfg.timestep / cfg.ratio
    assert vaf[0, 0] == pytest.approx(t0, rel=1e-6)
    assert vaf[0, 1] > 0.0
