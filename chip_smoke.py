#!/usr/bin/env python3
"""Smoke test of the MDQT main path on one NVIDIA GPU.

Runs the user entry points at the reference's widths, compares every
kernel of the path with its plain reference, and exits non-zero on any
failure (no error is caught and turned into success):

  a. device    JAX's first device is a GPU (no CPU fallback);
  b. flagship  laser_cooling.run at N0=3500, density 2, Ge 0.1, tmax 0.4
               (200 MD steps, 5 samples): the .dat tree, finite energies,
               row counts, compile seconds and µs per quantum tick;
  c. tick      the fused tick-block kernel (Pallas through Triton) vs the
               XLA per-tick path at highest matmul precision: one MD step
               (25 ticks) at N=3500 with the same uniforms;
  d. forces    XLA f32 pair forces on the card vs a float64 numpy sum;
  e. phases    S(k) and LCCF current J(k) on the card vs float64 numpy;
  f. ensemble  run_ensemble(n_jobs=8) at N0=3500 and a 2-point detuning
               run_sweep: every member finite, every directory written;
  g. families  frozen-tag 422linear (N0=3500), mc-tag 408quad (N=4096),
               transport (N=4096) and three-state (N=1000) through their
               ``run`` entry points, steps cut.

``--four-cards`` runs only the multi-card path instead: run_ensemble over
an (ens=4, ions=1) mesh vs the same seeds on one card, and one
gather-sharded force call on (ens=1, ions=4) vs unsharded.

Usage, from the repository root:
    python3 chip_smoke.py [--four-cards] [--phases abcdefg]

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N0 = 3500              # the flagship's ion count (README.md:76-77)
FLAGSHIP_TMAX = 0.4    # 200 MD steps at dt=0.002 -> 5 samples
ENSEMBLE_TMAX = 0.16
# the other families at the reference's N, only steps cut
FROZEN = dict(variant="422linear", n0=N0, tstart=0.1, tmax=0.5)
MC_TAG = dict(variant="408quad", n=4096, mc_steps=10_000,
              mc_chunk_steps=5_000, pre_record_md_steps=50,
              record_steps=300, gr_every_record=100)
TRANSPORT = dict(n=4096, mc_steps=20_000, gr_every_mc=10_000,
                 pre_record_md_steps=100, record_steps=500,
                 instant_aniso_steps=500, reequil_steps=100,
                 aniso_relax_steps=500, aniso_time_us=1.0)
THREE_STATE = dict(n0=1000, tmax=500.0, sample_freq=100)


def check(cond, what: str) -> None:
    """Fail the run (non-zero exit) unless ``cond``."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def yukawa_f64(R, L, ldeb, rows=256):
    """Float64 numpy pair forces (minimum image, half-box cutoff)."""
    R = np.asarray(R, np.float64)
    F = np.zeros_like(R)
    for i in range(0, R.shape[0], rows):
        d = R[i:i + rows, None, :] - R[None, :, :]
        d -= L * np.round(d / L)
        r2 = (d * d).sum(-1)
        ok = (r2 > 0) & (r2 < (L / 2) ** 2)
        r = np.sqrt(np.where(ok, r2, 1.0))
        ft = np.where(ok, (1 / r + 1 / ldeb) * np.exp(-r / ldeb) / r ** 2,
                      0.0)
        F[i:i + rows] = (d * ft[:, :, None]).sum(1)
    return F


def finite_tree(tree) -> bool:
    import jax
    return all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(tree)
               if np.issubdtype(np.asarray(x).dtype, np.number))


# ---------------------------------------------------------------- phases

def phase_b(tmp):
    from mdqtplasmasims_tpu.experiments import laser_cooling as lc
    cfg = lc.CoolingConfig(n0=N0, tmax=FLAGSHIP_TMAX, save_directory=tmp)
    check(lc.uses_fused_kernel(cfg), "flagship runs the fused tick kernel")
    n_md = int(round(cfg.tmax / cfg.timestep))
    n_s = n_md // cfg.sample_freq
    t0 = time.perf_counter()
    final, res = lc.run(cfg)
    cold = time.perf_counter() - t0
    d = lc._save_dir(cfg)
    e = np.loadtxt(os.path.join(d, "energies.dat"), ndmin=2)
    check(e.shape == (n_s, 7), f"energies.dat is {n_s}x7, got {e.shape}")
    check(np.isfinite(e).all(), "energies finite")
    for stem in ("vel_distX_time", "vel_distY_time", "vel_distZ_time",
                 "statePopulationsVsVTime"):
        n = len(glob.glob(os.path.join(d, stem + "*.dat")))
        check(n == n_s, f"{n_s} {stem} files, got {n}")
    pops = np.loadtxt(os.path.join(
        d, f"statePopulationsVsVTime{n_s - 1:06d}.dat"))
    check(pops.shape == (N0, 4), f"populations rows {pops.shape}")
    cond = np.loadtxt(os.path.join(d,
                                   f"conditions_timestep{n_md - 1:06d}.dat"))
    check(cond.shape[0] == N0, f"terminal checkpoint rows {cond.shape}")
    # warm rerun, no file output: the steady-state rate of run()
    t0 = time.perf_counter()
    lc.run(dataclasses.replace(cfg, save_directory=None))
    warm = time.perf_counter() - t0
    ticks = n_md * cfg.ratio
    say("b", f"flagship N0={N0} tmax={cfg.tmax}: {len(os.listdir(d))} "
        f"files in {d}; energies {n_s}x7 finite; Ekin_x {e[-1, 1]:.4e}")
    say("b", f"cold run {cold:.2f} s, warm run {warm:.3f} s -> compile "
        f"~{cold - warm:.2f} s; {warm / ticks * 1e6:.3f} us/tick "
        f"(run(), {ticks} ticks, sampling and fetch included)")
    return cfg, final


def phase_c(cfg, final):
    import jax
    import jax.numpy as jnp
    from mdqtplasmasims_tpu.core.md import leapfrog_substep
    from mdqtplasmasims_tpu.core.qt_fused import (DEFAULT_BLOCK,
                                                  fused_md_substeps)
    from mdqtplasmasims_tpu.experiments.laser_cooling import build_scheduler
    sched = build_scheduler(cfg)
    spec, eng = sched.fused_spec, sched.engine
    check(spec is not None, "fused spec built")
    n, S, ratio, L = N0, spec.S, spec.ratio, sched.L
    R = jnp.asarray(final.R)
    V = jnp.asarray(final.V)
    psi = jnp.asarray(final.psi)
    tp = jnp.asarray(final.t_part)
    tick = int(final.tick)
    F = sched.forces_fn(R)[0]
    rolls = jax.random.uniform(jax.random.PRNGKey(11), (ratio, 5, n),
                               jnp.float32)
    w = jnp.asarray(eng.scheme.decay_w, jnp.float32)

    @jax.jit
    def reference(R, V, psi, tp, F, rolls):
        Rs, Vs, ps = R.T, V.T, psi.T
        margin = jnp.full((n,), jnp.inf, jnp.float32)
        for i in range(ratio):
            Rs, Vs = leapfrog_substep(Rs, Vs, F.T, cfg.qdt, L, False)
            dp0 = eng.h * jnp.sum(w[:, None] * jnp.abs(ps) ** 2, 0)
            margin = jnp.minimum(margin, jnp.abs(rolls[i, 0] - dp0))
            ps, vx, tp = eng.step_sm(ps, Vs[0], tp, rolls=rolls[i])
            Vs = Vs.at[0].set(vx)
        return Rs, Vs, tp, ps, margin

    with jax.default_matmul_precision("highest"):
        Rx, Vx, tpx, psx, margin = jax.device_get(
            reference(R, V, psi, tp, F, rolls))

    npad = -(-n // DEFAULT_BLOCK) * DEFAULT_BLOCK

    def pad(x):
        return jnp.zeros((x.shape[0], npad), jnp.float32).at[:, :n].set(x)

    t0 = time.perf_counter()
    out = fused_md_substeps(
        spec, jnp.float32(tick == 0), pad(R.T), pad(V.T), pad(F.T),
        pad(tp[None]), pad(psi.T.real), pad(psi.T.imag),
        pad(rolls.reshape(ratio * 5, n)), tick0=jnp.float32(tick),
        interpret=sched.interpret)
    Ro, Vo, tpo, pre, pim = (np.asarray(o)[:, :n] for o in
                             jax.device_get(out))
    secs = time.perf_counter() - t0
    dpsi = np.abs(pre + 1j * pim - psx).max(0)
    dR = np.abs(Ro - Rx)
    dR = np.minimum(dR, L - dR).max(0)          # minimum image
    dV = np.abs(Vo - Vx).max(0)
    off = dpsi > 1e-4
    near = margin < 1e-5
    check(not np.any(off & ~near),
          f"{int(np.sum(off & ~near))} lanes differ beyond 1e-4 away from "
          "a jump threshold")
    ok = ~off
    e_psi = float(dpsi[ok].max())
    e_R = float(dR[ok].max() / np.abs(Rx).max())
    e_V = float(dV[ok].max() / np.abs(Vx).max())
    check(e_psi <= 1e-4, f"max|dpsi| {e_psi:.3e} <= 1e-4")
    check(e_R <= 1e-4, f"rel |dR| {e_R:.3e} <= 1e-4")
    check(e_V <= 1e-4, f"rel |dV| {e_V:.3e} <= 1e-4")
    say("c", f"tick kernel vs XLA (HIGHEST) one MD step, {ratio} ticks, "
        f"N={n}: max|dpsi| {e_psi:.3e}, rel|dR| {e_R:.3e}, rel|dV| "
        f"{e_V:.3e}; jump decisions differing: {int(off.sum())} (all at "
        f"|r0-dp0|<1e-5; {int(near.sum())} lanes that close); first call "
        f"incl. compile {secs:.2f} s")


def phase_d(cfg, final):
    import jax
    import jax.numpy as jnp
    from mdqtplasmasims_tpu.ops.yukawa import best_forces_fn
    from mdqtplasmasims_tpu.units import PlasmaUnits
    L = PlasmaUnits.box_length(N0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    R = np.asarray(final.R, np.float32)
    fn = jax.jit(lambda r: best_forces_fn(N0, L, ldeb)(r)[0])
    F = np.asarray(jax.device_get(fn(jnp.asarray(R))), np.float64)
    F_ref = yukawa_f64(R, L, ldeb)
    rel = float(np.abs(F - F_ref).max() / np.abs(F_ref).max())
    rms = float(np.sqrt(((F - F_ref) ** 2).mean() / (F_ref ** 2).mean()))
    check(rel <= 1e-4, f"force rel err {rel:.3e} <= 1e-4")
    say("d", f"XLA f32 forces N={N0} vs float64 numpy: max|dF|/max|F| "
        f"{rel:.3e}, rms rel {rms:.3e}")


def phase_e(final):
    import jax
    import jax.numpy as jnp
    from mdqtplasmasims_tpu.ops.structure import (current_fourier, k_grid,
                                                  static_structure_factor)
    from mdqtplasmasims_tpu.units import PlasmaUnits
    L = PlasmaUnits.box_length(N0)
    kv = k_grid(L, 12)
    R = np.asarray(final.R, np.float32)
    V = np.asarray(final.V, np.float32)
    Sk = np.asarray(jax.device_get(jax.jit(static_structure_factor)(
        jnp.asarray(R), jnp.asarray(kv, jnp.float32))))
    J = np.asarray(jax.device_get(jax.jit(current_fourier)(
        jnp.asarray(R), jnp.asarray(V), jnp.asarray(kv, jnp.float32))))
    e = np.exp(1j * (R.astype(np.float64) @ kv.T))          # [N, K]
    rho = e.sum(0)
    Sk_ref = (rho * rho.conj()).real / N0
    J_ref = V.astype(np.float64).T @ e
    phase_max = float(np.abs(R.astype(np.float64) @ kv.T).max())
    k1 = slice(1, None)                     # drop k = 0 (the forward term)
    rel_S = float(np.abs(Sk - Sk_ref)[k1].max() / np.abs(Sk_ref[k1]).max())
    rel_J = float(np.abs(J - J_ref)[:, k1].max()
                  / np.abs(J_ref[:, k1]).max())
    check(rel_S <= 1e-4, f"S(k) rel err {rel_S:.3e} <= 1e-4")
    check(rel_J <= 1e-4, f"J(k) rel err {rel_J:.3e} <= 1e-4")
    say("e", f"S(k) and J(k) on {kv.shape[0]} k-vectors, phases up to "
        f"{phase_max:.1f} rad, vs float64: S rel {rel_S:.3e}, J rel "
        f"{rel_J:.3e}")


def phase_f(tmp):
    from mdqtplasmasims_tpu.experiments import laser_cooling as lc
    cfg = lc.CoolingConfig(n0=N0, tmax=ENSEMBLE_TMAX,
                           save_directory=os.path.join(tmp, "ens"))
    n_s = int(round(cfg.tmax / cfg.timestep)) // cfg.sample_freq
    t0 = time.perf_counter()
    final, outs = lc.run_ensemble(cfg, n_jobs=8, seed=0)
    secs = time.perf_counter() - t0
    check(outs["ekin"].shape[:2] == (8, n_s), f"ensemble outs "
          f"{outs['ekin'].shape}")
    check(finite_tree(outs) and finite_tree(final), "ensemble finite")
    n_e = len(glob.glob(os.path.join(tmp, "ens", "*", "job*",
                                     "energies.dat")))
    check(n_e == 8, f"8 job directories written, got {n_e}")
    say("f", f"run_ensemble n_jobs=8 N0={N0} tmax={cfg.tmax}: 8 job "
        f"dirs, all finite, {secs:.2f} s incl. compile")
    cfg_s = dataclasses.replace(cfg, save_directory=os.path.join(tmp, "sw"))
    t0 = time.perf_counter()
    final_s, outs_s, members = lc.run_sweep(cfg_s, [(-1.0, 1.0),
                                                    (-0.5, 0.5)])
    secs = time.perf_counter() - t0
    check(finite_tree(outs_s) and finite_tree(final_s), "sweep finite")
    dirs = glob.glob(os.path.join(tmp, "sw", "*", "job1", "energies.dat"))
    check(len(dirs) == 2, f"2 sweep directories, got {len(dirs)}")
    ek = np.asarray(outs_s["ekin"])
    say("f", f"run_sweep 2 detuning points: 2 dirs, finite, final Ekin_x "
        f"{ek[0, -1, 0]:.4e} vs {ek[1, -1, 0]:.4e}; {secs:.2f} s")


def phase_g(tmp):
    from mdqtplasmasims_tpu.experiments import (frozen_tagging,
                                                mc_md_anisotropy,
                                                mc_qt_tagging, three_state)
    runs = [
        (f"frozen-tag {FROZEN['variant']} N0={FROZEN['n0']}",
         frozen_tagging.run, frozen_tagging.FrozenTagConfig(
             **FROZEN, save_directory=os.path.join(tmp, "frozen"))),
        (f"mc-tag {MC_TAG['variant']} N={MC_TAG['n']}", mc_qt_tagging.run,
         mc_qt_tagging.MCTagConfig(
             **MC_TAG, save_directory=os.path.join(tmp, "mctag"))),
        (f"transport N={TRANSPORT['n']}", mc_md_anisotropy.run,
         mc_md_anisotropy.MCTransportConfig(
             **TRANSPORT, save_directory=os.path.join(tmp, "transport"))),
        (f"three-state N={THREE_STATE['n0']}", three_state.run,
         three_state.ThreeStateConfig(
             **THREE_STATE, save_directory=os.path.join(tmp, "three"))),
    ]
    for name, run, cfg in runs:
        t0 = time.perf_counter()
        res = run(cfg)
        secs = time.perf_counter() - t0
        check(finite_tree(res), f"{name}: outputs finite")
        n_dat = len(glob.glob(os.path.join(cfg.save_directory, "**",
                                           "*.dat"), recursive=True))
        check(n_dat > 0, f"{name}: .dat files written")
        say("g", f"{name}: finite outputs, {n_dat} .dat files, "
            f"{secs:.2f} s incl. compile")


def four_cards():
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from mdqtplasmasims_tpu.experiments import laser_cooling as lc
    from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_soa_batched
    from mdqtplasmasims_tpu.parallel.ensemble import gather_soa_forces
    from mdqtplasmasims_tpu.parallel.mesh import ION_AXIS, make_mesh
    from mdqtplasmasims_tpu.units import PlasmaUnits
    devs = jax.devices()
    check(len(devs) == 4, f"4 GPUs, found {len(devs)}")
    cfg = lc.CoolingConfig(n0=N0, tmax=ENSEMBLE_TMAX)
    t0 = time.perf_counter()
    f4, o4 = lc.run_ensemble(cfg, 4, seed=3,
                             mesh=make_mesh(4, 1, devices=devs))
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    f1, o1 = lc.run_ensemble(cfg, 4, seed=3,
                             mesh=make_mesh(1, 1, devices=devs[:1]))
    t1 = time.perf_counter() - t0
    dR = float(np.abs(np.asarray(f4.R) - np.asarray(f1.R)).max())
    dpsi = float(np.abs(np.asarray(f4.psi) - np.asarray(f1.psi)).max())
    dE = float(np.abs(o4["ekin"] - o1["ekin"]).max()
               / np.abs(o1["ekin"]).max())
    check(finite_tree(o4) and finite_tree(f4), "mesh ensemble finite")
    check(dR <= 1e-4 and dpsi <= 1e-4 and dE <= 1e-4,
          f"ens=4 mesh vs one card: dR {dR:.3e}, dpsi {dpsi:.3e}, "
          f"rel dEkin {dE:.3e} <= 1e-4")
    say("4", f"run_ensemble 4 members N0={N0}: (ens=4,ions=1) mesh "
        f"{t4:.2f} s vs one card {t1:.2f} s (incl. compile); max dR "
        f"{dR:.3e}, max dpsi {dpsi:.3e}, rel dEkin {dE:.3e}")

    # gather-sharded forces on (ens=1, ions=4) vs unsharded
    mesh = make_mesh(1, 4, devices=devs)
    n_loc, npad = N0 // 4, 896
    L = PlasmaUnits.box_length(N0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    rng = np.random.default_rng(0)
    R = np.zeros((1, 4 * npad, 3), np.float32)
    mask = np.zeros((1, 4 * npad), np.float32)
    for s in range(4):
        R[0, s * npad:s * npad + n_loc] = rng.uniform(0, L, (n_loc, 3))
        mask[0, s * npad:s * npad + n_loc] = 1.0
    mrows = jnp.zeros((1, npad), jnp.float32).at[0, :n_loc].set(1.0)

    def fold(x):
        return jnp.swapaxes(jnp.swapaxes(x, 1, 2), 0, 1).reshape(3, -1)

    def local(Rb):
        return gather_soa_forces(L, ldeb, 1, npad, mrows)(fold(Rb))

    F_sh = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(None, ION_AXIS),),
                             out_specs=P(None, ION_AXIS)))(jnp.asarray(R))
    F_un = jax.jit(lambda r, m: yukawa_forces_soa_batched(
        fold(r), m, 1, L, ldeb))(jnp.asarray(R), jnp.asarray(mask))
    F_sh, F_un = np.asarray(F_sh), np.asarray(F_un)
    rel = float(np.abs(F_sh - F_un).max() / np.abs(F_un).max())
    check(rel <= 1e-4, f"gather-sharded forces rel {rel:.3e} <= 1e-4")
    say("4", f"gather-sharded forces (ens=1, ions=4) N={N0} vs unsharded: "
        f"max|dF|/max|F| {rel:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh comparisons")
    ap.add_argument("--phases", default="abcdefg",
                    help="subset of phases b-g to run (a always runs)")
    args = ap.parse_args()

    for ln in card_lines():
        print(f"card: {ln}", flush=True)

    import jax
    from mdqtplasmasims_tpu.util import enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX device is a GPU, got {dev.platform}")
    say("a", f"{len(jax.devices())} x {dev.device_kind} "
        f"({dev.platform}); jax {jax.__version__}")

    t_all = time.perf_counter()
    if args.four_cards:
        four_cards()
    else:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            cfg = final = None
            if set(args.phases) & set("bcde"):
                cfg, final = phase_b(tmp)
            if "c" in args.phases:
                phase_c(cfg, final)
            if "d" in args.phases:
                phase_d(cfg, final)
            if "e" in args.phases:
                phase_e(final)
            if "f" in args.phases:
                phase_f(tmp)
            if "g" in args.phases:
                phase_g(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    say("=", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
