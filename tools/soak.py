"""Production-length soak: one full reference-scale run per experiment
family, with .dat outputs archived and headline physics numbers extracted
to ``artifacts/soak/physics.json`` for ``tests/test_physics_targets.py``'s
full-scale assertions.  Wall times are printed, not archived: the record
holds physics only, which does not depend on the device.

The configurations are the reference programs' own production operating
points:

- cooling: laserCoolingPlusExpansionMDQTSpeedUp.cpp README.md:51 headline
  (N0=3500, tmax=30, density=2e14, Ge=0.1)
- frozen tag: randomFrozenStartTag422Linear.cpp:52-83 (N0=3500,
  tstart=15, tmax=25)
- mc tag: MonteCarloFollowedByQTTagging408Quad.cpp (N=4096, 100k MC
  steps, 1500 record steps at Gamma=3, kappa=0.5)
- transport: MonteCarloFollowedByMDAndTempAnisotropy.cpp:62-107 (N=4096,
  200k MC steps, full staged pipeline)
- three-state: laserCoolNoPlasmaThreeState.cpp (N=1000, tmax=45000 1/gamma)

Usage:  python tools/soak.py [family ...]     (default: all five)

Each family's record is written incrementally, so a failure in one
family doesn't lose the others (rerun with just that family's name).
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mdqtplasmasims_tpu.util import enable_compilation_cache
enable_compilation_cache()
ART = os.path.join(ROOT, "artifacts", "soak")
SUMMARY = os.path.join(ART, "physics.json")
_TIMING_KEYS = ("wall_s", "agg_updates_per_sec", "n_devices")


def _update_summary(family: str, metrics: dict) -> None:
    os.makedirs(ART, exist_ok=True)
    cur = {}
    if os.path.exists(SUMMARY):
        with open(SUMMARY) as f:
            cur = json.load(f)
    cur[family] = {k: v for k, v in metrics.items()
                   if k not in _TIMING_KEYS}
    tmp = SUMMARY + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cur, f, indent=1, sort_keys=True)
    os.replace(tmp, SUMMARY)
    print(f"[soak] {family} on {_device_name()}: {json.dumps(metrics)}",
          flush=True)


def _device_name() -> str:
    import jax
    return str(jax.devices()[0].device_kind)


def soak_cooling() -> None:
    from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                              run)
    cfg = CoolingConfig(n0=3500, tmax=30.0, sample_freq=40,
                        save_directory=os.path.join(ART, "cooling"))
    t0 = time.perf_counter()
    final, res = run(cfg)
    wall = time.perf_counter() - t0
    outs = res["outs"]
    t = np.asarray(outs["t"], np.float64)
    ekx = np.asarray(outs["ekin"], np.float64)[:, 0]
    # DIH: EkinX rises from ~0 to its global early-time peak near
    # omega_E t ~ 1 (omega_E = sqrt(1/3) omega_p; t is in omega_p^-1
    # units here so the peak lands at t ~ 1.7), then laser cooling pulls
    # it back down by t=30.
    early = t <= 8.0
    i_peak = int(np.argmax(ekx[early]))
    late = t >= 25.0
    pops = np.abs(np.asarray(final.psi)) ** 2
    popS = float(pops[:, :2].sum(-1).mean())
    popP = float(pops[:, 2:6].sum(-1).mean())
    popD = float(pops[:, 6:].sum(-1).mean())
    _update_summary("cooling", {
        "n0": cfg.n0, "tmax": cfg.tmax, "wall_s": round(wall, 1),
        "dih_peak_t": float(t[early][i_peak]),
        "dih_peak_ekin_x": float(ekx[early][i_peak]),
        "gamma_dih": float(1.0 / (2 * np.mean(ekx[(t > 6) & (t < 10)]))),
        "ekin_x_late": float(np.mean(ekx[late])),
        "cooling_ratio": float(np.mean(ekx[late]) / ekx[early][i_peak]),
        "pop_s": popS, "pop_p": popP, "pop_d": popD,
    })


def soak_frozen() -> None:
    from mdqtplasmasims_tpu.experiments.frozen_tagging import (
        FrozenTagConfig, run)
    cfg = FrozenTagConfig(variant="422linear", n0=3500, tstart=15.0,
                          tmax=25.0,
                          save_directory=os.path.join(ART, "frozen"))
    t0 = time.perf_counter()
    final, res = run(cfg)
    wall = time.perf_counter() - t0
    spin_up = np.asarray(res["spin_up"], bool)
    out_tag = res["out_tag"]
    vx_tag = np.asarray(final.V, np.float64)[spin_up, 0]
    mom_tag = np.asarray(out_tag["moments"], np.float64)
    _update_summary("frozen", {
        "n0": cfg.n0, "tstart": cfg.tstart, "tmax": cfg.tmax,
        "wall_s": round(wall, 1),
        "tag_fraction": float(spin_up.mean()),
        "tagged_vx_at_tag": float(mom_tag[0]),
        "tagged_vx2_at_tag": float(mom_tag[1]),
        "vaf_tau0": float(out_tag["vaf"]),
        "tagged_vx_final": float(vx_tag.mean()),
        "frac_tagged_positive_vx": float((vx_tag > 0).mean()),
    })


def soak_frozen_408quad() -> None:
    from mdqtplasmasims_tpu.experiments.frozen_tagging import (
        FrozenTagConfig, run)
    cfg = FrozenTagConfig(variant="408quad", n0=3500, tstart=15.0,
                          tmax=25.0,
                          save_directory=os.path.join(ART, "frozen408q"))
    t0 = time.perf_counter()
    final, res = run(cfg)
    wall = time.perf_counter() - t0
    spin_up = np.asarray(res["spin_up"], bool)
    mom_tag = np.asarray(res["out_tag"]["moments"], np.float64)
    _update_summary("frozen_408quad", {
        "n0": cfg.n0, "wall_s": round(wall, 1),
        "tag_fraction": float(spin_up.mean()),
        "tagged_vx2_at_tag": float(mom_tag[1]),
        "long_kin_tau0": float(res["out_tag"]["long_kin"]),
    })


def soak_mc_tag_422() -> None:
    from mdqtplasmasims_tpu.experiments.mc_qt_tagging import (MCTagConfig,
                                                              run)
    cfg = MCTagConfig(variant="422linear", n=4096,
                      save_directory=os.path.join(ART, "mc_tag422"))
    t0 = time.perf_counter()
    res = run(cfg)
    wall = time.perf_counter() - t0
    tags = np.asarray(res["tags"], bool)
    temps = np.asarray(res["temps"], np.float64)
    _update_summary("mc_tag_422", {
        "n": cfg.n, "wall_s": round(wall, 1),
        "tag_fraction": float(tags.mean()),
        "mean_record_temp": float(temps.mean()),
    })


def soak_mc_tag() -> None:
    from mdqtplasmasims_tpu.experiments.mc_qt_tagging import (MCTagConfig,
                                                              run)
    cfg = MCTagConfig(variant="408quad", n=4096,
                      save_directory=os.path.join(ART, "mc_tag"))
    t0 = time.perf_counter()
    res = run(cfg)
    wall = time.perf_counter() - t0
    tags = np.asarray(res["tags"], bool)
    moments = np.asarray(res["moments"], np.float64)   # [T, 4]
    temps = np.asarray(res["temps"], np.float64)
    vaf = np.asarray(res["vaf"], np.float64)
    _update_summary("mc_tag", {
        "n": cfg.n, "gamma": cfg.gamma, "wall_s": round(wall, 1),
        "tag_fraction": float(tags.mean()),
        "tagged_vx2_initial": float(moments[0, 1]),
        "mean_record_temp": float(temps.mean()),
        "selectivity": float(moments[0, 1] * cfg.gamma),
        "vaf_norm_min": float((vaf / vaf[0]).min()),
    })


def soak_transport() -> None:
    from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import (
        MCTransportConfig, run)
    cfg = MCTransportConfig(n=4096,
                            save_directory=os.path.join(ART, "transport"))
    t0 = time.perf_counter()
    res = run(cfg)
    wall = time.perf_counter() - t0
    temps = np.asarray(res["temps"], np.float64)
    ti = np.asarray(res["temps_inst"], np.float64)     # [steps, 3]
    vaf = np.asarray(res["vaf"], np.float64)
    spread0 = float(ti[0].max() - ti[0].min())
    spread1 = float(ti[-500:].mean(0).max() - ti[-500:].mean(0).min())
    _update_summary("transport", {
        "n": cfg.n, "gamma": cfg.gamma, "wall_s": round(wall, 1),
        "mean_record_temp": float(temps.mean()),
        "vaf_norm_min": float((vaf / vaf[0]).min()),
        "aniso_spread_initial": spread0,
        "aniso_spread_relaxed": spread1,
    })


def soak_three_state() -> None:
    from mdqtplasmasims_tpu.experiments.three_state import (
        ThreeStateConfig, doppler_limit_ekin, run)
    cfg = ThreeStateConfig(n0=1000,
                           save_directory=os.path.join(ART, "three_state"))
    t0 = time.perf_counter()
    res = run(cfg)
    wall = time.perf_counter() - t0
    ek = np.asarray(res["ekin_x"], np.float64)
    n_late = max(1, len(ek) // 10)
    _update_summary("three_state", {
        "n0": cfg.n0, "tmax": cfg.tmax, "wall_s": round(wall, 1),
        "ekin_x_initial": float(ek[0]),
        "ekin_x_final": float(ek[-n_late:].mean()),
        "doppler_limit": float(doppler_limit_ekin(cfg.detuning, cfg.om)),
        "cooling_factor": float(ek[0] / ek[-n_late:].mean()),
    })


def soak_cooling_poisson_ensemble() -> None:
    """Production Poissonian ensemble (round 3): 8 jobs, each drawing its
    own N ~ Binomial(729*3500, 1/729) as the reference init does per
    array job, folded into one fused program with per-member masks."""
    import glob
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, run_ensemble)
    base = os.path.join(ART, "cooling_poisson")
    # periodic checkpoints every 75 samples (crash safety)
    cfg = CoolingConfig(n0=3500, tmax=30.0, sample_freq=40, exact_n=False,
                        checkpoint_every_segments=75,
                        save_directory=base)
    t0 = time.perf_counter()
    final, outs = run_ensemble(cfg, n_jobs=8, seed=1)
    wall = time.perf_counter() - t0
    t = np.asarray(outs["t"], np.float64)[0]
    ekx = np.asarray(outs["ekin"], np.float64)[:, :, 0]   # [E, S]
    early = t <= 8.0
    i_peak = int(np.argmax(ekx.mean(0)[early]))
    late = t >= 25.0
    c0 = int(round(cfg.tmax / cfg.timestep)) - 1
    n_js = sorted(np.loadtxt(p).shape[0] for p in glob.glob(
        base + f"/*/job*/conditions_timestep{c0:06d}.dat"))
    _update_summary("cooling_poisson_ensemble", {
        "n_jobs": 8, "n0": cfg.n0, "tmax": cfg.tmax,
        "wall_s": round(wall, 1),
        "member_ns": [int(n) for n in n_js],
        "member_n_spread": int(n_js[-1] - n_js[0]),
        "dih_peak_t": float(t[early][i_peak]),
        "dih_peak_ekin_x": float(ekx.mean(0)[early][i_peak]),
        "cooling_ratio": float(ekx.mean(0)[late].mean()
                               / ekx.mean(0)[early][i_peak]),
    })


def soak_cooling_mesh() -> None:
    """Production mesh ensemble: run_ensemble(mesh=...) on the attached
    device(s) — the multi-device entry point exercised end to end, .dat
    trees + periodic checkpoints included."""
    import jax
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, run_ensemble)
    from mdqtplasmasims_tpu.parallel.mesh import make_mesh
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, 1)
    cfg = CoolingConfig(n0=3500, tmax=30.0, sample_freq=40,
                        checkpoint_every_segments=75,
                        save_directory=os.path.join(ART, "cooling_mesh"))
    t0 = time.perf_counter()
    final, outs = run_ensemble(cfg, n_jobs=8 * n_dev, seed=1, mesh=mesh)
    wall = time.perf_counter() - t0
    t = np.asarray(outs["t"], np.float64)[0]
    ekx = np.asarray(outs["ekin"], np.float64)[:, :, 0]
    early = t <= 8.0
    i_peak = int(np.argmax(ekx.mean(0)[early]))
    late = t >= 25.0
    ticks = 8 * n_dev * cfg.n0 * int(round(cfg.tmax / cfg.timestep)) * cfg.ratio
    _update_summary("cooling_mesh_ensemble", {
        "n_devices": n_dev, "n_jobs": 8 * n_dev, "n0": cfg.n0,
        "tmax": cfg.tmax, "wall_s": round(wall, 1),
        "agg_updates_per_sec": round(ticks / wall, 1),
        "dih_peak_t": float(t[early][i_peak]),
        "cooling_ratio": float(ekx.mean(0)[late].mean()
                               / ekx.mean(0)[early][i_peak]),
    })


FAMILIES = {
    "cooling": soak_cooling,
    "frozen": soak_frozen,
    "mc_tag": soak_mc_tag,
    "transport": soak_transport,
    "three_state": soak_three_state,
    # variant coverage beyond the one-per-family defaults
    "frozen_408quad": soak_frozen_408quad,
    "mc_tag_422": soak_mc_tag_422,
    # round-3 production modes
    "cooling_poisson_ensemble": soak_cooling_poisson_ensemble,
    "cooling_mesh_ensemble": soak_cooling_mesh,
}


DEFAULT_FAMILIES = ("cooling", "frozen", "mc_tag", "transport",
                    "three_state")


def main() -> None:
    names = sys.argv[1:] or list(DEFAULT_FAMILIES)
    for name in names:
        print(f"[soak] running {name} ...", flush=True)
        t0 = time.perf_counter()
        FAMILIES[name]()
        print(f"[soak] {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
