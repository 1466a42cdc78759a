"""Pooled cross-validation of the EXPANDING-FRAME flagship physics — the
"PlusExpansion" in laserCoolingPlusExpansionMDQTSpeedUp — against the
compiled reference (round-1 VERDICT weak #1: the expanding-frame path
had only unit tests, no end-to-end cross-validation).

The reference is patched to N0=600 / tmax=6 / sampleFreq=20 /
fracOfSig=1.0 (the moving-chunk frame: time-dependent detuning
0.0126*fracOfSig*Te*t/(sqrt(density)*sig0*sqrt(1+0.00014314*Te*t^2/
(density*sig0^2))), SpeedUp.cpp:447), compiled with tools/arma_shim.hpp
and run for JOBS jobs; the framework runs the matched CoolingConfig
(frac_of_sig=1.0) with JOBS seeds on the XLA f64 path.  Pooled
comparison:

  * Ekin_tot(t) and Epot(t) curves (median relative difference)
  * <vx>(t) drift — the expansion-frame signature: the detuning sweep
    drags the cooled velocity distribution off v=0
  * final S/P/D populations

Usage: python tools/cross_validate_expansion.py [workdir]
"""

import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

JOBS = int(os.environ.get("XVAL_JOBS", "8"))   # pool size per side
# (validate_all sets XVAL_JOBS=4 for a tractable single-core re-run at HEAD;
#  the committed 8v8 results from earlier rounds stand in RESULTS.md)
N0, TMAX, SAMPLE_FREQ, FRAC = 600, 6.0, 20, 1.0
REF = "/root/reference/laserCoolingPlusExpansionMDQTSpeedUp.cpp"


def patch_and_compile(workdir: str) -> str:
    src = open(REF).read()
    subs = [
        (r"#define N0 3500", f"#define N0 {N0}"),
        (r"#define tmax 30", f"#define tmax {TMAX:g}"),
        (r"int sampleFreq = 40;", f"int sampleFreq = {SAMPLE_FREQ};"),
        (r"double fracOfSig=0;", f"double fracOfSig={FRAC:g};"),
        (r'char saveDirectory\[256\] = "dataLaserCool/";',
         'char saveDirectory[256] = "refdata_exp/";'),
    ]
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    cpp = os.path.join(workdir, "ref_exp.cpp")
    open(cpp, "w").write(src)
    shim = os.path.join(workdir, "shim")
    os.makedirs(shim, exist_ok=True)
    shutil.copy(os.path.join(REPO, "tools", "arma_shim.hpp"),
                os.path.join(shim, "armadillo"))
    out = os.path.join(workdir, "ref_exp")
    subprocess.run(["g++", "-std=c++11", "-fopenmp", "-O2", "-I", shim,
                    "-o", out, cpp, "-lm"], check=True)
    return out


def ref_job(job_dir: str):
    e = np.loadtxt(os.path.join(job_dir, "energies.dat"))
    pf = sorted(glob.glob(os.path.join(job_dir,
                                       "statePopulationsVsVTime*.dat")))
    spd = np.loadtxt(pf[-1])[:, 1:4].mean(0)
    return e, spd


def main() -> int:
    workdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/xval_exp"
    os.makedirs(workdir, exist_ok=True)

    binary = patch_and_compile(workdir)
    print(f"== compiled {binary}; running {JOBS} reference jobs",
          flush=True)
    n_rows_full = int(round(TMAX / 0.002)) // SAMPLE_FREQ
    for j in range(1, JOBS + 1):
        done = glob.glob(os.path.join(workdir, "refdata_exp", "*",
                                      f"job{j}", "energies.dat"))
        if done and len(np.loadtxt(done[0])) >= n_rows_full:
            print(f"   job{j}: already complete, skipping", flush=True)
            continue
        if done:
            # partial run: the binary APPENDS to energies.dat, so a
            # rerun over a partial dir would corrupt it — start clean
            shutil.rmtree(os.path.dirname(done[0]))
            print(f"   job{j}: removed partial dir", flush=True)
        subprocess.run([binary, str(j)], cwd=workdir, check=True,
                       timeout=3600)
    fam = glob.glob(os.path.join(workdir, "refdata_exp", "*"))
    assert len(fam) == 1, fam
    refs = [ref_job(os.path.join(fam[0], f"job{j}"))
            for j in range(1, JOBS + 1)]
    nmin = min(e.shape[0] for e, _ in refs)
    ref_e = np.mean([e[:nmin] for e, _ in refs], axis=0)
    ref_spd = np.mean([s for _, s in refs], axis=0)

    print(f"== running {JOBS} framework jobs (XLA f64, frac_of_sig={FRAC})",
          flush=True)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, P_MANIFOLD, D_MANIFOLD, S_MANIFOLD, run)
    fw_rows, fw_spd = [], []
    for j in range(1, JOBS + 1):
        cache = os.path.join(workdir, f"fw_job{j}.npz")
        stamp = np.array([N0, TMAX, SAMPLE_FREQ, FRAC, nmin])
        if os.path.exists(cache):
            z = np.load(cache)
            if "stamp" in z.files and np.array_equal(z["stamp"], stamp):
                fw_rows.append(z["row"])
                fw_spd.append(z["spd"])
                print(f"   fw job{j}: cached", flush=True)
                continue
            print(f"   fw job{j}: stale cache (config changed), rerun",
                  flush=True)
        cfg = CoolingConfig(n0=N0, tmax=TMAX, sample_freq=SAMPLE_FREQ,
                            frac_of_sig=FRAC,
                            dtype="float64", job=j)
        final, res = run(cfg)
        o = res["outs"]
        ek = np.asarray(o["ekin"], np.float64)
        row = np.stack([np.asarray(o["t"], np.float64),
                        ek[:, 0], ek[:, 1], ek[:, 2],
                        np.asarray(o["epot"], np.float64),
                        np.asarray(o["vx_mean"], np.float64)],
                       axis=-1)[:nmin]
        pop = np.abs(np.asarray(final.psi)) ** 2
        spd = np.array([pop[:, list(S_MANIFOLD)].sum(-1).mean(),
                        pop[:, list(P_MANIFOLD)].sum(-1).mean(),
                        pop[:, list(D_MANIFOLD)].sum(-1).mean()])
        np.savez(cache, row=row, spd=spd, stamp=stamp)
        fw_rows.append(row)
        fw_spd.append(spd)
        print(f"   fw job{j}: done", flush=True)
    fw = np.mean(fw_rows, axis=0)

    # reference energies.dat: t ekx eky ekz epot audit vxmean
    ek_ref = ref_e[:, 1:4].sum(1)
    ek_fw = fw[:, 1:4].sum(1)
    ep_ref, ep_fw = ref_e[:, 4], fw[:, 4]
    vx_ref, vx_fw = ref_e[:, 6], fw[:, 5]
    rel = lambda a, b: np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
    ek_med = float(np.median(rel(ek_ref, ek_fw)))
    ep_med = float(np.median(rel(ep_ref, ep_fw)))

    # statistical criterion (same standard as cross_validate_frozen_
    # pooled): per-sample z of the pooled means against the actual
    # 8-job-per-side seed scatter — a raw relative-difference gate
    # punishes the small-denominator DIH era instead of the agreement
    from mdqtplasmasims_tpu.analysis import two_sample_z_columns as zcurve

    z_ek = zcurve([e[:nmin, 1:4].sum(1) for e, _ in refs],
                  [f[:, 1:4].sum(1) for f in fw_rows])
    z_ep = zcurve([e[:nmin, 4] for e, _ in refs],
                  [f[:, 4] for f in fw_rows])

    # the drift signature: compare late-time <vx> means (both should be
    # dragged the same way by the detuning sweep)
    lt = slice(max(0, nmin - nmin // 3), nmin)
    drift_ref = float(vx_ref[lt].mean())
    drift_fw = float(vx_fw[lt].mean())
    spd_diff = np.abs(ref_spd - np.mean(fw_spd, axis=0))

    print(f"pooled Ekin_tot(t): median rel diff {ek_med:.3f}, "
          f"median |z| {np.median(np.abs(z_ek)):.2f}, "
          f"max |z| {np.abs(z_ek).max():.2f}")
    print(f"pooled Epot(t):     median rel diff {ep_med:.3f}, "
          f"median |z| {np.median(np.abs(z_ep)):.2f}, "
          f"max |z| {np.abs(z_ep).max():.2f}")
    print(f"late <vx> drift: ref {drift_ref:+.4f} vs fw {drift_fw:+.4f}")
    print(f"final S/P/D: ref {np.round(ref_spd, 3)} vs "
          f"fw {np.round(np.mean(fw_spd, axis=0), 3)} "
          f"(max |diff| {spd_diff.max():.3f})")

    ok = (np.abs(z_ek).max() < 3 and np.abs(z_ep).max() < 3
          and spd_diff.max() < 0.05
          and (abs(drift_ref) < 1e-3 or
               abs(drift_fw - drift_ref) < 0.5 * abs(drift_ref)
               or abs(drift_fw - drift_ref) < 0.02))
    print("EXPANSION XVAL", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
