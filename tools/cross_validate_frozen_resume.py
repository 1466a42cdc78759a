"""Checkpoint interop for the frozen-tag family: resume the *compiled
reference binary* from a framework-written checkpoint and vice versa.

The randomFrozenStartTag* programs support the same newRun=0 walltime
chaining as the flagship (randomFrozenStartTag422Linear.cpp:987-995),
restoring N/counter, SpinUpList, and R|V via fscanf — no wavefunctions
(post-tag they are dead weight) and no Vholder.  This proves the
framework's ASCII tagging-state API is binary-compatible both ways:

  A. framework 422linear run to t=2  ->  reference binary (newRun=0,
     c0=999) continues to t=3 in the same job directory;
  B. reference binary run to t=2 (newRun=1)  ->  framework
     run(resume=True) continues to t=3.

Checks per direction: total-energy continuity across the splice (post-tag
is pure MD, so Etot must step across the boundary like any other sample
interval), the continued rows land on the same (c0+1)%sampleFreq grid,
and the spin-up list survives the round trip bit-for-bit (the resumed
side really parsed the tag state, not re-measured it).

Usage:  python tools/cross_validate_frozen_resume.py [workdir]
(compiles the reference with tools/arma_shim.hpp; a few minutes on CPU)
"""

import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/randomFrozenStartTag422Linear.cpp"
sys.path.insert(0, REPO)

N0, TMAX1, TMAX2, TSTART = 256, 2.0, 3.0, 1.0


def patch_source(dst: str, *, new_run: int, c0: int, tmax: float,
                 save_dir: str) -> None:
    src = open(REF).read()
    subs = [
        (r"#define N0 3500", f"#define N0 {N0}"),
        (r"#define tmax 25", f"#define tmax {tmax:g}"),
        (r"#define tstartV0 15", f"#define tstartV0 {TSTART:g}"),
        (r"int newRun = 1;", f"int newRun = {new_run};"),
        (r"int c0 = 0;", f"int c0 = {c0};"),
        (r'char saveDirectory\[256\] = "data422/";',
         f'char saveDirectory[256] = "{save_dir}/";'),
    ]
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    open(dst, "w").write(src)


def compile_ref(workdir: str, name: str) -> str:
    shim = os.path.join(workdir, "shim")
    os.makedirs(shim, exist_ok=True)
    shutil.copy(os.path.join(REPO, "tools", "arma_shim.hpp"),
                os.path.join(shim, "armadillo"))
    out = os.path.join(workdir, name)
    subprocess.run(["g++", "-std=c++11", "-fopenmp", "-O2", "-I", shim,
                    "-o", out, os.path.join(workdir, name + ".cpp"), "-lm"],
                   check=True)
    return out


def fw_config(base_dir: str, tmax: float):
    from mdqtplasmasims_tpu.experiments.frozen_tagging import FrozenTagConfig
    # every knob at the reference file's compiled-in value
    return FrozenTagConfig(variant="422linear", n0=N0, tstart=TSTART,
                           tmax=tmax, timestep=0.002, sample_freq=40,
                           tpump_seconds=1e-7, detuning=-1.0, om=1.3,
                           density=2.0, ge=0.1, dtype="float64",
                           save_directory=base_dir)


def job_dir(base_dir: str) -> str:
    from mdqtplasmasims_tpu.experiments.frozen_tagging import frozen_tag_dir
    return frozen_tag_dir(base_dir, tpump_seconds=1e-7, tstart=TSTART,
                          detuning=-1.0, om=1.3, density=2.0, ge=0.1,
                          n0=N0, job=1)


def splice_ok(e: np.ndarray, n_first_leg: int, label: str) -> bool:
    tot = e[:, 1:4].sum(1) + e[:, 4]
    jump = abs(tot[n_first_leg] - tot[n_first_leg - 1])
    steps = np.abs(np.diff(tot))
    typical = np.median(steps[max(0, n_first_leg - 8):n_first_leg + 8])
    rel = jump / max(abs(tot[n_first_leg - 1]), 1e-12)
    print(f"  {label}: splice jump {jump:.3e} ({rel * 100:.3f}% of Etot), "
          f"typical interval step {typical:.3e}")
    return jump < 5 * typical + 1e-12 and rel < 0.05


def grid_ok(e: np.ndarray, label: str) -> bool:
    """All rows 40 MD steps (0.08 w_E^-1) apart — one unbroken sample
    grid across the splice with NO tolerance for a sub-step offset:
    since round 4 the framework stamps rows at the reference's exact
    gate instant (one quantum tick into the sampling MD step, PARITY.md
    delta #2 closed), so the splice interval must be identical to every
    other interval to f64 print precision."""
    dt_rows = np.diff(e[:, 0])
    # 4e-5 = well under one quantum tick (qdt = dt/ratio) yet above the
    # %g 6-sig-digit print rounding of t <= 3
    ok = bool(np.all(np.abs(dt_rows - 0.08) < 4e-5))
    print(f"  {label}: row spacing {dt_rows.min():.6f}..{dt_rows.max():.6f}"
          f" (want exactly 0.080000 everywhere, splice included)")
    return ok


def latest_spinups(d: str):
    fs = sorted(glob.glob(os.path.join(d, "spinUpIonsList_timestep*.dat")))
    arr = np.loadtxt(fs[-1], dtype=np.int64)
    return fs[-1], arr


def direction_a(workdir: str) -> bool:
    """Framework writes the tagging checkpoint; the binary resumes."""
    print("direction A: framework -> reference binary")
    from mdqtplasmasims_tpu.experiments.frozen_tagging import run
    w = os.path.join(workdir, "a")
    os.makedirs(w, exist_ok=True)
    run(fw_config(w, TMAX1))
    d = job_dir(w)
    n_rows1 = np.loadtxt(os.path.join(d, "energies.dat")).reshape(
        -1, 6).shape[0]
    _, spins_fw = latest_spinups(d)

    c0 = int(round(TMAX1 / 0.002)) - 1
    patch_source(os.path.join(workdir, "tagresume.cpp"), new_run=0, c0=c0,
                 tmax=TMAX2, save_dir=w)
    binary = compile_ref(workdir, "tagresume")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)

    e = np.loadtxt(os.path.join(d, "energies.dat")).reshape(-1, 6)
    _, spins_bin = latest_spinups(d)
    print(f"  rows {n_rows1} -> {e.shape[0]}; spin-up list "
          f"{spins_fw.sum()} tags preserved: "
          f"{bool((spins_fw == spins_bin).all())}")
    return (e.shape[0] > n_rows1 and splice_ok(e, n_rows1, "A")
            and grid_ok(e, "A") and bool((spins_fw == spins_bin).all()))


def direction_b(workdir: str) -> bool:
    """The binary writes the tagging checkpoint; the framework resumes."""
    print("direction B: reference binary -> framework")
    from mdqtplasmasims_tpu.experiments.frozen_tagging import run
    w = os.path.join(workdir, "b")
    os.makedirs(w, exist_ok=True)
    patch_source(os.path.join(workdir, "tagfirst.cpp"), new_run=1, c0=0,
                 tmax=TMAX1, save_dir=w)
    binary = compile_ref(workdir, "tagfirst")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)
    d = job_dir(w)
    n_rows1 = np.loadtxt(os.path.join(d, "energies.dat")).reshape(
        -1, 6).shape[0]
    _, spins_bin = latest_spinups(d)

    run(fw_config(w, TMAX2), resume=True)
    e = np.loadtxt(os.path.join(d, "energies.dat")).reshape(-1, 6)
    _, spins_fw = latest_spinups(d)
    print(f"  rows {n_rows1} -> {e.shape[0]}; spin-up list "
          f"{spins_bin.sum()} tags preserved: "
          f"{bool((spins_bin == spins_fw).all())}")
    return (e.shape[0] > n_rows1 and splice_ok(e, n_rows1, "B")
            and grid_ok(e, "B") and bool((spins_bin == spins_fw).all()))


def main(workdir: str = "/tmp/xval_frozen_resume") -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    ok_a = direction_a(workdir)
    ok_b = direction_b(workdir)
    print(f"A (fw -> binary): {'PASS' if ok_a else 'FAIL'}; "
          f"B (binary -> fw): {'PASS' if ok_b else 'FAIL'}")
    return 0 if ok_a and ok_b else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
