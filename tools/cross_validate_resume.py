"""Checkpoint interop proof: resume the *compiled reference binary* from a
framework-written checkpoint, and resume the framework from a
reference-written one (VERDICT round-1 item 3).

The reference's walltime-window chaining (README.md:51-53) restarts with
``newRun=0, c0=<last timestep>`` and reads ions_/conditions_/wvFns_/VZERO_
via fscanf (laserCoolingPlusExpansionMDQTSpeedUp.cpp:785-916, time formula
t=(c0-9)*TIMESTEP+0.02 at :789).  This script proves the framework's ASCII
state API is binary-compatible in BOTH directions:

  A. framework run to t=1  ->  reference binary (newRun=0, c0=499)
     continues to t=2 in the same job directory;
  B. reference binary run to t=1 (newRun=1)  ->  framework resume_state()
     continues to t=2.

Both splices are checked for total-energy continuity (same microstate
across the boundary, so the energy must match at the few-permille level of
one output interval's drift) and for live wavefunctions after the splice
(P/D populations nonzero -> the wvFns_ fscanf really parsed our files).

Usage:  python tools/cross_validate_resume.py [workdir]
(compiles the reference with tools/arma_shim.hpp; ~5 min on CPU)
"""

import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/laserCoolingPlusExpansionMDQTSpeedUp.cpp"
sys.path.insert(0, REPO)

N0, TMAX1, TMAX2, SAMPLE_FREQ, TIMESTEP = 256, 1.0, 2.0, 10, 0.002
TSTART_V0 = 0.5        # VAF interval 0 start (vaf directions)
# off-grid chaining legs: 505 MD steps, 5 past the last output gate
TMAX_OG1, TMAX_OG2 = 1.01, 2.01
RATIO = 25             # CoolingConfig(timestep=0.002).ratio
QDT = TIMESTEP / RATIO
# both codes stamp rows at the identical gate instant since round 4
# (PARITY delta #2 closed): one quantum tick into 0-based MD step c0,
# t = (c0*ratio + 1)*qdt.  Grid checks are tight: 4e-5 is under one
# quantum tick (8e-5) yet above %g print rounding of t <= 3.
T_ATOL = 4e-5


def gate_t(c0: int) -> float:
    """Row timestamp of the (c0+1)%sampleFreq==0 && timeStepCounter==1
    output gate (SpeedUp.cpp:1365-1368)."""
    return (c0 * RATIO + 1) * QDT


def patch_source(dst: str, *, new_run: int, c0: int, tmax: float,
                 save_dir: str, enable_vaf: bool = False) -> None:
    src = open(REF).read()
    subs = [
        (r"#define N0 3500", f"#define N0 {N0}"),
        (r"#define tmax 30", f"#define tmax {tmax:g}"),
        (r"int sampleFreq = 40;", f"int sampleFreq = {SAMPLE_FREQ};"),
        (r"int newRun = 1;", f"int newRun = {new_run};"),
        (r"int c0 = 0;", f"int c0 = {c0};"),
        (r'char saveDirectory\[256\] = "dataLaserCool/";',
         f'char saveDirectory[256] = "{save_dir}/";'),
    ]
    if enable_vaf:
        # The SpeedUp main ships with the whole CCF+VAF block commented
        # out (:1250-1362) but readConditions still restores Vholder from
        # VZERO on every restart (:898-916).  Re-open the comment just
        # before the VAF intervals so Zfunc/printVAF stream (the CCF part
        # stays disabled), and move interval 0 into the short test run.
        subs += [
            (r"// Calculation of VAF", "*/\n\t\t// Calculation of VAF"),
            (re.escape("}*/"), "}"),
            (r"#define tstartV0 3\b", f"#define tstartV0 {TSTART_V0:g}"),
            # the block predates the SpeedUp substepping: gate it to once
            # per MD step exactly like the output() call (:1365), else it
            # fires on every quantum substep
            (r"if\(c0 >= vstart0  && c0 < \(vstart0 \+ "
             r"lengthOfIntervalV\) && \(c0-vstart0\)%sampleFreq == 0\)",
             "if(c0 >= vstart0  && c0 < (vstart0 + lengthOfIntervalV) && "
             "(c0-vstart0)%sampleFreq == 0 && timeStepCounter==1)"),
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


def etot(rows: np.ndarray) -> np.ndarray:
    return rows[:, 1:4].sum(1) + rows[:, 4]


def load_energies(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1, 7)


def splice_ok(e: np.ndarray, n_first_leg: int, label: str) -> bool:
    """Energy continuity across the resume boundary: compare the jump at
    the splice to the typical per-interval energy change around it."""
    tot = etot(e)
    jump = abs(tot[n_first_leg] - tot[n_first_leg - 1])
    steps = np.abs(np.diff(tot))
    typical = np.median(steps[max(0, n_first_leg - 10):n_first_leg + 10])
    rel = jump / max(tot[n_first_leg - 1], 1e-12)
    print(f"  {label}: splice jump {jump:.3e} ({rel * 100:.2f}% of Etot), "
          f"typical interval step {typical:.3e}")
    # the boundary must look like any other sample interval (allow 5x for
    # stochastic variation) and never a discontinuity in Etot
    return jump < 5 * typical + 1e-12 and rel < 0.05


def pops_alive(job_dir: str, first_k: int) -> bool:
    """P/D populations nonzero in the first post-splice snapshot -> the
    binary (or framework) really parsed the wavefunction checkpoint."""
    f = os.path.join(job_dir, f"statePopulationsVsVTime{first_k:06d}.dat")
    p = np.loadtxt(f)
    pd = float(p[:, 2:4].mean())
    print(f"  first post-splice P+D population: {pd:.4f}")
    return pd > 1e-3


def direction_a(workdir: str) -> bool:
    """Framework writes the checkpoint; the reference binary resumes."""
    print("direction A: framework -> reference binary")
    from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                              run, _save_dir)
    base = os.path.join(workdir, "dataA")
    cfg = CoolingConfig(n0=N0, tmax=TMAX1, sample_freq=SAMPLE_FREQ,
                        dtype="float64",
                        save_directory=base)
    run(cfg)
    job_dir = _save_dir(cfg)
    n_rows1 = load_energies(os.path.join(job_dir, "energies.dat")).shape[0]
    c0 = int(round(TMAX1 / TIMESTEP)) - 1          # framework writes n_md-1
    assert os.path.exists(os.path.join(job_dir,
                                       f"conditions_timestep{c0:06d}.dat"))

    patch_source(os.path.join(workdir, "refresume.cpp"), new_run=0, c0=c0,
                 tmax=TMAX2, save_dir="dataA")
    binary = compile_ref(workdir, "refresume")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)

    e = load_energies(os.path.join(job_dir, "energies.dat"))
    print(f"  rows: {n_rows1} (framework) + {e.shape[0] - n_rows1} "
          f"(reference continuation)")
    ok = e.shape[0] > n_rows1 + 10
    # the binary's first continuation row lands on the exact global gate
    # grid: one tick into MD step 509 (t = 1.01808, zero offset)
    ok &= abs(e[n_rows1, 0] - gate_t(509)) < T_ATOL
    ok &= splice_ok(e, n_rows1, "A")
    # counter restored from ions_: snapshot numbering continues
    first_k = n_rows1
    ok &= pops_alive(job_dir, first_k)
    return bool(ok)


def direction_b(workdir: str) -> bool:
    """The reference binary writes the checkpoint; the framework resumes."""
    print("direction B: reference binary -> framework")
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, resume_state, run, write_outputs)
    patch_source(os.path.join(workdir, "reffresh.cpp"), new_run=1, c0=0,
                 tmax=TMAX1, save_dir="dataB")
    binary = compile_ref(workdir, "reffresh")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)

    job_dirs = glob.glob(os.path.join(workdir, "dataB", "*", "job1"))
    assert len(job_dirs) == 1, job_dirs
    job_dir = job_dirs[0]
    ions = glob.glob(os.path.join(job_dir, "ions_timestep*.dat"))
    c0 = max(int(re.search(r"(\d{6})", os.path.basename(f)).group(1))
             for f in ions)
    e_ref = load_energies(os.path.join(job_dir, "energies.dat"))
    n_rows1 = e_ref.shape[0]

    cfg = CoolingConfig(n0=N0, tmax=TMAX2 - TMAX1, sample_freq=SAMPLE_FREQ,
                        dtype="float64")
    state = resume_state(job_dir, c0, cfg)
    n_ions = state.R.shape[0]
    print(f"  resumed N={n_ions} ions at t={float(state.t):.4f} "
          f"(c0={c0})")
    assert abs(float(state.t) - TMAX1) < 0.05
    final, res = run(cfg, state=state)
    # append the continuation rows the way a chained framework window would
    n_md_total = int(round(TMAX2 / TIMESTEP))
    write_outputs(job_dir, cfg, res["outs"], res["epot0"], final,
                  n_md_total, sample_offset=n_rows1)
    e = load_energies(os.path.join(job_dir, "energies.dat"))
    print(f"  rows: {n_rows1} (reference) + {e.shape[0] - n_rows1} "
          f"(framework continuation)")
    ok = e.shape[0] > n_rows1 + 10
    ok &= splice_ok(e, n_rows1, "B")
    # the resumed wavefunctions must keep evolving: P/D occupied at the end
    pops = np.abs(np.asarray(final.psi)) ** 2
    pd = float(pops[:, 2:].sum(1).mean())
    print(f"  final P+D population (framework leg): {pd:.4f}")
    ok &= pd > 1e-3
    return bool(ok)


def direction_c(workdir: str) -> bool:
    """Off-grid tmax chaining, framework -> binary: the framework runs to
    tmax=1.01 (505 MD steps, 5 past the last output gate at 500),
    simulates the trailing sub-segment, and writes the terminal
    checkpoint at the true c0=504; the reference binary (newRun=0)
    continues to 2.01 and its *global* (c0+1)%sampleFreq gate must pick
    up at step 510 (t=1.02) with energy continuity — proving the
    framework's tail state is exactly the restart state the binary
    expects."""
    print("direction C: off-grid tmax, framework -> reference binary")
    from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                              run, _save_dir)
    base = os.path.join(workdir, "dataC")
    cfg = CoolingConfig(n0=N0, tmax=TMAX_OG1, sample_freq=SAMPLE_FREQ,
                        dtype="float64",
                        save_directory=base)
    run(cfg)
    job_dir = _save_dir(cfg)
    n_rows1 = load_energies(os.path.join(job_dir, "energies.dat")).shape[0]
    c0 = int(round(TMAX_OG1 / TIMESTEP)) - 1       # 504: true final step
    assert os.path.exists(os.path.join(job_dir,
                                       f"conditions_timestep{c0:06d}.dat"))
    patch_source(os.path.join(workdir, "refresume_og.cpp"), new_run=0,
                 c0=c0, tmax=TMAX_OG2, save_dir="dataC")
    binary = compile_ref(workdir, "refresume_og")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)
    e = load_energies(os.path.join(job_dir, "energies.dat"))
    print(f"  rows: {n_rows1} (framework) + {e.shape[0] - n_rows1} "
          f"(reference continuation); first continuation t="
          f"{e[n_rows1, 0]:.4f}")
    ok = e.shape[0] > n_rows1 + 10
    # the binary's global gate resumes one tick into step 509
    # (t = 1.01808) — exact, no sub-step offset since round 4
    ok &= abs(e[n_rows1, 0] - gate_t(509)) < T_ATOL
    ok &= splice_ok(e, n_rows1, "C")
    return bool(ok)


def direction_d(workdir: str) -> bool:
    """Off-grid tmax chaining, binary -> framework run(resume=True): the
    reference runs fresh to tmax=1.01 (its loop leaves the terminal c0 a
    step past the last gate), the tree is copied to the framework's
    param-encoded path, and run(resume=True) with tmax=2.01 must resume
    from the ASCII checkpoint, realign to the global gate (first new row
    at t=1.02, uniform spacing across the splice), run its own trailing
    sub-segment to exactly 2.01, and keep Etot continuous."""
    print("direction D: off-grid tmax, reference binary -> framework "
          "run(resume=True)")
    from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                              run, _save_dir)
    patch_source(os.path.join(workdir, "reffresh_og.cpp"), new_run=1, c0=0,
                 tmax=TMAX_OG1, save_dir="dataD")
    binary = compile_ref(workdir, "reffresh_og")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)
    job_dirs = glob.glob(os.path.join(workdir, "dataD", "*", "job1"))
    assert len(job_dirs) == 1, job_dirs
    src_dir = job_dirs[0]
    base = os.path.join(workdir, "dataD_fw")
    cfg = CoolingConfig(n0=N0, tmax=TMAX_OG2, sample_freq=SAMPLE_FREQ,
                        dtype="float64",
                        save_directory=base)
    job_dir = _save_dir(cfg)
    os.makedirs(os.path.dirname(job_dir), exist_ok=True)
    shutil.copytree(src_dir, job_dir)
    n_rows1 = load_energies(os.path.join(job_dir, "energies.dat")).shape[0]
    final, _ = run(cfg, resume=True)
    e = load_energies(os.path.join(job_dir, "energies.dat"))
    print(f"  rows: {n_rows1} (reference) + {e.shape[0] - n_rows1} "
          f"(framework continuation); first continuation t="
          f"{e[n_rows1, 0]:.4f}, final t={float(final.t):.4f}")
    ok = e.shape[0] > n_rows1 + 10
    ok &= abs(e[n_rows1, 0] - gate_t(509)) < T_ATOL
    ok &= abs(float(final.t) - TMAX_OG2) < 1e-6
    # one uniform global grid across the splice — exact since round 4
    # (both codes stamp at the identical gate instant)
    ok &= bool(np.allclose(np.diff(e[:, 0]), SAMPLE_FREQ * TIMESTEP,
                           atol=T_ATOL))
    ok &= splice_ok(e, n_rows1, "D")
    return bool(ok)


def vaf_continuity(path: str, n_rows1: int, label: str) -> bool:
    """The interval-VAF stream must cross the splice like any other
    sample step: both legs share the same v0 (restored from VZERO), so a
    discontinuity means the restore failed."""
    v = np.loadtxt(path).reshape(-1, 2)
    jump = abs(v[n_rows1, 1] - v[n_rows1 - 1, 1])
    steps = np.abs(np.diff(v[:, 1]))
    typical = np.median(steps[max(0, n_rows1 - 10):n_rows1 + 10])
    scale = float(np.abs(v[:, 1]).max())
    dt_rows = np.diff(v[:, 0])
    print(f"  {label}: VAF rows {v.shape[0]} ({n_rows1}+"
          f"{v.shape[0] - n_rows1}), splice jump {jump:.3e}, typical "
          f"step {typical:.3e}, scale {scale:.3e}")
    ok = v.shape[0] > n_rows1 + 10
    ok &= bool(np.all(dt_rows > 0))
    # exact grid since round 4: both codes stamp VAF rows at the
    # identical gate instant (one tick into the sampling MD step), and
    # the global c0 gate makes the splice interval equal every other
    # interval even when the terminal checkpoint lands past tmax
    ok &= bool(np.allclose(dt_rows, SAMPLE_FREQ * TIMESTEP,
                           atol=T_ATOL))
    ok &= jump < 5 * typical + 0.02 * scale
    return ok


def direction_a_vaf(workdir: str) -> bool:
    """Framework leg 1 with a live VAF interval -> patched reference
    binary (Zfunc re-enabled) restores Vholder from our VZERO files and
    keeps streaming VAF_interval0.dat."""
    print("direction A-vaf: framework VZERO -> reference Zfunc")
    from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                              run, _save_dir)
    base = os.path.join(workdir, "dataAV")
    cfg = CoolingConfig(n0=N0, tmax=TMAX1, sample_freq=SAMPLE_FREQ,
                        dtype="float64",
                        vaf_intervals=(TSTART_V0,), save_directory=base)
    run(cfg)
    job_dir = _save_dir(cfg)
    c0 = int(round(TMAX1 / TIMESTEP)) - 1
    vzero = np.loadtxt(os.path.join(
        job_dir, f"VZERO_timestep{c0:06d}_interval0.dat"))
    assert np.any(vzero), "framework leg wrote a zero VZERO snapshot"
    n_rows1 = np.loadtxt(os.path.join(job_dir, "VAF_interval0.dat")) \
        .reshape(-1, 2).shape[0]

    patch_source(os.path.join(workdir, "refresumev.cpp"), new_run=0,
                 c0=c0, tmax=TMAX2, save_dir="dataAV", enable_vaf=True)
    binary = compile_ref(workdir, "refresumev")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)
    return vaf_continuity(os.path.join(job_dir, "VAF_interval0.dat"),
                          n_rows1, "A-vaf")


def direction_b_vaf(workdir: str) -> bool:
    """Patched reference binary (Zfunc re-enabled) writes real VZERO at
    its checkpoint -> framework ``run(resume=True)`` restores Vholder
    (via resume_vholder on the ASCII-resume path) and keeps streaming
    the same interval.  The user-facing resume entry realigns to the
    *global* output gate (the binary's terminal c0 is one MD step past
    it), so the chained VAF rows land on the identical grid — a manual
    ``run(cfg, state=...)`` window would start a fresh local gate one
    step off it."""
    print("direction B-vaf: reference VZERO -> framework vholder restore")
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, _save_dir, run)
    patch_source(os.path.join(workdir, "reffreshv.cpp"), new_run=1, c0=0,
                 tmax=TMAX1, save_dir="dataBV", enable_vaf=True)
    binary = compile_ref(workdir, "reffreshv")
    subprocess.run([binary, "1"], cwd=workdir, check=True, timeout=1800)

    job_dirs = glob.glob(os.path.join(workdir, "dataBV", "*", "job1"))
    assert len(job_dirs) == 1, job_dirs
    src_dir = job_dirs[0]
    ions = glob.glob(os.path.join(src_dir, "ions_timestep*.dat"))
    c0 = max(int(re.search(r"(\d{6})", os.path.basename(f)).group(1))
             for f in ions)
    vzero = os.path.join(src_dir,
                         f"VZERO_timestep{c0:06d}_interval0.dat")
    assert np.any(np.loadtxt(vzero)), \
        "reference leg wrote no/zero VZERO snapshot"
    n_rows1 = np.loadtxt(os.path.join(src_dir, "VAF_interval0.dat")) \
        .reshape(-1, 2).shape[0]

    base = os.path.join(workdir, "dataBV_fw")
    cfg = CoolingConfig(n0=N0, tmax=TMAX2, sample_freq=SAMPLE_FREQ,
                        dtype="float64",
                        vaf_intervals=(TSTART_V0,), save_directory=base)
    job_dir = _save_dir(cfg)
    os.makedirs(os.path.dirname(job_dir), exist_ok=True)
    shutil.copytree(src_dir, job_dir)
    run(cfg, resume=True)
    return vaf_continuity(os.path.join(job_dir, "VAF_interval0.dat"),
                          n_rows1, "B-vaf")


def main(workdir: str = "/tmp/xval_resume") -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    ok_a = direction_a(workdir)
    ok_b = direction_b(workdir)
    ok_av = direction_a_vaf(workdir)
    ok_bv = direction_b_vaf(workdir)
    ok_c = direction_c(workdir)
    ok_d = direction_d(workdir)
    ok = ok_a and ok_b and ok_av and ok_bv and ok_c and ok_d
    print("RESUME INTEROP", "PASS" if ok else "FAIL",
          f"(A={ok_a}, B={ok_b}, A-vaf={ok_av}, B-vaf={ok_bv}, "
          f"C={ok_c}, D={ok_d})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
