"""Cross-validate the frozen-start 408-LINEAR tagging variant against the
compiled reference (randomFrozenStartTag408Linear.cpp with
tools/arma_shim.hpp, shrunk to N0=256 / tstartV0=1 / tmax=2 /
sampleFreq=10; default pump det=-2.5, Om=0.7, tpump=2e-7 s).  This
exercises the 7-state *linear* coupling table (4 counter-propagating
sigma+/sigma- terms) end to end — the one coupling scheme not covered by
the 422linear and 408quad binary cross-validations.

Usage:
  1. copy the reference file somewhere writable, apply the shrink seds,
     copy arma_shim.hpp to <dir>/include/armadillo and compile:
       g++ -std=c++11 -O2 -fopenmp -I<dir>/include -o ref ref.cpp -lm
  2. ./ref 1 ; ./ref 2 ; ./ref 3
  3. python tools/cross_validate_frozen_tag408.py <data408/PumpTime.../>

Compared (3 jobs per side, ~100 tagged ions each so ~10% per-job noise):
tag fraction (spinUpIons file), first-sample tagged <vx> and <vx^2>
(taggedMoments.dat).

Round-1 result (3 reference jobs vs 3 framework seeds):
  tag fraction       ref 0.45 vs mine 0.50 (per-job spreads overlap;
                     the reference draws Poisson N, we use exact_n)
  pooled tagged <vx> ref +0.049 vs mine +0.063
  pooled tagged <vx2> ref 0.254 vs mine 0.265
"""
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def ref_job(job_dir):
    mom = np.loadtxt(os.path.join(job_dir, "taggedMoments.dat"))
    ups = int(open(glob.glob(os.path.join(
        job_dir, "spinUpIons_timestep*.dat"))[0]).read().split()[0])
    # actual (Poisson-drawn) ion count from the terminal checkpoint
    n = int(open(glob.glob(os.path.join(
        job_dir, "ions_timestep*.dat"))[0]).read().split()[0])
    return dict(vx=mom[0, 1], vx2=mom[0, 2], n_up=ups, n=n)


def main(ref_family_dir: str) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from mdqtplasmasims_tpu.experiments.frozen_tagging import (
        FrozenTagConfig, run)

    refs = [ref_job(d) for d in sorted(
        glob.glob(os.path.join(ref_family_dir, "job*")))]

    mine = []
    for seed in range(1, len(refs) + 1):
        cfg = FrozenTagConfig(variant="408linear", n0=256, tstart=1.0,
                              tmax=1.8, sample_freq=10, job=seed,
                              dtype="float64")
        final, res = run(cfg)
        up = res["spin_up"]
        # the 408linear reference writes its taggedMoments row 0 AT the
        # tag instant (output() inside the t>=tendV0 block), so compare
        # the framework's tag-instant moments, not the next sample
        m = res["out_tag"]["moments"]
        mine.append(dict(vx=float(m[0]), vx2=float(m[1]),
                         n_up=int(up.sum()), frac=float(up.mean())))

    fr = np.mean([x["n_up"] / x["n"] for x in refs])
    fm = np.mean([x["frac"] for x in mine])
    print(f"tag fraction: ref {fr:.3f} vs mine {fm:.3f} "
          f"(per-job ref {[x['n_up'] for x in refs]}, "
          f"mine {[x['n_up'] for x in mine]})")
    ok = abs(fr - fm) < 0.10

    def pooled(xs, k):
        w = np.array([x["n_up"] for x in xs], float)
        v = np.array([x[k] for x in xs])
        return float((w * v).sum() / w.sum())

    for k, tol in (("vx", 0.06), ("vx2", 0.25)):
        r, m = pooled(refs, k), pooled(mine, k)
        print(f"pooled tagged <{k}>: ref {r:+.4f} vs mine {m:+.4f}")
        ok &= abs(r - m) < tol if k == "vx" else abs(r - m) / abs(r) < tol

    print("CROSS-VALIDATION", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
