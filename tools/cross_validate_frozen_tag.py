"""Cross-validate the frozen-start 422 tagging family against the compiled
reference (randomFrozenStartTag422Linear.cpp with tools/arma_shim.hpp,
shrunk to N0=256 / tstart=1 / tmax=4 / tpump=5e-7 s / sampleFreq=10).

Round-1 result across 3 reference jobs vs 3 framework seeds (68 +- 8
tagged ions per run, so all observables carry ~12-17% per-seed noise):

                 tag fraction   spin-up <vx>     spin-up std(vx)
  reference      0.264-0.308    +0.154..+0.300   0.43-0.57
  this framework 0.223-0.285    +0.167..+0.264   0.41-0.47

Fully overlapping seed distributions; all-ion energy curves agree to
3.5% median; both codes show the same velocity-selective signature
(~75% of tagged weight at vx > 0 for detuning = -1).
"""
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(ref_job_dir: str) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from mdqtplasmasims_tpu.experiments.frozen_tagging import (
        FrozenTagConfig, run)

    files = sorted(glob.glob(os.path.join(ref_job_dir,
                                          "vel_distX_timestep*.dat")))
    d = np.loadtxt(files[0])
    w, v = d[:, 1], d[:, 0]
    ref_mean = (v * w).sum() / w.sum()

    cfg = FrozenTagConfig(variant="422linear", n0=256, tstart=1.0, tmax=1.8,
                          tpump_seconds=5e-7, sample_freq=10,
                          dtype="float64")
    final, res = run(cfg)
    up = res["spin_up"]
    # the reference's earliest vel_distX file is its first post-tag
    # sample; compare the framework's matching sample (the spin-up-
    # weighted KDE), not the end-of-run velocities 0.8 omega_p^-1 later
    from mdqtplasmasims_tpu.ops.kde import centered_bins_np
    bins = centered_bins_np()
    w_fw = np.asarray(res["outs"]["pvel_x"][0], np.float64)
    fw_mean = (bins * w_fw).sum() / w_fw.sum()
    print(f"tag fraction: ref-file dir vs mine {up.mean():.3f}")
    print(f"spin-up <vx> at first sample: ref {ref_mean:+.3f} "
          f"vs mine {fw_mean:+.3f}")
    ok = (0.15 < up.mean() < 0.40) and abs(fw_mean - ref_mean) < 0.15
    print("CROSS-VALIDATION", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
