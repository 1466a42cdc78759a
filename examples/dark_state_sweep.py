"""Reproduce the thesis-4.5 dark-state observable with a detuning sweep
— the whole sweep in ONE fused dispatch.

The reference README's analysis recipe (README.md:110-118): bin the P
population of ``statePopulationsVsVTime*.dat`` against ion velocity;
dips mark dark states, sitting at the two-photon resonance
v_res = (detDP - detSP)/(1 + kRat).  The reference needs an 8 h job —
and a fresh *compile* of the binary — per detuning point; here the
grid folds into one compiled program (``run_sweep``: per-lane diagonal
energies in the fused kernel, so each point costs one more ensemble
member), writing the same per-point .dat trees, and the profiles come
from ``mdqtplasmasims_tpu.analysis.state_population_profile``.

Usage: python examples/dark_state_sweep.py [outdir]

Typical output (seed 1): dips at 1.47 / 1.22 / 1.22 gamma/k for
predictions 1.43 / 1.08 / 1.08 — the dip tracks the two-photon
detuning, riding ~0.1 high on the thermal-tail slope at this run
length.  Wall time on the GPU: not measured.
"""
import glob
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mdqtplasmasims_tpu.analysis import state_population_profile
from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                          build_engine,
                                                          run_sweep)
from mdqtplasmasims_tpu.units import K_RATIO_1033

OUT = sys.argv[1] if len(sys.argv) > 1 else "dataDarkState"
SWEEP = [(-1.0, 1.0), (-0.5, 1.0), (-1.0, 0.5)]   # (detSP, detDP) gamma


def nearest_local_dip(centers, prof, v_res, window=0.45):
    """Strict local minima of the P(v) profile near the predicted
    resonance (a plain argmin would catch the thermal-tail falloff)."""
    ok = np.isfinite(prof)
    dips = [i for i in range(1, len(prof) - 1)
            if ok[i - 1] and ok[i] and ok[i + 1]
            and prof[i] < prof[i - 1] and prof[i] < prof[i + 1]
            and abs(centers[i] - v_res) <= window]
    return min(dips, key=lambda i: abs(centers[i] - v_res), default=None)


cfg = CoolingConfig(n0=2048, tmax=6.0, sample_freq=50, save_directory=OUT)
t0 = time.perf_counter()
final, outs, member_cfgs = run_sweep(cfg, SWEEP, seed=1)
print(f"[sweep] {len(SWEEP)} detuning points in one fused fold: "
      f"{time.perf_counter() - t0:.1f} s wall\n")

print(f"{'detSP':>6s} {'detDP':>6s} {'v_res (pred)':>12s} "
      f"{'v_dip (meas)':>12s} {'depth':>6s}")
for mcfg in member_cfgs:
    det_sp, det_dp = mcfg.detuning, mcfg.detuning_dp
    p2q = build_engine(mcfg).plas_to_quant_vel
    job = sorted(glob.glob(os.path.join(
        OUT, "*DetSP%i*DetDP%i*" % (round(det_sp * 100),
                                    round(det_dp * 100)),
        f"job{mcfg.job}")))[-1]
    # pool the second half of the run — pumping is in steady state
    centers, prof = state_population_profile(job, vel_scale=p2q,
                                             last_k=30, nbins=40,
                                             vmax=2.5)
    v_res = abs(det_dp - det_sp) / (1.0 + K_RATIO_1033)
    i = nearest_local_dip(centers, prof, v_res)
    if i is None:
        print(f"{det_sp:6.2f} {det_dp:6.2f} {v_res:12.3f} "
              f"{'(no local dip)':>12s}")
        continue
    depth = prof[i] / max(prof[i - 1], prof[i + 1])
    print(f"{det_sp:6.2f} {det_dp:6.2f} {v_res:12.3f} "
          f"{centers[i]:12.3f} {depth:6.2f}")
print("(v in gamma/k units; depth = P(v_dip)/max(neighbor bins), "
      "< 1 means a dark-state dip)")
