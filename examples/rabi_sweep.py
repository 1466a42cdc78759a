"""Rabi-frequency (OmDP) scan of the 1033 repump — the whole scan in
ONE fused dispatch.

The reference explores laser powers the same way it explores detunings:
edit the compile-time constants ``Om``/``OmDP`` (SpeedUp.cpp:68-69) and
rebuild the binary per point, 8 h of walltime each.  Here the
Hamiltonian is *linear* in each Rabi frequency (levels.py:172-211), so
the fused kernel scales two fixed base coupling patterns by per-lane
(om, om_dp) rows (core/qt_fused.py ``per_lane_om``) and the whole scan
folds into one compiled program — each point costs one more ensemble
member.

Physics: OmDP sets the 1033 repump rate out of the D5/2 shelf.  Weak
repump piles population into D (shelving); strong repump empties it and
deepens/broadens the EIT dark state.  The steady-state D population
should fall monotonically with OmDP.

Usage: python examples/rabi_sweep.py [outdir]

Physics (seed 2): 4 OmDP points at N=2048, tmax=6; the steady-state D
population falls 0.71 -> 0.19 as OmDP goes 0.25 -> 2.0.  Wall time on
the GPU: not measured.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                          run_sweep)

OUT = sys.argv[1] if len(sys.argv) > 1 else "dataRabiScan"
OM_DP = [0.25, 0.5, 1.0, 2.0]

cfg = CoolingConfig(n0=2048, tmax=6.0, sample_freq=50, save_directory=OUT)
t0 = time.perf_counter()
final, outs, member_cfgs = run_sweep(cfg, [{"om_dp": o} for o in OM_DP],
                                     seed=2)
print(f"[sweep] {len(OM_DP)} OmDP points in one fused fold: "
      f"{time.perf_counter() - t0:.1f} s wall\n")

print(f"{'OmDP':>6s} {'S':>7s} {'P':>7s} {'D':>7s}   (steady state, "
      "last half of run)")
pops = np.asarray(outs["pops"])          # [E, T, N, 3] (per-ion)
half = pops.shape[1] // 2
for j, mcfg in enumerate(member_cfgs):
    s, p, d = pops[j, half:].mean(axis=(0, 1))
    print(f"{mcfg.om_dp:6.2f} {s:7.3f} {p:7.3f} {d:7.3f}")
d_pop = pops[:, half:, :, 2].mean(axis=(1, 2))
assert np.all(np.diff(d_pop) < 0), (
    "D-shelf population must fall monotonically with repump power: "
    f"{d_pop}")
print("\nD-shelf population falls monotonically with repump power — "
      "the 1033 repump physics, one compiled program for the scan.")
