"""The reference's full 99-job production campaign on one GPU.

The reference's production workload is a 99-way SLURM array of the
flagship N0=3500/tmax=30 cooling run, 8 h walltime and 4 OpenMP threads
per job (exampleSlurmFile.slurm:3-16; README.md:51,63), each job drawing
its own Poissonian ion count at init (SpeedUp.cpp:289-348).  This script
runs that entire campaign as one 99-member Poissonian fold on one GPU
(wall time on the GPU: not measured yet).

``checkpoint_every_segments=10`` publishes a native checkpoint every 10
samples, so a crash loses at most 10 samples of the campaign.

Usage: python tools/campaign99.py
"""
import time

import numpy as np

from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                          run_ensemble)
from mdqtplasmasims_tpu.util import enable_compilation_cache

enable_compilation_cache()

cfg = CoolingConfig(n0=3500, tmax=30.0, sample_freq=40,
                    checkpoint_every_segments=10)
t0 = time.time()
final, outs = run_ensemble(cfg, n_jobs=99, seed=7)
wall = time.time() - t0
ekx = np.asarray(outs["ekin"], np.float64)[:, :, 0]
t = np.asarray(outs["t"], np.float64)[0]
early, late = t <= 8.0, t >= 25.0
i_pk = int(np.argmax(ekx.mean(0)[early]))
ticks = 99 * cfg.n0 * int(round(cfg.tmax / cfg.timestep)) * cfg.ratio
print(f"99-job campaign: wall {wall:.0f}s, agg {ticks/wall/1e6:.0f}M "
      f"updates/s, DIH peak t={t[early][i_pk]:.2f} "
      f"EkinX={ekx.mean(0)[early][i_pk]:.3f}, cooling ratio "
      f"{ekx.mean(0)[late].mean()/ekx.mean(0)[early][i_pk]:.3f}, "
      f"job spread at t=30: {ekx[:, -1].std():.4f}")
