"""Benchmark of the flagship cooling run on one GPU, in one process.

Measures, at the reference's north-star configuration (N0=3500, density 2,
Ge 0.1, 12-level Sr+ scheme, ratio=25 quantum ticks per MD step):

* µs per quantum tick of ``run_compiled`` over whole sampling segments
  (forces, ticks and on-device sampling), for the fused tick-block kernel
  and for the plain XLA per-tick path (``CoolingConfig(fused=False)``),
  one trajectory and an 8-member ensemble;
* µs per tick of the fused MD loop alone for each kernel block size
  (``--blocks``), the tuning behind ``qt_fused.DEFAULT_BLOCK``;
* the XLA pair-force time per refresh at N=3500 and N=14000, and its
  share of one MD step.

Errors propagate; there is no CPU fallback.  Prints the device (platform,
device_kind, count, and the card's name and power limit), one line per
measurement, and one JSON object as the last line.

Usage: python bench.py [--segments 5] [--blocks 32,64,128,256]
"""

import argparse
import dataclasses
import json
import subprocess
import time

import jax
import jax.numpy as jnp

from mdqtplasmasims_tpu.experiments import laser_cooling as lc
from mdqtplasmasims_tpu.ops.yukawa import best_forces_fn
from mdqtplasmasims_tpu.units import PlasmaUnits
from mdqtplasmasims_tpu.util import enable_compilation_cache

N0 = 3500


def best_time(fn, reps: int = 5) -> float:
    """Seconds of the fastest of ``reps`` calls after one warm-up call;
    ``fn`` must return device arrays (timed through block_until_ready)."""
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def e2e_us_per_tick(cfg, n_seg: int, n_jobs: int) -> float:
    """run_compiled (or the ensemble runner) over ``n_seg`` segments."""
    ticks = n_seg * cfg.sample_freq * cfg.ratio
    if n_jobs == 1:
        state = lc.initial_state(cfg)
        secs = best_time(lambda: lc.run_compiled(cfg, state, n_seg))
    else:
        keys = jax.random.split(jax.random.PRNGKey(0), n_jobs)
        states = jax.jit(jax.vmap(
            lambda k: lc._initial_state_from_key(cfg, k)))(keys)
        secs = best_time(lambda: lc.run_compiled_ensemble(cfg, states,
                                                          n_seg))
    return secs / ticks * 1e6


def block_us_per_tick(cfg, block: int, n_steps: int) -> float:
    """The fused MD loop alone (forces + tick kernel) at one block size."""
    sched = dataclasses.replace(lc.build_scheduler(cfg), block=block)
    pu = PlasmaUnits(cfg.density, cfg.ge)
    advance, _ = lc._make_advance(sched, sched.L, pu.debye_length)
    step = jax.jit(lambda s: advance(s, n_steps))
    state = lc.initial_state(cfg)
    return best_time(lambda: step(state)) / (n_steps * cfg.ratio) * 1e6


def force_ms(n: int, cfg, reps: int = 20) -> float:
    """XLA pair-force refresh at ``n`` ions, timed inside one jitted loop
    of ``reps`` refreshes so per-call dispatch does not count."""
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(n)
    R = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), jnp.float32, 0, L)
    forces = best_forces_fn(n, L, pu.debye_length)

    @jax.jit
    def loop(R):
        # the carry feeds back so the refreshes cannot be merged
        return jax.lax.fori_loop(
            0, reps, lambda i, acc: acc + forces(R + 0.0 * acc)[0],
            jnp.zeros_like(R))
    return best_time(lambda: loop(R)) / reps * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--segments", type=int, default=5)
    ap.add_argument("--blocks", default="32,64,128,256")
    args = ap.parse_args()

    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench needs a GPU, JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    print(f"device: {json.dumps(device)}", flush=True)

    cfg = lc.canonical_run_cfg(lc.CoolingConfig(n0=N0))
    xla = dataclasses.replace(cfg, fused=False)
    res = {}
    for name, c, jobs in (("fused_1", cfg, 1), ("xla_1", xla, 1),
                          ("fused_8", cfg, 8), ("xla_8", xla, 8)):
        res[f"us_per_tick_{name}"] = e2e_us_per_tick(c, args.segments,
                                                     jobs)
        print(f"{name}: {res[f'us_per_tick_{name}']:.3f} us/tick "
              "(run_compiled, sampling included)", flush=True)
    for b in (int(x) for x in args.blocks.split(",")):
        res[f"loop_us_per_tick_block{b}"] = block_us_per_tick(cfg, b, 40)
        print(f"block {b}: {res[f'loop_us_per_tick_block{b}']:.3f} us/tick "
              "(fused MD loop, forces included)", flush=True)
    for n in (N0, 4 * N0):
        res[f"force_ms_n{n}"] = force_ms(n, cfg)
        print(f"forces N={n}: {res[f'force_ms_n{n}']:.4f} ms/refresh",
              flush=True)
    step_us = res["us_per_tick_fused_1"] * cfg.ratio
    res["force_share_of_md_step_fused_1"] = (
        res[f"force_ms_n{N0}"] * 1e3 / step_us)
    print(json.dumps({"device": device, "config": "N0=3500 density=2 "
                      "Ge=0.1 ratio=25 f32", **res}))


if __name__ == "__main__":
    main()
