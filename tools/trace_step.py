"""Where the time of a cooling MD step goes, from a profiler trace.

Traces ``--steps`` MD steps of the flagship N0=3500 cooling loop (forces
+ ``ratio`` quantum ticks, no sampling) on the fused tick-kernel path and
on the plain XLA per-tick path, then reduces each trace to device time
per kernel name, device busy time and idle share of the traced window.
Also times the XLA pair-force refresh inside one jitted loop at several
row-chunk sizes, so per-call dispatch does not count.

Usage (on a GPU):  python tools/trace_step.py [--steps 10] [--out DIR]
Writes ``DIR/<path>/`` traces and ``DIR/summary.json``; prints tables.
"""

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mdqtplasmasims_tpu.experiments import laser_cooling as lc  # noqa: E402
from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential  # noqa
from mdqtplasmasims_tpu.units import PlasmaUnits  # noqa: E402
from mdqtplasmasims_tpu.util import enable_compilation_cache  # noqa: E402


def device_events(trace_dir: str):
    """(name, start_ns, duration_ns) of every kernel on the GPU streams."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            out += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    return out


def reduce_trace(events):
    """Kernel time by name, busy time (union of intervals) and idle share
    of the window from the first kernel start to the last kernel end."""
    by_name = defaultdict(lambda: [0.0, 0])
    spans = sorted((s, s + d) for _, s, d in events)
    for name, _, d in events:
        by_name[name][0] += d
        by_name[name][1] += 1
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = spans[-1][1] - spans[0][0]
    return by_name, busy, window


def trace_path(cfg, n_steps: int, out_dir: str):
    sched = lc.build_scheduler(cfg)
    pu = PlasmaUnits(cfg.density, cfg.ge)
    advance, _ = lc._make_advance(sched, sched.L, pu.debye_length)
    step = jax.jit(lambda s: advance(s, n_steps))
    state = lc.initial_state(cfg)
    jax.block_until_ready(step(state))
    t0 = time.perf_counter()
    jax.block_until_ready(step(state))
    wall = time.perf_counter() - t0
    with jax.profiler.trace(out_dir):
        jax.block_until_ready(step(state))
    by_name, busy, window = reduce_trace(device_events(out_dir))
    ticks = n_steps * cfg.ratio
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "wall_us_per_tick": wall / ticks * 1e6,
        "device_busy_us_per_tick": busy / 1e3 / ticks,
        "idle_share": 1.0 - busy / window,
        "kernels_per_tick": sum(c for _, c in by_name.values()) / ticks,
        "top_kernels_us_per_md_step": [
            (name, t / 1e3 / n_steps, c / n_steps) for name, (t, c) in top],
    }


def force_loop_ms(n: int, chunk: int, cfg, reps: int = 20) -> float:
    """XLA force refresh time inside one jitted loop of ``reps``."""
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(n)
    R0 = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), jnp.float32, 0,
                            L)

    @jax.jit
    def loop(R):
        def body(i, acc):
            F, _ = yukawa_forces_potential(R + acc * 0.0, L,
                                           pu.debye_length, chunk=chunk)
            return acc + F
        return jax.lax.fori_loop(0, reps, body, jnp.zeros_like(R))
    jax.block_until_ready(loop(R0))
    t0 = time.perf_counter()
    jax.block_until_ready(loop(R0))
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args()
    enable_compilation_cache()
    print("device:", jax.devices()[0].device_kind, flush=True)
    cfg = lc.canonical_run_cfg(lc.CoolingConfig(n0=3500))
    summary = {}
    for name, c in (("fused", cfg),
                    ("xla", dataclasses.replace(cfg, fused=False))):
        r = trace_path(c, args.steps, os.path.join(args.out, name))
        summary[name] = r
        print(f"== {name}: wall {r['wall_us_per_tick']:.3f} us/tick, "
              f"device busy {r['device_busy_us_per_tick']:.3f} us/tick, "
              f"idle {r['idle_share']:.3f}, kernels/tick "
              f"{r['kernels_per_tick']:.1f}", flush=True)
        for kname, us, cnt in r["top_kernels_us_per_md_step"]:
            print(f"   {us:10.2f} us/step  x{cnt:6.1f}  {kname[:90]}")
    summary["force_ms"] = {}
    for n in (3500, 14000):
        for chunk in (512, 1024, 4096):
            ms = force_loop_ms(n, chunk, cfg)
            summary["force_ms"][f"n{n}_chunk{chunk}"] = ms
            print(f"forces N={n} chunk={chunk}: {ms:.4f} ms/refresh "
                  "(in-loop)", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
