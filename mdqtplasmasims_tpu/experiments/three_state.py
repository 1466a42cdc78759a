"""QT-only toy: 3-level laser cooling of free (non-interacting) ions.

JAX re-expression of laserCoolNoPlasmaThreeState.cpp: N0 ions with
MB velocities at ``temperature`` K, ground-state wavefunctions, evolved by
the 3-state QT engine with counter-propagating beams along x (recoil kicks
applied when ``apply_force``).  No Coulomb forces; time is in 1/gamma units
(dt = 0.01).  Output: mean x kinetic energy every ``sample_freq`` ticks
(energies.dat: t, EkinX — reference output(), lines 296-347).

This is the minimum end-to-end slice and the Doppler-limit validation
vehicle (SURVEY.md 3.5).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.qt import QTEngine
from ..io.datfiles import DatWriter
from ..io.dirs import three_state_dir
from ..levels import three_state
from ..units import SQRT_KELVIN_TO_PLASMA_VEL


@dataclasses.dataclass(frozen=True)
class ThreeStateConfig:
    n0: int = 1000
    detuning: float = -0.5
    om: float = 0.5
    temperature_k: float = 0.01
    tmax: float = 45000.0
    dt: float = 0.01
    sample_freq: int = 1000
    apply_force: bool = True
    vkick: float = 0.0012076       # laserCoolNoPlasmaThreeState.cpp:88
    dispatch_segments: int = 500   # segments per compiled dispatch
    job: int = 1
    dtype: str = "float32"
    save_directory: Optional[str] = None

    @property
    def np_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


def build_engine(cfg: ThreeStateConfig) -> QTEngine:
    return QTEngine(three_state(cfg.detuning, cfg.om, cfg.vkick),
                    h=cfg.dt, dt_plasma=cfg.dt, plas_to_quant_vel=1.0,
                    gamma_to_einstein=1.0, apply_force=cfg.apply_force)


@partial(jax.jit, static_argnames=("cfg", "n_segments"))
def run_compiled(cfg: ThreeStateConfig, V, psi, t_part, key,
                 n_segments: int, qt_params=None, force_scale=None):
    """``qt_params``/``force_scale`` override the Hamiltonian with traced
    per-member (detuning, om) tables and scale the om-linear Ehrenfest
    kick (run_sweep); None takes cfg's static scheme."""
    eng = build_engine(cfg)

    def tick(c, _):
        V, psi, tp, key = c
        key, sub = jax.random.split(key)
        psi, vx, tp = eng.step(psi, V[:, 0], tp, sub, params=qt_params,
                               force_scale=force_scale)
        V = V.at[:, 0].set(vx)
        return (V, psi, tp, key), None

    def segment(c, _):
        c, _ = jax.lax.scan(tick, c, None, length=cfg.sample_freq)
        V = c[0]
        return c, jnp.stack([jnp.mean(0.5 * V[:, 0] ** 2),
                             jnp.mean(jnp.abs(c[1][:, 0]) ** 2)])

    (V, psi, t_part, key), recs = jax.lax.scan(
        segment, (V, psi, t_part, key), None, length=n_segments)
    return (V, psi, t_part, key), recs


def run(cfg: ThreeStateConfig, seed: Optional[int] = None):
    key = jax.random.PRNGKey(cfg.job if seed is None else seed)
    kv, krun = jax.random.split(key)
    sigma = SQRT_KELVIN_TO_PLASMA_VEL * np.sqrt(cfg.temperature_k)
    V = jax.random.normal(kv, (cfg.n0, 3), cfg.np_dtype) * jnp.asarray(
        sigma, cfg.np_dtype)
    cdt = jnp.complex128 if cfg.dtype == "float64" else jnp.complex64
    psi = jax.jit(lambda: jnp.zeros((cfg.n0, 3), cdt).at[:, 0].set(1.0))()
    t_part = jnp.zeros((cfg.n0,), cfg.np_dtype)

    n_segments = int(cfg.tmax / cfg.dt) // cfg.sample_freq
    # job/save_directory don't affect the traced program — strip them so
    # sequential jobs (cli --jobs) share one compiled program
    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    # Run fixed-length groups of segments with the carry staying on
    # device and fetch once at the end: the scan length is then a
    # property of the group, not of tmax, so runs of any length share one
    # compiled program (plus at most one remainder-length program).
    group = min(cfg.dispatch_segments or n_segments, n_segments)
    carry, rec_groups = (V, psi, t_part, krun), []
    done = 0
    while done < n_segments:
        g = min(group, n_segments - done)
        carry, recs_g = run_compiled(cfg_run, *carry, g)
        rec_groups.append(recs_g)
        done += g
    V = carry[0]
    jax.block_until_ready(V)
    recs = (np.concatenate([np.asarray(jax.device_get(r))
                            for r in rec_groups])
            if rec_groups else np.zeros((0, 2)))
    t_axis = (np.arange(1, n_segments + 1) * cfg.sample_freq) * cfg.dt
    results = dict(t=t_axis, ekin_x=recs[:, 0], ground_pop=recs[:, 1],
                   V=np.asarray(jax.device_get(V)))

    if cfg.save_directory is not None:
        d = three_state_dir(cfg.save_directory, om=cfg.om,
                            detuning=cfg.detuning, n0=cfg.n0,
                            temperature_k=cfg.temperature_k, job=cfg.job)
        w = DatWriter(d)
        w.append("energies.dat", np.stack([t_axis, recs[:, 0]], -1))
    return results


def run_ensemble(cfg: ThreeStateConfig, n_jobs: int, seed: int = 0,
                 mesh=None):
    """Batched job array for the QT-only toy: per-job (V, psi, t_part,
    key) carries vmap over the job axis through the same grouped-dispatch
    loop as run() (ions are already independent, so this is one bigger
    QT program with per-job output rows).  Writes each job's
    energies.dat; returns the stacked results dict.  ``mesh`` spreads
    jobs over the mesh's ``ens`` devices."""
    base_keys = jax.random.split(jax.random.PRNGKey(seed), n_jobs)
    sigma = SQRT_KELVIN_TO_PLASMA_VEL * np.sqrt(cfg.temperature_k)
    cdt = jnp.complex128 if cfg.dtype == "float64" else jnp.complex64

    @jax.jit
    def init_one(key):
        kv, krun = jax.random.split(key)
        V = jax.random.normal(kv, (cfg.n0, 3), cfg.np_dtype) * jnp.asarray(
            sigma, cfg.np_dtype)
        psi = jnp.zeros((cfg.n0, 3), cdt).at[:, 0].set(1.0)
        return V, psi, jnp.zeros((cfg.n0,), cfg.np_dtype), krun

    carry = jax.vmap(init_one)(base_keys)
    n_segments = int(cfg.tmax / cfg.dt) // cfg.sample_freq
    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    group = min(cfg.dispatch_segments or n_segments, n_segments)
    rec_groups, done = [], 0

    def make_step(g):
        fn = jax.vmap(lambda V, psi, tp, k: run_compiled(
            cfg_run, V, psi, tp, k, g))
        if mesh is not None:
            from ..parallel.ensemble import member_sharded
            fn = member_sharded(fn, mesh)
        return fn

    steps = {}   # at most two distinct group lengths -> two programs
    while done < n_segments:
        g = min(group, n_segments - done)
        if g not in steps:
            steps[g] = make_step(g)
        carry, recs_g = steps[g](*carry)
        rec_groups.append(recs_g)
        done += g
    jax.block_until_ready(carry[0])
    recs = np.concatenate([np.asarray(jax.device_get(r))
                           for r in rec_groups], axis=1)   # [E, S, 2]
    t_axis = (np.arange(1, n_segments + 1) * cfg.sample_freq) * cfg.dt
    results = dict(t=t_axis, ekin_x=recs[:, :, 0],
                   ground_pop=recs[:, :, 1],
                   V=np.asarray(jax.device_get(carry[0])))
    if cfg.save_directory is not None:
        for j in range(n_jobs):
            d = three_state_dir(cfg.save_directory, om=cfg.om,
                                detuning=cfg.detuning, n0=cfg.n0,
                                temperature_k=cfg.temperature_k,
                                job=j + 1)
            w = DatWriter(d)
            w.append("energies.dat",
                     np.stack([t_axis, recs[j, :, 0]], -1))
    return results


def run_sweep(cfg: ThreeStateConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None):
    """Run a laser (detuning, om) grid as ONE batched QT program.

    The reference compiles detuning/Om into the binary
    (laserCoolNoPlasmaThreeState.cpp:85-87) and rebuilds per point — e.g.
    a Doppler-limit-vs-detuning curve costs one build+run each.  Here the
    toy Hamiltonian is linear in both knobs, so each member carries its
    own traced QTParams (core/qt.sweep_qt_params) and an om force scale
    (the Ehrenfest kick is om-linear; jump recoils are fixed at vkick)
    through the vmapped tick loop.

    ``points``: dicts with keys among ``detuning``/``om``.
    ``jobs_per_point`` replicates each point with independent seeds;
    member order is point-major.  Writes each member's energies.dat under
    its own Om/detuning-encoded directory.  Returns ``(results,
    member_cfgs)`` with results as in run_ensemble (row-stacked)."""
    from ..core.qt import sweep_member_params
    cdt = jnp.complex128 if cfg.dtype == "float64" else jnp.complex64
    rdtype = cfg.np_dtype
    member_cfgs, params = sweep_member_params(
        cfg, points, jobs_per_point, three_state(1.0, 1.0, cfg.vkick),
        rdtype, cdt)
    n_members = len(member_cfgs)
    base_keys = jax.random.split(jax.random.PRNGKey(seed), n_members)
    sigma = SQRT_KELVIN_TO_PLASMA_VEL * np.sqrt(cfg.temperature_k)

    @jax.jit
    def init_one(key):
        kv, krun = jax.random.split(key)
        V = jax.random.normal(kv, (cfg.n0, 3), rdtype) * jnp.asarray(
            sigma, rdtype)
        psi = jnp.zeros((cfg.n0, 3), cdt).at[:, 0].set(1.0)
        return V, psi, jnp.zeros((cfg.n0,), rdtype), krun

    carry = jax.vmap(init_one)(base_keys)
    n_segments = int(cfg.tmax / cfg.dt) // cfg.sample_freq
    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    group = min(cfg.dispatch_segments or n_segments, n_segments)
    rec_groups, done = [], 0
    # the engine's static scheme bakes force_w = vkick*cfg.om; scale it
    # to each member's om (e0/coupling come absolute from qt_params)
    if cfg.om == 0.0 and any(m.om != 0.0 for m in member_cfgs):
        raise ValueError("om sweep needs a nonzero cfg.om base "
                         "(force_w scales relative to it)")
    oms = jnp.asarray([m.om for m in member_cfgs], rdtype)
    fscales = oms / jnp.asarray(cfg.om if cfg.om != 0.0 else 1.0, rdtype)

    def make_step(g):
        fn = jax.vmap(lambda V, psi, tp, k, p, fs: run_compiled(
            cfg_run, V, psi, tp, k, g, qt_params=p, force_scale=fs))
        if mesh is not None:
            from ..parallel.ensemble import member_sharded
            fn = member_sharded(fn, mesh)
        return fn

    steps = {}
    while done < n_segments:
        g = min(group, n_segments - done)
        if g not in steps:
            steps[g] = make_step(g)
        carry, recs_g = steps[g](*carry, params, fscales)
        rec_groups.append(recs_g)
        done += g
    jax.block_until_ready(carry[0])
    recs = np.concatenate([np.asarray(jax.device_get(r))
                           for r in rec_groups], axis=1)   # [E, S, 2]
    t_axis = (np.arange(1, n_segments + 1) * cfg.sample_freq) * cfg.dt
    results = dict(t=t_axis, ekin_x=recs[:, :, 0],
                   ground_pop=recs[:, :, 1],
                   V=np.asarray(jax.device_get(carry[0])))
    for j, mcfg in enumerate(member_cfgs):
        if mcfg.save_directory is not None:
            d = three_state_dir(mcfg.save_directory, om=mcfg.om,
                                detuning=mcfg.detuning, n0=mcfg.n0,
                                temperature_k=mcfg.temperature_k,
                                job=mcfg.job)
            w = DatWriter(d)
            w.append("energies.dat",
                     np.stack([t_axis, recs[j, :, 0]], -1))
    return results, member_cfgs


def doppler_limit_ekin(detuning: float, om: float = 0.0) -> float:
    """Textbook Doppler-limit x kinetic energy (in gamma/k velocity units):
    T_D = (hbar*gamma/4)(1/|2 det| + |2 det|)/ ... expressed directly as
    <v_x^2>/2 for recoil 0.0012076 and unit gamma.  Used as a sanity scale,
    not an exact target (the 3-level scheme differs O(1) from two-level)."""
    g = 1.0
    d = abs(detuning)
    # standard result: kB T = hbar g/4 * (1 + (2d/g)^2)/(2d/g)
    kbt = 0.25 * (1.0 + (2 * d) ** 2) / (2 * d)   # in hbar*gamma
    # v^2 = kB T / m -> in (gamma/k)^2 units: kbt * (recoil vkick)
    return 0.5 * kbt * 0.0012076
