"""MC-equilibrated quantum-trajectory velocity tagging.

JAX re-expression of MonteCarloFollowedByQTTagging{408Linear,
408Quad,422Linear}.cpp (call stack SURVEY.md 3.3): cubic lattice + MB
velocities + random S-superposition wavefunctions, Metropolis MC anneal,
collisional velocity-Verlet MD, then an optical-pumping phase (``ratio``
qsteps then one MD step, per pump MD step), a projective tag, and a
collisionless recording phase emitting tagged moments + tagged KDE velocity
distribution, g(r), temperature and the stored-velocity autocorrelation
suite.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.init import lattice_init
from ..core.mc import MetropolisMC
from ..core.qt import QTEngine, random_s_superposition
from ..core.scheduler import MCTagScheduler
from ..core.tagging import (spin_up_probability_408, spin_up_probability_422,
                            tagged_moments)
from ..core.thermostat import collide_and_kick, temperature
from ..core.md import wrap_pbc
from ..io.datfiles import DatWriter
from ..io.dirs import mc_tag_dir
from ..levels import DECAY_RATIO_422_MC, tag408, tag422
from ..ops.correlations import autocorr_suite
from ..ops.kde import centered_bins, centered_bins_np, gaussian_kde
from ..ops.structure import pair_correlation

from ..state import make_state
from ..units import (QTUnits, GAMMA422_FACTOR, K422_FACTOR,
                     pump_window_einstein)

VARIANT_DEFAULTS = {  # (tpump_seconds, detuning, om) per reference file
    "408linear": (2e-7, -2.5, 0.7),
    "408quad": (1e-7, 0.0, 2.0),
    "422linear": (5e-8, -1.0, 1.3),
}


@dataclasses.dataclass(frozen=True)
class MCTagConfig:
    variant: str = "408quad"
    n: int = 4096                 # perfect cube
    kappa: float = 0.5
    gamma: float = 3.0
    density: float = 2.0
    tpump_seconds: Optional[float] = None
    detuning: Optional[float] = None
    om: Optional[float] = None
    mc_steps: int = 100_000
    mc_chunk_steps: int = 10_000   # Metropolis dispatch/checkpoint chunk
    pre_record_md_steps: int = 200
    record_steps: int = 1500
    collision_freq: float = 0.25
    timestep: float = 0.005
    gr_every_record: int = 100
    # crash checkpointing (native-only; the reference's writeConditions
    # never appears in the MC-tagging programs — SURVEY.md §5).  >0 =
    # publish a pipeline checkpoint every K MC/record chunks, through
    # the pump window, and at every stage boundary (needs
    # save_directory); 0 = off.
    checkpoint_every_chunks: int = 0
    job: int = 1
    dtype: str = "float32"
    dist_every: int = 1           # reference writes vel_dist every step
    save_directory: Optional[str] = None

    def __post_init__(self):
        assert self.variant in VARIANT_DEFAULTS
        d = VARIANT_DEFAULTS[self.variant]
        if self.tpump_seconds is None:
            object.__setattr__(self, "tpump_seconds", d[0])
        if self.detuning is None:
            object.__setattr__(self, "detuning", d[1])
        if self.om is None:
            object.__setattr__(self, "om", d[2])

    @property
    def is_422(self) -> bool:
        return self.variant == "422linear"

    @property
    def units(self) -> QTUnits:
        return QTUnits(self.density,
                       gamma_factor=GAMMA422_FACTOR if self.is_422 else 1.0,
                       k_factor=K422_FACTOR if self.is_422 else 1.0)

    @property
    def ratio(self) -> int:
        # round(87*gamma_factor/sqrt(n)): 408Quad.cpp:111, 422Linear.cpp:116
        return self.units.ratio_mc_tagging()

    @property
    def qdt(self) -> float:
        return self.timestep / self.ratio

    @property
    def pump_md_steps(self) -> int:
        tpump = pump_window_einstein(self.tpump_seconds, self.density)
        return int(round(tpump / self.timestep))

    @property
    def n_states(self) -> int:
        return 5 if self.is_422 else 7

    @property
    def L(self) -> float:
        return (self.n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)

    @property
    def np_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32

    def scheme(self):
        if self.is_422:
            return tag422(self.detuning, self.om,
                          decay_ratio=DECAY_RATIO_422_MC)
        return tag408(self.detuning, self.om,
                      linear=(self.variant == "408linear"))

    def scheme_unit(self):
        """The variant's scheme at detuning=om=1 — the base pattern that
        sweep folds scale per member (core/qt.sweep_qt_params)."""
        if self.is_422:
            return tag422(1.0, 1.0, decay_ratio=DECAY_RATIO_422_MC)
        return tag408(1.0, 1.0, linear=(self.variant == "408linear"))

    def spin_up_probability(self, psi):
        return (spin_up_probability_422(psi) if self.is_422
                else spin_up_probability_408(psi))


def _forces(cfg: MCTagConfig):
    """R -> (F, pot): XLA pair forces (ops/yukawa.best_forces_fn)."""
    from ..ops.yukawa import best_forces_fn
    return best_forces_fn(cfg.n, cfg.L, 1.0 / cfg.kappa)


@partial(jax.jit, static_argnames=("cfg", "n_steps", "collision_freq"))
def md_phase(cfg: MCTagConfig, R, V, A, key, n_steps: int,
             collision_freq: float):
    forces = _forces(cfg)
    dt = cfg.timestep

    def step(carry, _):
        R, V, A, key = carry
        key, kc = jax.random.split(key)
        R = wrap_pbc(R + dt * V + 0.5 * dt * dt * A, cfg.L)
        A_new = forces(R)[0]
        V_verlet = V + 0.5 * dt * (A + A_new)
        V = collide_and_kick(V_verlet, kc, dt=dt,
                             collision_freq=collision_freq, gamma=cfg.gamma)
        return (R, V, A_new, key), None

    return jax.lax.scan(step, (R, V, A, key), None, length=n_steps)[0]


def _make_scheduler(cfg: MCTagConfig, qt_params=None) -> MCTagScheduler:
    u = cfg.units
    engine = QTEngine(cfg.scheme(), h=cfg.qdt * u.gamma_to_einstein,
                      dt_plasma=cfg.qdt,
                      plas_to_quant_vel=u.plas_to_quant_vel,
                      gamma_to_einstein=u.gamma_to_einstein,
                      apply_force=False)
    return MCTagScheduler(engine=engine, forces_fn=_forces(cfg), L=cfg.L,
                          dt=cfg.timestep, ratio=cfg.ratio,
                          qt_params=qt_params)


@partial(jax.jit, static_argnames=("cfg",))
def pump_phase(cfg: MCTagConfig, R, V, A, psi, t_part, key,
               qt_params=None):
    """pumpMDTimeSteps x [ratio qsteps; MDStep]
    (MonteCarlo...408Quad.cpp:1230-1235).  ``qt_params`` overrides the
    pump Hamiltonian with traced per-member (detuning, om) tables
    (run_sweep)."""
    sched = _make_scheduler(cfg, qt_params)
    state = make_state(R, V, psi, key, dtype=cfg.np_dtype)
    state = state._replace(F=A, t_part=t_part)
    state = jax.lax.fori_loop(0, cfg.pump_md_steps,
                              lambda i, s: sched.md_step(s), state)
    return state


@partial(jax.jit, static_argnames=("cfg", "n_md_steps"))
def _pump_chunk(cfg: MCTagConfig, state, n_md_steps: int):
    """``n_md_steps`` pump MD steps on a live SimState.  Chunk boundaries
    are numerics-invariant (the RNG rides in state.key), so the resumable
    runner can cut the pump window anywhere without changing the run."""
    sched = _make_scheduler(cfg)
    return jax.lax.fori_loop(0, n_md_steps,
                             lambda i, s: sched.md_step(s), state)


def _make_record_chunk(cfg: MCTagConfig):
    """One ``gr_every_record``-step recording chunk — g(r) of the incoming
    configuration, then per step: tagged moments + tagged KDE distribution
    + temperature before the MD step, velocity storage after it.  Shared
    by the scanned phase (vmapped folds) and the host-chunked resumable
    runner so both paths dispatch the same math."""
    forces = _forces(cfg)
    dt = cfg.timestep
    bins = centered_bins(cfg.np_dtype)

    def chunk(carry, tags):
        w = tags.astype(cfg.np_dtype)

        def body(carry, _):
            R, V, A, key = carry
            moments = tagged_moments(V[:, 0], tags)
            dist = gaussian_kde(V[:, 0], bins, folded=False, weights=w)
            temp = temperature(V)
            R = wrap_pbc(R + dt * V + 0.5 * dt * dt * A, cfg.L)
            A_new = forces(R)[0]
            V = V + 0.5 * dt * (A + A_new)
            return (R, V, A_new, key), (moments, dist, temp, V)

        g = pair_correlation(carry[0], cfg.L)
        carry, recs = jax.lax.scan(body, carry, None,
                                   length=cfg.gr_every_record)
        return carry, (g,) + recs

    return chunk


_record_chunk = partial(jax.jit, static_argnames=("cfg",))(
    lambda cfg, R, V, A, key, tags:
    _make_record_chunk(cfg)((R, V, A, key), tags))


@partial(jax.jit, static_argnames=("cfg",))
def record_phase(cfg: MCTagConfig, R, V, A, key, tags):
    """Collisionless recording: tagged moments + tagged KDE dist before the
    step, velocity storage after, g(r) per chunk."""
    assert cfg.record_steps % cfg.gr_every_record == 0
    n_chunks = cfg.record_steps // cfg.gr_every_record
    chunk = _make_record_chunk(cfg)

    carry, (grs, moments, dists, temps, vstore) = jax.lax.scan(
        lambda c, _: chunk(c, tags), (R, V, A, key), None,
        length=n_chunks)
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    return carry, grs, flat(moments), flat(dists), flat(temps), flat(vstore)


def _mc_scan(cfg: MCTagConfig, R, k_mc):
    """Chunked Metropolis anneal (``mc_chunk_steps`` per chunk, one
    pre-split key each) — the fixed chunk grid both the single-job runner
    (host-dispatched, checkpointable mid-anneal) and the vmapped fold
    (scanned) share, so their streams match."""
    n_chunks = max(1, cfg.mc_steps // cfg.mc_chunk_steps)
    mc = MetropolisMC(L=cfg.L, ldeb=1.0 / cfg.kappa, gamma=cfg.gamma)

    def chunk(carry, k):
        R, n_acc = carry
        R, acc = mc.run(R, k, cfg.mc_steps // n_chunks)
        return (R, n_acc + acc), None

    (R, n_acc), _ = jax.lax.scan(chunk, (R, jnp.zeros((), jnp.int32)),
                                 jax.random.split(k_mc, n_chunks))
    return R, n_acc


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def _mc_chunk(cfg: MCTagConfig, R, key, n_steps: int):
    mc = MetropolisMC(L=cfg.L, ldeb=1.0 / cfg.kappa, gamma=cfg.gamma)
    return mc.run(R, key, n_steps)


def run(cfg: MCTagConfig, seed: Optional[int] = None, *,
        resume: bool = False,
        _crash_after_checkpoints: Optional[int] = None) -> dict:
    """Execute the MC -> MD -> pump -> tag -> record pipeline; returns all
    observables and writes reference-schema .dat files when
    save_directory is set.

    With ``cfg.checkpoint_every_chunks`` > 0 (requires save_directory)
    the run publishes a native pipeline checkpoint every K MC/record
    chunks, through the pump window, and at every stage boundary;
    ``resume=True`` continues from the newest one, bit-identical to the
    uninterrupted run (MC chunk keys are pre-split on a fixed grid; the
    pump RNG rides in the checkpointed SimState).  The reference program
    cannot checkpoint at all — ``writeConditions`` exists only in the
    cooling and frozen-tag files (SURVEY.md §5)."""
    from ..io.checkpoint import load_pipeline_checkpoint
    from .mc_md_anisotropy import (PipelinePublisher, _host_cat,
                                   check_pipeline_meta)
    dt = cfg.np_dtype
    cdtype = jnp.complex128 if cfg.dtype == "float64" else jnp.complex64
    key = jax.random.PRNGKey(cfg.job if seed is None else seed)
    k_lat, k_psi, k_mc, k_tag, k_run = jax.random.split(key, 5)
    # job/save_directory don't affect the traced phases — strip them so
    # sequential jobs (cli --jobs) share one compiled program
    cfg_j = cfg
    cfg = dataclasses.replace(cfg, job=1, save_directory=None)

    out_dir = (_job_dir(cfg_j) if cfg_j.save_directory is not None
               else None)
    meta = dict(variant=cfg.variant, n=cfg.n, gamma=cfg.gamma,
                kappa=cfg.kappa, mc_steps=cfg.mc_steps,
                record_steps=cfg.record_steps,
                pump_md_steps=cfg.pump_md_steps,
                seed=cfg_j.job if seed is None else seed)
    pub = None
    if cfg.checkpoint_every_chunks > 0:
        if out_dir is None:
            raise ValueError("checkpoint_every_chunks needs "
                             "save_directory")
        pub = PipelinePublisher(out_dir, "mc_tag", meta,
                                crash_after=_crash_after_checkpoints)

    n_mc_chunks = max(1, cfg.mc_steps // cfg.mc_chunk_steps)
    mc_keys = jax.random.split(k_mc, n_mc_chunks)
    assert cfg.record_steps % cfg.gr_every_record == 0
    n_rec = cfg.record_steps // cfg.gr_every_record

    # Pipeline stages: 0 MC, 1 collisional MD, 2 pump window, 3
    # tag+record, 4 done.  Checkpoints are labeled with the NEXT
    # (stage, chunk) to execute (stage 2's chunk counts pump MD steps).
    stage, chunk = 0, 0
    R = V = A = tags = pump_state = None
    n_acc = jnp.zeros((), jnp.int32)
    acc: dict = {k: [] for k in ("grs", "moments", "dists", "temps",
                                 "vstore")}
    autoc: dict = {}

    if resume:
        if out_dir is None:
            raise ValueError("resume=True needs save_directory")
        z = load_pipeline_checkpoint(out_dir, "mc_tag")
        if z is None:
            raise ValueError(
                f"{out_dir}: no pipeline checkpoint to resume from "
                "(runs publish them when checkpoint_every_chunks > 0)")
        check_pipeline_meta(z, out_dir, **meta)
        stage, chunk = int(z["stage"]), int(z["chunk"])
        if pub is not None:
            pub.seq = int(z["seq"])
        R, V = jnp.asarray(z["R"], dt), jnp.asarray(z["V"], dt)
        A = jnp.asarray(z["A"], dt) if "A" in z else None
        if "k_run" in z:
            k_run = jnp.asarray(z["k_run"])
        n_acc = jnp.asarray(z["mc_accepted"], jnp.int32)
        if "psi" in z:               # mid-pump snapshot: a live SimState
            st = make_state(R, V, np.asarray(z["psi"], cdtype), k_run,
                            dtype=dt)
            pump_state = st._replace(
                F=A, t_part=jnp.asarray(z["t_part"], dt),
                tick=jnp.asarray(z["tick"], st.tick.dtype),
                t=jnp.asarray(z["t"], st.t.dtype))
        if "tags" in z:
            tags = jnp.asarray(z["tags"])
        for k in acc:
            if k in z:
                acc[k] = [z[k]]
        for k in ("vaf", "long_visc", "v_cube", "v_fourth"):
            if k in z:
                autoc[k] = z[k]

    def _publish(stage_, chunk_, with_vstore=False):
        if pub is None:
            return
        if pump_state is not None:
            payload = dict(R=pump_state.R, V=pump_state.V,
                           A=pump_state.F, psi=pump_state.psi,
                           t_part=pump_state.t_part, k_run=pump_state.key,
                           tick=pump_state.tick, t=pump_state.t,
                           mc_accepted=n_acc)
        else:
            payload = dict(R=R, V=V, A=A, k_run=k_run, mc_accepted=n_acc,
                           tags=tags, **autoc)
        for k in ("grs", "moments", "dists", "temps"):
            if acc[k]:
                payload[k] = _host_cat(acc[k])
        if with_vstore and acc["vstore"]:
            payload["vstore"] = _host_cat(acc["vstore"])
        pub.save(stage_, chunk_, **payload)

    # ---- stage 0: lattice init + Metropolis MC (resumable mid-stage)
    if stage == 0:
        if chunk == 0:
            R, V = lattice_init(k_lat, cfg.n, cfg.gamma, cfg.L, dtype=dt)
        for i in range(chunk, n_mc_chunks):
            R, acc_i = _mc_chunk(cfg, R, mc_keys[i],
                                 cfg.mc_steps // n_mc_chunks)
            n_acc = n_acc + acc_i
            last = i + 1 == n_mc_chunks
            if pub is not None and (last or (i + 1)
                                    % cfg.checkpoint_every_chunks == 0):
                _publish(1 if last else 0, 0 if last else i + 1)
        stage, chunk = 1, 0

    # ---- stage 1: collisional MD equilibration
    if stage == 1:
        if A is None:
            A = _forces(cfg)(R)[0]
        R, V, A, k_run = md_phase(cfg, R, V, A, k_run,
                                  cfg.pre_record_md_steps,
                                  cfg.collision_freq)
        _publish(2, 0)
        stage, chunk = 2, 0

    # ---- stage 2: optical pump window (chunked fori; resumable at any
    # MD step), then the projective spin measurement
    if stage == 2:
        if pump_state is None:
            psi = jax.jit(random_s_superposition,
                          static_argnums=(1, 2, 3))(
                k_psi, cfg.n, cfg.n_states, cdtype)
            pump_state = make_state(R, V, psi, k_run, dtype=dt)
            pump_state = pump_state._replace(
                F=A, t_part=jnp.zeros((cfg.n,), dt))
        cs = (max(1, -(-cfg.pump_md_steps // 8)) if pub is not None
              else cfg.pump_md_steps)
        done = chunk
        while done < cfg.pump_md_steps:
            m = min(cs, cfg.pump_md_steps - done)
            pump_state = _pump_chunk(cfg, pump_state, m)
            done += m
            if pub is not None and done < cfg.pump_md_steps:
                _publish(2, done)
        key2, k_meas = jax.random.split(pump_state.key)
        p = cfg.spin_up_probability(pump_state.psi)
        tags = jax.random.uniform(k_meas, p.shape, p.dtype) < p
        R, V, A, k_run = (pump_state.R, pump_state.V, pump_state.F,
                          key2)
        pump_state = None
        _publish(3, 0)
        stage, chunk = 3, 0

    # ---- stage 3: collisionless recording (resumable mid-stage), then
    # the FFT autocorrelation suite
    if stage == 3:
        for i in range(chunk, n_rec):
            ((R, V, A, k_run),
             (g, moments, dists, temps, vchunk)) = _record_chunk(
                cfg, R, V, A, k_run, tags)
            acc["grs"].append(g[None])
            acc["moments"].append(moments)
            acc["dists"].append(dists)
            acc["temps"].append(temps)
            acc["vstore"].append(vchunk)
            if (pub is not None and i + 1 < n_rec
                    and (i + 1) % cfg.checkpoint_every_chunks == 0):
                _publish(3, i + 1, with_vstore=True)
        vstore = jnp.concatenate([jnp.asarray(v) for v in acc["vstore"]])
        vaf, long_visc, v_cube, v_fourth = autocorr_suite(vstore,
                                                          cfg.gamma)
        autoc = dict(vaf=vaf, long_visc=long_visc, v_cube=v_cube,
                     v_fourth=v_fourth)
        _publish(4, 0)
        stage = 4

    results = dict(
        mc_accepted=jax.device_get(n_acc),
        tags=jax.device_get(tags),
        grs=_host_cat(acc["grs"]),
        moments=_host_cat(acc["moments"]),
        dists=_host_cat(acc["dists"]),
        temps=_host_cat(acc["temps"]),
        **{k: jax.device_get(v) for k, v in autoc.items()},
        R=jax.device_get(R), V=jax.device_get(V))

    if cfg_j.save_directory is not None:
        _write_outputs(cfg_j, results)
    return results


def _run_batched(cfg: MCTagConfig, member_cfgs, keys, qt_params=None,
                 mesh=None):
    """vmap the whole per-job pipeline over the member axis — every stage
    (Metropolis equilibration, collisional MD, pump-window QT, projective
    tag, collisionless recording, FFT autocorrelations) runs
    member-parallel in one compiled program.  ``qt_params``: optional
    [E]-batched QTParams pytree (sweep folds).  ``mesh`` shards the
    member axis over the mesh's ``ens`` devices
    (parallel/ensemble.member_sharded — zero collectives)."""
    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    dt = cfg.np_dtype
    forces = _forces(cfg_run)

    def pipeline(key, qt_p=None):
        k_lat, k_psi, k_mc, _, k_run = jax.random.split(key, 5)
        R, V = lattice_init(k_lat, cfg.n, cfg.gamma, cfg.L, dtype=dt)
        psi = random_s_superposition(
            k_psi, cfg.n, cfg.n_states,
            jnp.complex128 if cfg.dtype == "float64" else jnp.complex64)
        R, n_acc = _mc_scan(cfg_run, R, k_mc)
        A = forces(R)[0]
        R, V, A, k_run = md_phase(cfg_run, R, V, A, k_run,
                                  cfg.pre_record_md_steps,
                                  cfg.collision_freq)
        state = pump_phase(cfg_run, R, V, A, psi,
                           jnp.zeros((cfg.n,), dt), k_run, qt_params=qt_p)
        key2, k_meas = jax.random.split(state.key)
        p = cfg_run.spin_up_probability(state.psi)
        tags = jax.random.uniform(k_meas, p.shape, p.dtype) < p
        (R, V, A, _), grs, moments, dists, temps, vstore = record_phase(
            cfg_run, state.R, state.V, state.F, key2, tags)
        vaf, long_visc, v_cube, v_fourth = autocorr_suite(vstore,
                                                          cfg.gamma)
        return dict(mc_accepted=n_acc, tags=tags, grs=grs,
                    moments=moments, dists=dists, temps=temps, vaf=vaf,
                    long_visc=long_visc, v_cube=v_cube,
                    v_fourth=v_fourth, R=R, V=V)

    fn = jax.vmap(pipeline)
    args = (keys,) if qt_params is None else (keys, qt_params)
    if mesh is not None:
        from ..parallel.ensemble import member_sharded
        fn = member_sharded(fn, mesh)
    batched = jax.jit(fn)(*args)
    jax.block_until_ready(batched["R"])
    batched_np = {k: jax.device_get(v) for k, v in batched.items()}

    results = []
    for j, mcfg in enumerate(member_cfgs):
        res = {k: v[j] for k, v in batched_np.items()}
        results.append(res)
        if mcfg.save_directory is not None:
            _write_outputs(mcfg, res)
    return results


def run_ensemble(cfg: MCTagConfig, n_jobs: int, seed: int = 0, mesh=None):
    """Batched MC->MD->pump->tag->record job array (the reference's
    SLURM array over MonteCarloFollowedByQTTagging* jobs).  Per-job .dat
    trees land in ``job<k>/``; returns the per-job results list.
    ``mesh`` spreads jobs over the mesh's ``ens`` devices."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_jobs)
    member_cfgs = [dataclasses.replace(cfg, job=j + 1)
                   for j in range(n_jobs)]
    return _run_batched(cfg, member_cfgs, keys, mesh=mesh)


def run_sweep(cfg: MCTagConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None):
    """Run a pump-laser (detuning, om) grid as ONE vmapped program.

    The reference compiles the pump detuning and Rabi frequency into each
    tagging binary (MonteCarloFollowedByQTTagging408Quad.cpp:96-100) and
    rebuilds per point.  Here the pump Hamiltonian is linear in both
    knobs, so each member carries its own traced QTParams
    (core/qt.sweep_qt_params) through the vmapped pump phase — every grid
    point costs one more batched member, and the expensive shared stages
    (MC anneal, MD, recording, FFT suite) batch with it.

    ``points``: dicts with keys among ``detuning``/``om`` (unset fields
    keep cfg's value).  ``jobs_per_point`` replicates each point with
    independent seeds; member order is point-major.  With
    ``cfg.save_directory`` set, each member writes the full reference
    .dat tree under its own detuning/om-encoded directory.  Returns
    ``(results, member_cfgs)``."""
    from ..core.qt import sweep_member_params
    cdtype = jnp.complex64 if cfg.dtype == "float32" else jnp.complex128
    member_cfgs, params = sweep_member_params(
        cfg, points, jobs_per_point, cfg.scheme_unit(), cfg.np_dtype,
        cdtype)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(member_cfgs))
    results = _run_batched(cfg, member_cfgs, keys, qt_params=params,
                           mesh=mesh)
    return results, member_cfgs


def _job_dir(cfg: MCTagConfig) -> str:
    # the 422 main stamps the run date into the directory name
    # (MonteCarloFollowedByQTTagging422Linear.cpp:1127-1134)
    stamp = time.strftime("Date%m%d%y") if cfg.is_422 else None
    return mc_tag_dir(cfg.save_directory, gamma=cfg.gamma,
                      kappa=cfg.kappa, n=cfg.n,
                      tpump_seconds=cfg.tpump_seconds,
                      detuning=cfg.detuning, om=cfg.om,
                      density=cfg.density, job=cfg.job, date_stamp=stamp)


def _write_outputs(cfg: MCTagConfig, res: dict) -> None:
    w = DatWriter(_job_dir(cfg))
    t_axis = np.arange(cfg.record_steps) * cfg.timestep
    bins = centered_bins_np()
    w.append("taggedMoments.dat",
             np.concatenate([t_axis[:, None], res["moments"]], axis=1))
    for k in range(0, cfg.record_steps, cfg.dist_every):
        w.write(f"vel_distX_timestep{k:06d}.dat",
                np.stack([bins, res["dists"][k]], -1))
    n_gr = int((cfg.L / 2.0) / 0.05)   # reference's r < L/2 row cap
    rr = np.arange(n_gr) * 0.05
    for i, g in enumerate(res["grs"]):
        w.write(f"pairPairCorrStepNum{i * cfg.gr_every_record}.dat",
                np.stack([rr, g[:n_gr]], -1))
    w.write("temperature.dat", res["temps"][:, None])
    for name, arr in (("VAF", res["vaf"]),
                      ("longViscAutoCorr", res["long_visc"]),
                      ("vCubeAutoCorr", res["v_cube"]),
                      ("vFourthAutoCorr", res["v_fourth"])):
        w.write(f"{name}.dat", np.stack([t_axis, arr], -1))
