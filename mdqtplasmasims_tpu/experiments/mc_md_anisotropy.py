"""Pure classical transport study: MC equilibration -> collisional MD ->
tagged-moment + autocorrelation recording -> temperature-anisotropy
relaxation (instantaneous rescale and slow anisotropic-force versions).

JAX re-expression of MonteCarloFollowedByMDAndTempAnisotropy.cpp
(call stack SURVEY.md 3.2).  Each stage is one jitted device program; the
velocity history for the autocorrelation suite stays on device and the
O(T^2 N) reference post-pass becomes batched FFTs.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.init import lattice_init
from ..core.mc import MetropolisMC
from ..core.tagging import tag_classical, tagged_moments
from ..core.thermostat import (anisotropize_velocities, collide_and_kick,
                               laser_force, temperature, temperature_per_axis)
from ..core.md import wrap_pbc
from ..io.datfiles import DatWriter
from ..io.dirs import mc_transport_dir
from ..ops.correlations import autocorr_suite, power_autocorr
from ..ops.structure import pair_correlation



@dataclasses.dataclass(frozen=True)
class MCTransportConfig:
    """Inputs of MonteCarloFollowedByMDAndTempAnisotropy.cpp:62-107."""

    n: int = 4096                 # must be a perfect cube
    kappa: float = 0.5
    gamma: float = 3.0
    density: float = 0.4          # 1e14 m^-3 (units only)
    collision_freq: float = 0.25
    mc_steps: int = 200_000
    max_r_step: float = 0.3
    timestep: float = 0.005
    pre_record_md_steps: int = 200
    record_steps: int = 2500      # numVelAutoCorrsSteps
    instant_aniso_steps: int = 2500
    reequil_steps: int = 500
    temp_percent_diff: float = 0.15
    beta: float = 26000.0
    aniso_time_us: float = 10.0   # anisotropyEstablishmentTime
    aniso_relax_steps: int = 2000
    one_axis_force: bool = False
    gr_every_mc: int = 10_000
    gr_every_record: int = 100
    # crash checkpointing (native-only: the reference's writeConditions
    # never appears in this program — its multi-hour transport jobs lose
    # everything on a crash; SURVEY.md §5 failure-detection gap).  >0 =
    # publish a pipeline checkpoint every K MC/record chunks and at every
    # stage boundary (needs save_directory); 0 = off.
    checkpoint_every_chunks: int = 0
    job: int = 1
    dtype: str = "float32"
    save_directory: Optional[str] = None

    @property
    def aniso_establish_steps(self) -> int:
        # MonteCarlo...cpp:106
        return int(round(0.8 * self.aniso_time_us * np.sqrt(self.density)
                         / self.timestep))

    @property
    def L(self) -> float:
        return (self.n * 4.0 * np.pi / 3.0) ** (1.0 / 3.0)

    @property
    def ldeb(self) -> float:
        return 1.0 / self.kappa

    @property
    def np_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


def _forces(cfg: MCTransportConfig, ldeb=None):
    """R -> F: XLA pair forces (ops/yukawa.best_forces_fn).  ``ldeb``
    optionally overrides cfg's screening length with a traced scalar
    (per-member kappa sweeps)."""
    from ..ops.yukawa import best_forces_fn
    fn = best_forces_fn(cfg.n, cfg.L, cfg.ldeb if ldeb is None else ldeb)
    return lambda R: fn(R)[0]


def make_md_stage(cfg: MCTransportConfig, *, collision_freq: float,
                  add_laser_force: bool = False, gamma=None, ldeb=None):
    """One velocity-Verlet MD step incl. thermostat/laser options as a
    scannable (R, V, A, key) -> ... function.  ``gamma``/``ldeb`` may be
    traced per-member overrides (sweep folds); None takes cfg's values."""
    forces = _forces(cfg, ldeb)
    dt = cfg.timestep
    g = cfg.gamma if gamma is None else gamma

    def step(carry, _):
        R, V, A, key = carry
        key, kc = jax.random.split(key)
        R = wrap_pbc(R + dt * V + 0.5 * dt * dt * A, cfg.L)
        A_new = forces(R)
        V_verlet = V + 0.5 * dt * (A + A_new)
        V = collide_and_kick(V_verlet, kc, dt=dt,
                             collision_freq=collision_freq, gamma=g)
        if add_laser_force:
            V = laser_force(V, dt=dt, beta=cfg.beta, density=cfg.density,
                            one_axis_only=cfg.one_axis_force)
        return (R, V, A_new, key), None

    return step


@partial(jax.jit, static_argnames=("cfg", "n_steps", "collision_freq",
                                   "add_laser_force", "record"))
def md_stage(cfg: MCTransportConfig, R, V, A, key, n_steps: int,
             collision_freq: float = 0.0, add_laser_force: bool = False,
             record: str = "none", gamma=None, ldeb=None):
    """Run n_steps of velocity-Verlet.  record: none | temp | temp_axes |
    full (tagged moments need tags; handled by record_stage below)."""
    step = make_md_stage(cfg, collision_freq=collision_freq,
                         add_laser_force=add_laser_force, gamma=gamma,
                         ldeb=ldeb)

    def body(carry, x):
        carry, _ = step(carry, x)
        R, V, A, key = carry
        if record == "temp":
            out = temperature(V)
        elif record == "temp_axes":
            out = temperature_per_axis(V)
        else:
            out = jnp.zeros((), R.dtype)
        return carry, out

    (R, V, A, key), rec = jax.lax.scan(body, (R, V, A, key), None,
                                       length=n_steps)
    return (R, V, A, key), rec


def _make_record_chunk(cfg: MCTransportConfig, gamma=None, ldeb=None):
    """One ``gr_every_record``-step recording chunk — g(r) of the incoming
    configuration, then per step: tagged moments (all four taggings) and
    scalar temperature *before* the MD step, velocity storage *after* it
    (the reference order, main :1095-1104).  Shared by the scanned stage
    (vmapped folds) and the host-chunked resumable runner so both paths
    dispatch the same math."""
    step = make_md_stage(cfg, collision_freq=0.0, gamma=gamma, ldeb=ldeb)
    g_eq = cfg.gamma if gamma is None else gamma

    def chunk(carry, tags):
        t1, t2, t3, t4 = tags

        def body(carry, _):
            R, V, A, key = carry
            moments = jnp.stack([
                tagged_moments(V[:, 0], t, subtract_equilibrium=True,
                               gamma=g_eq)
                for t in (t1, t2, t3, t4)])
            temp = temperature(V)
            carry, _ = step((R, V, A, key), None)
            return carry, (moments, temp, carry[1])

        g = pair_correlation(carry[0], cfg.L)
        carry, recs = jax.lax.scan(body, carry, None,
                                   length=cfg.gr_every_record)
        return carry, (g,) + recs

    return chunk


@partial(jax.jit, static_argnames=("cfg",))
def record_stage(cfg: MCTransportConfig, R, V, A, key, tags, gamma=None,
                 ldeb=None):
    """The collisionless recording phase (main :1095-1104) as one scan of
    :func:`_make_record_chunk` chunks."""
    assert cfg.record_steps % cfg.gr_every_record == 0
    n_chunks = cfg.record_steps // cfg.gr_every_record
    chunk = _make_record_chunk(cfg, gamma=gamma, ldeb=ldeb)

    (R, V, A, key), (grs, moments, temps, vstore) = jax.lax.scan(
        lambda c, _: chunk(c, tags), (R, V, A, key), None,
        length=n_chunks)
    moments = moments.reshape((-1,) + moments.shape[2:])
    temps = temps.reshape(-1)
    vstore = vstore.reshape((-1,) + vstore.shape[2:])
    return (R, V, A, key), grs, moments, temps, vstore


def _mc_chunk_fn(cfg: MCTransportConfig, R, key, n_steps: int,
                 gamma=None, ldeb=None):
    """One Metropolis chunk: g(r) snapshot of the incoming configuration,
    then ``n_steps`` single-particle moves (the reference's
    g(r)-every-10k-MC-steps cadence, main :1069-1078)."""
    g = cfg.gamma if gamma is None else gamma
    ld = cfg.ldeb if ldeb is None else ldeb
    mc = MetropolisMC(L=cfg.L, ldeb=ld, gamma=g,
                      max_r_step=cfg.max_r_step)
    gr = pair_correlation(R, cfg.L)
    R, acc = mc.run(R, key, n_steps)
    return R, acc, gr


_mc_chunk = partial(jax.jit,
                    static_argnames=("cfg", "n_steps"))(_mc_chunk_fn)
_record_chunk = partial(jax.jit, static_argnames=("cfg",))(
    lambda cfg, R, V, A, key, tags:
    _make_record_chunk(cfg)((R, V, A, key), tags))


class PipelinePublisher:
    """Crash-checkpoint publisher for the staged experiment families
    (io/checkpoint.save_pipeline_checkpoint: atomic, newest-only).
    ``crash_after`` is a test hook: raise after the K-th publish to
    simulate a walltime kill at a known point."""

    def __init__(self, directory: str, family: str, meta: dict,
                 crash_after: Optional[int] = None):
        from ..io.checkpoint import save_pipeline_checkpoint
        self._save = save_pipeline_checkpoint
        self.directory = directory
        self.family = family
        self.meta = {k: np.asarray(v) for k, v in meta.items()}
        self.seq = 0
        self._crash_after = crash_after

    def save(self, stage: int, chunk: int, **arrays) -> None:
        payload = dict(self.meta, stage=np.int64(stage),
                       chunk=np.int64(chunk))
        payload.update(jax.device_get(
            {k: v for k, v in arrays.items() if v is not None}))
        self.seq += 1
        self._save(self.directory, self.seq, self.family, payload)
        if self._crash_after is not None and self.seq >= self._crash_after:
            raise RuntimeError(
                f"simulated crash after pipeline checkpoint {self.seq} "
                "(test hook)")


def check_pipeline_meta(z: dict, directory: str, **fields) -> None:
    """Refuse to resume a pipeline checkpoint written under a different
    configuration — a silent splice across mismatched physics would be
    worse than restarting."""
    for k, want in fields.items():
        got = z.get(k)
        if isinstance(want, str):
            ok = got is not None and str(got) == want
        else:
            ok = got is not None and np.allclose(np.asarray(got),
                                                 np.asarray(want))
        if not ok:
            raise ValueError(
                f"{directory}: pipeline checkpoint was written with "
                f"{k}={got}, this run is configured with {k}={want} — "
                "refusing to splice")


def _host_cat(chunks) -> np.ndarray:
    """Concatenate accumulated per-chunk outputs (device and/or restored
    host arrays) on the host, chunk-major."""
    return np.concatenate([jax.device_get(c) for c in chunks], axis=0)


def run(cfg: MCTransportConfig, seed: Optional[int] = None, *,
        resume: bool = False,
        _crash_after_checkpoints: Optional[int] = None) -> dict:
    """Execute the full staged pipeline; returns all observables and writes
    reference-schema .dat files when save_directory is set.

    With ``cfg.checkpoint_every_chunks`` > 0 (requires save_directory)
    the run publishes a native pipeline checkpoint every K MC/record
    chunks and at every stage boundary; ``resume=True`` continues from
    the newest one, bit-identical to the uninterrupted run (every RNG
    stream is pre-derived per chunk or carried in the checkpoint, so the
    replay dispatches the same per-chunk programs on the same operands).
    The reference program cannot checkpoint at all — ``writeConditions``
    exists only in the cooling and frozen-tag files, so its multi-hour
    transport jobs restart from zero on a crash (SURVEY.md §5)."""
    from ..io.checkpoint import load_pipeline_checkpoint
    dt = cfg.np_dtype
    key = jax.random.PRNGKey(cfg.job if seed is None else seed)
    k_lat, k_mc, k_tag, k_run = jax.random.split(key, 4)
    # job/save_directory don't affect the traced stages — strip them so
    # sequential jobs (cli --jobs) share one compiled program
    cfg_j = cfg
    cfg = dataclasses.replace(cfg, job=1, save_directory=None)

    out_dir = (mc_transport_dir(cfg_j.save_directory, gamma=cfg_j.gamma,
                                kappa=cfg_j.kappa, n=cfg_j.n, job=cfg_j.job)
               if cfg_j.save_directory is not None else None)
    meta = dict(n=cfg.n, gamma=cfg.gamma, kappa=cfg.kappa,
                mc_steps=cfg.mc_steps, record_steps=cfg.record_steps,
                instant_aniso_steps=cfg.instant_aniso_steps,
                seed=cfg_j.job if seed is None else seed)
    pub = None
    if cfg.checkpoint_every_chunks > 0:
        if out_dir is None:
            raise ValueError("checkpoint_every_chunks needs "
                             "save_directory")
        pub = PipelinePublisher(out_dir, "transport", meta,
                                crash_after=_crash_after_checkpoints)

    n_chunks = max(1, cfg.mc_steps // cfg.gr_every_mc)
    mc_keys = jax.random.split(k_mc, n_chunks)
    assert cfg.record_steps % cfg.gr_every_record == 0
    n_rec = cfg.record_steps // cfg.gr_every_record

    # Pipeline stages: 0 MC, 1 pre-record MD, 2 tag+record, 3 instant
    # anisotropy, 4 re-equilibration, 5 anisotropic force, 6 relaxation,
    # 7 done.  Checkpoints are labeled with the NEXT (stage, chunk) to
    # execute.
    stage, chunk = 0, 0
    R = V = A = tags = None
    n_acc = jnp.zeros((), jnp.int32)
    acc: dict = {k: [] for k in ("gr_mc", "gr_record", "moments",
                                 "temps", "vstore")}
    autoc: dict = {}
    stage_rec: dict = {}

    if resume:
        if out_dir is None:
            raise ValueError("resume=True needs save_directory")
        z = load_pipeline_checkpoint(out_dir, "transport")
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
        k_run = jnp.asarray(z["k_run"])
        n_acc = jnp.asarray(z["mc_accepted"], jnp.int32)
        if "tags" in z:
            tags = tuple(jnp.asarray(z["tags"][i]) for i in range(4))
        for k in acc:
            if k in z:
                acc[k] = [z[k]]
        for k in ("vaf", "long_visc", "v_cube", "v_fourth"):
            if k in z:
                autoc[k] = z[k]
        for k in ("temps_inst", "temps_force", "temps_relax"):
            if k in z:
                stage_rec[k] = z[k]

    def _publish(stage_, chunk_, with_vstore=False):
        if pub is None:
            return
        payload = dict(R=R, V=V, A=A, k_run=k_run, mc_accepted=n_acc,
                       tags=None if tags is None else jnp.stack(tags),
                       **autoc, **stage_rec)
        for k in ("gr_mc", "gr_record", "moments", "temps"):
            if acc[k]:
                payload[k] = _host_cat(acc[k])
        if with_vstore and acc["vstore"]:
            payload["vstore"] = _host_cat(acc["vstore"])
        pub.save(stage_, chunk_, **payload)

    # ---- stage 0: lattice init + Metropolis MC (resumable mid-stage)
    if stage == 0:
        if chunk == 0:
            R, V = lattice_init(k_lat, cfg.n, cfg.gamma, cfg.L, dtype=dt)
        for i in range(chunk, n_chunks):
            R, acc_i, gr = _mc_chunk(cfg, R, mc_keys[i],
                                     cfg.mc_steps // n_chunks)
            acc["gr_mc"].append(gr[None])
            n_acc = n_acc + acc_i
            last = i + 1 == n_chunks
            if pub is not None and (last or (i + 1)
                                    % cfg.checkpoint_every_chunks == 0):
                _publish(1 if last else 0, 0 if last else i + 1)
        stage, chunk = 1, 0

    # ---- stage 1: collisional MD equilibration
    if stage == 1:
        if A is None:
            A = _forces(cfg)(R)
        (R, V, A, k_run), _ = md_stage(cfg, R, V, A, k_run,
                                       cfg.pre_record_md_steps,
                                       collision_freq=cfg.collision_freq)
        _publish(2, 0)
        stage, chunk = 2, 0

    # ---- stage 2: classical tag + collisionless recording (resumable
    # mid-stage), then the FFT autocorrelation suite (the reference's
    # O(T^2 N) post-pass)
    if stage == 2:
        if tags is None:
            tags = tag_classical(V[:, 0], k_tag, cfg.gamma)
        for i in range(chunk, n_rec):
            ((R, V, A, k_run),
             (gr, moments, temps, vchunk)) = _record_chunk(
                cfg, R, V, A, k_run, tags)
            acc["gr_record"].append(gr[None])
            acc["moments"].append(moments)
            acc["temps"].append(temps)
            acc["vstore"].append(vchunk)
            if (pub is not None and i + 1 < n_rec
                    and (i + 1) % cfg.checkpoint_every_chunks == 0):
                _publish(2, i + 1, with_vstore=True)
        vstore = jnp.concatenate([jnp.asarray(v) for v in acc["vstore"]])
        vaf, long_visc, v_cube, v_fourth = autocorr_suite(vstore,
                                                          cfg.gamma)
        autoc = dict(vaf=vaf, long_visc=long_visc, v_cube=v_cube,
                     v_fourth=v_fourth)
        _publish(3, 0)
        stage, chunk = 3, 0

    # ---- stage 3: instantaneous anisotropy + relaxation
    if stage == 3:
        V = anisotropize_velocities(V, cfg.temp_percent_diff)
        (R, V, A, k_run), stage_rec["temps_inst"] = md_stage(
            cfg, R, V, A, k_run, cfg.instant_aniso_steps,
            record="temp_axes")
        _publish(4, 0)
        stage = 4

    # ---- stage 4: re-equilibration (collisional)
    if stage == 4:
        (R, V, A, k_run), _ = md_stage(cfg, R, V, A, k_run,
                                       cfg.reequil_steps,
                                       collision_freq=cfg.collision_freq)
        _publish(5, 0)
        stage = 5

    # ---- stage 5: anisotropic force application
    if stage == 5:
        (R, V, A, k_run), stage_rec["temps_force"] = md_stage(
            cfg, R, V, A, k_run, cfg.aniso_establish_steps,
            add_laser_force=True, record="temp_axes")
        _publish(6, 0)
        stage = 6

    # ---- stage 6: post-force relaxation
    if stage == 6:
        (R, V, A, k_run), stage_rec["temps_relax"] = md_stage(
            cfg, R, V, A, k_run, cfg.aniso_relax_steps,
            record="temp_axes")
        _publish(7, 0)
        stage = 7

    results = dict(
        gr_mc=_host_cat(acc["gr_mc"]),
        gr_record=_host_cat(acc["gr_record"]),
        mc_accepted=jax.device_get(n_acc),
        moments=_host_cat(acc["moments"]),
        temps=_host_cat(acc["temps"]),
        **{k: jax.device_get(v) for k, v in autoc.items()},
        **{k: jax.device_get(v) for k, v in stage_rec.items()},
        R=jax.device_get(R), V=jax.device_get(V))

    if cfg_j.save_directory is not None:
        _write_outputs(cfg_j, results)
    return results


def _pipeline(cfg: MCTransportConfig, key, gamma=None, ldeb=None) -> dict:
    """One member's full staged pipeline as a pure traced function:
    lattice init -> chunked MC with g(r) snapshots -> collisional MD ->
    classical tagging -> collisionless recording -> FFT autocorrelations
    -> both anisotropy drives.  ``gamma``/``ldeb`` may be traced scalars
    overriding cfg's coupling and screening — that is how a (Gamma,
    kappa) phase-diagram sweep folds into ONE vmapped program (run_sweep;
    the pair forces take the member's traced ldeb)."""
    g = cfg.gamma if gamma is None else gamma
    n_chunks = max(1, cfg.mc_steps // cfg.gr_every_mc)

    k_lat, k_mc, k_tag, k_run = jax.random.split(key, 4)
    R, V = lattice_init(k_lat, cfg.n, g, cfg.L, dtype=cfg.np_dtype)

    def chunk(carry, k):
        R, n_acc = carry
        R, acc, gr = _mc_chunk_fn(cfg, R, k, cfg.mc_steps // n_chunks,
                                  gamma=gamma, ldeb=ldeb)
        return (R, n_acc + acc), gr
    (R, n_acc), gr_mc = jax.lax.scan(
        chunk, (R, jnp.zeros((), jnp.int32)),
        jax.random.split(k_mc, n_chunks))

    A = _forces(cfg, ldeb)(R)
    (R, V, A, k_run), _ = md_stage(cfg, R, V, A, k_run,
                                   cfg.pre_record_md_steps,
                                   collision_freq=cfg.collision_freq,
                                   gamma=gamma, ldeb=ldeb)
    tags = tag_classical(V[:, 0], k_tag, g)
    (R, V, A, k_run), gr_record, moments, temps, vstore = record_stage(
        cfg, R, V, A, k_run, tags, gamma=gamma, ldeb=ldeb)
    vaf, long_visc, v_cube, v_fourth = (
        power_autocorr(vstore, k, g) for k in (1, 2, 3, 4))
    V = anisotropize_velocities(V, cfg.temp_percent_diff)
    (R, V, A, k_run), temps_inst = md_stage(
        cfg, R, V, A, k_run, cfg.instant_aniso_steps,
        record="temp_axes", gamma=gamma, ldeb=ldeb)
    (R, V, A, k_run), _ = md_stage(cfg, R, V, A, k_run,
                                   cfg.reequil_steps,
                                   collision_freq=cfg.collision_freq,
                                   gamma=gamma, ldeb=ldeb)
    (R, V, A, k_run), temps_force = md_stage(
        cfg, R, V, A, k_run, cfg.aniso_establish_steps,
        add_laser_force=True, record="temp_axes", gamma=gamma, ldeb=ldeb)
    (R, V, A, k_run), temps_relax = md_stage(
        cfg, R, V, A, k_run, cfg.aniso_relax_steps,
        record="temp_axes", gamma=gamma, ldeb=ldeb)
    return dict(gr_mc=gr_mc, gr_record=gr_record, mc_accepted=n_acc,
                moments=moments, temps=temps, vaf=vaf,
                long_visc=long_visc, v_cube=v_cube,
                v_fourth=v_fourth, temps_inst=temps_inst,
                temps_force=temps_force, temps_relax=temps_relax,
                R=R, V=V)


def _run_batched(cfg: MCTransportConfig, member_cfgs, keys,
                 gammas=None, ldebs=None, mesh=None):
    """vmap _pipeline over the member axis, fetch once, write each
    member's .dat tree under its own param-encoded directory.  ``mesh``
    shards the member axis over the mesh's ``ens`` devices
    (parallel/ensemble.member_sharded — zero collectives)."""
    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    if gammas is None:
        fn = jax.vmap(lambda k: _pipeline(cfg_run, k))
        args = (keys,)
    else:
        fn = jax.vmap(lambda k, g, ld: _pipeline(cfg_run, k, gamma=g,
                                                 ldeb=ld))
        args = (keys, gammas, ldebs)
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


def run_ensemble(cfg: MCTransportConfig, n_jobs: int, seed: int = 0,
                 mesh=None):
    """Batched job array for the MC transport pipeline (the reference's
    SLURM array over MonteCarloFollowedByMDAndTempAnisotropy jobs): the
    full staged pipeline — MC equilibration with g(r) snapshots,
    collisional MD, classical tagging, collisionless recording, FFT
    autocorrelations, both anisotropy drives — vmapped over the job axis
    as one compiled program.  Per-job .dat trees in ``job<k>/``; returns
    the per-job results list.  ``mesh`` spreads jobs over the mesh's
    ``ens`` devices (n_jobs must divide evenly)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_jobs)
    member_cfgs = [dataclasses.replace(cfg, job=j + 1)
                   for j in range(n_jobs)]
    return _run_batched(cfg, member_cfgs, keys, mesh=mesh)


def run_sweep(cfg: MCTransportConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None):
    """Run a (Gamma, kappa) phase-diagram grid as ONE vmapped program.

    The reference explores the Yukawa phase diagram by editing the
    compile-time constants ``Gamma``/``kappa``
    (MonteCarloFollowedByMDAndTempAnisotropy.cpp:64-65) and rebuilding
    the binary per point.  Here both enter the traced pipeline as
    per-member scalars: Gamma scales initialization, MC acceptance,
    thermostat kicks and the equilibrium-moment subtractions; kappa
    enters the pair forces as a traced screening length, so one compiled
    program serves the whole grid — every point costs one more vmapped
    member.

    ``points``: sequence of dicts with keys among ``gamma``/``kappa``
    (unset fields keep cfg's value).  ``jobs_per_point`` replicates each
    point with independent seeds (job numbers 1..jobs_per_point inside
    the point's Gamma/kappa-encoded directory).  Member order in the
    returned results list is point-major.  Returns (results,
    member_cfgs)."""
    allowed = {"gamma", "kappa"}
    member_cfgs = []
    for pt in points:
        ov = dict(pt)
        bad = set(ov) - allowed
        if bad:
            # only parameters the traced pipeline reads per member can
            # vary inside one fold; n/timestep/step counts shape the
            # compiled program itself
            raise ValueError(f"sweep points can only override "
                             f"{sorted(allowed)}, got {sorted(bad)}")
        for r in range(jobs_per_point):
            member_cfgs.append(
                dataclasses.replace(cfg, job=r + 1, **ov))
    keys = jax.random.split(jax.random.PRNGKey(seed), len(member_cfgs))
    gammas = jnp.asarray([m.gamma for m in member_cfgs], cfg.np_dtype)
    ldebs = jnp.asarray([m.ldeb for m in member_cfgs], cfg.np_dtype)
    results = _run_batched(cfg, member_cfgs, keys, gammas, ldebs,
                           mesh=mesh)
    return results, member_cfgs


def _write_outputs(cfg: MCTransportConfig, res: dict) -> None:
    d = mc_transport_dir(cfg.save_directory, gamma=cfg.gamma,
                         kappa=cfg.kappa, n=cfg.n, job=cfg.job)
    w = DatWriter(d)
    dr = 0.05
    # the reference writes only int((L/2)/dr) rows (the r < L/2 cap,
    # MonteCarlo...cpp:627/649) — not the full 400-slot array
    n_gr = int((cfg.L / 2.0) / dr)
    rr = np.arange(n_gr) * dr

    for i, g in enumerate(res["gr_mc"]):
        w.write(f"pairPairCorrStepNum{i * cfg.gr_every_mc}.dat",
                np.stack([rr, g[:n_gr]], -1))
    # record-phase g(r) snapshots (the reference reuses the same filename
    # pattern with the record-step index, MonteCarlo...cpp:1099)
    for i, g in enumerate(res["gr_record"]):
        w.write(f"pairPairCorrStepNum{i * cfg.gr_every_record}.dat",
                np.stack([rr, g[:n_gr]], -1))
    t_axis = np.arange(cfg.record_steps) * cfg.timestep
    for name, arr in (("VAF", res["vaf"]), ("longViscAutoCorr", res["long_visc"]),
                      ("vCubeAutoCorr", res["v_cube"]),
                      ("vFourthAutoCorr", res["v_fourth"])):
        w.write(f"{name}.dat", np.stack([t_axis, arr], -1))
    w.write("temperature.dat", res["temps"][:, None])
    names = ("taggedVOneMoments", "taggedVTwoMoments", "taggedVThreeMoments",
             "taggedVFourMoments")
    for k, name in enumerate(names):
        w.write(f"{name}.dat",
                np.concatenate([t_axis[:, None], res["moments"][:, k]], -1))
    for fname, arr in (("TemperaturesAlongAxesInstantaneous.dat",
                        res["temps_inst"]),
                       ("TemperaturesAlongAxesDuringForcePeriod.dat",
                        res["temps_force"]),
                       ("TemperaturesAlongAxesAfterForcePeriod.dat",
                        res["temps_relax"])):
        steps = np.arange(arr.shape[0]) * cfg.timestep
        w.write(fname, np.concatenate([steps[:, None], arr], -1))
