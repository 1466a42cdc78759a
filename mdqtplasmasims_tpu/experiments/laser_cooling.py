"""Flagship experiment: MDQT laser cooling + expansion of a Sr+ Yukawa OCP.

JAX re-expression of laserCoolingPlusExpansionMDQTSpeedUp.cpp — the
reference's north-star configuration (N0=3500, Ge=0.1, density=2, tmax=30,
12-level S/P/D scheme with S->P cooling and D->P repump lasers along x, in a
self-similarly expanding frame).

Design: the full run compiles to a single ``lax.scan`` over output segments,
each segment an inner scan over ``sample_freq`` multirate MD steps (forces
refreshed once per MD step; drift/kick + QT at the quantum substep — the
SpeedUp scheme, reference lines 1365-1378).  All diagnostics (energies, KDE
velocity distributions, S/P/D populations-vs-velocity) are computed on
device and stacked; the host fetches once at the end and writes the
reference-compatible .dat files.

Output cadence: samples are emitted at the reference's exact instant —
one quantum tick into the sampling MD step (the
``(c0+1)%sampleFreq==0 && timeStepCounter==1`` gate, SpeedUp.cpp:
1365-1368) — by splitting that MD step's tick block at trace time into
[forces; 1 tick] -> sample -> [ratio-1 ticks, same forces].  Sample k
lands at t = ((k*sampleFreq-1)*ratio+1)*qdt, the identical grid the
compiled binary writes (no timestamp offset across resume splices).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.init import frozen_gas_init
from ..core.md import kinetic_energies
from ..core.qt import QTEngine, state_populations
from ..core.scheduler import CoolingScheduler, fold_sweep_lanes
from ..io import checkpoint as ckpt
from ..io.datfiles import DatWriter
from ..io.dirs import cooling_dir
from ..levels import sr12_cooling, with_recoil
from ..ops.kde import folded_bins, folded_bins_np, gaussian_kde
from ..ops.yukawa import (best_forces_fn, yukawa_forces_soa,
                          yukawa_forces_soa_batched, yukawa_potential)
from ..routing import TRITON, kernel_route
from ..state import SimState, make_state
from ..units import (PlasmaUnits, QTUnits, VKICK_408_QUANTUM, K_RATIO_1033,
                     qt_units_408)

S_MANIFOLD = (0, 1)
P_MANIFOLD = (2, 3, 4, 5)
D_MANIFOLD = (6, 7, 8, 9, 10, 11)


@dataclasses.dataclass(frozen=True)
class CoolingConfig:
    """User inputs of the reference (README.md:40-55; SpeedUp.cpp:56-108)."""

    ge: float = 0.1
    density: float = 2.0          # units of 1e14 m^-3
    sig0: float = 4.0             # initial cloud width, mm
    te: float = 19.0              # electron temperature, K
    frac_of_sig: float = 0.0      # chunk position in units of sigma
    n0: int = 3500
    detuning: float = -1.0        # SP detuning / gamma_SP
    detuning_dp: float = 1.0      # DP detuning / gamma_SP
    om: float = 1.0               # SP Rabi freq / gamma_SP
    om_dp: float = 1.0            # DP Rabi freq / gamma_SP
    tmax: float = 30.0
    timestep: float = 0.002
    sample_freq: int = 40
    renormalize: bool = False
    # "speedup" (laserCoolingPlusExpansionMDQTSpeedUp.cpp, the current
    # generation) or "pre_speedup" (LaserCoolingPlusExpansionMDQT.cpp:502's
    # sqrt(dr)-smaller DP Ehrenfest kick) — see levels.sr12_cooling
    physics: str = "speedup"
    job: int = 1
    exact_n: bool = True          # pin N = n0 (False: Poissonian as reference)
    dtype: str = "float32"
    # the fused tick-block kernel (core/qt_fused.py) on the GPU route;
    # False keeps the plain XLA per-tick path there too
    fused: bool = True
    # run the fused kernel in the Pallas *interpreter* on any platform —
    # lets the CPU tests and the multi-device dry run exercise the exact
    # program the GPU runs
    fused_interpret: bool = False
    save_directory: Optional[str] = None   # base dir; None = no file output
    # interval diagnostics of the pre-SpeedUp code (active in
    # LaserCoolingPlusExpansionMDQT.cpp:1252-1362; commented out of the
    # SpeedUp main) — evaluated post-hoc from per-sample phase-space
    # snapshots, which is exact because the reference also only evaluates
    # them at sample times:
    record_snapshots: bool = False         # keep V (and R) per sample
    vaf_intervals: tuple = ()              # start times, e.g. (3,5,...,27)
    record_lccf: bool = False              # J(k) per sample (needs snapshots)
    # periodic checkpointing (the reference only checkpoints at the end;
    # a crash mid-run loses everything — SURVEY.md section 5):
    checkpoint_every_segments: int = 0     # 0 = terminal only

    @property
    def units(self) -> QTUnits:
        return qt_units_408(self.density)

    @property
    def ratio(self) -> int:
        return self.units.ratio_cooling()

    @property
    def qdt(self) -> float:
        return self.timestep / self.ratio

    @property
    def vkick(self) -> float:
        return VKICK_408_QUANTUM / self.units.plas_to_quant_vel

    @property
    def np_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


def build_engine(cfg: CoolingConfig) -> QTEngine:
    scheme = with_recoil(
        sr12_cooling(cfg.detuning, cfg.detuning_dp, cfg.om, cfg.om_dp,
                     gs_convention=cfg.physics),
        kick_s=cfg.vkick, kick_d=cfg.vkick * K_RATIO_1033)
    u = cfg.units
    return QTEngine(scheme, h=cfg.qdt * u.gamma_to_einstein,
                    dt_plasma=cfg.qdt,
                    plas_to_quant_vel=u.plas_to_quant_vel,
                    gamma_to_einstein=u.gamma_to_einstein,
                    apply_force=True, renormalize=cfg.renormalize)


def om_split_schemes(cfg: CoolingConfig):
    """Base coupling patterns for per-lane Rabi sweeps: the sr12 scheme
    at (om=1, om_dp=0) and (om=0, om_dp=1).  Every coupling, beat-note
    coefficient, and Ehrenfest force weight is linear in its Rabi
    frequency (levels.py:172-211), so H = om*H_sp + om_dp*H_dp + diag
    exactly; the fused kernel scales the two patterns by [2, Np] lane
    rows (core/qt_fused.py per_lane_om)."""
    ks, kd = cfg.vkick, cfg.vkick * K_RATIO_1033
    sp = with_recoil(sr12_cooling(cfg.detuning, cfg.detuning_dp, om=1.0,
                                  om_dp=0.0, gs_convention=cfg.physics),
                     kick_s=ks, kick_d=kd)
    dp = with_recoil(sr12_cooling(cfg.detuning, cfg.detuning_dp, om=0.0,
                                  om_dp=1.0, gs_convention=cfg.physics),
                     kick_s=ks, kick_d=kd)
    return sp, dp


def expansion_coeffs(cfg: CoolingConfig):
    """(c1, c2) of the expanding-frame detuning c1*t/sqrt(1+c2*t^2)
    (SpeedUp.cpp:447)."""
    c1 = 0.0126 * cfg.frac_of_sig * cfg.te / (math.sqrt(cfg.density) * cfg.sig0)
    c2 = 0.00014314 * cfg.te / (cfg.density * cfg.sig0 ** 2)
    return c1, c2


def expansion_detuning_fn(cfg: CoolingConfig):
    """Time-dependent expanding-frame detuning (SpeedUp.cpp:447), traced."""
    c1, c2 = expansion_coeffs(cfg)

    def f(t):
        return c1 * t / jnp.sqrt(1.0 + c2 * t * t)
    return f


def uses_fused_kernel(cfg: CoolingConfig) -> bool:
    """Whether ``cfg`` runs the fused tick-block kernel: on the Triton
    route (routing.kernel_route), or anywhere in the interpreter when
    asked by name; f32 only."""
    return (cfg.fused and cfg.dtype == "float32"
            and (cfg.fused_interpret or kernel_route() == TRITON))


def build_scheduler(cfg: CoolingConfig, mask=None) -> CoolingScheduler:
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    forces_fn = best_forces_fn(cfg.n0, L, pu.debye_length, mask=mask)
    engine = build_engine(cfg)
    fused_spec = None
    if uses_fused_kernel(cfg) and mask is None:
        from ..core.qt_fused import FusedTickSpec
        c1, c2 = expansion_coeffs(cfg) if cfg.frac_of_sig else (0.0, 0.0)
        fused_spec = FusedTickSpec(
            scheme=engine.scheme, h=engine.h, qdt=cfg.qdt,
            plas_to_quant_vel=engine.plas_to_quant_vel,
            gamma_to_einstein=engine.gamma_to_einstein, ratio=cfg.ratio,
            L=L, apply_force=True, exp_c1=c1, exp_c2=c2,
            renormalize=cfg.renormalize)
    return CoolingScheduler(
        engine=engine, forces_fn=forces_fn, L=L, qdt=cfg.qdt,
        ratio=cfg.ratio,
        exp_det_fn=expansion_detuning_fn(cfg) if cfg.frac_of_sig else None,
        fused_spec=fused_spec, interpret=cfg.fused_interpret)


def initial_state(cfg: CoolingConfig, seed: Optional[int] = None) -> SimState:
    key = jax.random.PRNGKey(cfg.job if seed is None else seed)
    k_init, k_run = jax.random.split(key)
    R, V, psi, n = frozen_gas_init(k_init, cfg.n0, n_states=12,
                                   exact_n=cfg.exact_n, dtype=cfg.np_dtype,
                                   seed_for_count=cfg.job)
    return make_state(R, V, psi, k_run, dtype=cfg.np_dtype)


def _sample_outputs(state: SimState, cfg: CoolingConfig, L, ldeb, bins,
                    mask=None):
    """On-device observables for one output sample (reference output()).
    ``mask`` marks real ions when the member carries padded lanes (the
    Poissonian-N ensemble fold); padded lanes are inert (R=0, V=0,
    psi=0) and excluded from every reduction."""
    ekx, eky, ekz, vx_mean = kinetic_energies(state.V, subtract_mean_vx=True,
                                              mask=mask)
    epot = yukawa_potential(state.R, L, ldeb, mask=mask)
    vx = state.V[:, 0] - vx_mean
    pvel_x = gaussian_kde(vx, bins, folded=True, weights=mask)
    pvel_y = gaussian_kde(state.V[:, 1], bins, folded=True, weights=mask)
    pvel_z = gaussian_kde(state.V[:, 2], bins, folded=True, weights=mask)
    pops = state_populations(state.psi, [S_MANIFOLD, P_MANIFOLD, D_MANIFOLD])
    out = dict(
        t=state.t, ekin=jnp.stack([ekx, eky, ekz]), epot=epot,
        vx_mean=vx_mean, pvel=jnp.stack([pvel_x, pvel_y, pvel_z]),
        vx_ions=state.V[:, 0], pops=jnp.stack(pops, axis=-1))
    if cfg.record_snapshots or cfg.vaf_intervals or cfg.record_lccf:
        out["V"] = state.V
        if cfg.record_lccf:
            out["R"] = state.R
    return out


def _make_advance(sched, L, ldeb):
    """``(advance, advance_sampled)`` closures shared by
    :func:`run_compiled` and :func:`run_compiled_span` (single source for
    the stepping logic, so the off-grid span path cannot diverge from the
    segment path).

    ``advance(state, n_steps)`` runs whole MD steps;
    ``advance_sampled(state, n_steps) -> (state_mid, state_end)``
    additionally splits the LAST MD step at the reference's output
    instant — the (c0+1)%sampleFreq==0 && timeStepCounter==1 gate fires
    one quantum tick into the sampling MD step
    (SpeedUp.cpp:1365-1368) — so ``state_mid`` is the exact state the
    reference's output() sees (t = ((k*f-1)*ratio+1)*qdt) and
    ``state_end`` completes the step with the same forces.

    Fused path: SoA-resident stepping — stay in the fused kernel's
    [rows, Np] layout for all ``n_steps`` MD steps; convert to SimState
    only at the boundaries (scheduler.py soa_* helpers).  The mask is
    built from the *actual* ion count (which differs from cfg.n0 when
    exact_n=False draws a Poissonian N), not from cfg.n0."""
    if sched.fused_spec is not None:
        def make_soa_forces(state):
            n_actual = state.R.shape[0]
            npad = sched._npad(n_actual)
            mask_row = jnp.zeros((1, npad),
                                 jnp.float32).at[0, :n_actual].set(1.0)
            return lambda Rp: yukawa_forces_soa(Rp, mask_row, L, ldeb)

        def advance(state, n_steps):
            soa_forces = make_soa_forces(state)
            carry = jax.lax.fori_loop(
                0, n_steps, lambda i, c: sched.soa_md_step(c, soa_forces),
                sched.soa_init(state, state.F))
            return sched.soa_restore(carry, state)

        def advance_sampled(state, n_steps):
            soa_forces = make_soa_forces(state)
            carry = jax.lax.fori_loop(
                0, n_steps - 1,
                lambda i, c: sched.soa_md_step(c, soa_forces),
                sched.soa_init(state, state.F))
            carry = sched.soa_md_step(carry, soa_forces, n_ticks=1)
            state_mid = sched.soa_restore(carry, state)
            if sched.ratio > 1:
                carry = sched.soa_md_step(carry, soa_forces,
                                          n_ticks=sched.ratio - 1,
                                          reuse_forces=True)
            return state_mid, sched.soa_restore(carry, state)
    else:
        def advance(state, n_steps):
            return jax.lax.fori_loop(
                0, n_steps, lambda i, s: sched.md_step(s), state)

        def advance_sampled(state, n_steps):
            state = jax.lax.fori_loop(
                0, n_steps - 1, lambda i, s: sched.md_step(s), state)
            F, _ = sched.forces_fn(state.R)
            state_mid = sched.substeps(state, F, n_ticks=1)
            state_end = (sched.substeps(state_mid, F,
                                        n_ticks=sched.ratio - 1)
                         if sched.ratio > 1 else state_mid)
            return state_mid, state_end
    return advance, advance_sampled


@partial(jax.jit, static_argnames=("cfg", "n_segments"))
def run_compiled(cfg: CoolingConfig, state: SimState, n_segments: int):
    """The full cooling run as one device program.

    Returns final state + stacked per-sample outputs.
    """
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    sched = build_scheduler(cfg)
    bins = folded_bins(cfg.np_dtype)
    _, advance_sampled = _make_advance(sched, L, pu.debye_length)

    def segment(state, _):
        # sample exactly at the reference's output instant: one quantum
        # tick into the segment's last MD step (SpeedUp.cpp:1365-1368)
        state_mid, state = advance_sampled(state, cfg.sample_freq)
        return state, _sample_outputs(state_mid, cfg, L, pu.debye_length,
                                      bins)

    return jax.lax.scan(segment, state, None, length=n_segments)


@partial(jax.jit, static_argnames=("cfg", "n_steps", "sample"))
def run_compiled_span(cfg: CoolingConfig, state: SimState, n_steps: int,
                      sample: bool = True):
    """A partial segment off the sample grid: advance ``n_steps`` MD
    steps, optionally taking one output sample at the reference instant
    (one quantum tick into the final MD step — see _make_advance).

    The reference main loop runs to tmax regardless of sample-grid
    alignment (while t <= tmax+0.0009, SpeedUp.cpp:1247) and its output
    gate is *global* ((c0+1)%sampleFreq==0, :1365), so when tmax is not
    a multiple of sampleFreq*dt the run has a trailing sub-segment, and
    a chained window (tmax extension restart) must first realign to the
    global gate.  ``run`` composes this with :func:`run_compiled` for
    both cases."""
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    sched = build_scheduler(cfg)
    advance, advance_sampled = _make_advance(sched, L, pu.debye_length)
    if not sample:
        return advance(state, n_steps), None
    state_mid, state = advance_sampled(state, n_steps)
    bins = folded_bins(cfg.np_dtype)
    outs = _sample_outputs(state_mid, cfg, L, pu.debye_length, bins)
    # leading sample axis of length 1, matching run_compiled's stack
    return state, jax.tree.map(lambda a: jnp.asarray(a)[None], outs)


def run_compiled_ensemble(cfg: CoolingConfig, states: SimState,
                          n_segments: int, mask=None, sweep_e0=None,
                          sweep_om=None, seg_len: Optional[int] = None,
                          tail: int = 0):
    """Batched-ensemble run: pair forces are vmapped over the job axis;
    on the fused path the quantum-substepped leapfrog folds all jobs into
    the tick kernel's ion axis (per-ion independent), else the XLA
    substep loop is vmapped.

    ``mask [E, N]`` marks each member's real ions when members carry
    Poissonian ion counts (reference init draws a fresh N per array job,
    SpeedUp.cpp:289-348): padded lanes start at R=V=psi=0 and stay
    exactly there (the pair forces mask both the row and source sides,
    so their forces are zero, and zero wavefunctions neither jump nor
    kick), and every diagnostic reduction excludes them.

    ``sweep_e0 [E, S]`` gives each member its own diagonal energies — a
    *detuning sweep* running as one fused dispatch (the reference user
    recompiles the binary per (detSP, detDP) point; detunings enter the
    physics only through e0, levels.py:151-156).  ``sweep_om [E, 2]``
    additionally gives each member its own (om, om_dp) Rabi frequencies
    (H is linear in each — see om_split_schemes).  Fused path only.

    ``seg_len`` overrides the per-segment step count (splice
    realignment after a previous window's off-grid tmax — see
    run_compiled_span); ``tail`` appends that many un-sampled MD steps
    after the last segment (the reference runs to tmax regardless of
    the sample grid, SpeedUp.cpp:1247), so the returned states hold the
    true tmax state for the terminal checkpoint."""
    from ..core.scheduler import check_uniform_tick
    # the fold applies tick[0]'s first-step drift flag and expansion-frame
    # time to every member.  This wrapper is deliberately NOT jitted:
    # under jit the tick would be a tracer on every trace (and the traced
    # Python body would not re-run on cached calls at all), so the check
    # must sit host-side, before the jit boundary, to ever fire.
    check_uniform_tick(states.tick)
    return _run_compiled_ensemble(cfg, states, n_segments, mask, sweep_e0,
                                  sweep_om, seg_len, tail)


@partial(jax.jit, static_argnames=("cfg", "n_segments", "seg_len", "tail"))
def _run_compiled_ensemble(cfg: CoolingConfig, states: SimState,
                           n_segments: int, mask=None, sweep_e0=None,
                           sweep_om=None, seg_len: Optional[int] = None,
                           tail: int = 0):
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    sched = build_scheduler(cfg)
    if sweep_e0 is not None or sweep_om is not None:
        if sched.fused_spec is None:
            raise ValueError(
                "laser-parameter sweeps fold through the fused tick "
                "kernel, which routing.kernel_route selects on the GPU "
                "(or fused_interpret=True anywhere); loop run() over the "
                "sweep points instead")
        upd = {}
        if sweep_e0 is not None:
            upd["per_lane_e0"] = True
        if sweep_om is not None:
            ssp, sdp = om_split_schemes(cfg)
            upd.update(per_lane_om=True, scheme_sp=ssp, scheme_dp=sdp)
        sched = dataclasses.replace(
            sched, fused_spec=dataclasses.replace(sched.fused_spec, **upd))
    bins = folded_bins(cfg.np_dtype)

    def batched_forces(R):
        if mask is None:
            return jax.vmap(lambda r: sched.forces_fn(r)[0])(R)
        return jax.vmap(lambda r, m: best_forces_fn(
            cfg.n0, L, pu.debye_length, mask=m)(r)[0])(
                R, mask.astype(R.dtype))

    def sample(states):
        if mask is None:
            return jax.vmap(lambda s: _sample_outputs(
                s, cfg, L, pu.debye_length, bins))(states)
        return jax.vmap(lambda s, m: _sample_outputs(
            s, cfg, L, pu.debye_length, bins,
            mask=m.astype(cfg.np_dtype)))(states, mask)

    if sched.fused_spec is not None:
        # fold the job axis into the fused kernel's ion axis (one kernel
        # launch per MD step for the whole ensemble) and stay in folded
        # [rows, E*npad] planes for the whole sampling segment — the
        # SimState<->plane conversion happens once per sample, not per
        # MD step (scheduler.py soa_ens_*)
        E, n_actual = states.R.shape[0], states.R.shape[1]
        npad = sched._npad(n_actual)
        if mask is None:
            mask_rows = jnp.zeros((1, npad),
                                  jnp.float32).at[0, :n_actual].set(1.0)
        else:
            mask_rows = jnp.zeros((E, npad), jnp.float32).at[
                :, :n_actual].set(mask.astype(jnp.float32))
        soa_forces = lambda Rp: yukawa_forces_soa_batched(
            Rp, mask_rows, E, L, pu.debye_length)

        e0p, omp = fold_sweep_lanes(sched.fused_spec, npad,
                                    sweep_e0=sweep_e0, sweep_om=sweep_om)

        def advance(states, n_steps):
            carry = jax.lax.fori_loop(
                0, n_steps,
                lambda i, c: sched.soa_ens_md_step(c, soa_forces,
                                                   e0_lanes=e0p,
                                                   om_lanes=omp),
                sched.soa_ens_init(states, states.F))
            return sched.soa_ens_restore(carry, states)

        def advance_sampled(states, n_steps):
            # split the last MD step at the reference's output instant
            # (SpeedUp.cpp:1365-1368; see _make_advance)
            carry = jax.lax.fori_loop(
                0, n_steps - 1,
                lambda i, c: sched.soa_ens_md_step(c, soa_forces,
                                                   e0_lanes=e0p,
                                                   om_lanes=omp),
                sched.soa_ens_init(states, states.F))
            carry = sched.soa_ens_md_step(carry, soa_forces, e0_lanes=e0p,
                                          om_lanes=omp, n_ticks=1)
            states_mid = sched.soa_ens_restore(carry, states)
            if sched.ratio > 1:
                carry = sched.soa_ens_md_step(carry, soa_forces,
                                              e0_lanes=e0p, om_lanes=omp,
                                              n_ticks=sched.ratio - 1,
                                              reuse_forces=True)
            return states_mid, sched.soa_ens_restore(carry, states)
    else:
        def md_step(states):
            F = batched_forces(states.R)
            return jax.vmap(sched.substeps)(states, F)

        def advance(states, n_steps):
            return jax.lax.fori_loop(0, n_steps,
                                     lambda i, s: md_step(s), states)

        def advance_sampled(states, n_steps):
            states = jax.lax.fori_loop(0, n_steps - 1,
                                       lambda i, s: md_step(s), states)
            F = batched_forces(states.R)
            states_mid = jax.vmap(
                lambda s, f: sched.substeps(s, f, n_ticks=1))(states, F)
            states_end = (jax.vmap(lambda s, f: sched.substeps(
                s, f, n_ticks=sched.ratio - 1))(states_mid, F)
                if sched.ratio > 1 else states_mid)
            return states_mid, states_end

    def segment(states, _):
        states_mid, states = advance_sampled(states,
                                             seg_len or cfg.sample_freq)
        return states, sample(states_mid)

    states, outs = jax.lax.scan(segment, states, None, length=n_segments)
    if tail:
        states = advance(states, tail)
    # [n_segments, E, ...] -> [E, n_segments, ...] (per-job layout)
    outs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), outs)
    return states, outs


def run_compiled_sharded(cfg: CoolingConfig, mesh, states: SimState,
                         n_segments: int, mask=None, sweep_e0=None,
                         sweep_om=None, seg_len: Optional[int] = None,
                         tail: int = 0):
    """Multi-device ensemble run on the production program: trajectories
    are sharded over the mesh's ``ens`` axis (ions optionally over
    ``ions``), and each device advances its local members through the
    fused tick-block kernel + XLA pair forces — the same program a single
    device runs, SPMD over the mesh (parallel/ensemble.py
    fused_local_stepper).  Diagnostics are computed on the sharded states
    under GSPMD (cross-shard reductions inserted automatically).  ``cfg``
    must enable the fused path (the GPU route, or ``fused_interpret=True``
    on a CPU mesh).  ``sweep_e0 [E, S]`` runs
    the members as a detuning sweep (sharded over ``ens`` like the
    states; see run_compiled_ensemble)."""
    from ..core.scheduler import check_uniform_tick
    # host-side, before the jit boundary — under jit the guard could
    # never fire (tracer on trace, no Python body on cached calls); see
    # run_compiled_ensemble
    check_uniform_tick(states.tick)
    return _run_compiled_sharded(cfg, mesh, states, n_segments, mask,
                                 sweep_e0, sweep_om, seg_len, tail)


@partial(jax.jit,
         static_argnames=("cfg", "n_segments", "mesh", "seg_len", "tail"))
def _run_compiled_sharded(cfg: CoolingConfig, mesh, states: SimState,
                          n_segments: int, mask=None, sweep_e0=None,
                          sweep_om=None, seg_len: Optional[int] = None,
                          tail: int = 0):
    from ..parallel.ensemble import fused_local_stepper
    from ..parallel.mesh import ION_AXIS, state_pspec
    from jax import shard_map

    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    sched = build_scheduler(cfg)
    if sched.fused_spec is None:
        raise ValueError("run_compiled_sharded requires the fused tick "
                         "kernel: the GPU route of routing.kernel_route, "
                         "or cfg.fused_interpret=True")
    if sweep_e0 is not None or sweep_om is not None:
        upd = {}
        if sweep_e0 is not None:
            upd["per_lane_e0"] = True
        if sweep_om is not None:
            ssp, sdp = om_split_schemes(cfg)
            upd.update(per_lane_om=True, scheme_sp=ssp, scheme_dp=sdp)
        sched = dataclasses.replace(
            sched, fused_spec=dataclasses.replace(sched.fused_spec, **upd))
    bins = folded_bins(cfg.np_dtype)
    spec = state_pspec()
    from ..parallel.mesh import ENS_AXIS
    from jax.sharding import PartitionSpec as P
    local = fused_local_stepper(sched, pu.debye_length,
                                mesh.shape[ION_AXIS])
    # optional operands (Poisson mask, sweep energies) enter shard_map as
    # keyword-bound positionals so every combination shares one wrapper
    in_specs = [spec]
    names = []
    if mask is not None:
        in_specs.append(P(ENS_AXIS, ION_AXIS))
        names.append("mask")
    if sweep_e0 is not None:
        in_specs.append(P(ENS_AXIS, None))
        names.append("sweep_e0")
    if sweep_om is not None:
        in_specs.append(P(ENS_AXIS, None))
        names.append("sweep_om")

    def local_seg(s, *opt):
        kw = dict(zip(names, opt))
        # split the segment's last MD step at the reference's output
        # instant (SpeedUp.cpp:1365-1368): the sampler below sees the
        # mid state, the scan carries the completed step
        return local(s, seg_len or cfg.sample_freq, split_last=True,
                     **kw)

    # check_vma=False: Pallas kernels inside shard_map lack varying-axes
    # metadata (see parallel/ensemble.py make_sharded_fused_step)
    seg = shard_map(local_seg, mesh=mesh, in_specs=tuple(in_specs),
                    out_specs=(spec, spec), check_vma=False)
    opt_args = tuple(a for a in (mask, sweep_e0, sweep_om)
                     if a is not None)

    def segment(states, _):
        states_mid, states = seg(states, *opt_args)
        if mask is None:
            outs = jax.vmap(lambda s: _sample_outputs(
                s, cfg, L, pu.debye_length, bins))(states_mid)
        else:
            outs = jax.vmap(lambda s, m: _sample_outputs(
                s, cfg, L, pu.debye_length, bins,
                mask=m.astype(cfg.np_dtype)))(states_mid, mask)
        return states, outs

    states, outs = jax.lax.scan(segment, states, None, length=n_segments)
    if tail:
        # trailing un-sampled sub-segment to tmax (see
        # run_compiled_ensemble); same shard_map wrapper, shorter span
        def local_tail(s, *opt):
            kw = dict(zip(names, opt))
            return local(s, tail, **kw)
        states = shard_map(local_tail, mesh=mesh, in_specs=tuple(in_specs),
                           out_specs=spec, check_vma=False)(states,
                                                            *opt_args)
    outs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), outs)
    return states, outs


def _save_dir(cfg: CoolingConfig) -> str:
    return cooling_dir(cfg.save_directory, ge=cfg.ge, density=cfg.density,
                       sig0=cfg.sig0, te=cfg.te, frac_of_sig=cfg.frac_of_sig,
                       detuning=cfg.detuning, detuning_dp=cfg.detuning_dp,
                       om=cfg.om, om_dp=cfg.om_dp, n0=cfg.n0, job=cfg.job)


def canonical_run_cfg(cfg: CoolingConfig) -> CoolingConfig:
    """Strip config fields that don't affect the traced program so jit/
    remote-compile caches are shared across uses (recompiles can be
    minutes-slow on this backend)."""
    return dataclasses.replace(cfg, save_directory=None,
                               checkpoint_every_segments=0, job=1,
                               tmax=0.0, exact_n=True)


def latest_checkpoint(directory: str) -> Optional[int]:
    """Highest c0 among native checkpoints in a run directory."""
    from ..io.checkpoint import latest_native_checkpoint
    return latest_native_checkpoint(directory)


def run(cfg: CoolingConfig, seed: Optional[int] = None,
        state: Optional[SimState] = None, resume: bool = False,
        vholder0=None):
    """Execute the experiment; write reference-schema .dat files when
    ``cfg.save_directory`` is set.  Returns (final_state, outputs dict).

    With ``checkpoint_every_segments`` set, the run is split into groups of
    segments with a native checkpoint published after each (the reference
    only checkpoints at the very end, losing everything on a crash).
    ``resume=True`` continues from the newest native checkpoint in the run
    directory — the equivalent of the reference's walltime-window
    chaining with ``newRun=0, c0=<last timestep>`` (README.md:51-53).

    tmax need not be a multiple of sample_freq*timestep: like the
    reference (while t<=tmax+0.0009, SpeedUp.cpp:1247) the run simulates
    the trailing sub-segment past the last output gate, and a chained
    window realigns to the global gate so the sample grid matches an
    uninterrupted run's (proven against the compiled binary both ways —
    tools/cross_validate_resume.py directions C/D)."""
    done = 0
    step_done = None      # MD steps already simulated; done*f when aligned
    epot0_resume = None
    save_dir = _save_dir(cfg) if cfg.save_directory is not None else None
    if resume and save_dir is not None and state is None:
        c0_last = latest_checkpoint(save_dir)
        # newest checkpoint wins across formats: after the reference
        # binary continues a framework run (interop chaining) only the
        # ASCII conditions_/wvFns_/ions_ files advance, and resuming
        # from a stale native .npz would replay covered steps and
        # append duplicate .dat rows
        c0_ascii = ckpt.latest_ascii_checkpoint(save_dir)
        if c0_ascii is not None and (c0_last is None or c0_ascii > c0_last):
            state = resume_state(save_dir, c0_ascii, cfg)
            _, done = ckpt.read_ions(save_dir, c0_ascii)
            # a previous window whose tmax ended off the sample grid
            # leaves the state past the last sample; the loop below
            # realigns to the global gate with one partial segment
            step_done = c0_ascii + 1
            if vholder0 is None and cfg.vaf_intervals:
                vholder0 = resume_vholder(save_dir, c0_ascii)
            # the ASCII schema does not carry Epot0; the reference's
            # global stays 0.0 on a newRun=0 restart (SpeedUp.cpp:119,
            # 346 — assigned only in init()), so the audit column
            # continues with Epot0=0 exactly as the reference's does
            epot0_resume = 0.0
        elif c0_last is not None:
            z = ckpt.load_native(save_dir, c0_last)
            # continue the checkpointed RNG stream when available; fall
            # back to a deterministic reseed for pre-round-3 checkpoints
            key = (_key_restore(z["key"]) if "key" in z
                   else jax.random.PRNGKey(cfg.job * 7919 + c0_last))
            state = make_state(z["R"], z["V"], z["psi"], key,
                               dtype=cfg.np_dtype)
            tick = (c0_last + 1) * cfg.ratio
            state = state._replace(tick=jnp.asarray(tick, jnp.int32),
                                   t=jnp.asarray(tick * cfg.qdt,
                                                 cfg.np_dtype))
            if "t_part" in z:      # lossless native resume (see save)
                state = state._replace(
                    t_part=jnp.asarray(z["t_part"], cfg.np_dtype))
            done = int(z["counter"])
            step_done = c0_last + 1
            # the t=0 potential rides the checkpoint: the energies.dat
            # total-change column is Ekin+Epot-Epot0 with Epot0 from
            # *initialization* (SpeedUp.cpp never reassigns it on a
            # newRun=0 restart) — recomputing it from the restored R
            # would put a jump at the splice
            if "epot0" in z:
                epot0_resume = float(z["epot0"])
            # VAF-interval v0 snapshots ride the checkpoint too, so
            # intervals that started before the splice keep streaming
            # (the reference re-reads VZERO into Vholder on restart,
            # SpeedUp.cpp:901-909)
            if vholder0 is None and "vholder" in z:
                vholder0 = z["vholder"]
    if state is None:
        state = initial_state(cfg, seed)
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    epot0 = (epot0_resume if epot0_resume is not None
             else yukawa_potential(state.R, L, pu.debye_length))

    n_md = int(round(cfg.tmax / cfg.timestep))
    f = cfg.sample_freq
    n_segments = n_md // f          # total output samples (global gate)
    group = cfg.checkpoint_every_segments or n_segments
    cfg_run = canonical_run_cfg(cfg)
    if step_done is None:
        step_done = done * f
    aligned = n_md == n_segments * f

    outs_groups = []
    epot0_f: Optional[float] = None
    vh_carry = vholder0
    while done < n_segments:
        if step_done % f:
            # splice realignment: the previous window's tmax ended off
            # the sample grid, but the reference's output gate is global
            # ((c0+1)%sampleFreq==0, SpeedUp.cpp:1365) — one partial
            # segment lands the state back on it, with its sample
            g = 1
            state, outs = run_compiled_span(cfg_run, state,
                                            f - step_done % f)
        else:
            g = min(group, n_segments - done)
            state, outs = run_compiled(cfg_run, state, g)
        jax.block_until_ready(state)
        if epot0_f is None:
            epot0_f = float(epot0)
        outs_np = jax.device_get(outs)
        outs_groups.append(outs_np)
        prev_done = done
        done += g
        step_done = done * f
        if save_dir is not None:
            # stream this group's rows (the reference appends output()
            # rows at every sample — a crash loses at most one group),
            # then publish the native checkpoint; the .dat writes land
            # first so a crash between the two re-appends one group on
            # resume rather than leaving a gap
            st = jax.device_get(state)
            import os
            os.makedirs(save_dir, exist_ok=True)
            vh_carry = write_outputs(save_dir, cfg, outs_np, epot0_f, st,
                                     n_md, sample_offset=prev_done,
                                     vholder0=vh_carry,
                                     terminal=(done == n_segments
                                               and aligned))
            if done < n_segments:
                c0 = done * cfg.sample_freq - 1
                extra = {"epot0": epot0_f}
                key = getattr(state, "key", None)
                if key is not None:
                    # carry the RNG stream so a crash-resume continues the
                    # checkpointed trajectory rather than reseeding
                    extra["key"] = _key_payload(key)
                # the native format is lossless (unlike the reference's
                # ASCII schema, which drops tPart on restart —
                # SpeedUp.cpp:333 is the only assignment): carry the
                # per-ion quantum clock so a native resume is bit-exact
                extra["t_part"] = st.t_part
                ckpt.save_native(
                    save_dir, c0, R=st.R, V=st.V, psi=st.psi,
                    counter=done,
                    vholder=vh_carry if cfg.vaf_intervals else None,
                    extra=extra)

    if step_done < n_md:
        # trailing sub-segment past the last output gate: the reference
        # runs to tmax regardless of sample-grid alignment
        # (while t <= tmax+0.0009, SpeedUp.cpp:1247), so the terminal
        # checkpoint at c0 = n_md-1 must hold the true tmax state — a
        # chained window then realigns to the global gate above
        state, _ = run_compiled_span(cfg_run, state, n_md - step_done,
                                     sample=False)
        jax.block_until_ready(state)
        step_done = n_md
        if save_dir is not None:
            import os
            os.makedirs(save_dir, exist_ok=True)
            if epot0_f is None:
                epot0_f = float(epot0)
            write_terminal_checkpoint(save_dir, cfg, jax.device_get(state),
                                      n_md, done, vh_carry, epot0_f)

    if not outs_groups:           # resume found nothing left to do
        final_np = jax.device_get(state)
        return final_np, dict(outs=None, epot0=float(epot0), final=final_np)
    outs = jax.tree.map(lambda *xs: np.concatenate(xs), *outs_groups)
    final_np = jax.device_get(state)
    return final_np, dict(outs=outs, epot0=epot0_f, final=final_np)


def _key_payload(key) -> np.ndarray:
    """PRNG key -> checkpointable array (typed or legacy uint32)."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(key))
    return np.asarray(key)


def _key_restore(arr) -> jax.Array:
    return jnp.asarray(arr, jnp.uint32)


def _mesh_ion_round(n_arr: int, mesh) -> int:
    """Round the fold's padded lane count up to the mesh's ion-shard
    multiple — the sharded stepper splits the ion axis evenly across
    shards (matches _poisson_member_states' round_to on fresh runs)."""
    if mesh is None:
        return n_arr
    from ..parallel.mesh import ION_AXIS
    shards = mesh.shape[ION_AXIS]
    return -(-n_arr // shards) * shards


def _pad_rows(a, n_arr: int) -> np.ndarray:
    """Zero-pad axis 0 to ``n_arr`` rows on the host (numpy), before
    ``make_state`` moves the member to the device."""
    a = np.asarray(a)
    out = np.zeros((n_arr,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


def _stack_fold(members, n_js, n_arr: int):
    """Stack per-member states into the [E, ...] fold and build the
    Poissonian ion mask: returns ``(states, mask, n_js)`` with
    ``mask``/``n_js`` None when every member fills all ``n_arr`` lanes
    (shared by the ASCII- and native-resume rebuilds)."""
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    if all(nj == n_arr for nj in n_js):
        return states, None, None
    m = np.zeros((len(n_js), n_arr), np.float32)
    for j, nj in enumerate(n_js):
        m[j, :nj] = 1.0
    return states, jnp.asarray(m), n_js


def run_ensemble(cfg: CoolingConfig, n_jobs: int, seed: int = 0,
                 resume: bool = False, mesh=None, sweep=None):
    """Batched ensemble of independent trajectories — the batched
    replacement for the reference's SLURM job array
    (exampleSlurmFile.slurm).  Returns per-job stacked outputs; with
    ``cfg.save_directory`` set, writes each trajectory's .dat tree into
    ``job<k>/`` exactly as the reference's array jobs would.

    Pair forces are vmapped over the job axis; the quantum substep block
    runs all jobs through one fused kernel launch per MD step (vmapped
    XLA substeps on the plain XLA route).

    With ``checkpoint_every_segments`` set, each job's directory gets a
    native checkpoint (including its RNG key and VAF vholder) after every
    group and its .dat rows stream group-by-group — the ensemble version
    of the reference's per-job walltime chaining (README.md:51-53).
    ``resume=True`` reconstructs the fold from the newest checkpoint
    common to all job directories; members at inconsistent counters
    raise (the fold requires one shared tick).

    ``mesh`` runs the compute over a multi-chip ``jax.sharding.Mesh``
    (parallel/mesh.make_mesh): members shard over the ``ens`` axis and
    ions optionally over ``ions``, each device stepping its local fold
    through the same fused program a single device runs
    (run_compiled_sharded).  When ions are sharded, each force refresh
    all-gathers the member's positions and computes the local rows.
    Host-side file output, checkpointing and resume are identical —
    resume a mesh run with the same mesh.

    ``sweep`` makes the members a *parameter sweep* instead of replicas:
    a length-``n_jobs`` sequence of per-member overrides (dicts with keys
    among ``detuning``/``detuning_dp``/``job``).  The whole sweep still
    folds into ONE fused kernel launch per MD step (per-lane diagonal
    energies, core/qt_fused.py) — where the reference user edits the
    compile-time constants and rebuilds the binary per (detSP, detDP)
    point (SpeedUp.cpp:66-67), this runs the grid in one compiled
    program.  Each member's .dat tree lands in its own param-encoded
    directory, exactly as separate reference builds would.  Single- and
    multi-chip; checkpoint/resume per member works unchanged.  See
    ``run_sweep`` for the convenience grid builder."""
    import os
    save_directory = cfg.save_directory
    if mesh is not None:
        from ..parallel.mesh import ENS_AXIS, ION_AXIS
        if n_jobs % mesh.shape[ENS_AXIS] or (
                cfg.exact_n and cfg.n0 % mesh.shape[ION_AXIS]):
            raise ValueError(
                f"n_jobs {n_jobs} / n0 {cfg.n0} must divide the mesh "
                f"axes {dict(mesh.shape)}")
    n_md = int(round(cfg.tmax / cfg.timestep))
    n_segments = n_md // cfg.sample_freq
    group = cfg.checkpoint_every_segments or n_segments
    cfg_run = canonical_run_cfg(cfg)
    job_cfgs = [dataclasses.replace(cfg, job=j + 1) for j in range(n_jobs)]
    sweep_e0 = sweep_om = None
    if sweep is not None:
        if len(sweep) != n_jobs:
            raise ValueError(f"sweep has {len(sweep)} entries for "
                             f"{n_jobs} jobs")
        allowed = {"detuning", "detuning_dp", "om", "om_dp", "job"}
        keys = {k for s in sweep for k in s}
        bad = keys - allowed
        if bad:
            # only fields the fused kernel reads per lane can vary inside
            # one fold: detunings enter purely through the diagonal e0
            # and H is linear in each Rabi frequency (om_split_schemes)
            raise ValueError(f"sweep can only override {sorted(allowed)}, "
                             f"got {sorted(bad)}")
        job_cfgs = [dataclasses.replace(c, **dict(s))
                    for c, s in zip(job_cfgs, sweep)]
        if keys & {"detuning", "detuning_dp"}:
            sweep_e0 = jnp.asarray(np.stack(
                [build_engine(c).scheme.e0 for c in job_cfgs]),
                jnp.float32)
        if keys & {"om", "om_dp"}:
            sweep_om = jnp.asarray([[c.om, c.om_dp] for c in job_cfgs],
                                   jnp.float32)
    job_dirs = ([_save_dir(c) for c in job_cfgs]
                if save_directory is not None else None)

    done = 0
    step_done = None    # MD steps already simulated; done*f when aligned
    states = None
    mask = None                 # [E, n_arr] when members carry Poisson N
    n_js = None                 # per-member real ion counts
    epot0_np = None
    vholders = [None] * n_jobs
    if resume and job_dirs is not None:
        c0s = [latest_checkpoint(d) for d in job_dirs]
        c0s_ascii = [ckpt.latest_ascii_checkpoint(d) for d in job_dirs]
        have_native = all(c is not None for c in c0s)
        # newest checkpoint wins across formats, fold-wide (see run()):
        # after a reference binary continues each job of the array
        # (interop chaining, newRun=0 per job) only the ASCII
        # conditions_/wvFns_/ions_ files advance, and resuming the fold
        # from the stale .npz would replay covered steps and append
        # duplicate .dat rows
        use_ascii = (all(c is not None for c in c0s_ascii)
                     and (not have_native
                          or min(c0s_ascii) > min(c0s)))
        if use_ascii:
            c0set = set(c0s_ascii)
            if len(c0set) != 1:
                raise ValueError(
                    "ensemble members at inconsistent ASCII checkpoints "
                    f"{sorted(c0set)}; the fused fold requires one "
                    "shared tick")
            c0 = c0set.pop()
            counters = {ckpt.read_ions(d, c0)[1] for d in job_dirs}
            if len(counters) != 1:
                raise ValueError(
                    "ensemble members at inconsistent checkpoint "
                    f"counters {sorted(counters)}; the fused fold "
                    "requires one shared tick")
            done = counters.pop()
            step_done = c0 + 1
            hosts = [(ckpt.read_conditions(d, c0)
                      + (ckpt.read_wvfns(d, c0),)) for d in job_dirs]
            for d, (R_h, _, psi_h) in zip(job_dirs, hosts):
                if psi_h.shape[0] != R_h.shape[0]:
                    raise ValueError(
                        f"{d}: wvFns_timestep{c0:06d}.dat has "
                        f"{psi_h.shape[0]} rows for "
                        f"{R_h.shape[0]} ions — truncated or "
                        "mismatched member checkpoint")
            n_arr = _mesh_ion_round(max(int(R.shape[0])
                                        for R, _, _ in hosts), mesh)

            t0 = ckpt.restore_time(c0, cfg.timestep)
            tick = int(round(t0 / cfg.qdt))

            def member(h, c):
                R, V, psi = h
                key = jax.random.PRNGKey(c.job * 7919 + c0)
                st = make_state(_pad_rows(R, n_arr), _pad_rows(V, n_arr),
                                _pad_rows(psi, n_arr), key,
                                dtype=cfg.np_dtype, t=t0)
                return st._replace(tick=jnp.asarray(tick, jnp.int32))
            states, mask, n_js = _stack_fold(
                [member(h, c) for h, c in zip(hosts, job_cfgs)],
                [int(R.shape[0]) for R, _, _ in hosts], n_arr)
            # reference newRun=0 restart semantics per job: Epot0 stays 0
            # (SpeedUp.cpp:119 — assigned only in init()) and Vholder is
            # re-read from the VZERO files (:901-909)
            epot0_np = np.zeros(n_jobs)
            if cfg.vaf_intervals:
                vholders = [resume_vholder(d, c0) for d in job_dirs]
        elif have_native:
            c0 = min(c0s)           # newest checkpoint common to all jobs
            newer_ascii = sorted({ca for ca in c0s_ascii
                                  if ca is not None and ca > c0})
            if newer_ascii:
                # a reference binary advanced only SOME jobs' ASCII
                # checkpoints: resuming the whole fold from the older
                # native point would replay those jobs' covered steps
                # (duplicate .dat rows, diverged trajectories)
                raise ValueError(
                    f"ASCII checkpoints at timestep(s) {newer_ascii} are "
                    f"newer than the native resume point {c0} but not "
                    "present for every job; advance the remaining jobs "
                    "to the same checkpoint (or remove the stale files) "
                    "before resuming the fold")
            zs = [ckpt.load_native(d, c0) for d in job_dirs]
            counters = {int(z["counter"]) for z in zs}
            if len(counters) != 1:
                raise ValueError("ensemble members at inconsistent "
                                 f"checkpoint counters {sorted(counters)}; "
                                 "the fused fold requires one shared tick")
            done = counters.pop()
            # a terminal checkpoint of an off-grid tmax window sits past
            # the last sample; the loop realigns to the global gate
            step_done = c0 + 1
            tick = (c0 + 1) * cfg.ratio
            n_arr = _mesh_ion_round(max(int(z["R"].shape[0])
                                        for z in zs), mesh)

            def member(z, j):
                key = (_key_restore(z["key"]) if "key" in z
                       else jax.random.PRNGKey((j + 1) * 7919 + c0))
                st = make_state(_pad_rows(z["R"], n_arr),
                                _pad_rows(z["V"], n_arr),
                                _pad_rows(z["psi"], n_arr),
                                key, dtype=cfg.np_dtype)
                if "t_part" in z:  # lossless native resume (see save)
                    st = st._replace(t_part=jnp.asarray(
                        _pad_rows(z["t_part"], n_arr), cfg.np_dtype))
                return st._replace(tick=jnp.asarray(tick, jnp.int32),
                                   t=jnp.asarray(tick * cfg.qdt,
                                                 cfg.np_dtype))
            states, mask, n_js = _stack_fold(
                [member(z, j) for j, z in enumerate(zs)],
                [int(z["R"].shape[0]) for z in zs], n_arr)
            if all("epot0" in z for z in zs):
                epot0_np = np.asarray([float(z["epot0"]) for z in zs])
            vholders = [z.get("vholder") for z in zs]
        elif (any(c is not None for c in c0s)
              or any(c is not None for c in c0s_ascii)):
            n_nat = sum(c is not None for c in c0s)
            n_asc = sum(c is not None for c in c0s_ascii)
            raise ValueError(
                f"resume=True but no single checkpoint format covers "
                f"every job ({n_nat}/{n_jobs} native, {n_asc}/{n_jobs} "
                f"ASCII): checkpoints exist for only a subset of jobs; "
                f"refusing to restart the fold from scratch (it would "
                f"replay covered steps and append duplicate .dat rows)")
    if states is None:
        if mesh is not None and not cfg.exact_n:
            from ..parallel.mesh import ION_AXIS
            states, mask, n_js = _poisson_member_states(
                cfg_run, n_jobs, seed, round_to=mesh.shape[ION_AXIS])
        elif mesh is not None:
            # per-(job, ion-shard) key streams, as the sharded stepper
            # expects ([E, I] keys; each ion shard draws its own rolls)
            from ..parallel.ensemble import shard_keys
            from ..parallel.mesh import ION_AXIS
            keys = shard_keys(jax.random.PRNGKey(seed), n_jobs,
                              mesh.shape[ION_AXIS])
            states = jax.jit(jax.vmap(
                lambda k: _initial_state_from_key(cfg_run, k)))(keys[:, 0])
            states = states._replace(key=keys)
        elif cfg.exact_n:
            keys = jax.random.split(jax.random.PRNGKey(seed), n_jobs)
            states = jax.jit(jax.vmap(
                lambda k: _initial_state_from_key(cfg_run, k)))(keys)
        else:
            states, mask, n_js = _poisson_member_states(cfg_run, n_jobs,
                                                        seed)
    # cross-mode resume: a single-device checkpoint carries [E, 2] keys,
    # a mesh checkpoint [E, I, 2] — normalize to the mode we run in
    if mesh is not None and states.key.ndim == 2:
        from ..parallel.mesh import ION_AXIS
        n_ion = mesh.shape[ION_AXIS]
        states = states._replace(key=jax.vmap(
            lambda k: jax.random.split(k, n_ion))(states.key))
    elif mesh is None and states.key.ndim == 3:
        states = states._replace(key=states.key[:, 0])
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    if epot0_np is None:
        if mask is None:
            epot0_np = jax.device_get(jax.jit(jax.vmap(
                lambda R: yukawa_potential(R, L, pu.debye_length)))(
                    states.R))
        else:
            epot0_np = jax.device_get(jax.jit(jax.vmap(
                lambda R, m: yukawa_potential(R, L, pu.debye_length,
                                              mask=m)))(
                    states.R, mask.astype(cfg.np_dtype)))

    f = cfg.sample_freq
    rem = n_md - n_segments * f   # trailing steps past the last gate
    if step_done is None:
        step_done = done * f
    outs_groups = []
    while done < n_segments:
        if step_done % f:
            # splice realignment after a previous window's off-grid
            # tmax: one short segment back onto the global output gate
            # (see run_compiled_span)
            g, seg_len = 1, f - step_done % f
        else:
            g, seg_len = min(group, n_segments - done), None
        # fold the trailing sub-segment into the final group so the
        # returned states hold the true tmax state for the terminal
        # checkpoint (reference runs to tmax, SpeedUp.cpp:1247)
        tail = rem if done + g == n_segments else 0
        if mesh is None:
            states, outs = run_compiled_ensemble(cfg_run, states, g,
                                                 mask=mask,
                                                 sweep_e0=sweep_e0,
                                                 sweep_om=sweep_om,
                                                 seg_len=seg_len,
                                                 tail=tail)
        else:
            states, outs = run_compiled_sharded(cfg_run, mesh, states, g,
                                                mask=mask,
                                                sweep_e0=sweep_e0,
                                                sweep_om=sweep_om,
                                                seg_len=seg_len,
                                                tail=tail)
        jax.block_until_ready(states)
        outs_np = jax.device_get(outs)
        outs_groups.append(outs_np)
        prev_done = done
        done += g
        step_done = done * f + tail
        if job_dirs is not None:
            st = jax.device_get(states)
            key_payload = _key_payload(states.key)
            for j in range(n_jobs):
                n_j = n_js[j] if n_js is not None else None
                outs_j = jax.tree.map(lambda a: a[j], outs_np)
                final_j = jax.tree.map(lambda a: a[j], st)
                vholders[j] = write_outputs(
                    job_dirs[j], job_cfgs[j], outs_j, float(epot0_np[j]),
                    final_j, n_md, sample_offset=prev_done,
                    vholder0=vholders[j], terminal=(done == n_segments),
                    n_actual=n_j)
                if done < n_segments:
                    c0 = done * cfg.sample_freq - 1
                    os.makedirs(job_dirs[j], exist_ok=True)
                    nw = n_j if n_j is not None else final_j.R.shape[0]
                    ckpt.save_native(
                        job_dirs[j], c0, R=final_j.R[:nw],
                        V=final_j.V[:nw], psi=final_j.psi[:nw],
                        counter=done,
                        vholder=(vholders[j] if cfg.vaf_intervals
                                 else None),
                        extra={"epot0": float(epot0_np[j]),
                               "key": key_payload[j],
                               "t_part": final_j.t_part[:nw]})

    if step_done < n_md:
        # trailing sub-segment with no sampled segment left to carry it
        # (fresh tmax below one sample period, or a resumed window whose
        # extended tmax adds only steps past the last gate): the
        # reference still runs to tmax (SpeedUp.cpp:1247), so advance
        # and publish the terminal checkpoint at the true c0 = n_md-1
        tail = n_md - step_done
        if mesh is None:
            states, _ = run_compiled_ensemble(cfg_run, states, 0,
                                              mask=mask, sweep_e0=sweep_e0,
                                              sweep_om=sweep_om, tail=tail)
        else:
            states, _ = run_compiled_sharded(cfg_run, mesh, states, 0,
                                             mask=mask, sweep_e0=sweep_e0,
                                             sweep_om=sweep_om, tail=tail)
        jax.block_until_ready(states)
        step_done = n_md
        final_np = jax.device_get(states)
        if job_dirs is not None:
            for j in range(n_jobs):
                n_j = n_js[j] if n_js is not None else None
                final_j = jax.tree.map(lambda a: a[j], final_np)
                os.makedirs(job_dirs[j], exist_ok=True)
                write_terminal_checkpoint(
                    job_dirs[j], job_cfgs[j], final_j, n_md, done,
                    vholders[j], float(epot0_np[j]), n_actual=n_j)
    else:
        final_np = jax.device_get(states)
    if not outs_groups:           # resume found nothing left to do
        return final_np, None
    outs_np = jax.tree.map(lambda *xs: np.concatenate(xs, axis=1),
                           *outs_groups)
    return final_np, outs_np


def run_sweep(cfg: CoolingConfig, points, jobs_per_point: int = 1,
              seed: int = 0, resume: bool = False, mesh=None):
    """Run a laser-parameter grid as ONE fused ensemble fold.

    The reference explores laser parameters by editing the compile-time
    constants and rebuilding the binary per point (SpeedUp.cpp:66-69;
    README.md:73-87 — each build's output lands in its param-encoded
    directory).  Here the whole grid is one compiled program: detunings
    enter the physics only through the Hamiltonian's diagonal e0
    (levels.py:151-156), which the fused kernel reads per lane
    (core/qt_fused.py per_lane_e0), and H is *linear* in each Rabi
    frequency, so om/om_dp scale two fixed base patterns per lane
    (om_split_schemes, per_lane_om).  Every sweep point costs the same
    as one more ensemble member — one kernel launch per MD step for the
    entire grid.

    ``points``: sequence of ``(det_sp, det_dp)`` pairs in units of
    gamma_SP, or dicts with keys among ``detuning``/``detuning_dp``/
    ``om``/``om_dp`` (unset fields keep ``cfg``'s value — e.g. a pure
    Rabi sweep at fixed detuning uses ``{"om": x}`` points).
    ``jobs_per_point`` replicates each point with independent seeds (job
    numbers 1..jobs_per_point inside each point's directory).  Member
    order in the returned outputs is point-major:
    ``member = point_index * jobs_per_point + rep``.

    Returns ``(final_states, outs, member_cfgs)``; with
    ``cfg.save_directory`` set, each member writes the full reference
    .dat tree under its own param-encoded directory (the exact layout a
    per-point reference build would produce).  Checkpoint/resume and
    ``mesh`` behave as in ``run_ensemble``."""
    sweep = []
    for pt in points:
        ov = (dict(pt) if isinstance(pt, dict)
              else {"detuning": float(pt[0]), "detuning_dp": float(pt[1])})
        for r in range(jobs_per_point):
            sweep.append({**ov, "job": r + 1})
    member_cfgs = [dataclasses.replace(cfg, **s) for s in sweep]
    final, outs = run_ensemble(cfg, len(sweep), seed=seed, resume=resume,
                               mesh=mesh, sweep=sweep)
    return final, outs, member_cfgs


def _initial_state_from_key(cfg: CoolingConfig, key,
                            n: Optional[int] = None) -> SimState:
    from ..core.qt import random_s_superposition
    from ..core.init import frozen_gas_positions
    k_pos, k_psi, k_run = jax.random.split(key, 3)
    n = cfg.n0 if n is None else n
    L = PlasmaUnits.box_length(cfg.n0)
    R = frozen_gas_positions(k_pos, n, L, cfg.np_dtype)
    V = jnp.zeros((n, 3), cfg.np_dtype)
    cdtype = jnp.complex64 if cfg.dtype == "float32" else jnp.complex128
    psi = random_s_superposition(k_psi, n, 12, cdtype)
    return make_state(R, V, psi, k_run, dtype=cfg.np_dtype)


def _poisson_member_states(cfg: CoolingConfig, n_jobs: int, seed: int,
                           round_to: int = 1):
    """Fixed-shape ensemble fold with per-member Poissonian ion counts —
    the reference's init draws a fresh N for every array job by
    scattering 729*N0 candidates over a 9L box and keeping the ones in
    the cell (SpeedUp.cpp:289-348).  Members are padded to the largest
    draw; padded lanes start at R=V=psi=0 and stay exactly inert (see
    run_compiled_ensemble).  Returns (states [E, n_arr, ...],
    mask [E, n_arr], counts)."""
    from ..core.init import poisson_member_mask
    m, n_js = poisson_member_mask(cfg.n0, n_jobs, seed, round_to=round_to)
    n_arr = m.shape[1]
    mask = jnp.asarray(m)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_jobs)

    @jax.jit
    def build(keys, mask):
        def one(key, mk):
            st = _initial_state_from_key(cfg, key, n=n_arr)
            mc = mk.astype(st.R.dtype)[:, None]
            return st._replace(R=st.R * mc, V=st.V * mc, psi=st.psi * mc)
        return jax.vmap(one)(keys, mask)
    return build(keys, mask), mask, n_js


def _interval_vholder(cfg: CoolingConfig, outs, n: int,
                      vholder0=None, sample_offset: int = 0):
    """[>=13, N, 3] VAF-interval velocity snapshots (the reference's
    Vholder, SpeedUp.cpp:133) plus ``starts``: per interval, the local
    sample index this window's VAF rows begin at, or None when the
    interval emits nothing here.

    Activity is decided by *time*, never by snapshot content: a
    legitimately all-zero restored v0 (e.g. a reference binary's VZERO
    files, which readConditions restores and streams from regardless —
    SpeedUp.cpp:901-909) still yields rows.  Each window owns the
    half-spacing neighborhood of its own sample grid, so an interval
    whose tstart falls in the gap *between* two windows snaps to the
    nearest sample exactly as an unwindowed run's argmin would — window
    (checkpoint-group) boundaries never change the emitted diagnostics,
    and an interval a final window claims stays claimed if the run is
    later chained (the restored snapshot streams on).  An interval
    starting before the run's very first sample snaps to sample 0 (the
    nearest-sample convention at the grid edge); one starting past the
    last sample's half-spacing never fires here (reference gate: vstart
    beyond the window is simply never reached, SpeedUp.cpp:1260).  A
    pre-window origin with no restored snapshot (``vholder0`` None —
    crash resume without the native vholder) is skipped: its pre-crash
    rows are already on disk."""
    m = max(13, len(cfg.vaf_intervals))
    vholder = np.zeros((m, n, 3))
    has_restored = vholder0 is not None
    if has_restored:
        v0 = np.asarray(vholder0, np.float64)
        vholder[:v0.shape[0]] = v0
    starts = [None] * m
    if not (cfg.vaf_intervals and "V" in outs):
        return vholder, starts
    t_arr = np.asarray(outs["t"], np.float64)
    d = (float(t_arr[1] - t_arr[0]) if t_arr.size > 1
         else cfg.sample_freq * cfg.timestep)
    for k, tstart in enumerate(cfg.vaf_intervals):
        if tstart >= t_arr[-1] + d / 2:
            continue         # starts in a later window (or never fires)
        if tstart >= t_arr[0] - d / 2 or (sample_offset == 0
                                          and not has_restored):
            idx = int(np.argmin(np.abs(t_arr - tstart)))  # origin here
            vholder[k] = np.asarray(outs["V"][idx], np.float64)[:n]
            starts[k] = idx
        elif has_restored:
            starts[k] = 0                # restored pre-window origin
    return vholder, starts


def write_outputs(directory: str, cfg: CoolingConfig, outs, epot0: float,
                  final, n_md: int, sample_offset: int = 0,
                  vholder0=None, terminal: bool = True,
                  n_actual: Optional[int] = None) -> np.ndarray:
    """Emit energies.dat, vel_dist{X,Y,Z}_time*.dat,
    statePopulationsVsVTime*.dat and (when ``terminal``) the final
    checkpoint.  ``sample_offset`` shifts the per-sample file counters on
    resume; ``vholder0`` carries VAF-interval v0 snapshots restored from
    the previous walltime window or checkpoint group (reference
    readConditions, SpeedUp.cpp:901-909) so pre-splice intervals keep
    streaming VAF rows.  Returns the updated vholder for the caller to
    carry into the next group.  ``terminal=False`` writes only the sample
    rows — the group-streaming mode of run()/run_ensemble, which the
    reference matches by appending output() rows at every sample."""
    w = DatWriter(directory)
    bins = folded_bins_np()
    n_samples = outs["t"].shape[0]
    # ``n_actual`` slices off padded lanes when the member carries a
    # Poissonian ion count inside a fixed-shape ensemble fold — emitted
    # files and checkpoints are sized to the member's real N, exactly as
    # the reference's per-job arrays are
    n = n_actual if n_actual is not None else final.R.shape[0]
    energies = np.zeros((n_samples, 7))
    for k in range(n_samples):
        kk = k + sample_offset
        t = float(outs["t"][k])
        ekx, eky, ekz = (float(x) for x in outs["ekin"][k])
        epot = float(outs["epot"][k])
        vxm = float(outs["vx_mean"][k])
        energies[k] = (t, ekx, eky, ekz, epot,
                       ekx + eky + ekz + epot - epot0, vxm)
        pv = outs["pvel"][k]
        w.write(f"vel_distX_time{kk:06d}.dat",
                np.stack([bins + vxm, pv[0]], axis=-1))
        w.write(f"vel_distY_time{kk:06d}.dat", np.stack([bins, pv[1]], axis=-1))
        w.write(f"vel_distZ_time{kk:06d}.dat", np.stack([bins, pv[2]], axis=-1))
        w.write(f"statePopulationsVsVTime{kk:06d}.dat",
                np.concatenate([outs["vx_ions"][k][:n, None],
                                outs["pops"][k][:n]], axis=-1))
    w.append("energies.dat", energies)

    # Interval VAF + LCCF of the pre-SpeedUp code, evaluated from the
    # per-sample snapshots.  The reference's streaming Zfunc/LCCF also
    # fire only at sample cadence, but its interval gate is offset from
    # the output grid by up to half a period
    # (LaserCoolingPlusExpansionMDQT.cpp:1252-1362: (c0-vstart)%sampleFreq
    # with vstart=(tstart-0.02)/dt+9), so interval origins here sit on the
    # nearest output sample — within sampleFreq/2 MD steps of the
    # reference's.  On a resumed run, intervals that started before the
    # resume point stream on from the restored ``vholder0`` snapshot
    # (reference: readConditions re-reads VZERO into Vholder,
    # SpeedUp.cpp:901-909); without a restored snapshot they are skipped
    # (their pre-crash rows are already on disk).
    vholder, starts = _interval_vholder(cfg, outs, n, vholder0,
                                        sample_offset=sample_offset)
    if cfg.vaf_intervals and "V" in outs:
        t_arr = np.asarray(outs["t"], np.float64)
        for k in range(len(cfg.vaf_intervals)):
            if starts[k] is None:
                continue
            v0 = vholder[k]
            rows = []
            for j in range(starts[k], n_samples):
                vj = np.asarray(outs["V"][j], np.float64)[:n]
                rows.append((t_arr[j], float(np.mean(np.sum(v0 * vj, -1)))))
            w.append(f"VAF_interval{k}.dat", np.asarray(rows))
    if cfg.record_lccf and "R" in outs:
        from ..ops.structure import current_fourier, k_grid
        import jax.numpy as _jnp
        L = PlasmaUnits.box_length(cfg.n0)
        kv = k_grid(L, 12)
        ks = np.stack(np.meshgrid(np.arange(12), np.arange(12),
                                  np.arange(12), indexing="ij"),
                      -1).reshape(-1, 3)
        for j in range(n_samples):
            J = np.asarray(current_fourier(_jnp.asarray(outs["R"][j][:n]),
                                           _jnp.asarray(outs["V"][j][:n]),
                                           _jnp.asarray(kv)))
            rows = np.concatenate([
                np.full((kv.shape[0], 1),
                        (j + sample_offset) * cfg.sample_freq), ks,
                np.stack([J[0].real, J[0].imag, J[1].real, J[1].imag,
                          J[2].real, J[2].imag], -1)], axis=1)
            w.append("J_interval0.dat", rows)

    if not terminal:
        return vholder
    write_terminal_checkpoint(directory, cfg, final, n_md,
                              sample_offset + n_samples, vholder, epot0,
                              n_actual=n_actual)
    return vholder


def write_terminal_checkpoint(directory: str, cfg: CoolingConfig, final,
                              n_md: int, counter: int, vholder, epot0,
                              n_actual: Optional[int] = None) -> None:
    """The reference-schema terminal checkpoint at c0 = n_md - 1
    (writeConditions, SpeedUp.cpp:725-783) plus the lossless native
    .npz.  Split from :func:`write_outputs` so a run whose tmax ends off
    the sample grid can publish it *after* advancing the trailing
    sub-segment (the reference runs to tmax regardless of alignment)."""
    n = n_actual if n_actual is not None else final.R.shape[0]
    c0 = n_md - 1
    ckpt.write_ions(directory, c0, n, counter)
    ckpt.write_conditions(directory, c0, np.asarray(final.R)[:n],
                          np.asarray(final.V)[:n])
    ckpt.write_wvfns(directory, c0, np.asarray(final.psi)[:n])
    # SpeedUp main never fills Vholder unless VAF intervals are enabled; it
    # still writes all 13 VZERO interval files (lines 752-763).
    if vholder is None:
        vholder = np.zeros((13, n, 3))
    ckpt.write_vzero(directory, c0, vholder[:13])
    extra = {"epot0": epot0}
    key = getattr(final, "key", None)
    if key is not None:
        extra["key"] = _key_payload(key)
    t_part = getattr(final, "t_part", None)
    if t_part is not None:
        # lossless native resume; the ASCII schema stays reference-parity
        # (tPart resets on a newRun=0 restart, SpeedUp.cpp:333)
        extra["t_part"] = np.asarray(t_part)[:n]
    ckpt.save_native(directory, c0, R=np.asarray(final.R)[:n],
                     V=np.asarray(final.V)[:n],
                     psi=np.asarray(final.psi)[:n],
                     counter=counter,
                     vholder=vholder if cfg.vaf_intervals else None,
                     extra=extra)


def resume_vholder(directory: str, c0: int,
                   n_intervals: int = 13) -> np.ndarray:
    """Reference-compatible Vholder restore: re-read the
    VZERO_timestep{c0}_interval{k}.dat buffers written at the last
    checkpoint (readConditions, SpeedUp.cpp:901-909) so streaming
    interval VAF continues across walltime windows.  Pass the result as
    ``run(..., vholder0=...)`` / ``write_outputs(..., vholder0=...)``."""
    return ckpt.read_vzero(directory, c0, n_intervals)


def resume_state(directory: str, c0: int, cfg: CoolingConfig) -> SimState:
    """Reference-compatible restart (readConditions, SpeedUp.cpp:785-916).
    The ions_ N pins the conditions_/wvFns_ row counts — a truncated or
    mismatched file raises a ValueError naming the file, where the
    reference's fscanf would silently misparse.

    For walltime chaining prefer ``run(cfg, resume=True)``: it realigns
    to the *global* output gate ((c0+1)%sampleFreq==0, SpeedUp.cpp:1365)
    with a partial first segment.  Feeding this state to a fresh-window
    ``run(cfg2, state=...)`` starts a new local gate instead, which is
    one MD step off the global grid whenever the checkpoint's c0+1 is
    not a sample_freq multiple (the reference's terminal checkpoints
    always land one step past the gate)."""
    n_exp = None
    try:
        n_exp, _ = ckpt.read_ions(directory, c0)
    except FileNotFoundError:
        pass
    R, V = ckpt.read_conditions(directory, c0, expect_n=n_exp)
    psi = ckpt.read_wvfns(directory, c0, expect_n=R.shape[0])
    key = jax.random.PRNGKey(cfg.job * 7919 + c0)
    st = make_state(R, V, psi, key, dtype=cfg.np_dtype,
                    t=ckpt.restore_time(c0, cfg.timestep))
    tick = int(round(ckpt.restore_time(c0, cfg.timestep) / cfg.qdt))
    return st._replace(tick=jnp.asarray(tick, jnp.int32))
