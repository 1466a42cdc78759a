"""Multirate MDQT schedulers: the coupling contract between the classical MD
core and the quantum-trajectory engine (SURVEY.md L5).

Three schemes from the reference:

* **SpeedUp / cooling** (laserCoolingPlusExpansionMDQTSpeedUp.cpp:1365-1378):
  recompute forces once per full MD step; apply drift/kick in quantum-sized
  substeps so the QT code never sees large velocity jumps.  One
  ``cooling_md_step`` = [forces; ratio x (leapfrog substep; qstep)].

* **Frozen-tag** (randomFrozenStartTag422Linear.cpp:997-1027): full MD step
  (dt = ratio*qdt, forces inside) every ``ratio`` quantum ticks; ``qstep``
  runs only inside the pump window, otherwise time just advances.

* **MC-tag** (MonteCarloFollowedByQTTagging408Quad.cpp:1230-1235): per MD
  step, ``ratio`` qsteps then one velocity-Verlet MDStep.

All are built as pure ``SimState -> SimState`` functions suitable for
``lax.scan``; a whole run compiles to a single device program with no host
round-trips inside the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..state import SimState
from .md import leapfrog_substep, wrap_pbc
from .qt import QTEngine
from .qt_fused import DEFAULT_BLOCK, fused_md_substeps


def check_uniform_tick(tick) -> None:
    """Guard the fold precondition: all folded ensemble members must share
    one tick value (``soa_ens_md_step`` applies ``tick[0]``'s first-step
    drift flag and expansion-frame time to the whole fold; a violating
    caller would get silently mis-timed dynamics).  Enforced host-side
    whenever the value is concrete — soa_ens_init sees a tracer under
    jit/shard_map, so the eager public entry points
    (laser_cooling.run_compiled_ensemble / run_compiled_sharded) call
    this on the still-concrete member states before tracing."""
    if isinstance(tick, jax.core.Tracer):
        return
    import numpy as np
    t = np.asarray(tick)
    if t.size and (t != t.flat[0]).any():
        raise ValueError(
            "fused ensemble fold requires a uniform tick across members "
            f"(got {np.unique(t)}); do not fold members resumed from "
            "different checkpoints")


def fold_sweep_lanes(fused_spec, npad: int, sweep_e0=None, sweep_om=None):
    """Fold per-member sweep tables into the fused kernel's lane layout.

    ``sweep_e0`` [E, S] member diagonal energies -> [S, E*npad];
    ``sweep_om`` [E, 2] member (om, om_dp) -> [2, E*npad].  The lane
    order is E-major blocks of npad, which must exactly match
    ``fused_substeps_ensemble``'s member fold — this helper is the single
    source of that layout for every caller.  The result is
    loop-invariant, so XLA hoists the fold out of the surrounding scan.
    Returns ``(e0_lanes, om_lanes)`` (each None when its input is)."""
    e0p = omp = None
    if sweep_e0 is not None:
        E, S = sweep_e0.shape
        e0p = jnp.broadcast_to(sweep_e0.astype(jnp.float32)[:, :, None],
                               (E, S, npad))
        e0p = jnp.swapaxes(e0p, 0, 1).reshape(S, E * npad)
    if sweep_om is not None:
        E = sweep_om.shape[0]
        omp = jnp.repeat(
            jnp.swapaxes(sweep_om.astype(jnp.float32), 0, 1)[:, :, None],
            npad, axis=2).reshape(2, E * npad)
    return e0p, omp


@dataclasses.dataclass(frozen=True)
class CoolingScheduler:
    """SpeedUp-scheme stepper: quantum-substepped leapfrog."""

    engine: QTEngine
    forces_fn: Callable  # R -> (F, pot_per_ion)
    L: float
    qdt: float           # quantum timestep, plasma units
    ratio: int           # quantum substeps per MD step
    exp_det_fn: Optional[Callable] = None   # t -> expansion detuning (gamma units)
    fused_spec: object = None    # FusedTickSpec -> one-kernel MD step
    block: int = DEFAULT_BLOCK   # ions per fused-kernel program
    interpret: bool = False      # Pallas interpret mode (CPU tests)

    def md_step(self, state: SimState) -> SimState:
        F, _ = self.forces_fn(state.R)
        if self.fused_spec is not None:
            return self._fused_substeps(state, F)
        return self.substeps(state, F)

    def _fused_substeps(self, state: SimState, F) -> SimState:
        """Whole ratio-tick block as one kernel (core/qt_fused.py)."""
        carry = self.soa_init(state, F)
        Fp = carry[2]          # F already computed by md_step
        carry = self.soa_md_step(carry, lambda Rp: Fp)
        return self.soa_restore(carry, state)

    # ---- SoA-resident segment loop (fused path only) -----------------
    # The fused kernel speaks [rows, Np] f32 planes; converting to/from
    # the [N,3]/complex SimState costs ~5 pad/transpose ops per MD step.
    # These helpers keep the state in kernel layout across a whole
    # sampling segment, converting only at sample boundaries.

    def _npad(self, n: int) -> int:
        """Lane count of one member: ``n`` rounded up to the block."""
        return -(-max(n, self.block) // self.block) * self.block

    def soa_init(self, state: SimState, F=None):
        """SimState -> (Rp, Vp, Fp, tpp, prep, pimp, key, tick) planes."""
        n = state.R.shape[0]
        npad = self._npad(n)

        def pad_rows(x):
            out = jnp.zeros((x.shape[0], npad), jnp.float32)
            return out.at[:, :n].set(x.astype(jnp.float32))

        psi_sm = state.psi.T
        Fp = (jnp.zeros((3, npad), jnp.float32) if F is None
              else pad_rows(F.T))
        return (pad_rows(state.R.T), pad_rows(state.V.T), Fp,
                pad_rows(state.t_part[None, :]),
                pad_rows(psi_sm.real), pad_rows(psi_sm.imag),
                state.key, state.tick)

    def soa_restore(self, carry, state: SimState) -> SimState:
        """SoA planes -> SimState (shapes/dtypes from the template)."""
        Rp, Vp, Fp, tpp, prep, pimp, key, tick = carry
        n = state.R.shape[0]
        psi = (prep[:, :n] + 1j * pimp[:, :n]).T.astype(state.psi.dtype)
        return state._replace(
            R=Rp[:, :n].T.astype(state.R.dtype),
            V=Vp[:, :n].T.astype(state.V.dtype),
            F=Fp[:, :n].T.astype(state.F.dtype), psi=psi,
            t_part=tpp[0, :n].astype(state.t_part.dtype), key=key,
            tick=tick, t=tick.astype(state.t.dtype) * self.qdt)

    def _tick_spec(self, n_ticks: Optional[int]):
        """Fused spec for a (possibly partial) tick block.  The kernel's
        loop length is ``spec.ratio``, so a partial block — the
        reference's output gate splits one MD step per sample into
        [1 tick | sample | ratio-1 ticks] — is the same kernel traced at
        a different static ratio."""
        if n_ticks is None or n_ticks == self.fused_spec.ratio:
            return self.fused_spec
        return dataclasses.replace(self.fused_spec, ratio=n_ticks)

    def soa_md_step(self, carry, soa_forces_fn, e0_lanes=None,
                    om_lanes=None, n_ticks: Optional[int] = None,
                    reuse_forces: bool = False):
        """One MD step entirely in kernel layout: ``soa_forces_fn`` maps
        Rp [3, Np] -> F [3, Np] (ops.yukawa.yukawa_forces_soa).
        ``e0_lanes`` [S, Np] rides to the kernel when the spec uses
        per-lane diagonal energies (detuning sweeps).

        ``n_ticks`` runs a partial tick block (default: the full ratio)
        and ``reuse_forces`` continues with the forces already in the
        carry instead of refreshing — together they split one MD step at
        the reference's output instant ((c0+1)%sampleFreq==0 &&
        timeStepCounter==1, SpeedUp.cpp:1365: one quantum tick into the
        sampling MD step): [forces; 1 tick] -> sample -> [ratio-1 ticks
        with the same forces]."""
        spec = self._tick_spec(n_ticks)
        nt = spec.ratio
        Rp, Vp, Fc, tpp, prep, pimp, key, tick = carry
        npad = Rp.shape[1]
        Fp = Fc if reuse_forces else soa_forces_fn(Rp)
        key, sub = jax.random.split(key)
        rolls = jax.random.uniform(sub, (nt * 5, npad), jnp.float32)
        Rp, Vp, tpp, prep, pimp = fused_md_substeps(
            spec, (tick == 0).astype(jnp.float32), Rp, Vp, Fp, tpp, prep,
            pimp, rolls, tick0=tick.astype(jnp.float32),
            e0_lanes=e0_lanes, om_lanes=om_lanes, block=self.block,
            interpret=self.interpret)
        return (Rp, Vp, Fp, tpp, prep, pimp, key, tick + nt)

    def fused_substeps_ensemble(self, states: SimState, F,
                                e0_lanes=None, om_lanes=None) -> SimState:
        """Ensemble variant of the fused path.  The QT update and the
        quantum-substepped leapfrog are per-ion independent, so E batched
        trajectories fold into the *ion axis* of one kernel launch per MD
        step (the grid covers E*npad ions) instead of a vmapped XLA substep
        scan; only the force kernel (which couples ions within a job)
        stays per-job.

        All members must share one tick counter (``states.tick[0]`` is
        applied to the whole fold for the first-step drift and the
        expansion-frame time) — true for ensembles built by
        ``run_ensemble``/``run_compiled_ensemble``, which start every
        member at tick 0; do not fold members resumed from different
        checkpoints."""
        carry = self.soa_ens_init(states, F)
        Fp = carry[2]
        carry = self.soa_ens_md_step(carry, lambda Rp: Fp,
                                     e0_lanes=e0_lanes,
                                     om_lanes=om_lanes)
        return self.soa_ens_restore(carry, states)

    # Ensemble SoA-resident segment loop: same idea as soa_* but with the
    # job axis folded into the lane dimension ([rows, E*npad] planes).
    # Converting SimState <-> planes per MD step costs 8 [E,S,npad]
    # transposes + a complex split; keeping planes across a whole
    # sampling segment pays that once per sample instead.

    def soa_ens_init(self, states: SimState, F=None):
        """[E,...] SimState batch -> folded planes + per-member keys."""
        check_uniform_tick(states.tick)
        E, n, _ = states.R.shape
        npad = self._npad(n)

        def fold(x):
            # [E, r, n] -> [r, E*npad], job blocks contiguous on the ion axis
            rows = x.shape[1]
            out = jnp.zeros((E, rows, npad), jnp.float32)
            out = out.at[:, :, :n].set(x.astype(jnp.float32))
            return jnp.swapaxes(out, 0, 1).reshape(rows, E * npad)

        psi_sm = jnp.swapaxes(states.psi, 1, 2)          # [E, S, n]
        Fp = (jnp.zeros((3, E * npad), jnp.float32) if F is None
              else fold(jnp.swapaxes(F, 1, 2)))
        return (fold(jnp.swapaxes(states.R, 1, 2)),
                fold(jnp.swapaxes(states.V, 1, 2)), Fp,
                fold(states.t_part[:, None, :]),
                fold(psi_sm.real), fold(psi_sm.imag),
                states.key, states.tick)

    def soa_ens_md_step(self, carry, soa_forces_fn,
                        per_member_rolls: bool = False, e0_lanes=None,
                        om_lanes=None, n_ticks: Optional[int] = None,
                        reuse_forces: bool = False):
        """One ensemble MD step in folded-plane layout; ``soa_forces_fn``
        maps Rp [3, E*npad] -> F [3, E*npad] (job-batched forces).

        ``per_member_rolls`` draws each member's uniforms from that
        member's own key (instead of one draw from the fold's first key),
        making the trajectory of every member invariant to how the
        ensemble is split across devices — the sharded-ensemble path uses
        it so fused-sharded == fused-unsharded exactly.

        ``e0_lanes`` [S, E*npad] supplies per-member diagonal energies
        when the spec has ``per_lane_e0`` — a *detuning sweep* folds as
        one kernel launch per MD step, each member block carrying its own
        (detSP, detDP) point.

        ``n_ticks``/``reuse_forces``: partial tick block / carried
        forces, as in :meth:`soa_md_step` (the sampling MD step's
        reference-instant split)."""
        spec = self._tick_spec(n_ticks)
        nt = spec.ratio
        Rp, Vp, Fc, tpp, prep, pimp, keys, tick = carry
        Fp = Fc if reuse_forces else soa_forces_fn(Rp)
        ks = jax.vmap(jax.random.split)(keys)        # [E, 2, 2]
        if per_member_rolls:
            E = keys.shape[0]
            npad = Rp.shape[1] // E
            rolls = jax.vmap(lambda k: jax.random.uniform(
                k, (nt * 5, npad), jnp.float32))(ks[:, 1])
            rolls = jnp.swapaxes(rolls, 0, 1).reshape(nt * 5, E * npad)
        else:
            rolls = jax.random.uniform(ks[0, 1], (nt * 5, Rp.shape[1]),
                                       jnp.float32)
        Rp, Vp, tpp, prep, pimp = fused_md_substeps(
            spec, (tick[0] == 0).astype(jnp.float32), Rp, Vp, Fp, tpp,
            prep, pimp, rolls, tick0=tick[0].astype(jnp.float32),
            e0_lanes=e0_lanes, om_lanes=om_lanes, block=self.block,
            interpret=self.interpret)
        return (Rp, Vp, Fp, tpp, prep, pimp, ks[:, 0], tick + nt)

    def soa_ens_restore(self, carry, states: SimState) -> SimState:
        """Folded planes -> [E,...] SimState batch (template dtypes)."""
        Rp, Vp, Fp, tpp, prep, pimp, keys, tick = carry
        E, n, _ = states.R.shape
        npad = Rp.shape[1] // E
        S = states.psi.shape[-1]

        def unfold(y, rows):  # [rows', E*npad] -> [E, rows, n]
            y = jnp.swapaxes(y.reshape(-1, E, npad), 0, 1)
            return y[:, :rows, :n]

        psi = (unfold(prep, S) + 1j * unfold(pimp, S)).astype(states.psi.dtype)
        return states._replace(
            R=jnp.swapaxes(unfold(Rp, 3), 1, 2).astype(states.R.dtype),
            V=jnp.swapaxes(unfold(Vp, 3), 1, 2).astype(states.V.dtype),
            F=jnp.swapaxes(unfold(Fp, 3), 1, 2).astype(states.F.dtype),
            psi=jnp.swapaxes(psi, 1, 2),
            t_part=unfold(tpp, 1)[:, 0, :].astype(states.t_part.dtype),
            key=keys, tick=tick,
            t=tick.astype(states.t.dtype) * self.qdt)

    def substeps(self, state: SimState, F: jax.Array,
                 n_ticks: Optional[int] = None) -> SimState:
        """The ratio quantum-substepped ticks with the given (fresh) forces
        — split out so ensemble runners can batch the force kernel across
        jobs and vmap only this part.  ``n_ticks`` runs a partial block
        (the sampling MD step's reference-instant split; see
        :meth:`soa_md_step`)."""
        nt = self.ratio if n_ticks is None else n_ticks
        F_sm = F.T
        n = state.R.shape[0]
        key, sub = jax.random.split(state.key)
        # one batched RNG draw per MD step (not one per quantum tick)
        all_rolls = jax.random.uniform(sub, (nt, 5, n), state.R.dtype)

        def tick(c, rolls):
            R, V, psi_sm, tp, tick_i = c
            t = tick_i.astype(R.dtype) * self.qdt
            first = t <= 0.0
            R, V = leapfrog_substep(R, V, F_sm, self.qdt, self.L, first)
            exp_det = self.exp_det_fn(t) if self.exp_det_fn is not None else 0.0
            psi_sm, vx, tp = self.engine.step_sm(psi_sm, V[0, :], tp,
                                                 exp_det=exp_det, rolls=rolls)
            V = V.at[0, :].set(vx)
            return (R, V, psi_sm, tp, tick_i + 1), None

        # everything rides axis-major through the tick scan ([3, N]
        # coordinates, [S, N] wavefunctions) so the ion axis fills the
        # vector lanes; transposed once per MD step at the boundary
        (R_sm, V_sm, psi_sm, tp, tick_i), _ = jax.lax.scan(
            tick, (state.R.T, state.V.T, state.psi.T, state.t_part,
                   state.tick), all_rolls)
        return state._replace(R=R_sm.T, V=V_sm.T, F=F, psi=psi_sm.T,
                              t_part=tp, key=key, tick=tick_i,
                              t=tick_i.astype(state.t.dtype) * self.qdt)


@dataclasses.dataclass(frozen=True)
class FrozenTagScheduler:
    """Frozen-start tagging stepper: full-dt leapfrog MD + windowed pumping.

    The reference order per ``ratio``-tick block is [step(); ratio x
    (qstep-or-advance)] with forces recomputed inside step_V
    (randomFrozenStartTag422Linear.cpp:352-382,1015-1026)."""

    engine: QTEngine
    forces_fn: Callable
    L: float
    qdt: float
    ratio: int
    t_pump_start: float
    t_pump_end: float
    # traced per-member QTParams override (detuning/om sweeps —
    # core/qt.sweep_qt_params); None -> the engine's static scheme
    qt_params: Optional[object] = None

    def md_step_pure(self, state: SimState) -> SimState:
        """MD step for steps whose ticks are entirely OUTSIDE the pump
        window: identical leapfrog + forces, but no quantum tick scan —
        the reference's else-branch just advances t
        (randomFrozenStartTag422Linear.cpp:1020-1025).  The window
        boundaries are static, so experiment drivers split the run into
        [pure | windowed | pure] phases at trace time instead of paying
        ratio tiny lax.cond iterations per MD step (which dominated the
        production run: 312k gated ticks ~ 38 s at N0=3500)."""
        dt = self.qdt * self.ratio
        t0 = state.tick.astype(state.R.dtype) * self.qdt
        first = t0 <= 0.0
        from .md import step_R
        R = step_R(state.R, state.V, state.F, 0.5 * dt, self.L, first)
        F, _ = self.forces_fn(R)
        V = state.V + dt * F
        R = step_R(R, V, F, 0.5 * dt, self.L, first)
        tick_i = state.tick + self.ratio
        return state._replace(R=R, V=V, F=F, tick=tick_i,
                              t=tick_i.astype(state.t.dtype) * self.qdt)

    def md_step(self, state: SimState) -> SimState:
        dt = self.qdt * self.ratio
        t0 = state.tick.astype(state.R.dtype) * self.qdt
        first = t0 <= 0.0
        # step(): step_R(dt/2); forces(); step_V(dt); step_R(dt/2)
        R = state.R
        V = state.V
        from .md import step_R
        R = step_R(R, V, state.F, 0.5 * dt, self.L, first)
        F, _ = self.forces_fn(R)
        V = V + dt * F
        R = step_R(R, V, F, 0.5 * dt, self.L, first)

        n = state.R.shape[0]
        key, sub = jax.random.split(state.key)
        # lane-major draw: threefry counters are row-major, so each ion's
        # (ratio*5) rolls are a contiguous counter block independent of n.
        # A member padded to a larger lane count (the Poissonian-N fold)
        # then reproduces its exact-shape run bit-for-bit whenever the
        # force path also pads both shapes the same way.  Drawn as
        # [n, ratio*5] and reshaped after the transpose; the bits are
        # identical to a [.., ratio, 5] draw.
        all_rolls = (jax.random.uniform(sub, (n, self.ratio * 5),
                                        state.R.dtype)
                     .T.reshape(self.ratio, 5, n))
        vx = V[:, 0]

        def tick(c, rolls):
            psi_sm, tp, tick_i = c
            t = tick_i.astype(R.dtype) * self.qdt
            in_window = (t > self.t_pump_start) & (t < self.t_pump_end)

            def pump(args):
                psi_sm, tp = args
                psi2, _, tp2 = self.engine.step_sm(psi_sm, vx, tp,
                                                   rolls=rolls,
                                                   params=self.qt_params)
                return psi2, tp2

            # outside the pump window time advances with no quantum work
            # (randomFrozenStartTag422Linear.cpp:1020-1025); lax.cond skips
            # the QT update entirely on-device.
            psi_sm, tp = jax.lax.cond(in_window, pump, lambda a: a,
                                      (psi_sm, tp))
            return (psi_sm, tp, tick_i + 1), None

        (psi_sm, tp, tick_i), _ = jax.lax.scan(
            tick, (state.psi.T, state.t_part, state.tick), all_rolls)
        return state._replace(R=R, V=V, F=F, psi=psi_sm.T, t_part=tp,
                              key=key, tick=tick_i,
                              t=tick_i.astype(state.t.dtype) * self.qdt)


@dataclasses.dataclass(frozen=True)
class MCTagScheduler:
    """MC-family pump stepper: ratio x qstep then one velocity-Verlet MDStep
    (MonteCarloFollowedByQTTagging408Quad.cpp:1230-1235)."""

    engine: QTEngine
    forces_fn: Callable
    L: float
    dt: float            # MD timestep (0.005)
    ratio: int
    qt_params: Optional[object] = None   # see FrozenTagScheduler

    def md_step(self, state: SimState) -> SimState:
        n = state.R.shape[0]
        key, sub = jax.random.split(state.key)
        all_rolls = jax.random.uniform(sub, (self.ratio, 5, n),
                                       state.R.dtype)
        vx = state.V[:, 0]

        def tick(c, rolls):
            psi_sm, tp = c
            psi_sm, _, tp = self.engine.step_sm(psi_sm, vx, tp, rolls=rolls,
                                                params=self.qt_params)
            return (psi_sm, tp), None

        (psi_sm, tp), _ = jax.lax.scan(
            tick, (state.psi.T, state.t_part), all_rolls)
        psi = psi_sm.T
        # velocity-Verlet with fresh accelerations
        R = wrap_pbc(state.R + self.dt * state.V + 0.5 * self.dt ** 2 * state.F,
                     self.L)
        F, _ = self.forces_fn(R)
        V = state.V + 0.5 * self.dt * (state.F + F)
        return state._replace(R=R, V=V, F=F, psi=psi, t_part=tp, key=key,
                              tick=state.tick + self.ratio,
                              t=state.t + self.dt)
