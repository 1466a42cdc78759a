"""Quantum-trajectory engine: vectorized non-Hermitian RK4 + stochastic jumps.

One engine replaces the reference's four copy-edited ``qstep()`` variants
(laserCoolingPlusExpansionMDQTSpeedUp.cpp:438-717,
MonteCarloFollowedByQTTagging408Quad.cpp:554-755,
randomFrozenStartTag422Linear.cpp:390-566,
laserCoolNoPlasmaThreeState.cpp:140-293).  The per-ion algorithm is identical
across them (SURVEY.md L4):

1. jump probability ``dp = h * <psi| sum g^2 c^t c |psi>`` — with our
   :class:`~mdqtplasmasims_tpu.levels.LevelScheme` tables the decay operator
   is diagonal, so ``dp = h * sum_s w_s |psi_s|^2``.
2. no-jump: evolve by RK4 (3/8 rule) applied to the normalized non-Hermitian
   propagator ``G(phi) = (1-dp(phi))^(-1/2) (I - i h H) phi`` with the
   Hamiltonian frozen over the tick; apply the Ehrenfest optical force.
3. jump: pick the emitting excited sublevel prop. to its population, roll
   S-vs-D by the fixed branching ratio, collapse via the C-G-weighted
   destination table, reset the ion clock, apply +-recoil along x.

Design notes:

* Instead of per-ion [S,S] Hamiltonians (the reference does ~6 Armadillo
  matmuls per RK stage per ion), H*phi is (a) a diagonal term, (b) one
  shared [S,S] x [S,N] matmul, (c) <= 2 row updates for the time-dependent
  channels.  Every matmul asks for ``Precision.HIGHEST``: a default f32
  product may run in TF32 on the GPU.
* The hot path is **state-major**: wavefunctions ride as ``[S, N]`` so the
  ion axis is the contiguous one.  The public ``step()`` keeps the [N, S]
  convention (transposes at the boundary); schedulers use ``step_sm`` and
  keep [S, N] across whole segments.
* Both branches are computed for every ion and merged with ``jnp.where`` —
  no data-dependent control flow under ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..levels import LevelScheme


class QTParams(NamedTuple):
    """Runtime arrays derived from a LevelScheme (device constants)."""
    decay_w: jax.Array      # [S]
    e0: jax.Array           # [S]
    e1: jax.Array           # [S]
    coupling: jax.Array     # [S,S]
    jump_src_mask: jax.Array   # [S] float
    jump_dest_cum: jax.Array   # [2,S,S]: cumulative dest probs per (branch,src)


def _params(scheme: LevelScheme, rdtype, cdtype) -> QTParams:
    src_mask = np.zeros(scheme.n_states)
    src_mask[list(scheme.jump_src)] = 1.0
    dest_cum = np.cumsum(scheme.jump_dest, axis=-1)   # [S,2,S]
    return QTParams(
        decay_w=jnp.asarray(scheme.decay_w, rdtype),
        e0=jnp.asarray(scheme.e0, rdtype),
        e1=jnp.asarray(scheme.e1, rdtype),
        coupling=jnp.asarray(scheme.coupling, cdtype),
        jump_src_mask=jnp.asarray(src_mask, rdtype),
        jump_dest_cum=jnp.asarray(dest_cum.transpose(1, 0, 2), rdtype),
    )


def _categorical_sm(u: jax.Array, cum: jax.Array) -> jax.Array:
    """Index of first cumulative bin exceeding u.  u: [N], cum: [S,N]."""
    return jnp.sum((u[None, :] >= cum).astype(jnp.int32), axis=0)


def sweep_qt_params(scheme_unit: LevelScheme, detuning, om,
                    rdtype, cdtype) -> QTParams:
    """QTParams for traced ``(detuning, om)`` — the tagging/toy sweep fold.

    The tagging and toy Hamiltonians are *linear* in both knobs with zero
    intercept: ``e0 = detuning * e0_unit`` (excited rows are -detuning,
    levels.py tag408/tag422/three_state) and ``coupling = om * C_unit``
    (every drive coefficient carries -om/2).  So one QTParams built from
    the *unit* scheme (``detuning=1, om=1``) serves any sweep point via
    two scalar multiplies, and a [E]-batched pytree of these vmaps over
    ensemble members — one compiled program for a whole (detuning, om)
    grid where the reference rebuilds its binary per point
    (randomFrozenStartTag422Linear.cpp:55-57 compile-time constants).

    Jump tables and decay rates are detuning/om-independent and pass
    through.  NOT valid for sr12_cooling (two detunings live on shared
    rows; the fused-kernel sweep covers it — laser_cooling.run_sweep)."""
    base = _params(scheme_unit, rdtype, cdtype)
    det = jnp.asarray(detuning, rdtype)
    return base._replace(e0=det * base.e0,
                         coupling=jnp.asarray(om, rdtype) * base.coupling)


def sweep_member_params(cfg, points, jobs_per_point: int,
                        scheme_unit: LevelScheme, rdtype, cdtype):
    """Shared front half of every family's ``run_sweep``: validate the
    grid, build point-major member configs, and vmap
    :func:`sweep_qt_params` over the members' (detuning, om).

    ``points`` are dicts with keys among ``detuning``/``om`` (unset
    fields keep ``cfg``'s value); only these knobs can vary inside one
    fold — everything else (tpump, tstart, n0, ...) shapes the traced
    program.  ``jobs_per_point`` replicates each point with independent
    seeds (member order is point-major, job numbers restart at 1 per
    point).  Returns ``(member_cfgs, params)`` with ``params`` an
    [E]-batched QTParams pytree."""
    import dataclasses as _dc
    allowed = {"detuning", "om"}
    member_cfgs = []
    for pt in points:
        ov = dict(pt)
        bad = set(ov) - allowed
        if bad:
            raise ValueError(f"sweep points can only override "
                             f"{sorted(allowed)}, got {sorted(bad)}")
        for r in range(jobs_per_point):
            member_cfgs.append(_dc.replace(cfg, job=r + 1, **ov))
    dets = jnp.asarray([m.detuning for m in member_cfgs], rdtype)
    oms = jnp.asarray([m.om for m in member_cfgs], rdtype)
    params = jax.vmap(
        lambda d, o: sweep_qt_params(scheme_unit, d, o, rdtype, cdtype))(
            dets, oms)
    return member_cfgs, params


@dataclasses.dataclass(frozen=True)
class QTEngine:
    """Jittable quantum-trajectory stepper for one level scheme.

    Args:
      scheme: level-scheme tables.
      h: quantum timestep in gamma-time units (``dtQuant*gamToEinsteinFreq``
         for the plasma-coupled schemes; plain ``dt`` for the 3-state toy).
      dt_plasma: quantum timestep in plasma units (increment of the per-ion
         clock ``t_part``); equals ``h`` for the toy.
      plas_to_quant_vel: velocity conversion a*omega_E -> gamma/k.
      gamma_to_einstein: clock conversion used for the time-dependent phase
         (``t_gamma = t_part * gamma_to_einstein``).
      apply_force: whether kicks (Ehrenfest + recoil) modify vx — the
         tagging schemes compute but never apply them (SURVEY.md L4 step 3).
      renormalize: explicit norm division after each tick
         (laserCoolingPlusExpansionMDQTSpeedUp.cpp:706-712).
    """

    scheme: LevelScheme
    h: float
    dt_plasma: float
    plas_to_quant_vel: float = 1.0
    gamma_to_einstein: float = 1.0
    apply_force: bool = True
    renormalize: bool = False

    # ---- state-major ([S, N]) hot path ---------------------------------

    def _hpsi_sm(self, p: QTParams, phi: jax.Array, u: jax.Array,
                 tq, phase=None) -> jax.Array:
        """H(u, t_gamma) @ phi.  phi: [S,N], u/tq: [N].

        ``phase`` may be precomputed once per tick (the Hamiltonian is
        frozen across the RK stages)."""
        diag = (p.e0[:, None] + p.e1[:, None] * u[None, :]
                - 0.5j * p.decay_w[:, None])
        out = diag * phi + jnp.matmul(p.coupling, phi,
                                      precision=jax.lax.Precision.HIGHEST)
        if self.scheme.tdep_rows:
            if phase is None:
                phase = self._tdep_phase(u, tq, phi.dtype)
            S = self.scheme.n_states
            rows = jax.lax.broadcasted_iota(jnp.int32, (S, 1), 0)
            for r, c, m in zip(self.scheme.tdep_rows, self.scheme.tdep_cols,
                               self.scheme.tdep_coefs):
                m = jnp.asarray(m, phi.dtype)
                # masked broadcast-adds instead of .at[] row scatters — a
                # dynamic-update-slice would copy the whole [S,N] buffer
                out = out + jnp.where(rows == r, m * phase * phi[c, :][None, :],
                                      jnp.zeros((), phi.dtype))
                out = out + jnp.where(rows == c,
                                      jnp.conj(m * phase) * phi[r, :][None, :],
                                      jnp.zeros((), phi.dtype))
        return out

    def _tdep_phase(self, u, tq, cdtype):
        if not self.scheme.tdep_rows:
            return None
        return jnp.exp(1j * (self.scheme.tdep_freq * u * tq)
                       .astype(jnp.float32 if cdtype == jnp.complex64
                               else jnp.float64))

    def _dp_sm(self, p: QTParams, phi: jax.Array) -> jax.Array:
        return self.h * jnp.sum(
            p.decay_w[:, None] * (phi.real ** 2 + phi.imag ** 2), axis=0)

    def step_sm(self, psi: jax.Array, vx: jax.Array, t_part: jax.Array,
                key: Optional[jax.Array] = None, exp_det=0.0, rolls=None,
                params: Optional[QTParams] = None, force_scale=None):
        """Advance every ion one quantum tick.  psi: [S,N] (state-major).

        Returns ``(psi, vx, t_part)``.  ``exp_det`` is the scalar
        expansion-frame detuning (units of gamma) added to the Doppler
        shift.  Exactly one of ``key`` / ``rolls`` must be given:
        ``rolls`` supplies the [5, N] uniforms (drawn in batch by the
        scheduler — one RNG call per MD step instead of one per tick).

        ``params`` overrides the scheme-derived QTParams with traced
        arrays (per-member detuning/om sweeps — see sweep_qt_params);
        ``force_scale`` scales the Ehrenfest kick by a traced scalar (the
        toy scheme's force_w is om-linear, so an om sweep passes
        om/om_base here).  Jump recoils are om-independent (fixed photon
        momentum) and are never scaled."""
        if key is None and rolls is None:
            raise ValueError("step_sm needs either key= or rolls=")
        rdtype = vx.dtype
        p = (_params(self.scheme, rdtype, psi.dtype)
             if params is None else params)
        h = jnp.asarray(self.h, rdtype)
        S, n = psi.shape

        t_part = t_part + jnp.asarray(self.dt_plasma, rdtype)
        u = vx * self.plas_to_quant_vel + exp_det          # [N]
        tq = t_part * self.gamma_to_einstein

        if rolls is None:
            rolls = jax.random.uniform(key, (5, n), rdtype)
        dp0 = self._dp_sm(p, psi)
        # reference: rand>dp -> no jump (jump iff rand<=dp).  We use strict <
        # so dp=0 can never trigger a jump even when the uniform draw is 0.
        jumped = rolls[0] < dp0

        # ---- no-jump branch: RK4 (3/8) on the normalized propagator ----
        # The stage dp is clamped below 1: the renormalized propagator grows
        # the norm by O(h^2 |H psi|^2) per tick, so an ion that survives an
        # exceptionally long stretch without jumping can inflate until a
        # stage dp reaches 1 and 1/sqrt(1-dp) blows up (the reference has
        # the identical pathology, laserCooling...SpeedUp.cpp:532).  Any ion
        # near the cap jumps within a tick or two anyway (P(jump) = dp0).
        phase = self._tdep_phase(u, tq, psi.dtype)

        def g_slope(phi):
            dphi = jnp.clip(self._dp_sm(p, phi), 0.0, 0.9)
            pref = (1.0 / jnp.sqrt(1.0 - dphi))[None, :]
            stepped = pref.astype(phi.dtype) * (
                phi - 1j * h * self._hpsi_sm(p, phi, u, tq, phase))
            return (stepped - phi) / h

        k1 = g_slope(psi)
        k2 = g_slope(psi + 0.5 * h * k1)
        k3 = g_slope(psi + 0.5 * h * k2)
        k4 = g_slope(psi + h * k3)
        psi_evolved = psi + (k1 + 3 * k2 + 3 * k3 + k4) * (h / 8.0)

        # Ehrenfest optical force from the *initial* wavefunction
        # (laserCoolingPlusExpansionMDQTSpeedUp.cpp:490-503)
        kick_nojump = jnp.zeros((n,), rdtype)
        if self.scheme.force_w:
            for a, b, w in zip(self.scheme.force_a, self.scheme.force_b,
                               self.scheme.force_w):
                kick_nojump = kick_nojump + jnp.asarray(w, rdtype) * (
                    jnp.imag(psi[a, :] * jnp.conj(psi[b, :])))
            kick_nojump = kick_nojump * h
            if force_scale is not None:
                kick_nojump = kick_nojump * jnp.asarray(force_scale, rdtype)

        # ---- jump branch: collapse ----
        pop = psi.real ** 2 + psi.imag ** 2                # [S,N]
        src_w = pop * p.jump_src_mask[:, None]
        src_cum = jnp.cumsum(src_w, axis=0)
        tot = jnp.maximum(src_cum[-1, :], 1e-30)
        src = jnp.minimum(_categorical_sm(rolls[1] * tot, src_cum), S - 1)

        d_branch = rolls[2] < self.scheme.branch_d_prob     # D-decay?
        # destination distribution per ion via one-hot matmuls
        src_oh = (jax.lax.broadcasted_iota(jnp.int32, (S, n), 0)
                  == src[None, :]).astype(rdtype)           # [S,N]
        hi = jax.lax.Precision.HIGHEST
        cum_s = jnp.matmul(p.jump_dest_cum[0].T, src_oh,
                           precision=hi)                    # [S(dest),N]
        cum_d = jnp.matmul(p.jump_dest_cum[1].T, src_oh, precision=hi)
        dest_cum = jnp.where(d_branch[None, :], cum_d, cum_s)
        dest = jnp.minimum(_categorical_sm(rolls[4], dest_cum), S - 1)
        psi_jumped = (jax.lax.broadcasted_iota(jnp.int32, (S, n), 0)
                      == dest[None, :]).astype(psi.dtype)

        sign = jnp.where(rolls[3] < 0.5, 1.0, -1.0).astype(rdtype)
        kick_jump = sign * jnp.where(d_branch,
                                     jnp.asarray(self.scheme.kick_d, rdtype),
                                     jnp.asarray(self.scheme.kick_s, rdtype))
        if not self.scheme.apply_recoil:
            kick_jump = jnp.zeros_like(kick_jump)

        # ---- merge ----
        psi_new = jnp.where(jumped[None, :], psi_jumped, psi_evolved)
        t_part = jnp.where(jumped, jnp.zeros_like(t_part), t_part)
        if self.apply_force and self.scheme.has_force:
            vx = vx + jnp.where(jumped, kick_jump, kick_nojump)

        if self.renormalize:
            norm = jnp.sqrt(jnp.sum(psi_new.real ** 2 + psi_new.imag ** 2,
                                    axis=0, keepdims=True))
            # guard: padded Poissonian lanes carry psi == 0 (norm == 0) and
            # must stay exactly zero rather than 0/0 -> NaN (the fused kernel
            # applies the same guard in qt_fused.py)
            norm = jnp.where(norm > 0, norm, jnp.ones_like(norm))
            psi_new = psi_new / norm.astype(psi.dtype)

        return psi_new, vx, t_part

    # ---- ion-major ([N, S]) convenience wrapper -------------------------

    def step(self, psi: jax.Array, vx: jax.Array, t_part: jax.Array,
             key: jax.Array, exp_det=0.0, params: Optional[QTParams] = None,
             force_scale=None):
        """[N,S]-layout wrapper around :meth:`step_sm`."""
        psi_sm, vx, t_part = self.step_sm(psi.T, vx, t_part, key, exp_det,
                                          params=params,
                                          force_scale=force_scale)
        return psi_sm.T, vx, t_part


def random_s_superposition(key: jax.Array, n: int, n_states: int,
                           dtype=jnp.complex64) -> jax.Array:
    """Random superposition of the two S sublevels used by every plasma
    initializer (laserCoolingPlusExpansionMDQTSpeedUp.cpp:317-332):
    ``psi = sqrt(r1)|1> + (s2*sqrt((1-r1) r2) + i s1*sqrt((1-r1)(1-r2)))|2>``.
    """
    r1, r2, s1, s2 = jax.random.uniform(key, (4, n))
    sign1 = jnp.where(s1 < 0.5, -1.0, 1.0)
    sign2 = jnp.where(s2 < 0.5, -1.0, 1.0)
    c0 = jnp.sqrt(r1)
    c1 = (sign2 * jnp.sqrt((1 - r1) * r2)
          + 1j * sign1 * jnp.sqrt((1 - r1) * (1 - r2)))
    psi = jnp.zeros((n, n_states), dtype)
    psi = psi.at[:, 0].set(c0.astype(dtype))
    psi = psi.at[:, 1].set(c1.astype(dtype))
    return psi


def state_populations(psi: jax.Array, manifolds) -> list:
    """Total population per manifold, e.g. S/P/D
    (laserCoolingPlusExpansionMDQTSpeedUp.cpp:1019-1021).
    ``manifolds`` is a list of index tuples; psi is [N,S]."""
    pop = psi.real ** 2 + psi.imag ** 2
    return [jnp.sum(pop[:, list(idx)], axis=-1) for idx in manifolds]
