"""Fused tick-block kernel: one MD step's quantum ticks in one launch.

The SpeedUp scheme runs ``ratio`` quantum ticks (leapfrog substep + RK4
non-Hermitian QT update + jump sampling) between force refreshes.  The
XLA path runs each tick as ~20 small kernels over [S, N] planes (XLA
cannot fuse across iterations of the tick loop), each carrying
nanoseconds of work at the flagship N0=3500.  This kernel
runs the whole tick block per launch: Pallas through Triton, one program
per block of ``block`` ions, with every per-ion quantity — R, V, F,
``t_part`` and the S real + S imaginary rows of psi — held in registers
for all ticks.

The level scheme is baked in as Python scalars: H·psi is unrolled FMAs
over the real coupling table's nonzeros (the sr12 coupling is sparse),
the categorical jump draws are running sums and selects, and the decay
and force weights are constants.  Only the per-lane inputs (state planes,
the [ticks*5, Np] uniforms, the diagonal energies e0, and the Rabi rows of
a laser sweep) are read from memory, one [block] row at a time.

On an H100 at N0=3500 the kernel takes 32 µs per 25-tick MD step, and the
whole cooling loop runs at 8.07 µs per tick against 45.5 µs on the XLA
path (PERF.md).

Semantics are identical to ``QTEngine.step_sm`` + ``leapfrog_substep``
given the same uniforms (tests/test_fused.py runs the kernel in interpret
mode against the XLA path).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..levels import LevelScheme

#: Ions per program.  A power of two (Triton's block rule); one ion per
#: thread at ``num_warps = block // 32``.  128 measured fastest of
#: 32/64/128/256 at N0=3500 on an H100 (PERF.md).
DEFAULT_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class FusedTickSpec:
    """Static constants baked into the fused kernel."""

    scheme: LevelScheme
    h: float                 # quantum tick in gamma time
    qdt: float               # quantum tick in plasma time
    plas_to_quant_vel: float
    gamma_to_einstein: float
    ratio: int
    L: float
    apply_force: bool
    # expanding-frame detuning exp_det(t) = c1*t/sqrt(1+c2*t^2) added to the
    # Doppler shift u, computed in-kernel from the tick counter
    # (laserCoolingPlusExpansionMDQTSpeedUp.cpp:447); zero coefs disable it
    exp_c1: float = 0.0
    exp_c2: float = 0.0
    # explicit norm division after every tick (SpeedUp.cpp:706-712)
    renormalize: bool = False
    # the caller supplies the diagonal energies as a per-lane [S, Np]
    # plane (otherwise the scheme's e0 is broadcast to one) — lets folded
    # ensemble members carry *different laser detunings* (detSP/detDP
    # enter the physics only through e0, levels.py:151-156), so a whole
    # detuning sweep runs as ONE kernel launch per MD step.
    per_lane_e0: bool = False
    # per-lane Rabi frequencies: every coupling is *linear* in its Rabi
    # frequency (levels.py:172-190 — SP couplings ∝ om, DP couplings and
    # the beat-note coefficients ∝ om_dp, Ehrenfest force terms likewise
    # by group), so H splits exactly as om*C_sp + om_dp*C_dp + diag.
    # ``scheme_sp``/``scheme_dp`` hold the base patterns (the scheme
    # built at om=1,om_dp=0 and om=0,om_dp=1); the kernel scales them by
    # a [2, Np] row input.
    per_lane_om: bool = False
    scheme_sp: LevelScheme = None
    scheme_dp: LevelScheme = None

    @property
    def S(self) -> int:
        return self.scheme.n_states


def _row_nonzeros(mat) -> list:
    """Per row r of a real [S,S] table: the (column, value) nonzeros."""
    m = np.asarray(mat).real
    return [[(c, float(m[r, c])) for c in range(m.shape[1]) if m[r, c] != 0]
            for r in range(m.shape[0])]


def _make_kernel(spec: FusedTickSpec, n_ticks: int):
    sch = spec.scheme
    # beat-note (time-dependent coupling) source: with the om split the
    # coefficients come from the om_dp=1 base pattern, scaled per lane
    tsch = spec.scheme_dp if spec.per_lane_om else sch
    S = spec.S
    # plain Python floats: numpy scalars are not weakly typed and would
    # promote the f32 kernel arithmetic under jax_enable_x64
    h, qdt, L = float(spec.h), float(spec.qdt), float(spec.L)
    p2q, g2e = float(spec.plas_to_quant_vel), float(spec.gamma_to_einstein)
    c1, c2 = float(spec.exp_c1), float(spec.exp_c2)
    freq = float(tsch.tdep_freq) if tsch.tdep_rows else 0.0
    branch_d = float(sch.branch_d_prob)
    kick_s, kick_d = float(sch.kick_s), float(sch.kick_d)
    w = [float(x) for x in sch.decay_w]
    e1 = [float(x) for x in sch.e1]
    if spec.per_lane_om:
        groups_c = (_row_nonzeros(spec.scheme_sp.coupling),
                    _row_nonzeros(spec.scheme_dp.coupling))
    else:
        groups_c = (_row_nonzeros(sch.coupling),)
    src = set(int(s) for s in sch.jump_src)
    # destination-cumulative tables per (source, branch), nonzero sources
    cum = np.cumsum(np.asarray(sch.jump_dest, np.float64), -1)  # [S,2,S]
    cum_src = [s for s in range(S) if np.any(cum[s] != 0)]
    apply_kick = spec.apply_force and sch.has_force

    def kernel(scal_ref, R_ref, V_ref, F_ref, tp_ref, pre_ref, pim_ref,
               e0_ref, *rest):
        rest = list(rest)
        om_ref = rest.pop(0) if spec.per_lane_om else None
        rolls_ref, Ro_ref, Vo_ref, tpo_ref, preo_ref, pimo_ref = rest
        first = scal_ref[0]
        tick0 = scal_ref[1]
        F = [F_ref[k, :] for k in range(3)]
        zero = jnp.zeros_like(F[0])
        e0v = [e0_ref[r, :] for r in range(S)]
        # per-group lane scales: (om, om_dp) rows on a Rabi sweep
        scales = ((om_ref[0, :], om_ref[1, :]) if spec.per_lane_om
                  else (None,))

        def scaled(x, s):
            return x if s is None else s * x

        def hpsi(a, b, u, cphi, sphi, e0v):
            """(Hr + iHi)(a + ib) -> (re, im) lists of S rows."""
            re, im = [], []
            for r in range(S):
                d = e0v[r] + e1[r] * u if e1[r] else e0v[r]
                hr_a = d * a[r]
                hr_b = d * b[r]
                for nz, s in zip(groups_c, scales):
                    if not nz[r]:
                        continue
                    ca = cb = None
                    for c, v in nz[r]:
                        ca = v * a[c] if ca is None else ca + v * a[c]
                        cb = v * b[c] if cb is None else cb + v * b[c]
                    hr_a = hr_a + scaled(ca, s)
                    hr_b = hr_b + scaled(cb, s)
                if w[r]:
                    # -i w/2 decay on the diagonal
                    re.append(hr_a + (0.5 * w[r]) * b[r])
                    im.append(hr_b - (0.5 * w[r]) * a[r])
                else:
                    re.append(hr_a)
                    im.append(hr_b)
            sc = scales[-1]
            for r, cl, m in zip(tsch.tdep_rows, tsch.tdep_cols,
                                tsch.tdep_coefs):
                m = float(complex(m).real)
                # H[r,cl] = m e^{i phi}; H[cl,r] = m e^{-i phi}
                re[r] = re[r] + scaled(m * (cphi * a[cl] - sphi * b[cl]), sc)
                im[r] = im[r] + scaled(m * (cphi * b[cl] + sphi * a[cl]), sc)
                re[cl] = re[cl] + scaled(m * (cphi * a[r] + sphi * b[r]), sc)
                im[cl] = im[cl] + scaled(m * (cphi * b[r] - sphi * a[r]), sc)
            return re, im

        def dp_of(a, b):
            acc = zero
            for r in range(S):
                if w[r]:
                    acc = acc + w[r] * (a[r] * a[r] + b[r] * b[r])
            return h * acc

        def g_slope(a, b, u, cphi, sphi, e0v):
            dphi = jnp.minimum(jnp.maximum(dp_of(a, b), 0.0), 0.9)
            pref = jax.lax.rsqrt(1.0 - dphi)
            hre, him = hpsi(a, b, u, cphi, sphi, e0v)
            # G = pref*(phi - i h Hphi): re = pref*(a + h*him),
            # im = pref*(b - h*hre); slope = (G - phi)/h
            ka = [(pref * (a[r] + h * him[r]) - a[r]) * (1.0 / h)
                  for r in range(S)]
            kb = [(pref * (b[r] - h * hre[r]) - b[r]) * (1.0 / h)
                  for r in range(S)]
            return ka, kb

        def axpy(x, k, c):
            return [x[r] + c * k[r] for r in range(S)]

        def tick(i, carry):
            R, V, tp, a, b, fsq = carry
            R, V, a, b = list(R), list(V), list(a), list(b)

            # ---- leapfrog substep (forces fixed); ``fsq`` carries the
            # 2nd-order first-drift term, nonzero on the run's first tick
            half = 0.5 * qdt
            for k in range(3):
                x = R[k] + half * V[k] + fsq * F[k]
                x = jnp.where(x < 0, x + L, x)
                x = jnp.where(x > L, x - L, x)
                V[k] = V[k] + qdt * F[k]
                x = x + half * V[k] + fsq * F[k]
                x = jnp.where(x < 0, x + L, x)
                R[k] = jnp.where(x > L, x - L, x)

            # ---- quantum tick ----
            tp = tp + qdt
            u = V[0] * p2q
            if c1:
                # expansion-frame detuning at the tick's entry time, as in
                # CoolingScheduler.substeps (t before the tick increments)
                tpl = (tick0 + i.astype(jnp.float32)) * qdt
                u = u + c1 * tpl * jax.lax.rsqrt(1.0 + c2 * tpl * tpl)
            if tsch.tdep_rows:
                ang = freq * u * (tp * g2e)
                cphi, sphi = jnp.cos(ang), jnp.sin(ang)
            else:
                cphi = sphi = None
            r0, r1, r2, r3, r4 = (rolls_ref[i * 5 + k, :] for k in range(5))

            jumped = r0 < dp_of(a, b)

            k1a, k1b = g_slope(a, b, u, cphi, sphi, e0v)
            k2a, k2b = g_slope(axpy(a, k1a, 0.5 * h), axpy(b, k1b, 0.5 * h),
                               u, cphi, sphi, e0v)
            k3a, k3b = g_slope(axpy(a, k2a, 0.5 * h), axpy(b, k2b, 0.5 * h),
                               u, cphi, sphi, e0v)
            k4a, k4b = g_slope(axpy(a, k3a, h), axpy(b, k3b, h),
                               u, cphi, sphi, e0v)
            ae = [a[r] + (k1a[r] + 3 * k2a[r] + 3 * k3a[r] + k4a[r])
                  * (h / 8) for r in range(S)]
            be = [b[r] + (k1b[r] + 3 * k2b[r] + 3 * k3b[r] + k4b[r])
                  * (h / 8) for r in range(S)]

            # ---- jump collapse: source by population, then destination
            # from the (source, branch) cumulative table ----
            acc = zero
            src_cum = []
            for k in range(S):
                if k in src:
                    acc = acc + (a[k] * a[k] + b[k] * b[k])
                src_cum.append(acc)
            x = r1 * jnp.maximum(acc, 1e-30)
            n_src = zero.astype(jnp.int32)
            for c in src_cum:
                n_src = n_src + (x >= c).astype(jnp.int32)
            src_i = jnp.minimum(n_src, S - 1)
            d_branch = r2 < branch_d
            n_dst = zero.astype(jnp.int32)
            for k in range(S):
                cs = cd = zero
                for s in cum_src:
                    hit = src_i == s
                    cs = jnp.where(hit, float(cum[s, 0, k]), cs)
                    cd = jnp.where(hit, float(cum[s, 1, k]), cd)
                n_dst = n_dst + (r4 >= jnp.where(d_branch, cd, cs)
                                 ).astype(jnp.int32)
            dest = jnp.minimum(n_dst, S - 1)

            if apply_kick:
                # Ehrenfest kick from the initial wavefunction:
                # Im(psi_a conj(psi_b)) = b_a a_b - a_a b_b
                if spec.per_lane_om:
                    fgroups = ((spec.scheme_sp, scales[0]),
                               (spec.scheme_dp, scales[1]))
                else:
                    fgroups = ((sch, None),)
                kick_nj = zero
                for gsch, s in fgroups:
                    kacc = zero
                    for fa, fb, fw in zip(gsch.force_a, gsch.force_b,
                                          gsch.force_w):
                        if fw:      # the om splits zero the other group
                            kacc = kacc + float(fw) * (b[fa] * a[fb]
                                                       - a[fa] * b[fb])
                    kick_nj = kick_nj + scaled(kacc, s)
                kick_nj = kick_nj * h
                if sch.apply_recoil:
                    kick_j = (jnp.where(r3 < 0.5, 1.0, -1.0)
                              * jnp.where(d_branch, kick_d, kick_s))
                else:
                    kick_j = zero
                V[0] = V[0] + jnp.where(jumped, kick_j, kick_nj)

            a = [jnp.where(jumped, jnp.where(dest == r, 1.0, 0.0), ae[r])
                 for r in range(S)]
            b = [jnp.where(jumped, 0.0, be[r]) for r in range(S)]
            tp = jnp.where(jumped, 0.0, tp)
            if spec.renormalize:
                nrm = zero
                for r in range(S):
                    nrm = nrm + (a[r] * a[r] + b[r] * b[r])
                # guarded so pad lanes (norm 0) stay exactly zero
                inv = jnp.where(nrm > 0.0, jax.lax.rsqrt(
                    jnp.where(nrm > 0.0, nrm, 1.0)), 0.0)
                a = [x * inv for x in a]
                b = [x * inv for x in b]
            return tuple(R), tuple(V), tp, tuple(a), tuple(b), 0.0 * fsq

        carry = (tuple(R_ref[k, :] for k in range(3)),
                 tuple(V_ref[k, :] for k in range(3)), tp_ref[0, :],
                 tuple(pre_ref[r, :] for r in range(S)),
                 tuple(pim_ref[r, :] for r in range(S)),
                 first * (0.25 * qdt * qdt))
        R, V, tp, a, b, _ = jax.lax.fori_loop(0, n_ticks, tick, carry)
        for k in range(3):
            Ro_ref[k, :] = R[k]
            Vo_ref[k, :] = V[k]
        tpo_ref[0, :] = tp
        for r in range(S):
            preo_ref[r, :] = a[r]
            pimo_ref[r, :] = b[r]

    return kernel


def _check_real_tables(spec: FusedTickSpec) -> None:
    """The kernel unrolls complex arithmetic assuming purely real coupling
    tables (true for all four reference schemes); fail loudly otherwise."""
    schemes = [spec.scheme]
    if spec.per_lane_om:
        if spec.scheme_sp is None or spec.scheme_dp is None:
            raise ValueError("spec.per_lane_om requires scheme_sp/"
                             "scheme_dp base patterns")
        schemes += [spec.scheme_sp, spec.scheme_dp]
    for s_ in schemes:
        if np.abs(np.asarray(s_.coupling).imag).max() != 0.0:
            raise ValueError("fused kernel requires a real coupling "
                             f"matrix; scheme {s_.name} has complex "
                             "entries")
        if any(complex(m).imag != 0.0 for m in s_.tdep_coefs):
            raise ValueError("fused kernel requires real tdep "
                             f"coefficients; scheme {s_.name} has "
                             "complex entries")


@functools.partial(jax.jit, static_argnames=("spec", "block", "interpret"))
def fused_md_substeps(spec: FusedTickSpec, first, R, V, F, tp, psi_re,
                      psi_im, rolls, tick0=None, e0_lanes=None,
                      om_lanes=None, block: int = DEFAULT_BLOCK,
                      interpret: bool = False):
    """One MD step's worth of quantum-substepped ticks as one kernel.

    Shapes: R/V/F [3, Np], tp [1, Np], psi planes [S, Np], rolls
    [ratio*5, Np] (row ``5*i + k`` is tick i's k-th uniform); Np must be
    a multiple of ``block``.  ``first`` is a one-element f32 flag
    selecting the reference's 2nd-order first drift; ``tick0`` is the
    one-element f32 run tick counter, required when the spec enables the
    expanding-frame detuning (exp_c1 != 0).  ``e0_lanes`` [S, Np]
    supplies per-lane diagonal energies when ``spec.per_lane_e0``
    (detuning-sweep folds — each member block of the lane axis carries
    its own detunings); ``om_lanes`` [2, Np] supplies per-lane (om,
    om_dp) Rabi rows when ``spec.per_lane_om``.  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests and dry runs).

    Returns ``(R, V, tp, psi_re, psi_im)`` in the input layout.
    """
    _check_real_tables(spec)
    S, npad = spec.S, R.shape[1]
    if block & (block - 1):
        raise ValueError(f"block {block} must be a power of two")
    if psi_re.shape != (S, npad) or psi_im.shape != (S, npad):
        raise ValueError(f"psi planes must be [{S}, {npad}], got "
                         f"{psi_re.shape}/{psi_im.shape}")
    if npad % block or R.shape != (3, npad) or tp.shape != (1, npad):
        raise ValueError(f"bad shapes: R {R.shape}, tp {tp.shape}, "
                         f"Np={npad} must be a multiple of block={block}")
    if rolls.shape != (spec.ratio * 5, npad):
        raise ValueError(f"rolls must be [{spec.ratio * 5}, {npad}], got "
                         f"{rolls.shape}")
    if tick0 is None:
        if spec.exp_c1:
            raise ValueError("tick0 is required when exp_c1 != 0 (the "
                             "expanding-frame detuning is a function of "
                             "absolute run time)")
        tick0 = 0.0
    scal = jnp.stack([jnp.reshape(first, ()), jnp.reshape(tick0, ())]
                     ).astype(jnp.float32)

    def rows(n):
        return pl.BlockSpec((n, block), lambda i: (0, i))

    if spec.per_lane_e0:
        if e0_lanes is None or e0_lanes.shape != (S, npad):
            raise ValueError(f"spec.per_lane_e0 requires e0_lanes [{S}, "
                             f"{npad}], got "
                             f"{None if e0_lanes is None else e0_lanes.shape}")
    else:
        # one code path for both: the diagonal always arrives as a plane
        e0_lanes = jnp.broadcast_to(
            jnp.asarray(np.asarray(spec.scheme.e0, np.float32))[:, None],
            (S, npad))
    in_specs = [pl.BlockSpec((2,), lambda i: (0,)), rows(3), rows(3),
                rows(3), rows(1), rows(S), rows(S), rows(S)]
    extra = []
    if spec.per_lane_om:
        if om_lanes is None or om_lanes.shape != (2, npad):
            raise ValueError(f"spec.per_lane_om requires om_lanes [2, "
                             f"{npad}], got "
                             f"{None if om_lanes is None else om_lanes.shape}")
        in_specs.append(rows(2))
        extra.append(om_lanes)
    in_specs.append(rows(spec.ratio * 5))
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    return pl.pallas_call(
        _make_kernel(spec, spec.ratio),
        grid=(npad // block,),
        in_specs=in_specs,
        out_specs=(rows(3), rows(3), rows(1), rows(S), rows(S)),
        out_shape=(f32(3, npad), f32(3, npad), f32(1, npad), f32(S, npad),
                   f32(S, npad)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="fused_tick_block",
    )(scal, R, V, F, tp, psi_re, psi_im, e0_lanes, *extra, rolls)
