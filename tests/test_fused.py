"""Fused tick-block kernel (Pallas through Triton) vs the XLA path.

The kernel runs in the Pallas interpreter here; the CUDA-lowering tests
check that it lowers to a Triton launch for the GPU without a GPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.core.qt import QTEngine
from mdqtplasmasims_tpu.core.md import leapfrog_substep
from mdqtplasmasims_tpu.core.qt_fused import FusedTickSpec, fused_md_substeps
from mdqtplasmasims_tpu.core.qt import random_s_superposition
from mdqtplasmasims_tpu.levels import sr12_cooling, tag422, with_recoil
from mdqtplasmasims_tpu.units import PlasmaUnits


def xla_reference(engine, R, V, F, tp, psi, rolls, qdt, L, ratio, first,
                  tick0=0, exp_det_fn=None):
    """The existing per-tick path with supplied rolls (f32)."""
    R, V, psi_sm = R.T, V.T, psi.T
    F_sm = F.T
    for i in range(ratio):
        fs = first and i == 0
        R, V = leapfrog_substep(R, V, F_sm, qdt, L, fs)
        exp_det = exp_det_fn((tick0 + i) * qdt) if exp_det_fn else 0.0
        psi_sm, vx, tp = engine.step_sm(psi_sm, V[0, :], tp,
                                        exp_det=exp_det, rolls=rolls[i])
        V = V.at[0, :].set(vx)
    return R, V, tp, psi_sm


@pytest.mark.parametrize("scheme_name", ["sr12", "tag422"])
@pytest.mark.parametrize("excited_start", [False, True])
def test_fused_matches_xla(scheme_name, excited_start):
    n = 96
    block = 64
    npad = 128
    ratio = 20 if excited_start else 5
    L = PlasmaUnits.box_length(n)
    if scheme_name == "sr12":
        scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
        apply_force = True
    else:
        scheme = tag422()
        apply_force = False
    S = scheme.n_states
    h, qdt, p2q, g2e = 0.00985, 8e-5, 1.327, 123.1
    engine = QTEngine(scheme, h=h, dt_plasma=qdt, plas_to_quant_vel=p2q,
                      gamma_to_einstein=g2e, apply_force=apply_force)
    spec = FusedTickSpec(scheme=scheme, h=h, qdt=qdt, plas_to_quant_vel=p2q,
                         gamma_to_einstein=g2e, ratio=ratio, L=L,
                         apply_force=apply_force)

    key = jax.random.PRNGKey(0)
    kr, kv, kp, kf, kq = jax.random.split(key, 5)
    R = jax.random.uniform(kr, (n, 3), jnp.float32, 0, L)
    V = jax.random.normal(kv, (n, 3), jnp.float32) * 0.3
    F = jax.random.normal(kf, (n, 3), jnp.float32) * 0.5
    psi = random_s_superposition(kp, n, S, jnp.complex64)
    if excited_start:
        # populate the P manifold so jumps fire on most ticks, exercising
        # the collapse tables (a ground-state start has dp ~ 0)
        psi = jnp.zeros((n, S), jnp.complex64)
        psi = psi.at[:, 2].set(0.7).at[:, 4].set(0.5j).at[:, 0].set(0.51)
    tp = jnp.abs(jax.random.normal(kq, (n,), jnp.float32))
    rolls = jax.random.uniform(jax.random.PRNGKey(7), (ratio, 5, n),
                               jnp.float32)

    R_x, V_x, tp_x, psi_x = xla_reference(engine, R, V, F, tp, psi, rolls,
                                          qdt, L, ratio, first=False)

    # pack padded fused inputs
    def pad_rows(x, rows):
        out = jnp.zeros((rows, npad), jnp.float32)
        return out.at[:x.shape[0], :n].set(x)
    Rp = pad_rows(R.T, 3)
    Vp = pad_rows(V.T, 3)
    Fp = pad_rows(F.T, 3)
    tpp = pad_rows(tp[None, :], 1)
    prep = pad_rows(psi.T.real, S)
    pimp = pad_rows(psi.T.imag, S)
    rollsp = pad_rows(rolls.reshape(ratio * 5, n), ratio * 5)
    first = jnp.zeros((1, 1), jnp.float32)

    Ro, Vo, tpo, preo, pimo = fused_md_substeps(
        spec, first, Rp, Vp, Fp, tpp, prep, pimp, rollsp, block=block,
        interpret=True)

    atol = 2e-5
    np.testing.assert_allclose(np.asarray(Ro[:, :n]), np.asarray(R_x),
                               atol=atol, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(Vo[:, :n]), np.asarray(V_x),
                               atol=atol, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(tpo[0, :n]), np.asarray(tp_x),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(preo[:, :n]),
                               np.asarray(psi_x.real), atol=5e-5)
    np.testing.assert_allclose(np.asarray(pimo[:, :n]),
                               np.asarray(psi_x.imag), atol=5e-5)
    # pad lanes stay zero
    assert float(jnp.abs(preo[:, n:]).max()) == 0.0


@pytest.mark.parametrize("renorm", [False, True])
def test_fused_expansion_and_renormalize_match_xla(renorm):
    """The full flagship envelope on the fused path: expanding-frame
    detuning (computed in-kernel from the tick counter) and explicit
    renormalization must reproduce the XLA per-tick path (VERDICT item 1;
    laserCoolingPlusExpansionMDQTSpeedUp.cpp:447,706-712)."""
    n, block, npad, ratio, tick_start = 96, 64, 128, 12, 3700
    L = PlasmaUnits.box_length(n)
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    S = scheme.n_states
    h, qdt, p2q, g2e = 0.00985, 8e-5, 1.327, 123.1
    # flagship-like coefficients: frac_of_sig=0.5, te=19, density=2, sig0=4
    c1 = 0.0126 * 0.5 * 19.0 / (np.sqrt(2.0) * 4.0)
    c2 = 0.00014314 * 19.0 / (2.0 * 16.0)
    exp_det_fn = lambda t: np.float32(c1 * t / np.sqrt(1.0 + c2 * t * t))
    engine = QTEngine(scheme, h=h, dt_plasma=qdt, plas_to_quant_vel=p2q,
                      gamma_to_einstein=g2e, apply_force=True,
                      renormalize=renorm)
    spec = FusedTickSpec(scheme=scheme, h=h, qdt=qdt, plas_to_quant_vel=p2q,
                         gamma_to_einstein=g2e, ratio=ratio, L=L,
                         apply_force=True, exp_c1=c1, exp_c2=c2,
                         renormalize=renorm)

    key = jax.random.PRNGKey(5)
    kr, kv, kp, kf, kq = jax.random.split(key, 5)
    R = jax.random.uniform(kr, (n, 3), jnp.float32, 0, L)
    V = jax.random.normal(kv, (n, 3), jnp.float32) * 0.3
    F = jax.random.normal(kf, (n, 3), jnp.float32) * 0.5
    psi = jnp.zeros((n, S), jnp.complex64)
    psi = psi.at[:, 2].set(0.7).at[:, 4].set(0.5j).at[:, 0].set(0.51)
    tp = jnp.abs(jax.random.normal(kq, (n,), jnp.float32))
    rolls = jax.random.uniform(jax.random.PRNGKey(17), (ratio, 5, n),
                               jnp.float32)

    R_x, V_x, tp_x, psi_x = xla_reference(
        engine, R, V, F, tp, psi, rolls, qdt, L, ratio, first=False,
        tick0=tick_start, exp_det_fn=exp_det_fn)

    def pad_rows(x, rows):
        out = jnp.zeros((rows, npad), jnp.float32)
        return out.at[:x.shape[0], :n].set(x)

    Ro, Vo, tpo, preo, pimo = fused_md_substeps(
        spec, jnp.zeros((1, 1), jnp.float32), pad_rows(R.T, 3),
        pad_rows(V.T, 3), pad_rows(F.T, 3), pad_rows(tp[None, :], 1),
        pad_rows(psi.T.real, S), pad_rows(psi.T.imag, S),
        pad_rows(rolls.reshape(ratio * 5, n), ratio * 5),
        tick0=jnp.full((1, 1), tick_start, jnp.float32), block=block,
        interpret=True)

    np.testing.assert_allclose(np.asarray(Ro[:, :n]), np.asarray(R_x),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(Vo[:, :n]), np.asarray(V_x),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(tpo[0, :n]), np.asarray(tp_x),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(preo[:, :n]),
                               np.asarray(psi_x.real), atol=5e-5)
    np.testing.assert_allclose(np.asarray(pimo[:, :n]),
                               np.asarray(psi_x.imag), atol=5e-5)
    # pad lanes stay exactly zero (renormalize must not 0/0 them)
    assert float(jnp.abs(preo[:, n:]).max()) == 0.0
    assert float(jnp.abs(pimo[:, n:]).max()) == 0.0
    if renorm:
        norm = preo[:, :n] ** 2 + pimo[:, :n] ** 2
        np.testing.assert_allclose(np.asarray(jnp.sum(norm, 0)), 1.0,
                                   atol=1e-5)


def test_fused_requires_tick0_with_expansion():
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    spec = FusedTickSpec(scheme=scheme, h=0.01, qdt=8e-5,
                         plas_to_quant_vel=1.3, gamma_to_einstein=123.0,
                         ratio=2, L=10.0, apply_force=True, exp_c1=0.5,
                         exp_c2=0.1)
    z3 = jnp.zeros((3, 128), jnp.float32)
    z1 = jnp.zeros((1, 128), jnp.float32)
    zS = jnp.zeros((spec.S, 128), jnp.float32)
    rolls = jnp.zeros((10, 128), jnp.float32)
    with pytest.raises(ValueError, match="tick0"):
        fused_md_substeps(spec, jnp.zeros((1, 1), jnp.float32), z3, z3, z3,
                          z1, zS, zS, rolls, interpret=True)


def test_fused_rejects_complex_coupling():
    scheme = sr12_cooling()
    C = scheme.coupling.copy()
    C[2, 1] += 0.3j
    C[1, 2] -= 0.3j
    bad = dataclasses.replace(scheme, coupling=C)
    spec = FusedTickSpec(scheme=bad, h=0.01, qdt=8e-5,
                         plas_to_quant_vel=1.3, gamma_to_einstein=123.0,
                         ratio=2, L=10.0, apply_force=True)
    z3 = jnp.zeros((3, 128), jnp.float32)
    z1 = jnp.zeros((1, 128), jnp.float32)
    zS = jnp.zeros((spec.S, 128), jnp.float32)
    rolls = jnp.zeros((10, 128), jnp.float32)
    with pytest.raises(ValueError, match="real coupling"):
        fused_md_substeps(spec, jnp.zeros((1, 1), jnp.float32), z3, z3, z3,
                          z1, zS, zS, rolls, interpret=True)


def test_fused_ensemble_fold_matches_per_job():
    """The ensemble fold (scheduler.fused_substeps_ensemble) packs E jobs
    into the fused kernel's ion axis; with explicit rolls each job must
    reproduce a direct per-job fused_md_substeps call bit-for-bit."""
    from mdqtplasmasims_tpu.core.scheduler import CoolingScheduler
    from mdqtplasmasims_tpu.state import SimState

    n, block, npad, ratio, E = 96, 64, 128, 5, 3
    L = PlasmaUnits.box_length(n)
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    S = scheme.n_states
    h, qdt, p2q, g2e = 0.00985, 8e-5, 1.327, 123.1
    engine = QTEngine(scheme, h=h, dt_plasma=qdt, plas_to_quant_vel=p2q,
                      gamma_to_einstein=g2e, apply_force=True)
    spec = FusedTickSpec(scheme=scheme, h=h, qdt=qdt, plas_to_quant_vel=p2q,
                         gamma_to_einstein=g2e, ratio=ratio, L=L,
                         apply_force=True)
    sched = CoolingScheduler(engine=engine, forces_fn=None, L=L, qdt=qdt,
                             ratio=ratio, fused_spec=spec, block=block,
                             interpret=True)

    key = jax.random.PRNGKey(3)
    kr, kv, kp, kf, kq, kk = jax.random.split(key, 6)
    R = jax.random.uniform(kr, (E, n, 3), jnp.float32, 0, L)
    V = jax.random.normal(kv, (E, n, 3), jnp.float32) * 0.3
    F = jax.random.normal(kf, (E, n, 3), jnp.float32) * 0.5
    psi = jnp.zeros((E, n, S), jnp.complex64)
    psi = psi.at[:, :, 2].set(0.7).at[:, :, 4].set(0.5j).at[:, :, 0].set(0.51)
    tp = jnp.abs(jax.random.normal(kq, (E, n), jnp.float32))
    keys = jax.random.split(kk, E)
    states = SimState(R=R, V=V, F=F, psi=psi, t_part=tp, key=keys,
                      tick=jnp.full((E,), 7, jnp.int32),
                      t=jnp.full((E,), 7 * qdt, jnp.float32))

    out = sched.fused_substeps_ensemble(states, F)

    # replicate the wrapper's roll draw, then run each job directly
    rolls = jax.random.uniform(
        jax.vmap(jax.random.split)(keys)[0, 1],
        (ratio * 5, E * npad), jnp.float32)
    def pad_rows(x, rows):
        o = jnp.zeros((rows, npad), jnp.float32)
        return o.at[:x.shape[0], :n].set(x)

    first = jnp.zeros((1, 1), jnp.float32)
    for e in range(E):
        Ro, Vo, tpo, preo, pimo = fused_md_substeps(
            spec, first, pad_rows(R[e].T, 3), pad_rows(V[e].T, 3),
            pad_rows(F[e].T, 3), pad_rows(tp[e][None, :], 1),
            pad_rows(psi[e].T.real, S), pad_rows(psi[e].T.imag, S),
            rolls[:, e * npad:(e + 1) * npad], block=block, interpret=True)
        np.testing.assert_array_equal(np.asarray(out.R[e]),
                                      np.asarray(Ro[:, :n].T))
        np.testing.assert_array_equal(np.asarray(out.V[e]),
                                      np.asarray(Vo[:, :n].T))
        np.testing.assert_array_equal(np.asarray(out.t_part[e]),
                                      np.asarray(tpo[0, :n]))
        np.testing.assert_array_equal(np.asarray(out.psi[e].real),
                                      np.asarray(preo[:S, :n].T))
        np.testing.assert_array_equal(np.asarray(out.psi[e].imag),
                                      np.asarray(pimo[:S, :n].T))
    assert int(out.tick[0]) == 7 + ratio


def test_soa_ensemble_segment_matches_per_step():
    """The ensemble SoA-resident segment loop (scheduler.soa_ens_*) is the
    same computation as repeated fused_substeps_ensemble calls — same
    job-batched force kernel, same RNG draws — so final state batches
    must match bit-for-bit."""
    from mdqtplasmasims_tpu.core.scheduler import CoolingScheduler
    from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_soa_batched
    from mdqtplasmasims_tpu.state import SimState

    n, block, npad, ratio, E, steps = 96, 64, 128, 4, 3, 3
    L = PlasmaUnits.box_length(n)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    S = scheme.n_states
    h, qdt, p2q, g2e = 0.00985, 8e-5, 1.327, 123.1
    engine = QTEngine(scheme, h=h, dt_plasma=qdt, plas_to_quant_vel=p2q,
                      gamma_to_einstein=g2e, apply_force=True)
    spec = FusedTickSpec(scheme=scheme, h=h, qdt=qdt, plas_to_quant_vel=p2q,
                         gamma_to_einstein=g2e, ratio=ratio, L=L,
                         apply_force=True)
    sched = CoolingScheduler(engine=engine, forces_fn=None, L=L, qdt=qdt,
                             ratio=ratio, fused_spec=spec, block=block,
                             interpret=True)

    key = jax.random.PRNGKey(5)
    kr, kv, kp, kk = jax.random.split(key, 4)
    R = jax.random.uniform(kr, (E, n, 3), jnp.float32, 0, L)
    V = jax.random.normal(kv, (E, n, 3), jnp.float32) * 0.2
    psi = jax.vmap(lambda k: random_s_superposition(k, n, S, jnp.complex64))(
        jax.random.split(kp, E))
    keys = jax.random.split(kk, E)
    states = SimState(R=R, V=V, F=jnp.zeros_like(R), psi=psi,
                      t_part=jnp.zeros((E, n), jnp.float32), key=keys,
                      tick=jnp.zeros((E,), jnp.int32),
                      t=jnp.zeros((E,), jnp.float32))

    mask_row = jnp.zeros((1, npad), jnp.float32).at[0, :n].set(1.0)
    soa_forces = lambda Rp: yukawa_forces_soa_batched(
        Rp, mask_row, E, L, ldeb)

    def batched_forces(R):
        # the same padded force program the SoA loop runs, on [E, n, 3]
        Rp = jnp.zeros((E, 3, npad), jnp.float32).at[:, :, :n].set(
            jnp.swapaxes(R, 1, 2))
        F = soa_forces(jnp.swapaxes(Rp, 0, 1).reshape(3, E * npad))
        F = jnp.swapaxes(F.reshape(3, E, npad), 0, 1)[:, :, :n]
        return jnp.swapaxes(F, 1, 2)

    # reference: per-step fused_substeps_ensemble with a fresh batched
    # force evaluation each step (as the pre-SoA ensemble loop did)
    s_ref = states
    for _ in range(steps):
        s_ref = sched.fused_substeps_ensemble(s_ref,
                                              batched_forces(s_ref.R))

    carry = sched.soa_ens_init(states, states.F)
    for _ in range(steps):
        carry = sched.soa_ens_md_step(carry, soa_forces)
    s_soa = sched.soa_ens_restore(carry, states)

    for name in ("R", "V", "t_part"):
        np.testing.assert_array_equal(
            np.asarray(getattr(s_ref, name)),
            np.asarray(getattr(s_soa, name)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(s_ref.psi),
                                  np.asarray(s_soa.psi))
    np.testing.assert_array_equal(np.asarray(s_ref.key),
                                  np.asarray(s_soa.key))
    assert int(s_soa.tick[0]) == steps * ratio


def test_soa_segment_loop_matches_md_steps():
    """The SoA-resident segment loop (scheduler.soa_*) is the same
    computation as repeated fused md_step calls — same force kernel, same
    RNG draws — so final states must match bit-for-bit."""
    from mdqtplasmasims_tpu.core.scheduler import CoolingScheduler
    from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_soa
    from mdqtplasmasims_tpu.state import make_state

    n, block, ratio, steps = 96, 64, 4, 3
    L = PlasmaUnits.box_length(n)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    h, qdt, p2q, g2e = 0.00985, 8e-5, 1.327, 123.1
    engine = QTEngine(scheme, h=h, dt_plasma=qdt, plas_to_quant_vel=p2q,
                      gamma_to_einstein=g2e, apply_force=True)
    spec = FusedTickSpec(scheme=scheme, h=h, qdt=qdt, plas_to_quant_vel=p2q,
                         gamma_to_einstein=g2e, ratio=ratio, L=L,
                         apply_force=True)
    npad = 128
    mask_row = jnp.zeros((1, npad), jnp.float32).at[0, :n].set(1.0)
    soa_forces = lambda Rp: yukawa_forces_soa(Rp, mask_row, L, ldeb)
    # md_step's [n, 3] forces through the same padded program
    forces_fn = lambda R: (soa_forces(
        jnp.zeros((3, npad), jnp.float32).at[:, :n].set(R.T))[:, :n].T,
        None)
    sched = CoolingScheduler(engine=engine, forces_fn=forces_fn, L=L,
                             qdt=qdt, ratio=ratio, fused_spec=spec,
                             block=block, interpret=True)

    key = jax.random.PRNGKey(11)
    kr, kv, kp, kk = jax.random.split(key, 4)
    R = jax.random.uniform(kr, (n, 3), jnp.float32, 0, L)
    V = jax.random.normal(kv, (n, 3), jnp.float32) * 0.1
    psi = random_s_superposition(kp, n, scheme.n_states, jnp.complex64)
    state0 = make_state(R, V, psi, kk)

    s_ref = state0
    for _ in range(steps):
        s_ref = sched.md_step(s_ref)

    carry = sched.soa_init(state0, state0.F)
    for _ in range(steps):
        carry = sched.soa_md_step(carry, soa_forces)
    s_soa = sched.soa_restore(carry, state0)

    for name in ("R", "V", "F", "t_part"):
        np.testing.assert_array_equal(
            np.asarray(getattr(s_ref, name)),
            np.asarray(getattr(s_soa, name)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(s_ref.psi),
                                  np.asarray(s_soa.psi))
    assert int(s_ref.tick) == int(s_soa.tick) == steps * ratio


class TestPerLaneE0:
    """Per-lane diagonal energies (FusedTickSpec.per_lane_e0): the kernel
    input that makes detuning sweeps fold into one launch.  Detunings
    enter the physics only through e0 (levels.py:151-156), so a member
    block whose lanes carry e0(detSP', detDP') must evolve exactly as a
    kernel whose *spec* was built from those detunings."""

    @staticmethod
    def _setup(detuning=-1.0, detuning_dp=1.0, ratio=5, n=96, npad=128):
        L = PlasmaUnits.box_length(n)
        scheme = with_recoil(sr12_cooling(detuning, detuning_dp),
                             9.1e-4, 3.6e-4)
        h, qdt, p2q, g2e = 0.00985, 8e-5, 1.327, 123.1
        spec = FusedTickSpec(scheme=scheme, h=h, qdt=qdt,
                             plas_to_quant_vel=p2q, gamma_to_einstein=g2e,
                             ratio=ratio, L=L, apply_force=True)
        return spec

    @staticmethod
    def _inputs(spec, n, npad, key=0):
        kr, kv, kf, kq, ko = jax.random.split(jax.random.PRNGKey(key), 5)
        S = spec.S
        R = jnp.zeros((3, npad), jnp.float32).at[:, :n].set(
            jax.random.uniform(kr, (3, n), jnp.float32, 0, spec.L))
        V = jnp.zeros((3, npad), jnp.float32).at[:, :n].set(
            jax.random.normal(kv, (3, n), jnp.float32) * 0.3)
        F = jnp.zeros((3, npad), jnp.float32).at[:, :n].set(
            jax.random.normal(kf, (3, n), jnp.float32) * 0.5)
        tp = jnp.zeros((1, npad), jnp.float32).at[0, :n].set(
            jnp.abs(jax.random.normal(kq, (n,), jnp.float32)))
        pre = jnp.zeros((S, npad), jnp.float32).at[0, :n].set(0.6)
        pre = pre.at[2, :n].set(0.64)
        pim = jnp.zeros((S, npad), jnp.float32).at[4, :n].set(0.48)
        rolls = jax.random.uniform(ko, (spec.ratio * 5, npad), jnp.float32)
        return R, V, F, tp, pre, pim, rolls

    @staticmethod
    def _e0_plane(scheme, S, npad):
        e0 = np.zeros((S, 1), np.float32)
        e0[:scheme.n_states, 0] = scheme.e0
        return jnp.asarray(np.repeat(e0, npad, axis=1))

    def test_uniform_plane_matches_baseline(self):
        """A per-lane plane filled with the scheme's own e0 is a no-op:
        bit-identical to the vecs-column baseline."""
        n = npad = block = 128
        spec = self._setup(n=n, npad=npad)
        args = self._inputs(spec, n, npad)
        first = jnp.ones((1, 1), jnp.float32)
        base = fused_md_substeps(spec, first, *args[:6], rolls=args[6],
                                 block=block, interpret=True)
        spec_pl = dataclasses.replace(spec, per_lane_e0=True)
        e0p = self._e0_plane(spec.scheme, spec.S, npad)
        out = fused_md_substeps(spec_pl, first, *args[:6], rolls=args[6],
                                e0_lanes=e0p, block=block, interpret=True)
        for a, b in zip(base, out):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_two_point_sweep_matches_per_detuning_specs(self):
        """Two lane blocks carrying different (detSP, detDP) e0 vectors
        evolve bit-identically to two kernels whose specs were built from
        those detunings (same rolls per block)."""
        n = npad = block = 128
        points = [(-1.0, 1.0), (-0.4, 0.25)]
        specs = [self._setup(d, dd, n=n, npad=npad) for d, dd in points]
        S = specs[0].S
        args = [self._inputs(s, n, npad, key=7 + i)
                for i, s in enumerate(specs)]
        first = jnp.zeros((1, 1), jnp.float32)

        # folded: one kernel over 2*npad lanes, per-lane e0 per block
        spec_pl = dataclasses.replace(specs[0], per_lane_e0=True)
        cat = lambda i: jnp.concatenate([args[0][i], args[1][i]], axis=1)
        e0p = jnp.concatenate(
            [self._e0_plane(s.scheme, S, npad) for s in specs], axis=1)
        out = fused_md_substeps(spec_pl, first, cat(0), cat(1), cat(2),
                                cat(3), cat(4), cat(5), rolls=cat(6),
                                e0_lanes=e0p, block=block, interpret=True)

        for j, spec_j in enumerate(specs):
            ref = fused_md_substeps(spec_j, first, *args[j][:6],
                                    rolls=args[j][6], block=block,
                                    interpret=True)
            sl = slice(j * npad, (j + 1) * npad)
            for a, b in zip(ref, out):
                np.testing.assert_array_equal(np.asarray(a),
                                              np.asarray(b[:, sl]))

    def test_e0_lanes_validation(self):
        n = npad = block = 128
        spec = self._setup(n=n, npad=npad)
        spec_pl = dataclasses.replace(spec, per_lane_e0=True)
        args = self._inputs(spec, n, npad)
        first = jnp.ones((1, 1), jnp.float32)
        with pytest.raises(ValueError, match="e0_lanes"):
            fused_md_substeps(spec_pl, first, *args[:6], rolls=args[6],
                              block=block, interpret=True)
        bad = jnp.zeros((spec.S, npad + 128), jnp.float32)
        with pytest.raises(ValueError, match="e0_lanes"):
            fused_md_substeps(spec_pl, first, *args[:6], rolls=args[6],
                              e0_lanes=bad, block=block, interpret=True)


@pytest.mark.parametrize("feature", ["plain", "expansion_renorm",
                                     "per_lane_e0", "per_lane_om"])
def test_kernel_lowers_to_triton_for_cuda(feature):
    """The kernel lowers through the Pallas Triton route for the CUDA
    platform (exported here with no GPU attached): every primitive it
    uses has a Triton lowering rule and every load/store is a power-of-two
    [block] row.  Compilation to PTX happens on the card itself."""
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, om_split_schemes)
    n, npad, ratio = 96, 128, 3
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    kw = {}
    if feature == "expansion_renorm":
        kw = dict(exp_c1=0.02, exp_c2=0.001, renormalize=True)
    elif feature == "per_lane_e0":
        kw = dict(per_lane_e0=True)
    elif feature == "per_lane_om":
        sp, dp = om_split_schemes(CoolingConfig())
        kw = dict(per_lane_om=True, scheme_sp=sp, scheme_dp=dp)
    spec = FusedTickSpec(scheme=scheme, h=0.00985, qdt=8e-5,
                         plas_to_quant_vel=1.327, gamma_to_einstein=123.1,
                         ratio=ratio, L=PlasmaUnits.box_length(n),
                         apply_force=True, **kw)
    S = spec.S
    z = lambda rows: jax.ShapeDtypeStruct((rows, npad), jnp.float32)
    args = [jax.ShapeDtypeStruct((), jnp.float32), z(3), z(3), z(3), z(1),
            z(S), z(S), z(ratio * 5), jax.ShapeDtypeStruct((), jnp.float32)]
    extra = {}
    if spec.per_lane_e0:
        extra["e0_lanes"] = z(S)
    if spec.per_lane_om:
        extra["om_lanes"] = z(2)
    names = list(extra)

    def f(first, R, V, F, tp, pre, pim, rolls, tick0, *lanes):
        return fused_md_substeps(spec, first, R, V, F, tp, pre, pim, rolls,
                                 tick0=tick0, block=64,
                                 **dict(zip(names, lanes)))

    exported = jax.export.export(
        jax.jit(f), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args, *extra.values())
    text = exported.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert "fused_tick_block" in text
    assert "num_warps = 2" in text            # block 64 -> 2 warps
