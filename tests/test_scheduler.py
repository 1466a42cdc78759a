"""Multirate scheduler unit tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.core.md import (leapfrog_substep,
                                        velocity_verlet_step, wrap_pbc)
from mdqtplasmasims_tpu.core.qt import QTEngine
from mdqtplasmasims_tpu.core.scheduler import (CoolingScheduler,
                                               FrozenTagScheduler,
                                               MCTagScheduler)
from mdqtplasmasims_tpu.levels import tag422, three_state
from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential
from mdqtplasmasims_tpu.state import make_state
from mdqtplasmasims_tpu.units import PlasmaUnits


@pytest.fixture
def system():
    n = 64
    L = PlasmaUnits.box_length(n)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    key = jax.random.PRNGKey(0)
    R = jax.random.uniform(key, (n, 3), jnp.float64, 0, L)
    V = jax.random.normal(jax.random.PRNGKey(1), (n, 3), jnp.float64) * 0.1
    return n, L, ldeb, R, V


def _forces(L, ldeb):
    return lambda R: yukawa_forces_potential(R, L, ldeb)


class TestSubsteppedLeapfrog:
    def test_substeps_close_to_single_step(self, system):
        """The SpeedUp scheme parcels one MD step into ratio substeps with
        the same forces; positions/velocities must stay O(dt^2)-close to
        the single big leapfrog step."""
        n, L, ldeb, R, V = system
        F = _forces(L, ldeb)(R)[0]
        dt = 0.002
        ratio = 25
        R1, V1 = leapfrog_substep(R, V, F, dt, L, False)
        Rs, Vs = R, V
        for _ in range(ratio):
            Rs, Vs = leapfrog_substep(Rs, Vs, F, dt / ratio, L, False)
        # identical total impulse; drift pattern differs at O(dt^2)
        assert np.allclose(np.asarray(V1), np.asarray(Vs), atol=1e-14)
        assert np.abs(np.asarray(R1) - np.asarray(Rs)).max() < dt * dt

    def test_wrap_pbc_single_shift(self):
        R = jnp.asarray([[-0.1, 5.0, 10.2]])
        out = np.asarray(wrap_pbc(R, 10.0))
        assert np.allclose(out, [[9.9, 5.0, 0.2]])


class TestVelocityVerlet:
    def test_energy_conservation(self, system):
        n, L, ldeb, R, V = system
        fn = lambda r: yukawa_forces_potential(r, L, ldeb)[0]
        A = fn(R)
        dt = 0.005

        @jax.jit
        def go(R, V, A):
            def body(c, _):
                R, V, A = c
                R, V, A = velocity_verlet_step(R, V, A, dt, L, fn)
                return (R, V, A), None
            return jax.lax.scan(body, (R, V, A), None, length=400)[0]

        from mdqtplasmasims_tpu.ops.yukawa import yukawa_potential
        e0 = float(yukawa_potential(R, L, ldeb)) + float(
            jnp.mean(0.5 * jnp.sum(V * V, 1)))
        R2, V2, _ = go(R, V, A)
        e1 = float(yukawa_potential(R2, L, ldeb)) + float(
            jnp.mean(0.5 * jnp.sum(V2 * V2, 1)))
        assert abs(e1 - e0) < 2e-3 * abs(e0)


class TestSchedulers:
    def test_cooling_scheduler_advances_clock(self, system):
        n, L, ldeb, R, V = system
        eng = QTEngine(tag422(), h=0.01, dt_plasma=8e-5, apply_force=False)
        sched = CoolingScheduler(engine=eng, forces_fn=_forces(L, ldeb),
                                 L=L, qdt=8e-5, ratio=5)
        psi = jnp.zeros((n, 5), jnp.complex128).at[:, 0].set(1.0)
        st = make_state(R, V, psi, jax.random.PRNGKey(2), dtype=jnp.float64)
        out = jax.jit(sched.md_step)(st)
        assert int(out.tick) == 5
        assert float(out.t) == pytest.approx(5 * 8e-5)
        assert not np.allclose(np.asarray(out.R), np.asarray(st.R))

    def test_frozen_scheduler_outside_window_is_pure_md(self, system):
        """Outside the pump window, psi and t_part must be untouched and
        the classical system must advance exactly as plain MD."""
        n, L, ldeb, R, V = system
        eng = QTEngine(tag422(), h=0.01, dt_plasma=8e-5, apply_force=False)
        sched = FrozenTagScheduler(engine=eng, forces_fn=_forces(L, ldeb),
                                   L=L, qdt=8e-5, ratio=5,
                                   t_pump_start=100.0, t_pump_end=101.0)
        psi = jnp.zeros((n, 5), jnp.complex128).at[:, 0].set(1.0)
        st = make_state(R, V, psi, jax.random.PRNGKey(3), dtype=jnp.float64)
        st = st._replace(F=_forces(L, ldeb)(R)[0],
                         tick=jnp.asarray(1000, jnp.int32))
        out = jax.jit(sched.md_step)(st)
        np.testing.assert_array_equal(np.asarray(out.psi), np.asarray(st.psi))
        np.testing.assert_array_equal(np.asarray(out.t_part),
                                      np.asarray(st.t_part))
        assert not np.allclose(np.asarray(out.V), np.asarray(st.V))

    def test_mc_tag_scheduler_counts(self, system):
        n, L, ldeb, R, V = system
        eng = QTEngine(tag422(), h=0.01, dt_plasma=0.00025,
                       apply_force=False)
        sched = MCTagScheduler(engine=eng, forces_fn=_forces(L, ldeb),
                               L=L, dt=0.005, ratio=20)
        psi = jnp.zeros((n, 5), jnp.complex128).at[:, 1].set(1.0)
        st = make_state(R, V, psi, jax.random.PRNGKey(4), dtype=jnp.float64)
        st = st._replace(F=_forces(L, ldeb)(R)[0])
        out = jax.jit(sched.md_step)(st)
        assert int(out.tick) == 20
        assert float(out.t) == pytest.approx(0.005)
        # pumping ran: some amplitude moved out of |2>
        assert float(jnp.sum(jnp.abs(out.psi[:, 1]) ** 2)) < n


def test_frozen_pure_step_matches_windowed_outside_window():
    """Outside the pump window the gated md_step does no quantum work, so
    md_step_pure (no tick scan) must produce identical R/V/F/tick and
    leave psi/t_part untouched."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mdqtplasmasims_tpu.core.qt import QTEngine, random_s_superposition
    from mdqtplasmasims_tpu.core.scheduler import FrozenTagScheduler
    from mdqtplasmasims_tpu.levels import tag422
    from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential
    from mdqtplasmasims_tpu.state import make_state
    from mdqtplasmasims_tpu.units import PlasmaUnits

    n, ratio, qdt = 32, 5, 4e-4
    L = PlasmaUnits.box_length(n)
    ldeb = PlasmaUnits(2.0, 0.1).debye_length
    engine = QTEngine(tag422(), h=qdt * 110.0, dt_plasma=qdt,
                      plas_to_quant_vel=1.28, gamma_to_einstein=110.0,
                      apply_force=False)
    sched = FrozenTagScheduler(
        engine=engine,
        forces_fn=lambda R: yukawa_forces_potential(R, L, ldeb),
        L=L, qdt=qdt, ratio=ratio, t_pump_start=100.0, t_pump_end=101.0)

    key = jax.random.PRNGKey(5)
    kr, kv, kp, kk = jax.random.split(key, 4)
    R = jax.random.uniform(kr, (n, 3), jnp.float64, 0, L)
    V = jax.random.normal(kv, (n, 3), jnp.float64) * 0.2
    psi = random_s_superposition(kp, n, 5, jnp.complex128)
    st = make_state(R, V, psi, kk, dtype=jnp.float64)
    st = st._replace(F=sched.forces_fn(R)[0],
                     tick=jnp.asarray(40, jnp.int32))  # far from window

    a = sched.md_step(st)
    b = sched.md_step_pure(st)
    for name in ("R", "V", "F"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert int(a.tick) == int(b.tick)
    np.testing.assert_array_equal(np.asarray(b.psi), np.asarray(st.psi))
    np.testing.assert_array_equal(np.asarray(a.psi), np.asarray(st.psi))


def test_expansion_detuning():
    """The expanding-frame detuning — the reference's 'PlusExpansion'
    feature (SpeedUp.cpp:447,506-510).  The two independent
    transcriptions (units.expansion_detuning and laser_cooling.
    expansion_detuning_fn) must agree, the curve must have the
    reference's shape (0 at t=0, asymptotically linear-over-sqrt
    saturating slope), and enabling frac_of_sig must change the QT
    dynamics through the scheduler."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, build_scheduler, expansion_detuning_fn, initial_state)
    from mdqtplasmasims_tpu.units import expansion_detuning

    cfg = CoolingConfig(n0=48, frac_of_sig=1.0, sig0=0.04, te=19.0,
                        dtype="float64")
    f = expansion_detuning_fn(cfg)
    for t in (0.0, 1.0, 7.5, 30.0, 120.0):
        a = float(f(t))
        b = expansion_detuning(t, cfg.density, cfg.sig0, cfg.te,
                               cfg.frac_of_sig)
        np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f"t={t}")
    assert float(f(0.0)) == 0.0
    assert float(f(30.0)) > float(f(1.0)) > 0.0

    # scheduler wiring: same state stepped with/without expansion detuning
    # must diverge in the wavefunctions (the detuning shifts every laser)
    sched_on = build_scheduler(cfg)
    assert sched_on.exp_det_fn is not None
    sched_off = build_scheduler(CoolingConfig(
        n0=48, frac_of_sig=0.0, dtype="float64"))
    st = initial_state(cfg)
    st = st._replace(tick=jnp.asarray(5000, jnp.int32),
                     t=jnp.asarray(5000 * cfg.qdt, jnp.float64))
    a = sched_on.md_step(st)
    b = sched_off.md_step(st)
    assert not np.array_equal(np.asarray(a.psi), np.asarray(b.psi))
