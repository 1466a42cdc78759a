"""Kernel selection by platform (routing.kernel_route) and the f32
precision requested at every matmul site that runs on the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu import routing
from mdqtplasmasims_tpu.experiments.laser_cooling import (
    CoolingConfig, build_scheduler)
from mdqtplasmasims_tpu.ops.yukawa import best_forces_fn


@pytest.fixture
def platform(monkeypatch):
    """Patch JAX's default backend name seen by the selector."""
    def set_platform(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_platform


@pytest.mark.parametrize("name,route", [("gpu", routing.TRITON),
                                        ("cpu", routing.XLA)])
def test_kernel_route(platform, name, route):
    platform(name)
    assert routing.kernel_route() == route
    assert routing.kernel_route(name) == route


@pytest.mark.parametrize("name", ["neuron", "METAL"])
def test_unknown_platform_raises(platform, name):
    platform(name)
    with pytest.raises(RuntimeError, match="no kernel route"):
        routing.kernel_route()


def test_best_forces_fn_raises_on_unknown_platform(platform):
    platform("neuron")
    with pytest.raises(RuntimeError, match="no kernel route"):
        best_forces_fn(16, 10.0, 1.0)


@pytest.mark.parametrize("name,fused", [("gpu", True), ("cpu", False)])
def test_cooling_scheduler_choice(platform, name, fused):
    """gpu -> the fused tick kernel (never in the interpreter unless asked
    for); cpu -> the plain XLA per-tick path."""
    platform(name)
    sched = build_scheduler(CoolingConfig(n0=64))
    assert (sched.fused_spec is not None) == fused
    assert sched.interpret is False
    # fused=False keeps the XLA path on the GPU route too; f64 always does
    assert build_scheduler(CoolingConfig(n0=64, fused=False)).fused_spec \
        is None
    assert build_scheduler(CoolingConfig(n0=64, dtype="float64")) \
        .fused_spec is None


def _dot_precisions(fn, *args):
    """Precision of every dot_general in the jaxpr of ``fn(*args)``."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _highest(p):
    return p is not None and all(
        x == jax.lax.Precision.HIGHEST for x in
        (p if isinstance(p, tuple) else (p,)))


def _qt_step_args():
    from mdqtplasmasims_tpu.core.qt import QTEngine, random_s_superposition
    from mdqtplasmasims_tpu.levels import sr12_cooling, with_recoil
    eng = QTEngine(with_recoil(sr12_cooling(), 9e-4, 3e-4), h=0.01,
                   dt_plasma=8e-5, plas_to_quant_vel=1.3,
                   gamma_to_einstein=123.0)
    n = 8
    psi = random_s_superposition(jax.random.PRNGKey(0), n, 12).T
    rolls = jnp.full((5, n), 0.5, jnp.float32)
    return eng, psi, jnp.zeros((n,), jnp.float32), rolls


def test_qt_coupling_matmul_highest():
    """H·psi (core/qt.py _hpsi_sm) asks for f32, not TF32."""
    eng, psi, v, rolls = _qt_step_args()
    from mdqtplasmasims_tpu.core.qt import _params
    params = _params(eng.scheme, jnp.float32, jnp.complex64)
    p = _dot_precisions(lambda ps: eng._hpsi_sm(params, ps, v, v), psi)
    assert p and all(_highest(x) for x in p), p


def test_qt_jump_table_matmuls_highest():
    """The whole tick (coupling + jump-table one-hot products)."""
    eng, psi, v, rolls = _qt_step_args()
    p = _dot_precisions(lambda ps: eng.step_sm(ps, v, v, rolls=rolls),
                        psi)
    # 4 RK stages x H·psi + the two destination-table products
    assert len(p) >= 6 and all(_highest(x) for x in p), p


@pytest.mark.parametrize("which", ["structure_factor", "current_fourier"])
def test_structure_phase_matmuls_highest(which):
    """R·k phases reach ~100 rad at N=3500; TF32 would be ~0.1 rad off."""
    from mdqtplasmasims_tpu.ops import structure
    R = jnp.asarray(np.random.default_rng(0).uniform(0, 5, (16, 3)),
                    jnp.float32)
    k = jnp.asarray(structure.k_grid(5.0, 3), jnp.float32)
    if which == "structure_factor":
        p = _dot_precisions(structure.static_structure_factor, R, k)
    else:
        p = _dot_precisions(structure.current_fourier, R, R, k)
    assert p and all(_highest(x) for x in p), p
