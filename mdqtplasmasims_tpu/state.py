"""Simulation state pytree.

The reference keeps global SoA arrays R/V/F plus per-ion Armadillo
wavefunctions (laserCoolingPlusExpansionMDQTSpeedUp.cpp:126-152).  Here the
whole system state is one immutable pytree threaded through pure step
functions and ``lax.scan`` loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SimState(NamedTuple):
    """Complete MDQT system state.

    Shapes: ``R, V, F`` are ``[N, 3]``; ``psi`` is ``[N, S]`` complex (absent
    for pure-MD runs as a ``[N, 0]`` array); ``t_part`` is the per-ion clock
    since the last quantum jump in plasma time units
    (laserCoolingPlusExpansionMDQTSpeedUp.cpp:152); ``tick`` counts quantum
    timesteps since t=0 (the source of truth for simulation time).
    """

    R: jax.Array            # [N,3] positions, units of a
    V: jax.Array            # [N,3] velocities, units of a*omega_E
    F: jax.Array            # [N,3] forces (per unit mass)
    psi: jax.Array          # [N,S] complex wavefunctions
    t_part: jax.Array       # [N] per-ion time since last jump (plasma units)
    key: jax.Array          # PRNG key
    tick: jax.Array         # int32/int64 quantum-tick counter
    t: jax.Array            # float simulation time (plasma units)

    @property
    def n_ions(self) -> int:
        return self.R.shape[0]


def make_state(R, V, psi=None, key=None, *, t=0.0,
               dtype=jnp.float32) -> SimState:
    R = jnp.asarray(R, dtype)
    V = jnp.asarray(V, dtype)
    n = R.shape[0]
    cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    if psi is None:
        psi = jnp.zeros((n, 0), cdtype)
    else:
        psi = jnp.asarray(psi, cdtype)
    if key is None:
        key = jax.random.PRNGKey(0)
    return SimState(
        R=R, V=V, F=jnp.zeros_like(R), psi=psi,
        t_part=jnp.zeros((n,), dtype), key=key,
        tick=jnp.zeros((), jnp.int32), t=jnp.asarray(t, dtype),
    )
