"""All-pairs Yukawa (screened-Coulomb) force and potential kernels.

The reference computes O(N^2/2) pair forces with an OpenMP loop and a racy
Newton's-third-law scatter (laserCoolingPlusExpansionMDQTSpeedUp.cpp:192-236;
MonteCarloFollowedByMDAndTempAnisotropy.cpp:387-448).  Here the interaction
is evaluated over the *full* N x N tile set (both triangles) so every output
row is an independent reduction — no scatter, no race.  Physics:

    force:      f(r) = (1/r + 1/lDeb) * exp(-r/lDeb) / r^2 * dr_vec
                (laserCooling...SpeedUp.cpp:224; equivalently
                 exp(-kappa r)(1/r^3 + kappa/r^2), MC family calcAIJ :161-169)
    potential:  u(r) = exp(-r/lDeb)/r            (Epotential :268, calcUIJ :155)
    minimum-image convention, half-box cutoff Rcut = L/2, r > 0.

One implementation, plain ``jax.numpy`` left to XLA: a row-chunked
per-axis broadcast-and-reduce, which XLA compiles into reduction fusions
with no [chunk, N] temporaries in memory (f64-able for validation).  The
``*_soa`` wrappers take the [3, Np] planes the cooling family's fused
loop carries, single-member or with the member axis folded into lanes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def yukawa_forces_potential(R: jax.Array, L: float, ldeb: float,
                            mask: Optional[jax.Array] = None,
                            chunk: int = 512,
                            cols: Optional[jax.Array] = None,
                            ) -> Tuple[jax.Array, jax.Array]:
    """Forces [N,3] and per-ion potential sums [N] (pure XLA).

    ``sum(pot)/(2*N)`` equals the reference's Epot per particle.
    ``cols`` optionally supplies a different source set (e.g. the
    all-gathered global positions when ``R`` is an ion shard); ``mask``
    applies to the column/source set.
    """
    n = R.shape[0]
    rcut2 = (L / 2.0) ** 2
    chunk = min(chunk, n)
    npad = _round_up(n, chunk)
    Rc = R if cols is None else cols
    Rx, Ry, Rz = Rc[:, 0], Rc[:, 1], Rc[:, 2]
    mj = mask if mask is not None else None

    def pad(v):
        return jnp.pad(v, (0, npad - n)).reshape(-1, chunk)

    Rrx, Rry, Rrz = R[:, 0], R[:, 1], R[:, 2]

    def row_block(args):
        xi, yi, zi = args
        dx = xi[:, None] - Rx[None, :]
        dy = yi[:, None] - Ry[None, :]
        dz = zi[:, None] - Rz[None, :]
        dx -= L * jnp.round(dx / L)
        dy -= L * jnp.round(dy / L)
        dz -= L * jnp.round(dz / L)
        r2 = dx * dx + dy * dy + dz * dz
        valid = (r2 > 0) & (r2 < rcut2)
        if mj is not None:
            valid = valid & (mj[None, :] > 0)
        r = jnp.sqrt(jnp.where(valid, r2, 1.0))
        expf = jnp.exp(-r / ldeb)
        ft = jnp.where(valid, (1.0 / r + 1.0 / ldeb) * expf / r2, 0.0)
        up = jnp.where(valid, expf / r, 0.0)
        return (jnp.sum(dx * ft, 1), jnp.sum(dy * ft, 1), jnp.sum(dz * ft, 1),
                jnp.sum(up, 1))

    fx, fy, fz, pot = jax.lax.map(row_block, (pad(Rrx), pad(Rry), pad(Rrz)))
    F = jnp.stack([fx.ravel()[:n], fy.ravel()[:n], fz.ravel()[:n]], axis=-1)
    pot = pot.ravel()[:n]
    if mask is not None and cols is None:
        F = F * mask[:, None]
        pot = pot * mask
    return F, pot


def yukawa_forces(R, L, ldeb, mask=None, chunk: int = 512) -> jax.Array:
    return yukawa_forces_potential(R, L, ldeb, mask, chunk)[0]


def yukawa_potential(R, L, ldeb, mask=None, chunk: int = 512) -> jax.Array:
    """Potential energy per particle (scalar), reference Epotential().
    ``mask`` marks which rows exist: it gates both the source set and the
    row sums (padded lanes contribute nothing)."""
    _, pot = yukawa_forces_potential(R, L, ldeb, mask, chunk)
    if mask is None:
        return 0.5 * jnp.sum(pot) / R.shape[0]
    return 0.5 * jnp.sum(pot * mask) / jnp.sum(mask)


def yukawa_forces_soa(Rp: jax.Array, mask_row: jax.Array, L: float,
                      ldeb) -> jax.Array:
    """Forces straight from the lane layout: ``Rp [3, Np]`` (padded, as
    carried by the fused MD loop) and ``mask_row [1, Np]`` marking real
    ions; masked lanes neither act nor feel a force.  Returns
    ``F [3, Np]``."""
    return yukawa_forces_potential(Rp.T, L, ldeb, mask=mask_row[0])[0].T


def yukawa_forces_soa_batched(Rp: jax.Array, mask_rows: jax.Array, e: int,
                              L: float, ldeb) -> jax.Array:
    """Job-batched forces from the *folded* lane layout: ``Rp [3,
    E*npad]`` (job blocks contiguous on the ion axis) and ``mask_rows``
    marking real ions — ``[1, npad]`` shared, or ``[E, npad]`` per job
    (the Poissonian-N ensemble mode, where each member drew its own count
    as in reference init, SpeedUp.cpp:289-348).  Members run one after
    another through the same per-member program (``lax.map``), so no pair
    crosses a member boundary and a member's forces do not depend on how
    many members share the call — the fold's layout invariance across
    devices.  Returns ``F [3, E*npad]``."""
    npad = Rp.shape[1] // e
    R3 = jnp.swapaxes(Rp.reshape(3, e, npad), 0, 1)        # [E, 3, npad]
    m = jnp.broadcast_to(mask_rows, (e, npad))[:, None, :]
    F = jax.lax.map(lambda a: yukawa_forces_soa(a[0], a[1], L, ldeb),
                    (R3, m))
    return jnp.swapaxes(F, 0, 1).reshape(3, e * npad)


def yukawa_forces_soa_cols_batched(Rp: jax.Array, cols: jax.Array,
                                   col_mask: jax.Array, row_mask: jax.Array,
                                   e: int, L: float, ldeb) -> jax.Array:
    """Row forces from the folded lane layout against an explicit source
    set — the ion-sharded "gather" schedule: ``Rp [3, E*npad]`` local
    ion-shard rows (job blocks contiguous), ``cols [E, ncols, 3]`` the
    source positions (the all-gathered global ions of each job),
    ``col_mask [E, ncols]`` and ``row_mask [E, npad]`` marking real
    ions.  Both ordered halves of every pair are evaluated (the reaction
    half lives on another shard).  Members run one after another, as in
    :func:`yukawa_forces_soa_batched`.  Returns ``F [3, E*npad]``, zero
    on masked rows."""
    npad = Rp.shape[1] // e
    R_rows = jnp.swapaxes(Rp.reshape(3, e, npad), 0, 2)   # [npad, E, 3]
    R_rows = jnp.swapaxes(R_rows, 0, 1)                    # [E, npad, 3]
    F = jax.lax.map(lambda a: yukawa_forces_potential(
        a[0], L, ldeb, mask=a[2], cols=a[1])[0], (R_rows, cols, col_mask))
    F = F * row_mask[:, :, None]
    return jnp.swapaxes(jnp.swapaxes(F, 0, 1), 0, 2).reshape(3, e * npad)


def best_forces_fn(n: int, L: float, ldeb, mask=None):
    """Return a ``R -> (F, pot_per_ion)`` callable for the current
    platform.  Every route (routing.kernel_route) computes pair forces on
    the XLA path; the call still goes through the selector so that an
    unsupported platform fails here, at build time.  ``ldeb`` may be a
    traced jax scalar (per-member kappa sweeps)."""
    from ..routing import kernel_route
    kernel_route()
    return lambda R: yukawa_forces_potential(R, L, ldeb, mask)
