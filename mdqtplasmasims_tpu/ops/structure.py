"""Structural diagnostics: pair correlation g(r) and the longitudinal
current correlation function's Fourier-space current J(k).

References:
  recordPairPairCorr  MonteCarloFollowedByMDAndTempAnisotropy.cpp:584-652
  LCCF / printJ       laserCoolingPlusExpansionMDQTSpeedUp.cpp:1040-1092
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# R.k phases reach ~100 rad at N=3500: a TF32 product (the GPU's default
# for f32 matmuls) would be off by ~0.1 rad, so every product asks for f32
_HIGHEST = jax.lax.Precision.HIGHEST

def pair_correlation(R: jax.Array, L: float, *, dr: float = 0.05,
                     n_bins: int = 400, chunk: int = 512) -> jax.Array:
    """Shell-normalized g(r) histogram, bins of width dr in units of a.

    Reproduces the reference normalization exactly, including its integer
    shell-volume approximation: bin 0 divides by N*(4/3)pi dr^3, bin i by
    N*3*dr^3*i^2 (MonteCarlo...cpp:626-635), and the r < L/2 cap via the
    bin-count limit."""
    n = R.shape[0]
    n_use = int(min(n_bins, np.floor((L / 2.0) / dr)))
    nchunk = -(-n // chunk)
    npad = nchunk * chunk
    Rx, Ry, Rz = R[:, 0], R[:, 1], R[:, 2]

    def pad(v):
        return jnp.pad(v, (0, npad - n), constant_values=jnp.inf).reshape(-1, chunk)

    def row_block(args):
        xi, yi, zi = args
        dx = xi[:, None] - Rx[None, :]
        dy = yi[:, None] - Ry[None, :]
        dz = zi[:, None] - Rz[None, :]
        dx -= L * jnp.round(dx / L)
        dy -= L * jnp.round(dy / L)
        dz -= L * jnp.round(dz / L)
        r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        idx = jnp.floor(r / dr).astype(jnp.int32)
        valid = (r > 0) & (idx < n_use) & jnp.isfinite(r)
        idx = jnp.where(valid, idx, n_use)   # overflow bin, dropped below
        return jnp.bincount(idx.ravel(), length=n_use + 1)[:n_use]

    hist = jnp.sum(jax.lax.map(row_block, (pad(Rx), pad(Ry), pad(Rz))),
                   axis=0).astype(R.dtype)
    i = jnp.arange(n_use, dtype=R.dtype)
    # bin 0: the reference's N*4/3 is C *integer* division (5461 for
    # N=4096, not 5461.33) before the double promotion
    shell = jnp.where(i == 0, float(n * 4 // 3) * jnp.pi * dr ** 3,
                      n * 3.0 * dr ** 3 * i * i)
    g = hist / shell
    return jnp.pad(g, (0, n_bins - n_use))


def k_grid(L: float, lambda_frac: int = 12) -> np.ndarray:
    """[K,3] wavevectors 2*pi*(kx,ky,kz)/L for integer triplets in
    [0, lambda_frac)^3 (laserCooling...SpeedUp.cpp:1046-1058)."""
    ks = np.arange(lambda_frac)
    kx, ky, kz = np.meshgrid(ks, ks, ks, indexing="ij")
    return (2.0 * np.pi / L) * np.stack(
        [kx.ravel(), ky.ravel(), kz.ravel()], axis=-1)


def static_structure_factor(R: jax.Array, kvecs: jax.Array) -> jax.Array:
    """S[k] = |rho(k)|^2 / N with rho(k) = sum_j exp(i k.R_j): the
    density analog of :func:`current_fourier`, one [N,K] complex matmul.

    The reference records g(r) and J(k) but not S(k) (its README stops
    at the output schema); this completes the static structure picture
    on the same integer-k grid as the LCCF (``k_grid``), e.g. for
    locating the correlation-driven first peak at k*a ~ 4.4 in the
    strongly coupled regime.  S(k=0) = N by this definition (the
    forward term); callers drop the zero vector."""
    phase = jnp.matmul(R, kvecs.T, precision=_HIGHEST)   # [N, K]
    e = jnp.exp(1j * phase.astype(
        jnp.complex64 if R.dtype == jnp.float32 else jnp.complex128))
    rho = jnp.sum(e, axis=0)                             # [K]
    return (rho * jnp.conj(rho)).real / R.shape[0]


def current_fourier(R: jax.Array, V: jax.Array, kvecs: jax.Array) -> jax.Array:
    """J[a, k] = sum_j V[a,j] exp(i k.R_j): one [K,N]x[N,3] complex matmul
    (the reference's O(N*12^3) triple loop, SpeedUp.cpp:1060-1065)."""
    phase = jnp.matmul(R, kvecs.T, precision=_HIGHEST)   # [N, K]
    e = jnp.exp(1j * phase.astype(
        jnp.complex64 if R.dtype == jnp.float32 else jnp.complex128))
    return jnp.matmul(V.T.astype(e.dtype), e,
                      precision=_HIGHEST)                # [3, K]
