"""Gaussian-KDE velocity distributions.

The reference accumulates, for every output, a 2001/4001-bin Gaussian kernel
sum over all ions (laserCoolingPlusExpansionMDQTSpeedUp.cpp:957-979;
randomFrozenStartTag422Linear.cpp:800-853).  Here it is a single [B, N]
broadcast-and-reduce.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

KDE_WIDTH = 0.002          # gaussian width (both families)
KDE_NORM = 6.0 * np.sqrt(2.0 * np.pi * KDE_WIDTH * KDE_WIDTH)


def folded_bins_np():
    """Host (float64) copy of :func:`folded_bins` for the .dat writers."""
    return np.arange(2001) * 0.0025


def centered_bins_np():
    """Host (float64) copy of :func:`centered_bins` for the .dat writers."""
    return (np.arange(4001) - 2000) * 0.0025


def folded_bins(dtype=jnp.float32) -> jax.Array:
    """2001 bins at 0.0025 spacing over [0, 5]
    (laserCooling...SpeedUp.cpp:340-344)."""
    return jnp.arange(2001, dtype=dtype) * 0.0025


def centered_bins(dtype=jnp.float32) -> jax.Array:
    """4001 bins over [-5, 5] (randomFrozenStartTag422Linear.cpp:295-299)."""
    return (jnp.arange(4001, dtype=dtype) - 2000) * 0.0025


def gaussian_kde(v: jax.Array, bins: jax.Array, *, folded: bool,
                 weights: Optional[jax.Array] = None,
                 width: float = KDE_WIDTH, normalize: bool = True) -> jax.Array:
    """KDE of velocities ``v`` [N] onto ``bins`` [B].

    ``folded=True`` reproduces the cooling code's symmetrized form
    ``exp(-(b-v)^2/2w^2) + exp(-(b+v)^2/2w^2)`` over non-negative bins
    (laserCooling...SpeedUp.cpp:969); ``folded=False`` is the plain kernel
    used with centered bins.  ``weights`` masks/weights ions (e.g. spin-up
    subsets).  The reference normalization 1/(6*sqrt(2*pi*w^2)) is applied
    when ``normalize``.
    """
    inv2w2 = 1.0 / (2.0 * width * width)
    d = bins[:, None] - v[None, :]
    k = jnp.exp(-inv2w2 * d * d)
    if folded:
        s = bins[:, None] + v[None, :]
        k = k + jnp.exp(-inv2w2 * s * s)
    if weights is not None:
        k = k * weights[None, :]
    out = jnp.sum(k, axis=1)
    if normalize:
        out = out / (6.0 * np.sqrt(2.0 * np.pi) * width)
    return out
