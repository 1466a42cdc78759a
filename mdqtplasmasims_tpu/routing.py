"""Kernel selection by platform: the one place that maps a JAX backend to
the code path every experiment family runs.

* ``"gpu"`` -> ``TRITON``: the fused tick-block kernel (core/qt_fused.py,
  Pallas through Triton) for the cooling family's quantum substeps, pair
  forces as plain XLA (ops/yukawa.py);
* ``"cpu"`` -> ``XLA``: the plain per-tick XLA path everywhere;
* any other platform raises.

Interpret mode is never chosen here: a caller that wants the kernel in
the Pallas interpreter asks for it by name (``CoolingConfig.
fused_interpret``), as the CPU tests and the multi-device dry run do.
"""

from __future__ import annotations

from typing import Optional

import jax

TRITON = "triton"
XLA = "xla"

_ROUTES = {"gpu": TRITON, "cpu": XLA}


def kernel_route(platform: Optional[str] = None) -> str:
    """``TRITON`` or ``XLA`` for ``platform`` (default: JAX's default
    backend).  Raises ``RuntimeError`` on a platform with no route."""
    platform = jax.default_backend() if platform is None else platform
    try:
        return _ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"no kernel route for platform {platform!r}; supported: "
            f"{sorted(_ROUTES)}") from None
