"""Test configuration: force CPU with 8 virtual devices and 64-bit mode.

The suite runs on the CPU backend (f64-capable) with a virtual 8-device
mesh for the sharding tests; Pallas kernels run in the interpreter.  A
test that needs the GPU itself carries the ``gpu`` marker and skips
unless JAX finds one; the on-card checks live in ``chip_smoke.py``.
"""

import os

# 8 virtual devices for the sharding tests; and keep XLA from inlining
# one-trip loops (a one-program kernel grid, a one-member lax.map), which
# compiles them differently from longer loops and moves f32 results by
# an ulp — the layout-invariance tests compare folds bit for bit
for _FLAG in ("--xla_force_host_platform_device_count=8",
              "--xla_disable_hlo_passes=simplify-while-loops"):
    if _FLAG not in os.environ.get("XLA_FLAGS", ""):
        # append rather than setdefault: a pre-set XLA_FLAGS (container/
        # CI) must not silently disable these
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   + _FLAG).strip()

import jax  # noqa: E402

# tests compare against the CPU's f64 path whatever JAX_PLATFORMS says
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")
    config.addinivalue_line(
        "markers", "slow: long-running test (skipped by the default "
        "fast tier; run with -m full)")
    config.addinivalue_line(
        "markers", "full: every test (so `pytest -m full` overrides the "
        "default `-m 'not slow'` and runs the whole suite)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX has no GPU — decided here, per
    test, never while a module is imported."""
    if request.node.get_closest_marker("gpu") is not None:
        try:
            has_gpu = bool(jax.devices("gpu"))
        except RuntimeError:
            has_gpu = False
        if not has_gpu:
            pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on one)")


def _slow_nodeids():
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            return {line.strip() for line in f
                    if line.strip() and not line.startswith("#")}
    except FileNotFoundError:
        return set()


def pytest_collection_modifyitems(config, items):
    slow_ids = _slow_nodeids()
    for item in items:
        # tier the suite: measured-slow tests (tests/slow_tests.txt) are
        # deselected by the default addopts -m 'not slow'; `-m full`
        # selects everything since every item carries `full`
        if item.nodeid in slow_ids:
            item.add_marker(pytest.mark.slow)
        item.add_marker(pytest.mark.full)
