"""Test harness config.

Must run before ANY jax import: selects the CPU backend unless the caller
chose a platform (``JAX_PLATFORMS=cuda`` runs the ``gpu``-marked tests on a
card), sets an 8-way virtual device mesh for sharding tests ("multi-node
without a cluster", SURVEY.md section 4), and enables f64 parity mode.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# no persistent compile cache under test: the CLI turns it on, and shared
# cache files across xdist workers and CPU feature sets only add noise
jax.config.update("jax_enable_compilation_cache", False)

from tpuwave import config  # noqa: E402

config.use_x64()

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release each module's compiled executables when it finishes.

    The suite holds ~460 JAX-heavy tests on an 8-virtual-device CPU
    backend; without this, compile-cache/arena memory accumulates across
    modules until an XLA `backend_compile_and_load` near the end of the
    run segfaults the process (reproduced twice in round 4 at
    test_tdep_c.py::test_tdep_unstructured_chebyshev_sharded, once in
    round 3). Clearing per module keeps the high-water mark at the
    largest single module instead of the sum of all of them; cross-module
    jit reuse is rare, so the retrace cost is noise."""
    yield
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips otherwise. Decided
    here, at test time, never at import (every xdist worker must collect
    the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform here: {dev.platform}); "
                    "run with JAX_PLATFORMS=cuda on a card")
    return dev


@pytest.fixture(scope="session")
def parameters_dir():
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent / "parameters"
    if not root.exists():
        pytest.skip("parameters/ not generated (run scripts/generate_presets.py)")
    return root
