"""Global numeric and compilation configuration.

The reference solver (deal.II) is double precision throughout; parity runs
therefore enable JAX x64. The performance paths (lumped-mass explicit
Newmark, stencil operators) are written dtype-generically, so the same code
runs f64 (the CLI default) or f32 (``--f32``).

Every ``jnp.einsum`` in the package asks for ``precision="highest"``: on a
GPU an f32 contraction may otherwise run in TF32 (about three decimal
digits), which would put the f32 paths' tolerances, stated against f32
rounding, out of reach.

Call :func:`use_x64` before building any arrays for parity runs; the CLI
entry points and the pytest suite do this automatically.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

_X64_ENABLED = False


def use_x64(enable: bool = True) -> None:
    """Enable (or disable) 64-bit floats/ints in JAX. Idempotent."""
    global _X64_ENABLED
    jax.config.update("jax_enable_x64", bool(enable))
    _X64_ENABLED = bool(enable)


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def default_float():
    """The dtype parity code should use (f64 when x64 is on, else f32)."""
    return jnp.float64 if x64_enabled() else jnp.float32


def env_flag_enabled(name: str, default_value: bool) -> bool:
    """Read a boolean env flag with the reference's exact semantics.

    Mirrors the anonymous helper in the reference base class
    (src/WaveEquationBase.cpp:22-33): only the literal strings
    "0"/"false"/"FALSE"/"False" and "1"/"true"/"TRUE"/"True" are
    recognised; anything else returns the default.
    """
    v = os.environ.get(name)
    if v is None:
        return default_value
    if v in ("0", "false", "FALSE", "False"):
        return False
    if v in ("1", "true", "TRUE", "True"):
        return True
    return default_value


#: the checkout root (the directory holding the ``tpuwave`` package)
CHECKOUT_ROOT = Path(__file__).resolve().parent.parent


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory and
    return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing else is set
    (JAX reads it itself). Otherwise the cache lives at
    ``<checkout>/.jax_cache``: a fixed path, because the directory is part
    of every cache key and a moving directory never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
