"""Preconditioned conjugate gradients, jit-compiled.

Replaces Trilinos ``SolverCG`` + ``ReductionControl(10000, 1e-12, 1e-6)``
(reference WaveTheta.cpp:288-293, WaveNewmark.cpp:256-261): the stopping
rule is ||r||_2 <= max(abs_tol, reduction * ||r0||_2), iteration cap 10000,
warm-started from the previous solution, and the performed-iteration count
is returned for iterations.csv parity.

The loop body is a ``lax.while_loop`` — one fused XLA computation per CG
iteration (SpMV + 2 dot products + axpys), with global reductions lowering
to ``psum`` when the operand arrays are sharded over a device mesh.

Preconditioning: Jacobi (inverse assembled diagonal). The reference uses ML
AMG for the time-step systems and SSOR for the one-time a0 mass solve;
AMG's irregular coarsening does not map onto dense arrays, and for the
mass-dominated, well-conditioned wave-equation systems Jacobi-CG converges
robustly — parity is solution accuracy (the tolerance is relative), not
iteration counts (SURVEY.md section 2.1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["pcg", "CgResult"]


class CgResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array   # int32, number of CG iterations performed
    residual_norm: jax.Array
    converged: jax.Array    # bool: residual target met within max_iter


def pcg(apply_a: Callable, b, x0, *, precond_inv_diag=None,
        max_iter: int = 10000, abs_tol: float = 1e-12,
        reduction: float = 1e-6, r0=None, norm0_sq=None) -> CgResult:
    """Solve A x = b with (Jacobi-)preconditioned CG.

    ``precond_inv_diag``: elementwise inverse-diagonal array (Jacobi), a
    callable SPD preconditioner (e.g. solve/chebyshev.py), or None.

    ``r0``/``norm0_sq``: optional precomputed initial residual
    ``b - A x0`` and its squared norm (e.g. the displacement-form
    setup, models/fast.py::run_implicit_mg_2term); skip the extra
    operator application / full-plane reduction here.
    """
    dtype = b.dtype

    if precond_inv_diag is None:
        def precond(r):
            return r
    elif callable(precond_inv_diag):
        precond = precond_inv_diag
    else:
        def precond(r):
            return precond_inv_diag * r

    if r0 is None:
        r0 = b - apply_a(x0)
    norm0 = (jnp.linalg.norm(r0) if norm0_sq is None
             else jnp.sqrt(norm0_sq).astype(dtype))
    tol = jnp.maximum(jnp.asarray(abs_tol, dtype), reduction * norm0)

    z0 = precond(r0)
    rz0 = jnp.vdot(r0, z0)

    def cond(state):
        x, r, z, p, rz, rnorm, k = state
        return jnp.logical_and(rnorm > tol, k < max_iter)

    def body(state):
        x, r, z, p, rz, rnorm, k = state
        ap = apply_a(p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, jnp.linalg.norm(r), k + 1)

    init = (x0, r0, z0, z0, rz0, norm0, jnp.asarray(0, jnp.int32))
    x, r, z, p, rz, rnorm, k = jax.lax.while_loop(cond, body, init)
    return CgResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=rnorm <= tol)
