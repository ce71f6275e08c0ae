"""Chebyshev preconditioning — the array-friendly AMG stand-in.

The reference wraps CG in ML-AMG (WaveTheta.cpp:276-286). AMG's irregular
coarse grids do not map onto dense arrays; for the theta u-system
(M + (theta dt)^2 K), which becomes stiffness-dominated at large
theta*dt/h, a fixed-degree Chebyshev polynomial in the Jacobi-preconditioned
operator captures most of AMG's smoothing benefit while staying a pure
sequence of operator applications (batched stencils/contractions) — no
setup graph, no data-dependent control flow, fully jit/shard-compatible.

``ChebyshevPreconditioner(apply_a, diag)`` targets the spectrum
[lambda_max / eig_ratio, lambda_max] of D^{-1}A, with lambda_max estimated
by power iteration at setup (deal.II's PreconditionChebyshev does the
same). Degree 0 degenerates to plain Jacobi.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["estimate_lambda_max", "ChebyshevPreconditioner",
           "chebyshev_apply"]


def chebyshev_apply(apply_a: Callable, inv_diag, r, *, lambda_max,
                    eig_ratio: float = 30.0, degree: int = 4):
    """One Chebyshev preconditioner application z ~= (D^-1 A)^-1 D^-1 r.

    Functional form of :class:`ChebyshevPreconditioner`: ``lambda_max``
    may be a TRACED scalar (jnp), so the spectrum bounds can change per
    step — required for `Time Dependent C`, where A = M + s K(t) is
    rebuilt inside the scan and a Gershgorin bound
    (``MatrixFreeOperator.abs_row_sums() / diag``) supplies lambda_max.
    """
    if degree <= 0:
        return inv_diag * r
    lmax = lambda_max
    lmin = lmax / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    z = (1.0 / theta) * (inv_diag * r)
    if degree == 1:
        return z
    rho = delta / theta
    p = z
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * theta / delta - rho)
        resid = inv_diag * (r - apply_a(z))
        p = (2.0 * rho_new / delta) * resid + (rho_new * rho) * p
        z = z + p
        rho = rho_new
    return z


def estimate_lambda_max(apply_a: Callable, inv_diag, n: int, *,
                        iters: int = 25, seed: int = 0) -> float:
    """Largest eigenvalue of D^{-1} A by power iteration (returns a float,
    slightly inflated for safety like deal.II's 1.2 factor)."""
    key = jax.random.PRNGKey(seed)
    v = jax.random.normal(key, (n,), dtype=inv_diag.dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = inv_diag * apply_a(v)
        return w / jnp.linalg.norm(w)

    v = jax.lax.fori_loop(0, iters, body, v)
    w = inv_diag * apply_a(v)
    lam = jnp.vdot(v, w) / jnp.vdot(v, v)
    return float(lam) * 1.2


class ChebyshevPreconditioner:
    """z = P(r): fixed ``degree`` Chebyshev iteration on D^{-1}A r = z.

    Symmetric and positive for SPD A (valid CG preconditioner). All state
    is a handful of scalars; application is ``degree`` operator applies.
    """

    def __init__(self, apply_a: Callable, diag, *, lambda_max: float,
                 eig_ratio: float = 30.0, degree: int = 4):
        self.apply_a = apply_a
        self.inv_diag = 1.0 / diag
        self.degree = int(degree)
        self.lmax = float(lambda_max)
        self.lmin = self.lmax / float(eig_ratio)
        self.theta = 0.5 * (self.lmax + self.lmin)
        self.delta = 0.5 * (self.lmax - self.lmin)

    def __call__(self, r):
        return chebyshev_apply(self.apply_a, self.inv_diag, r,
                               lambda_max=self.lmax,
                               eig_ratio=self.lmax / self.lmin,
                               degree=self.degree)
