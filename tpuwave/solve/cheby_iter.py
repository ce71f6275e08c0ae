"""Chebyshev ITERATION as the linear solver for the implicit fast path.

The reference solves every implicit system with AMG-CG (WaveTheta.cpp:
288-293, WaveNewmark.cpp:256-261). CG's two dot products per iteration
are global synchronisation points: they force one memory round-trip
per operator apply and (sharded) one psum latency per iteration, so CG
iterations cannot be fused.

For the wave-equation systems `M + c*K` (mass-dominated, condition number
a small constant independent of h at wave-stable dt), Chebyshev iteration
is the reduction-free alternative:

  * the iteration coefficients are DATA-INDEPENDENT scalars computable on
    the host from eigenvalue bounds -> no dot products, no global
    reductions, no dependency stalls;
  * k iterations therefore need no global reduction between them, so a
    block of k iterations can in principle run as one temporally blocked
    pass with a k-row halo (memory traffic ~ 4/k arrays per iteration
    instead of CG's ~10);
  * the eigenvalue bounds are ANALYTIC: the fast-path operators are
    constant 9-point stencils, whose Dirichlet matrix is a principal
    submatrix of the circulant on the torus, so its spectrum lies inside
    the range of the stencil SYMBOL  lam(theta) = sum_d s_d cos(d.theta)
    (eigenvalue interlacing) — no power iteration needed.

The solve still honours the reference's ReductionControl contract
(||r|| <= max(abs_tol, reduction*||r0||), SURVEY.md section 2.1): blocks of
``degree`` iterations run between residual-norm checks in a
``lax.while_loop``. Restarting the coefficient schedule each block costs
a factor <= 2 in residual per block vs the un-restarted sequence — at the
per-block contraction rates here (T_k(sigma) >> 1) that is a fraction of
one extra iteration — and makes every block identical, so the schedule
is a set of compile-time constants.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.solve.cg import CgResult

__all__ = ["stencil_symbol_bounds", "chebyshev_coefficients",
           "chebyshev_block", "chebyshev_solve"]


def stencil_symbol_bounds(stencil, n: int = 512,
                          pad_rel: float = 1e-3) -> Tuple[float, float]:
    """Spectrum bounds of a constant-stencil operator from its symbol.

    ``stencil``: (3, 3) coefficients, s[1+dj][1+di] = coupling to the
    neighbour at offset (di, dj); must be symmetric (s_d == s_{-d}), which
    holds for every FEM operator here. The Dirichlet (interior) matrix is
    a principal submatrix of the circulant whose eigenvalues are the
    symbol values, so its spectrum lies in [min lam, max lam]; pinned rows
    contribute exactly the diagonal s[1][1] = the symbol mean, inside the
    range. The symbol is a degree-1 trig polynomial per axis — a 512^2
    sample plus a relative pad far over-resolves its extrema.

    Hot-path users pass the stencil as a (hashable) tuple-of-tuples and
    hit the memo — this runs every time a step function is (re)traced,
    so it must not redo the host-side sweep per call.
    """
    if isinstance(stencil, tuple):
        return _symbol_bounds_cached(stencil, n, pad_rel)
    return _symbol_bounds_impl(np.asarray(stencil), n, pad_rel)


@functools.lru_cache(maxsize=256)
def _symbol_bounds_cached(stencil: Tuple, n: int, pad_rel: float):
    return _symbol_bounds_impl(np.asarray(stencil), n, pad_rel)


def _symbol_bounds_impl(stencil, n: int, pad_rel: float):
    s = np.asarray(stencil, dtype=np.float64)
    th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    tx = th[None, :]
    ty = th[:, None]
    lam = np.zeros((n, n))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            c = s[1 + dj, 1 + di]
            if c != 0.0:
                lam = lam + c * np.cos(di * tx + dj * ty)
    lo, hi = float(lam.min()), float(lam.max())
    pad = pad_rel * (hi - lo)
    return lo - pad, hi + pad


def chebyshev_coefficients(lam_min: float, lam_max: float,
                           degree: int) -> Tuple[float, List[Tuple[float, float]]]:
    """Host-side coefficient schedule for one degree-``degree`` block.

    Returns (theta, [(c1_j, c2_j)]) for the three-term recurrence
    (Saad, Iterative Methods, alg. 12.1):

        d_1 = r / theta;  x += d_1;  r -= A d_1
        for j = 1..degree-1:
            d_{j+1} = c1_j d_j + c2_j r;  x += d_{j+1};  r -= A d_{j+1}

    with c1_j = rho_j rho_{j-1}, c2_j = 2 rho_j / delta.
    """
    if not (0.0 < lam_min < lam_max):
        raise ValueError(f"need 0 < lam_min < lam_max, got "
                         f"[{lam_min}, {lam_max}]")
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    coeffs = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coeffs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, coeffs


def block_contraction(lam_min: float, lam_max: float, degree: int) -> float:
    """Guaranteed residual-reduction factor of one block: 1 / T_k(sigma)."""
    sigma = (lam_max + lam_min) / (lam_max - lam_min)
    return 1.0 / math.cosh(degree * math.acosh(sigma))


def chebyshev_block(apply_a: Callable, x, r, theta: float,
                    coeffs) -> Tuple[jax.Array, jax.Array]:
    """One restarted Chebyshev block."""
    d = r * (1.0 / theta)
    x = x + d
    r = r - apply_a(d)
    for c1, c2 in coeffs:
        d = c1 * d + c2 * r
        x = x + d
        r = r - apply_a(d)
    return x, r


def chebyshev_solve(apply_a: Callable, b, x0, *, lam_min: float,
                    lam_max: float, degree: int = 8,
                    abs_tol: float = 1e-12, reduction: float = 1e-6,
                    max_iter: int = 10000) -> CgResult:
    """Solve SPD ``A x = b`` by restarted Chebyshev iteration.

    Same stopping contract and result type as solve/cg.py::pcg. ``b`` and
    ``x0`` follow the constrained-system convention (pinned entries
    consistent with the operator's diagonal rows); when both are zero on
    pinned rows — as in every fast-path solve — the iterates stay zero
    there automatically.
    """
    dtype = b.dtype
    theta, coeffs = chebyshev_coefficients(lam_min, lam_max, degree)

    r0 = b - apply_a(x0)
    norm0 = jnp.linalg.norm(r0)
    tol = jnp.maximum(jnp.asarray(abs_tol, dtype), reduction * norm0)

    def cond(state):
        x, r, rnorm, k = state
        return jnp.logical_and(rnorm > tol, k < max_iter)

    def body(state):
        x, r, rnorm, k = state
        x, r = chebyshev_block(apply_a, x, r, theta, coeffs)
        return (x, r, jnp.linalg.norm(r), k + degree)

    init = (x0, r0, norm0, jnp.asarray(0, jnp.int32))
    x, r, rnorm, k = jax.lax.while_loop(cond, body, init)
    return CgResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=rnorm <= tol)
