"""Geometric multigrid for the P1 grid-stencil systems — the large-dt
implicit solver.

The reference hands every implicit system to ML-AMG-CG (WaveTheta.cpp:
276-293, WaveNewmark.cpp:243-261). For wave-stable time steps the Jacobi-
or Chebyshev-preconditioned CG/Chebyshev solvers in this package match it
at a fraction of the cost, because `M + c*K` is then mass-dominated with a
small, h-independent condition number. But the whole point of the
unconditionally stable schemes (BE, CN, Newmark-AA) is to take dt far
beyond the CFL limit — and there the system becomes stiffness-dominated:
cond ~ c*lam_max(K)/lam_min(M) ~ (dt/h)^2, and any single-level polynomial
solver needs O(dt/h) iterations (BE at 4096^2, dt=1e-3 is ~100x the
work of dt=8e-5; dt=1e-2 overflows the analytic-bound Chebyshev setup
entirely).

Multigrid is the standard fix, and on the STRUCTURED triangulated
rectangle it is exact and regular in a way AMG never is:

  * **Nested spaces**: the P1 space on the Nel/2 mesh (same diagonal
    direction) is a subspace of the fine one, and the inclusion operator P
    is the P1 interpolation: coincident nodes copy, edge-midpoint nodes
    average their two coarse edge endpoints — including the (+1,+1)
    triangulation diagonal. Hence the Galerkin coarse operator
    P^T (M + c K) P is EXACTLY the coarse-mesh FEM matrix M_2h + c K_2h:
    no triple products, no setup graph — each level's operator is just the
    constant stencil assembled on its own mesh (ops/stencil.py).
  * **Regular data flow**: restriction/prolongation are strided slices of
    2D planes, the smoother is the same 9-point stencil apply as
    everything else; all of it jit/shard-compatible (GSPMD inserts halo
    collectives), nothing data-dependent.
  * **Fixed polynomial structure**: smoothing and the coarsest solve are
    fixed-coefficient Chebyshev polynomials in the (symmetric) level
    operators with ANALYTIC eigenvalue bounds from the stencil symbol
    (solve/cheby_iter.py) — so one V(pre,post)-cycle is a fixed symmetric
    positive definite linear operator, a valid CG preconditioner with
    h- and dt-INDEPENDENT contraction.

Boundary handling follows the constrained-system convention used
everywhere in the fast path (ops/stencil.py, models/fast.py): level
operators act as `diag * x` on boundary rows, and residuals/corrections
are zeroed there before restriction / after prolongation, so the cycle
solves the interior (eliminated) problem and leaves pinned rows alone.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.solve.cheby_iter import (chebyshev_block, chebyshev_coefficients,
                                      block_contraction,
                                      stencil_symbol_bounds)
from tpuwave.ops.stencil import apply_stencil

__all__ = ["prolong_p1", "restrict_p1", "MgLevel", "build_gmg_levels",
           "GmgPreconditioner", "gmg_for_system",
           "gmg_flat_preconditioner", "prolong_p1_to_p2", "restrict_p2_to_p1",
           "P2GmgPreconditioner", "P2CanvasGmgPreconditioner",
           "p2_gmg_for_system", "auto_precond", "AUTO_MG_THRESHOLD"]

#: ``precond='auto'`` switches to the V-cycle once the dimensionless
#: stiffness ratio q = stiff_coef * c^2 / (hx * hy) of the system
#: M + stiff_coef * K crosses this value. Jacobi-CG iteration counts grow
#: ~sqrt(q) while MG-PCG stays flat (~10): measured break-even is a few
#: V-cycle-equivalents, q ≈ 4–16 (at q ≈ 16 Jacobi-CG already needs ~65
#: iterations vs MG's ~10 at ~3x the per-iteration cost — RESULTS.md).
AUTO_MG_THRESHOLD = 8.0


# ----------------------------------------------------------------------
# transfer operators (P = nested-P1 inclusion, R = P^T)
# ----------------------------------------------------------------------

# The P1 inclusion weights as a 3x3 stencil on the DILATED grid: a fine
# node takes 1x the coincident coarse node, 0.5x each endpoint of the
# coarse edge it bisects — horizontal, vertical, or the (+1,+1)
# triangulation DIAGONAL (not the 4-point bilinear average; the mesh is
# triangulated, core/mesh.py). Same layout convention as ops/stencil.py:
# s[1+dj][1+di] couples offset (di, dj).
_P_STENCIL = ((0.5, 0.5, 0.0),
              (0.5, 1.0, 0.5),
              (0.0, 0.5, 0.5))


def _interleave_cols(a: jax.Array, b: jax.Array) -> jax.Array:
    """(H, W) evens + (H, W-1) odds -> (H, 2W-1) column-interleaved."""
    zero = jnp.asarray(0.0, a.dtype)
    b = jax.lax.pad(b, zero, ((0, 0, 0), (0, 1, 0)))
    h, w = a.shape
    return jnp.stack([a, b], axis=2).reshape(h, 2 * w)[:, :2 * w - 1]


def prolong_p1(c: jax.Array) -> jax.Array:
    """(ny+1, nx+1) coarse plane -> (2ny+1, 2nx+1) fine plane by P1
    interpolation on the nested triangulation.

    Implemented phase-by-phase (coinciding nodes = copy; horizontal /
    vertical / diagonal edge midpoints = two-point averages) and merged
    with stack+reshape interleaves. The earlier dilate-then-9-point-
    stencil formulation is numerically identical (same summation order)
    reads an interior-dilated pad (half its multiply-adds hit zeros)
    and has compiled pathologically slowly on some XLA backends; a
    strided-scatter formulation is slower at run time. This form is
    plain slices, adds and reshapes.
    """
    # phase planes; 0.5*first + 0.5*second matches the old stencil-apply
    # summation order bitwise
    ee = c                                           # (H, W)   copies
    eo = 0.5 * c[:, :-1] + 0.5 * c[:, 1:]            # (H, W-1) horiz mids
    oe = 0.5 * c[:-1, :] + 0.5 * c[1:, :]            # (H-1, W) vert mids
    oo = 0.5 * c[:-1, :-1] + 0.5 * c[1:, 1:]         # (H-1, W-1) diagonal
    even_rows = _interleave_cols(ee, eo)             # (H,   2W-1)
    odd_rows = _interleave_cols(oe, oo)              # (H-1, 2W-1)
    zero = jnp.asarray(0.0, c.dtype)
    odd_rows = jax.lax.pad(odd_rows, zero, ((0, 1, 0), (0, 0, 0)))
    h, wf = even_rows.shape
    fine = jnp.stack([even_rows, odd_rows], axis=1).reshape(2 * h, wf)
    return fine[:2 * h - 1, :]


def restrict_p1(r: jax.Array) -> jax.Array:
    """(2ny+1, 2nx+1) fine plane -> (ny+1, nx+1) coarse plane, R = P^T.

    Coarse node (I, J) accumulates the fine residual at its own node plus
    half of the six fine edge-midpoint neighbours it interpolates into:
    the same `_P_STENCIL` pass (one zero ring absorbs the wrap), then a
    stride-2 subsample done as pad + reshape + contiguous slice (a
    deinterleave without a strided gather).
    """
    zero = jnp.asarray(0.0, r.dtype)
    p = jax.lax.pad(r, zero, ((1, 1, 0), (1, 1, 0)))
    y = apply_stencil(p, _P_STENCIL)[1:-1, 1:-1]
    hf, wf = y.shape
    ny1, nx1 = (hf + 1) // 2, (wf + 1) // 2
    yr = jax.lax.pad(y, zero, ((0, 1, 0), (0, 0, 0)))
    yr = yr.reshape(ny1, 2, wf)[:, 0, :]
    yc = jax.lax.pad(yr, zero, ((0, 0, 0), (0, 1, 0)))
    return yc.reshape(ny1, nx1, 2)[:, :, 0]


# ----------------------------------------------------------------------
# level construction
# ----------------------------------------------------------------------

class MgLevel(NamedTuple):
    stencil: Tuple            # (3,3) tuple-of-tuples operator stencil
    shape: Tuple[int, int]    # (ny+1, nx+1) plane shape
    sm_theta: float           # smoother Chebyshev schedule
    sm_coeffs: Tuple


def _spd_symbol_bounds(stencil) -> Tuple[float, float]:
    """Analytic SPD spectrum bounds; keeps the lower bound positive even
    when the default relative pad would cross zero (stiffness-dominated
    stencils have lam_min << lam_max)."""
    lo, hi = stencil_symbol_bounds(stencil)
    if lo <= 0.0:
        lo0, _ = stencil_symbol_bounds(stencil, pad_rel=0.0)
        if lo0 <= 0.0:
            raise ValueError(f"stencil symbol not SPD: min {lo0}")
        # 512^2 sampling of the degree-1 trig symbol is accurate to
        # ~1e-5 relative; halving is a generous safety margin
        lo = 0.5 * lo0
    return lo, hi


def build_gmg_levels(system_stencil_of: Callable[[int, int], np.ndarray],
                     nel: Tuple[int, int], *, pre_degree: int = 2,
                     smooth_range: float = 8.0, min_coarse: int = 8,
                     coarse_tol: float = 1e-2,
                     max_coarse_degree: int = 96) -> Tuple[List[MgLevel],
                                                           float, Tuple]:
    """Build the level hierarchy.

    ``system_stencil_of(nx, ny)`` returns the (3, 3) operator stencil
    assembled on the (nx, ny) mesh — by nestedness this IS the Galerkin
    coarse operator (module docstring). Coarsening halves both axes while
    they stay even and larger than ``min_coarse``.

    Returns (levels, coarse_theta, coarse_coeffs): every level carries a
    degree-``pre_degree`` Chebyshev smoother targeting the upper
    [lam_max/smooth_range, lam_max] band of its analytic symbol spectrum;
    the coarsest level's full-range schedule is sized (host-side, from
    ``block_contraction``) to reduce the residual by ``coarse_tol``.
    """
    nx, ny = int(nel[0]), int(nel[1])
    levels: List[MgLevel] = []
    while True:
        st = np.asarray(system_stencil_of(nx, ny))
        st_t = tuple(tuple(float(v) for v in row) for row in st)
        _, hi = _spd_symbol_bounds(st_t)
        th, cf = chebyshev_coefficients(hi / smooth_range, hi, pre_degree)
        levels.append(MgLevel(stencil=st_t, shape=(ny + 1, nx + 1),
                              sm_theta=th, sm_coeffs=tuple(cf)))
        if (nx % 2 or ny % 2 or min(nx, ny) // 2 < min_coarse):
            break
        nx //= 2
        ny //= 2

    lo, hi = _spd_symbol_bounds(levels[-1].stencil)
    sigma = (hi + lo) / (hi - lo)
    need = math.acosh(1.0 / coarse_tol) / math.acosh(sigma)
    degree = min(max(int(math.ceil(need)), pre_degree), max_coarse_degree)
    c_theta, c_coeffs = chebyshev_coefficients(lo, hi, degree)
    return levels, c_theta, tuple(c_coeffs)


# ----------------------------------------------------------------------
# the V-cycle
# ----------------------------------------------------------------------

def _interior(shape: Tuple[int, int]) -> jax.Array:
    h, w = shape
    ri = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return (ri > 0) & (ri < h - 1) & (ci > 0) & (ci < w - 1)


class GmgPreconditioner:
    """z = V(b): one V(pre, post)-cycle on the constrained level operators.

    A fixed SPD linear operator (fixed-polynomial Chebyshev smoothing and
    coarse solve, R = P^T) — pass directly as ``precond_inv_diag`` to
    solve/cg.py::pcg. Apply cost ~ (pre + post + 1) fine stencil applies
    plus a geometrically decaying coarse tail (< 4/3 of the fine work).
    """

    def __init__(self, levels: Sequence[MgLevel], coarse_theta: float,
                 coarse_coeffs: Tuple):
        self.levels = list(levels)
        self.coarse_theta = float(coarse_theta)
        self.coarse_coeffs = tuple(coarse_coeffs)

    @staticmethod
    def _constrained(lev: MgLevel, interior) -> Callable:
        diag = lev.stencil[1][1]

        def apply_c(x):
            # mask columns AND rows (models/fast.py::_constrained): the
            # eliminated operator is block-diagonal over interior/boundary,
            # hence symmetric — required for the SPD cycle
            xi = jnp.where(interior, x, 0.0)
            return jnp.where(interior, apply_stencil(xi, lev.stencil),
                             diag * x)
        return apply_c

    def _coarse_solve(self, apply_c: Callable, b: jax.Array) -> jax.Array:
        """Fixed-schedule Chebyshev on the coarsest level, rolled up as a
        ``lax.scan`` over the coefficient pairs: the stiffest systems need
        degree ~100 here, and unrolling that inside the caller's CG
        while_loop sends XLA:CPU compile time through the roof (>10 min),
        and the tiny level gains nothing from the unroll."""
        theta = jnp.asarray(self.coarse_theta, b.dtype)
        x = b * (1.0 / theta)
        r = b - apply_c(x)
        d = x
        if not self.coarse_coeffs:
            return x
        cc = jnp.asarray(self.coarse_coeffs, b.dtype)

        def body(carry, c):
            x, r, d = carry
            d = c[0] * d + c[1] * r
            x = x + d
            r = r - apply_c(d)
            return (x, r, d), None

        (x, r, d), _ = jax.lax.scan(body, (x, r, d), cc)
        return x

    def _cycle(self, l: int, b: jax.Array) -> jax.Array:
        lev = self.levels[l]
        interior = _interior(lev.shape)
        apply_c = self._constrained(lev, interior)
        x = jnp.zeros_like(b)
        if l == len(self.levels) - 1:
            return self._coarse_solve(apply_c, b)
        # pre-smoothing (zero initial guess -> r stays consistent)
        x, r = chebyshev_block(apply_c, x, b, lev.sm_theta, lev.sm_coeffs)
        # coarse correction (mask boundary rows first: restriction must be
        # the exact transpose of the masked prolongation for SPD symmetry)
        bc = restrict_p1(jnp.where(interior, r, 0.0))
        bc = jnp.where(_interior(self.levels[l + 1].shape), bc, 0.0)
        ec = self._cycle(l + 1, bc)
        x = x + jnp.where(interior, prolong_p1(ec), 0.0)
        r = b - apply_c(x)
        # post-smoothing (same polynomial -> symmetric cycle)
        x, _ = chebyshev_block(apply_c, x, r, lev.sm_theta, lev.sm_coeffs)
        return x

    def __call__(self, b: jax.Array) -> jax.Array:
        return self._cycle(0, b)


def gmg_for_system(nel: Tuple[int, int], geometry, c: float,
                   stiff_coef: float, *, pre_degree: int = 2,
                   smooth_range: float = 8.0, min_coarse: int = 8,
                   coarse_tol: float = 1e-2) -> GmgPreconditioner:
    """GMG preconditioner for ``M + stiff_coef * K`` on the structured
    (nel, geometry) P1 mesh (``stiff_coef`` = beta dt^2 for Newmark,
    (theta dt)^2 for the theta u-system — models/fast.py).

    Level operators are the coarse-mesh FEM stencils (exact Galerkin by
    nestedness); all setup is host-side numpy + closed-form assembly.
    """
    from tpuwave.core.mesh import FeSpace, StructuredTriMesh
    from tpuwave.core.quadrature import gauss_simplex
    from tpuwave.ops.assembly import (element_mass_class,
                                      element_stiffness_class)
    from tpuwave.ops.stencil import class_matrices_to_stencil

    quad = gauss_simplex(2)

    def stencil_of(nx, ny):
        space = FeSpace(StructuredTriMesh((nx, ny), geometry), 1)
        m = class_matrices_to_stencil(element_mass_class(space, quad))
        k = class_matrices_to_stencil(
            element_stiffness_class(space, quad, c * c))
        return m + stiff_coef * k

    levels, c_theta, c_coeffs = build_gmg_levels(
        stencil_of, nel, pre_degree=pre_degree, smooth_range=smooth_range,
        min_coarse=min_coarse, coarse_tol=coarse_tol)
    return GmgPreconditioner(levels, c_theta, c_coeffs)


def auto_precond(disc, stiff_coef: float) -> str:
    """Resolve ``precond='auto'`` for the system ``M + stiff_coef * K``.

    Returns ``'mg'`` when the geometric V-cycle is applicable (structured
    rectangle mesh, constant wave speed, R in {1, 2} — the
    :func:`gmg_flat_preconditioner` eligibility set) AND the system is
    stiffness-dominated enough that it pays (dimensionless ratio
    q = stiff_coef * c^2 / (hx * hy) >= AUTO_MG_THRESHOLD); ``'jacobi'``
    otherwise. The reference always pays for an AMG setup
    (WaveTheta.cpp:276-286); 'auto' buys the equivalent robustness at
    large dt without taxing the CFL-scale runs where Jacobi-CG already
    converges in O(10) iterations.
    """
    from tpuwave.core.mesh import StructuredTriMesh

    p = disc.params
    mesh = disc.mesh
    eligible = (type(mesh) is StructuredTriMesh
                and p.c.constant_value is not None
                and p.r in (1, 2)
                and not (p.time_dependent_c and p.c.time_dependent))
    if not eligible:
        return "jacobi"
    c = float(p.c.constant_value)
    q = float(stiff_coef) * c * c / (mesh.hx * mesh.hy)
    return "mg" if q >= AUTO_MG_THRESHOLD else "jacobi"


def gmg_flat_preconditioner(disc, stiff_coef: float, c_ref=None,
                            **kw) -> Callable:
    """GMG V-cycle as a FLAT-DoF-vector preconditioner for the general
    (parity) solvers (models/theta.py, models/newmark.py), whose state is
    the flat DoF vector of models/discretization.py.

    Requires the structured discretization with constant wave speed. For
    R=1 the flat DoF numbering IS the row-major vertex grid
    (core/mesh.py::vertex_index), so the adapter is a pair of reshapes;
    for R=2 it is the plane concatenation of ops/stencil_p2.py (vertices,
    h/v/d edge midpoints — core/mesh.py edge indexers), which is what
    ``P2GmgPreconditioner`` operates on directly. Raises ValueError
    otherwise (imported meshes, variable c, R>2).
    """
    from tpuwave.core.mesh import StructuredTriMesh

    p = disc.params
    mesh = disc.mesh
    if not type(mesh) is StructuredTriMesh:
        raise ValueError("mg preconditioner needs the structured mesh")
    c_val = p.c.constant_value if c_ref is None else float(c_ref)
    if c_val is None:
        raise ValueError("mg preconditioner needs a constant wave speed C "
                         "(or an explicit c_ref frozen coefficient)")
    if p.r == 2:
        return p2_gmg_for_system(mesh.nel, mesh.geometry,
                                 float(c_val), stiff_coef,
                                 dtype=disc.dtype, **kw)
    if p.r != 1:
        raise ValueError("mg preconditioner supports only R=1/R=2")
    shape = (mesh.ny + 1, mesh.nx + 1)
    inner = gmg_for_system(mesh.nel, mesh.geometry,
                           float(c_val), stiff_coef, **kw)

    def precond(r):
        return inner(r.reshape(shape)).reshape(-1)

    return precond


# ----------------------------------------------------------------------
# P2: p-multigrid (P2 -> P1 on the same mesh, then the h-hierarchy)
# ----------------------------------------------------------------------
#
# P1 on the (nx, ny) mesh is a SUBSPACE of P2 on the same mesh, and the
# inclusion is nodal: a P1 function's value at an edge midpoint is the
# average of the edge's endpoint values. So exactly as in the h-case the
# Galerkin coarse operator P^T (M2 + c K2) P is the P1 FEM matrix
# M1 + c K1 — the fine level of the existing h-hierarchy. One extra
# (p-)level on top of gmg_for_system therefore gives P2 a full
# dt-independent multigrid solver with no new operator machinery.

def prolong_p1_to_p2(c: jax.Array) -> dict:
    """(ny+1, nx+1) P1 vertex grid -> P2 plane dict (V, H, W, D): nodal
    P1-in-P2 interpolation (edge midpoints average their endpoints; the
    D plane sits on the (+1,+1) triangulation diagonal)."""
    return {"V": c,
            "H": 0.5 * (c[:, :-1] + c[:, 1:]),
            "W": 0.5 * (c[:-1, :] + c[1:, :]),
            "D": 0.5 * (c[:-1, :-1] + c[1:, 1:])}


def restrict_p2_to_p1(planes: dict) -> jax.Array:
    """P2 plane dict -> (ny+1, nx+1) P1 grid, the exact transpose of
    ``prolong_p1_to_p2`` (out-of-range edge neighbours read as zero —
    they only affect boundary rows, which every caller masks)."""
    v, h, w, d = planes["V"], planes["H"], planes["W"], planes["D"]
    zero = jnp.asarray(0.0, v.dtype)

    def pad(a, lo_r, hi_r, lo_c, hi_c):
        return jax.lax.pad(a, zero, ((lo_r, hi_r, 0), (lo_c, hi_c, 0)))

    hterm = pad(h, 0, 0, 1, 0) + pad(h, 0, 0, 0, 1)
    wterm = pad(w, 1, 0, 0, 0) + pad(w, 0, 1, 0, 0)
    dterm = pad(d, 1, 0, 1, 0) + pad(d, 0, 1, 0, 1)
    return v + 0.5 * (hterm + wterm + dterm)


def _smooth_block_jacobi(apply_c: Callable, inv_d, x, r, theta: float,
                         coeffs) -> Tuple[jax.Array, jax.Array]:
    """Chebyshev smoothing block on the Jacobi-scaled operator D^{-1}A
    (needed where the diagonal is NOT constant, e.g. P2 planes): a fixed
    polynomial q(D^{-1}A) D^{-1} = D^{-1/2} q(\\hat A) D^{-1/2} — still a
    symmetric positive smoother, so the cycle stays a valid CG
    preconditioner. ``theta``/``coeffs`` target the D^{-1}A spectrum."""
    d = (1.0 / theta) * (inv_d * r)
    x = x + d
    r = r - apply_c(d)
    for c1, c2 in coeffs:
        d = c1 * d + c2 * (inv_d * r)
        x = x + d
        r = r - apply_c(d)
    return x, r


def _p2_interior_flat(nx: int, ny: int) -> jax.Array:
    """Flat P2 non-Dirichlet mask (plane order V, H, W, D), from iota —
    mirrors models/fast_p2.py::interior_mask."""
    from tpuwave.ops.stencil_p2 import p2_plane_shapes
    parts = []
    for p, (r, c) in p2_plane_shapes(nx, ny).items():
        ri = jax.lax.broadcasted_iota(jnp.int32, (r, c), 0)
        ci = jax.lax.broadcasted_iota(jnp.int32, (r, c), 1)
        if p == "V":
            bnd = (ri == 0) | (ri == r - 1) | (ci == 0) | (ci == c - 1)
        elif p == "H":
            bnd = (ri == 0) | (ri == r - 1)
        elif p == "W":
            bnd = (ci == 0) | (ci == c - 1)
        else:
            bnd = jnp.zeros((r, c), bool)
        parts.append(jnp.logical_not(bnd).reshape(-1))
    return jnp.concatenate(parts)


def _p2_canvas_interior(nx: int, ny: int, cshape) -> jax.Array:
    """(4, Hc, Wc) interior (free-DoF) canvas mask from iota — mirrors
    models/fast_p2.py::P2CanvasSolver._interior_canvas_mask."""
    from tpuwave.ops.stencil_p2 import _PLANES, p2_plane_shapes
    shapes = p2_plane_shapes(nx, ny)
    hc, wc = cshape
    ri = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1)
    masks = []
    for p in _PLANES:
        r, ccols = shapes[p]
        lj = ri - 1
        li = ci - 1
        support = (lj >= 0) & (lj < r) & (li >= 0) & (li < ccols)
        if p == "V":
            bnd = (lj == 0) | (lj == r - 1) | (li == 0) | (li == ccols - 1)
        elif p == "H":
            bnd = (lj == 0) | (lj == r - 1)
        elif p == "W":
            bnd = (li == 0) | (li == ccols - 1)
        else:
            bnd = jnp.zeros((hc, wc), bool)
        masks.append(support & ~bnd)
    return jnp.stack(masks)


class P2GmgPreconditioner:
    """One (p+h)-multigrid V-cycle on the flat P2 DoF vector: Jacobi-
    Chebyshev smoothing on the P2 plane-stencil system, coarse correction
    by the full P1 h-hierarchy (GmgPreconditioner). SPD — valid for pcg.
    """

    def __init__(self, system, interior, diag, sm_theta: float,
                 sm_coeffs: Tuple, p1_cycle: GmgPreconditioner,
                 nx: int, ny: int):
        # NB interior/diag are accepted for setup-time use (lambda_max
        # estimation) but the V-cycle REBUILDS them from iota /
        # system.diagonal() inside each traced call: closing the
        # O(n_dofs) concrete arrays into a jitted solve lowers them to
        # HLO literals (~0.5 GB at 4096^2 P2) baked into the program.
        self.system = system            # P2PlaneStencil (flat call surface)
        self.sm_theta = float(sm_theta)
        self.sm_coeffs = tuple(sm_coeffs)
        self.p1_cycle = p1_cycle
        self.nx, self.ny = int(nx), int(ny)

    @property
    def interior(self):
        return _p2_interior_flat(self.nx, self.ny)

    @property
    def diag(self):
        return self.system.diagonal()

    def __call__(self, b: jax.Array) -> jax.Array:
        from tpuwave.ops.stencil_p2 import flat_to_planes, planes_to_flat

        interior = _p2_interior_flat(self.nx, self.ny)
        diag = self.system.diagonal()
        inv_diag = 1.0 / diag

        def apply_c(x):
            xi = jnp.where(interior, x, 0.0)
            return jnp.where(interior, self.system(xi), diag * x)

        x = jnp.zeros_like(b)
        x, r = _smooth_block_jacobi(apply_c, inv_diag, x, b,
                                    self.sm_theta, self.sm_coeffs)
        planes = flat_to_planes(jnp.where(interior, r, 0.0),
                                self.nx, self.ny)
        bc = restrict_p2_to_p1(planes)
        grid_int = _interior((self.ny + 1, self.nx + 1))
        bc = jnp.where(grid_int, bc, 0.0)
        ec = self.p1_cycle(bc)
        ec = jnp.where(grid_int, ec, 0.0)
        corr = planes_to_flat(prolong_p1_to_p2(ec))
        corr = jnp.where(interior, corr, 0.0)
        x = x + corr
        r = r - apply_c(corr)
        x, _ = _smooth_block_jacobi(apply_c, inv_diag, x, r,
                                    self.sm_theta, self.sm_coeffs)
        return x


class P2CanvasGmgPreconditioner:
    """(p+h)-MG V-cycle on the (4, Hc, Wc) canvas layout of
    models/fast_p2.py::P2CanvasSolver and the P2 product engine — the
    shardable P2 production path.

    Same algebra as :class:`P2GmgPreconditioner` (Jacobi-scaled Chebyshev
    smoothing on the P2 system, coarse correction through the full P1
    h-hierarchy), but the smoothing applies run through the solver's
    constrained CANVAS apply and the p<->h transfers go canvas -> planes
    -> P1 grid with no flat reshuffle. A fixed SPD polynomial, valid as a
    pcg preconditioner.
    """

    def __init__(self, apply_c, interior, inv_diag, sm_theta: float,
                 sm_coeffs: Tuple, p1_cycle: GmgPreconditioner,
                 nx: int, ny: int, cshape: Tuple[int, int]):
        self.apply_c = apply_c          # constrained canvas apply
        #: (4, Hc, Wc) bool, False on pins/pads; pass None to rebuild it
        #: from iota inside each traced call (bench-scale jitted solves:
        #: a concrete capture lowers to an HLO literal, see
        #: P2GmgPreconditioner)
        self._interior = interior
        self.inv_diag = inv_diag        # (4, 1, 1) plane inverse diagonals
        self.sm_theta = float(sm_theta)
        self.sm_coeffs = tuple(sm_coeffs)
        self.p1_cycle = p1_cycle
        self.nx, self.ny = int(nx), int(ny)
        self.cshape = tuple(cshape)

    @property
    def interior(self):
        if self._interior is not None:
            return self._interior
        return _p2_canvas_interior(self.nx, self.ny, self.cshape)

    def __call__(self, b: jax.Array) -> jax.Array:
        """b: (4, Hc, Wc) canvas residual, zero on pinned/pad entries (the
        canvas-CG invariant). Returns the canvas z = V(b)."""
        from tpuwave.ops.stencil_p2 import (canvases_to_planes,
                                            planes_to_canvases)

        x = jnp.zeros_like(b)
        x, r = _smooth_block_jacobi(self.apply_c, self.inv_diag, x, b,
                                    self.sm_theta, self.sm_coeffs)
        r = jnp.where(self.interior, r, 0.0)
        planes = canvases_to_planes(r, self.nx, self.ny)
        bc = restrict_p2_to_p1(planes)
        grid_int = _interior((self.ny + 1, self.nx + 1))
        bc = jnp.where(grid_int, bc, 0.0)
        ec = jnp.where(grid_int, self.p1_cycle(bc), 0.0)
        corr = planes_to_canvases(prolong_p1_to_p2(ec), self.cshape)
        corr = jnp.where(self.interior, corr, 0.0)
        x = x + corr
        r = r - self.apply_c(corr)
        x, _ = _smooth_block_jacobi(self.apply_c, self.inv_diag, x, r,
                                    self.sm_theta, self.sm_coeffs)
        return x


def p2_gmg_for_system(nel: Tuple[int, int], geometry, c: float,
                      stiff_coef: float, *, dtype=jnp.float64,
                      pre_degree: int = 2, smooth_range: float = 8.0,
                      min_coarse: int = 8, coarse_tol: float = 1e-2,
                      lambda_max: float | None = None) -> P2GmgPreconditioner:
    """(p+h)-MG preconditioner for the P2 system ``M + stiff_coef * K``
    on the structured (nel, geometry) mesh.

    The P2-level smoother needs lam_max of D^{-1}A; unlike the constant-
    stencil P1 levels there is no scalar symbol, so it is estimated once
    by power iteration (solve/chebyshev.py, the deal.II
    PreconditionChebyshev approach) unless passed in.
    """
    from tpuwave.core.mesh import FeSpace, StructuredTriMesh
    from tpuwave.core.quadrature import gauss_simplex
    from tpuwave.ops.assembly import (element_mass_class,
                                      element_stiffness_class)
    from tpuwave.ops.stencil_p2 import P2PlaneStencil
    from tpuwave.solve.chebyshev import estimate_lambda_max

    nx, ny = int(nel[0]), int(nel[1])
    space = FeSpace(StructuredTriMesh((nx, ny), geometry), 2)
    quad = gauss_simplex(3)
    mass = P2PlaneStencil(space, element_mass_class(space, quad), dtype)
    stiff = P2PlaneStencil(space,
                           element_stiffness_class(space, quad, c * c), dtype)
    system = mass.axpy(stiff_coef, stiff)
    interior = _p2_interior_flat(nx, ny)
    diag = system.diagonal()
    inv_diag = 1.0 / diag

    def apply_c(x):
        xi = jnp.where(interior, x, 0.0)
        return jnp.where(interior, system(xi), diag * x)

    if lambda_max is None:
        lambda_max = estimate_lambda_max(apply_c, inv_diag, space.n_dofs)
    th, cf = chebyshev_coefficients(lambda_max / smooth_range,
                                    lambda_max, pre_degree)
    p1_cycle = gmg_for_system((nx, ny), geometry, c, stiff_coef,
                              pre_degree=pre_degree,
                              smooth_range=smooth_range,
                              min_coarse=min_coarse, coarse_tol=coarse_tol)
    return P2GmgPreconditioner(system, interior, diag, th, tuple(cf),
                               p1_cycle, nx, ny)
