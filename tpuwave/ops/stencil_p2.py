"""P2 plane-stencil operators: the structured fast path for quadratics.

On the structured triangulated rectangle the P2 DoFs split into FOUR
translation-invariant sub-grids ("planes"):

    V: vertices        (ny+1, nx+1)
    H: horizontal-edge midpoints (ny+1, nx)
    W: vertical-edge midpoints   (ny,   nx+1)
    D: diagonal-edge midpoints   (ny,   nx)

and (for constant wave speed) both M and K become CONSTANT block-stencils
between planes: y_p[n] = sum_{q, off} C[p,q,off] * x_q[n + off] with
offsets in {-1,0,1}^2. Application is pure shifted adds over four 2D
canvases — the P2 analogue of ops/stencil.py, replacing the
gather/segment_sum flat path, whose scatter lowering needs O(n_cells)
index and sort buffers (this representation streams at memory bandwidth
with ~2x state footprint).

Plane embedding into a common (ny+3, nx+3) zero-padded canvas makes the
cross-plane shifts uniform; roll wraparound lands only in the canvas halo
ring, outside every crop window. Boundary rows are handled by the caller's
constrained wrapper exactly as in the P1 path (interior-masked apply +
diagonal pinning).

The flat DoF ordering (tpuwave.core.mesh: vertices, then h/v/d edge
blocks, each row-major) makes flat <-> planes a pure reshape/concat.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace

__all__ = ["P2PlaneStencil", "p2_plane_shapes", "flat_to_planes",
           "planes_to_flat", "canvas_shape", "planes_to_canvases",
           "canvases_to_planes", "p2_varcoef_data", "P2VarcoefStencil"]

# local-DoF -> (plane, (di, dj)) cell-relative positions, per element class
# (ordering matches core.mesh.FeSpace.cell_dofs: v0 v1 v2 e01 e12 e20)
_P2_POSITIONS = (
    # lower triangle (v00, v10, v11, h(i,j), v(i+1,j), d(i,j))
    (("V", (0, 0)), ("V", (1, 0)), ("V", (1, 1)),
     ("H", (0, 0)), ("W", (1, 0)), ("D", (0, 0))),
    # upper triangle (v00, v11, v01, d(i,j), h(i,j+1), v(i,j))
    (("V", (0, 0)), ("V", (1, 1)), ("V", (0, 1)),
     ("D", (0, 0)), ("H", (0, 1)), ("W", (0, 0))),
)

_PLANES = ("V", "H", "W", "D")


def p2_plane_shapes(nx: int, ny: int) -> Dict[str, Tuple[int, int]]:
    """(rows, cols) of each plane (rows = y index, cols = x index)."""
    return {"V": (ny + 1, nx + 1), "H": (ny + 1, nx),
            "W": (ny, nx + 1), "D": (ny, nx)}


def flat_to_planes(x, nx: int, ny: int) -> Dict[str, jax.Array]:
    shapes = p2_plane_shapes(nx, ny)
    out = {}
    off = 0
    for p in _PLANES:
        r, c = shapes[p]
        out[p] = x[off:off + r * c].reshape(r, c)
        off += r * c
    return out

def planes_to_flat(planes: Dict[str, jax.Array]) -> jax.Array:
    return jnp.concatenate([planes[p].reshape(-1) for p in _PLANES])


def canvas_shape(nx: int, ny: int, row_multiple: int = 1,
                 col_multiple: int = 1) -> Tuple[int, int]:
    """Common zero-padded canvas shape holding any plane at offset (1, 1),
    rows/cols padded up to multiples (for even sharding)."""
    rows = -(-(ny + 3) // row_multiple) * row_multiple
    cols = -(-(nx + 3) // col_multiple) * col_multiple
    return (rows, cols)


def planes_to_canvases(planes: Dict[str, jax.Array], cshape) -> jax.Array:
    """(4, Hc, Wc) stack, plane order V,H,W,D, each embedded at (1, 1)."""
    out = []
    for p in _PLANES:
        r, c = planes[p].shape
        canvas = jnp.zeros(cshape, planes[p].dtype)
        out.append(canvas.at[1:1 + r, 1:1 + c].set(planes[p]))
    return jnp.stack(out)


def canvases_to_planes(xc: jax.Array, nx: int, ny: int) -> Dict[str, jax.Array]:
    shapes = p2_plane_shapes(nx, ny)
    return {p: xc[i][1:1 + shapes[p][0], 1:1 + shapes[p][1]]
            for i, p in enumerate(_PLANES)}


def _build_coefficients(a_class: np.ndarray) -> Dict[Tuple, float]:
    """(2, 6, 6) per-class element matrices -> {(pa, pb, ox, oy): coeff}.

    coeff is the interior coupling of plane pa's node to plane pb's node
    at cell offset (ox, oy), summed over the incident triangles.
    """
    coeffs: Dict[Tuple, float] = {}
    for k in range(2):
        pos = _P2_POSITIONS[k]
        for i in range(6):
            pa, (xa, ya) = pos[i]
            for j in range(6):
                pb, (xb, yb) = pos[j]
                key = (pa, pb, xb - xa, yb - ya)
                coeffs[key] = coeffs.get(key, 0.0) + float(a_class[k, i, j])
    return {k: v for k, v in coeffs.items() if v != 0.0}


class P2PlaneStencil:
    """Constant block-stencil P2 operator acting on flat DoF vectors."""

    def __init__(self, space: FeSpace, a_class: np.ndarray, dtype):
        if space.degree != 2:
            raise ValueError("P2PlaneStencil requires a P2 space")
        self.nx, self.ny = space.mesh.nx, space.mesh.ny
        self.shapes = p2_plane_shapes(self.nx, self.ny)
        self.dtype = dtype
        self.coeffs = _build_coefficients(np.asarray(a_class))
        self.n_dofs = space.n_dofs
        #: interior diagonal per plane (V/H/W/D), for Jacobi/BC pinning
        self.plane_diag = {p: self.coeffs.get((p, p, 0, 0), 1.0)
                          for p in _PLANES}

    # -- canvas plumbing ----------------------------------------------------
    def _canvas_shape(self):
        return (self.ny + 3, self.nx + 3)

    def _to_canvas(self, plane, name):
        r, c = self.shapes[name]
        canvas = jnp.zeros(self._canvas_shape(), self.dtype)
        return canvas.at[1:1 + r, 1:1 + c].set(plane)

    def __call__(self, x):
        planes = flat_to_planes(x, self.nx, self.ny)
        canv = {p: self._to_canvas(planes[p], p) for p in _PLANES}
        out: Dict[str, jax.Array] = {}
        for (pa, pb, ox, oy), coeff in self.coeffs.items():
            term = canv[pb]
            if (ox, oy) != (0, 0):
                term = jnp.roll(term, shift=(-oy, -ox), axis=(0, 1))
            acc = out.get(pa)
            out[pa] = coeff * term if acc is None else acc + coeff * term
        result = {}
        for p in _PLANES:
            r, c = self.shapes[p]
            result[p] = out[p][1:1 + r, 1:1 + c]
        return planes_to_flat(result)

    def diagonal(self):
        """Flat diagonal using the constant interior values per plane
        (boundary rows differ but are only used for BC pinning, where any
        nonzero diagonal is exact — same convention as the P1 stencil)."""
        parts = []
        for p in _PLANES:
            r, c = self.shapes[p]
            parts.append(jnp.full(r * c, self.plane_diag[p], self.dtype))
        return jnp.concatenate(parts)

    # -- canvas-native application (shardable state layout) -----------------
    def apply_canvases(self, xc):
        """Apply on stacked canvases (4, Hc, Wc), plane order V,H,W,D.

        Caller guarantees xc is zero outside each plane's support (use
        support masks after every update); wrapped roll values then only
        reach non-support cells, which the caller masks again. All shifts
        are jnp.roll, so a row-sharded canvas stack lowers to
        collective-permute halo exchanges under GSPMD.
        """
        idx = {p: i for i, p in enumerate(_PLANES)}
        outs = [None] * len(_PLANES)
        for (pa, pb, ox, oy), coeff in self.coeffs.items():
            term = xc[idx[pb]]
            if (ox, oy) != (0, 0):
                term = jnp.roll(term, shift=(-oy, -ox), axis=(0, 1))
            a = idx[pa]
            outs[a] = coeff * term if outs[a] is None else outs[a] + coeff * term
        return jnp.stack(outs)

    def axpy_varcoef(self, coef: float,
                     other: "P2VarcoefStencil") -> "P2VarcoefStencil":
        """M + coef * K(t) with K a varcoef stencil: returns a varcoef
        operator whose constant part is this stencil."""
        return other.with_constant_part(self, coef)

    def axpy(self, coef: float, other: "P2PlaneStencil") -> "P2PlaneStencil":
        merged = object.__new__(P2PlaneStencil)
        merged.nx, merged.ny = self.nx, self.ny
        merged.shapes = self.shapes
        merged.dtype = self.dtype
        merged.n_dofs = self.n_dofs
        keys = set(self.coeffs) | set(other.coeffs)
        merged.coeffs = {k: self.coeffs.get(k, 0.0)
                         + coef * other.coeffs.get(k, 0.0) for k in keys}
        merged.plane_diag = {p: merged.coeffs.get((p, p, 0, 0), 1.0)
                             for p in _PLANES}
        return merged


# ---------------------------------------------------------------------------
# variable-coefficient P2 operator (time/space-dependent wave speed)
# ---------------------------------------------------------------------------

def p2_varcoef_data(space: FeSpace, quad):
    """Host constants for the varcoef P2 stiffness on the structured grid.

    Returns ``(G, frac, w, det)``: per-class per-quad gradient products
    G[k, q, i, j] = grad phi_i(q) . grad phi_j(q) (physical), fractional
    quadrature offsets frac[k, q, 2] within the unit grid cell, quadrature
    weights w[q], and the constant |det J|. The element matrix at time t is
    K_e = det * sum_q w_q c^2(x_eq, t) G[k, q] — unlike P1, G is
    q-DEPENDENT for quadratics, so the scales must be kept per (k, q).
    """
    from tpuwave.ops.stencil import P1_CLASS_CORNERS
    sh = space.shape_at(quad)
    grads = np.asarray(space.physical_grads(sh))        # (2, Q, 6, 2)
    G = np.einsum("kqia,kqja->kqij", grads, grads)      # (2, Q, 6, 6)
    ref = np.asarray(quad.points)                       # (Q, 2)
    frac = np.empty((2, len(ref), 2))
    for k in range(2):
        c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
        frac[k] = (c0[None]
                   + ref[:, 0:1] * (c1 - c0)[None]
                   + ref[:, 1:2] * (c2_ - c0)[None])
    return G, frac, np.asarray(quad.weights), float(space.mesh.det_j)


class P2VarcoefStencil:
    """Variable-coefficient P2 stiffness (plus optional constant part).

    ``scales``: (2, Q, ny, nx) per-class/per-quad-point planes
    det * w_q * c^2(x_ekq, t) — traceable, so the operator can be rebuilt
    inside a jitted step for `Time Dependent C`. Application is 72
    coefficient-weighted slice-adds on the common canvas (the varcoef
    generalisation of P2PlaneStencil.__call__: every element-matrix entry
    couples fixed plane positions, scaled by its own (ny, nx) plane).
    """

    def __init__(self, space: FeSpace, scales, G, dtype,
                 const_op: "P2PlaneStencil" = None, const_coef: float = 1.0,
                 var_coef: float = 1.0):
        self.nx, self.ny = space.mesh.nx, space.mesh.ny
        self.shapes = p2_plane_shapes(self.nx, self.ny)
        self.dtype = dtype
        self.n_dofs = space.n_dofs
        self.scales = scales                  # (2, Q, ny, nx) traced ok
        self.G = np.asarray(G)                # (2, Q, 6, 6) host constants
        self.const_op = const_op
        self.const_coef = float(const_coef)
        self.var_coef = float(var_coef)

    def with_constant_part(self, const_op: "P2PlaneStencil",
                           var_coef: float) -> "P2VarcoefStencil":
        out = object.__new__(P2VarcoefStencil)
        out.nx, out.ny = self.nx, self.ny
        out.shapes = self.shapes
        out.dtype = self.dtype
        out.n_dofs = self.n_dofs
        out.scales = self.scales
        out.G = self.G
        out.const_op = const_op
        out.const_coef = 1.0
        out.var_coef = float(var_coef)
        return out

    def _coeff_plane(self, k: int, i: int, j: int):
        """sum_q scales[k, q] * G[k, q, i, j] -> (ny, nx)."""
        acc = None
        for q in range(self.G.shape[1]):
            g = float(self.G[k, q, i, j])
            if g == 0.0:
                continue
            term = g * self.scales[k, q]
            acc = term if acc is None else acc + term
        return acc

    def _canvas_shape(self):
        return (self.ny + 3, self.nx + 3)

    def __call__(self, x):
        planes = flat_to_planes(x, self.nx, self.ny)
        cs = self._canvas_shape()
        canv = {}
        for p in _PLANES:
            r, c = self.shapes[p]
            canv[p] = jnp.zeros(cs, self.dtype).at[1:1 + r, 1:1 + c].set(
                planes[p])
        out = self._slice_add_apply([canv[p] for p in _PLANES], cs)
        result = {}
        for p, o in zip(_PLANES, out):
            r, c = self.shapes[p]
            result[p] = o[1:1 + r, 1:1 + c]
        y = planes_to_flat(result)
        if self.const_op is not None:
            y = y + self.const_coef * self.const_op(x)
        return y

    def _slice_add_apply(self, canv, cs):
        """Shared slice-add core: ``canv`` = list of 4 common canvases
        (plane order V, H, W, D, each embedded at (1, 1), zero outside
        support); returns the 4 output canvases (shape ``cs``)."""
        idx = {p: i for i, p in enumerate(_PLANES)}
        out = [jnp.zeros(cs, self.dtype) for _ in _PLANES]
        ny, nx = self.ny, self.nx
        vc = self.var_coef
        for k in range(2):
            pos = _P2_POSITIONS[k]
            for i in range(6):
                pa, (xa, ya) = pos[i]
                for j in range(6):
                    pb, (xb, yb) = pos[j]
                    cp = self._coeff_plane(k, i, j)
                    if cp is None:
                        continue
                    src = canv[idx[pb]][1 + yb:1 + yb + ny,
                                        1 + xb:1 + xb + nx]
                    out[idx[pa]] = out[idx[pa]].at[
                        1 + ya:1 + ya + ny, 1 + xa:1 + xa + nx].add(
                        (vc * cp) * src)
        return out

    def apply_canvases(self, xc):
        """Apply on stacked common canvases (4, Hc, Wc), planes embedded
        at (1, 1) — the shardable canvas-layout twin of ``__call__``
        (P2PlaneStencil.apply_canvases for the varcoef operator). Caller
        guarantees zeros outside each plane's support; every slice window
        stays inside the canvas for any Hc >= ny + 3, Wc >= nx + 3, so
        row/col padding (device-mesh divisibility) is
        transparent."""
        cs = (xc.shape[1], xc.shape[2])
        out = self._slice_add_apply([xc[i] for i in range(4)], cs)
        y = jnp.stack(out)
        if self.const_op is not None:
            y = y + self.const_coef * self.const_op.apply_canvases(xc)
        return y

    def diagonal_canvases(self, cshape):
        """(4, Hc, Wc) EXACT assembled diagonal on the common canvases
        (support entries only; zero on padding — callers pin padding to a
        harmless 1.0 themselves). Canvas twin of :meth:`diagonal`."""
        ny, nx = self.ny, self.nx
        diag = [jnp.zeros(cshape, self.dtype) for _ in _PLANES]
        idx = {p: i for i, p in enumerate(_PLANES)}
        for k in range(2):
            pos = _P2_POSITIONS[k]
            for i in range(6):
                pa, (xa, ya) = pos[i]
                cp = self._coeff_plane(k, i, i)
                if cp is None:
                    continue
                diag[idx[pa]] = diag[idx[pa]].at[
                    1 + ya:1 + ya + ny, 1 + xa:1 + xa + nx].add(
                    self.var_coef * cp)
        d = jnp.stack(diag)
        if self.const_op is not None:
            cd = jnp.asarray([self.const_op.plane_diag[p] for p in _PLANES],
                             self.dtype).reshape(4, 1, 1)
            # restrict the constant part to each plane's support so the
            # padding stays exactly zero (same contract as the varcoef part)
            supp = []
            for p in _PLANES:
                r, c = self.shapes[p]
                m = jnp.zeros(cshape, bool).at[1:1 + r, 1:1 + c].set(True)
                supp.append(m)
            d = d + jnp.where(jnp.stack(supp), self.const_coef * cd, 0.0)
        return d

    def diagonal(self):
        """Flat EXACT assembled diagonal (per-node: boundary rows are only
        consumed through BC pinning, but the varcoef diagonal genuinely
        varies per node, so assemble it instead of broadcasting)."""
        cs = self._canvas_shape()
        ny, nx = self.ny, self.nx
        diag = {p: jnp.zeros(cs, self.dtype) for p in _PLANES}
        for k in range(2):
            pos = _P2_POSITIONS[k]
            for i in range(6):
                pa, (xa, ya) = pos[i]
                cp = self._coeff_plane(k, i, i)
                if cp is None:
                    continue
                diag[pa] = diag[pa].at[1 + ya:1 + ya + ny,
                                       1 + xa:1 + xa + nx].add(
                    self.var_coef * cp)
        parts = []
        for p in _PLANES:
            r, c = self.shapes[p]
            parts.append(diag[p][1:1 + r, 1:1 + c].reshape(-1))
        d = jnp.concatenate(parts)
        if self.const_op is not None:
            d = d + self.const_coef * self.const_op.diagonal()
        return d
