"""O(grid) diagnostics surface for the P2 product fast engine.

The P2 counterpart of :mod:`tpuwave.models.grid_diag`: the parity
``Discretization`` at R=2 carries O(n_cells) element arrays (cell_dofs,
quadrature anchors) that cost O(n_cells) memory at bench scale, while
everything the run driver needs (models/runner.py) reduces to plane
arithmetic on the four P2 sub-grids of ops/stencil_p2.py (V vertices,
H/W/D edge midpoints):

* interpolation = expression evaluation at iota-generated plane coords,
* the energy quadratic forms = per-class element matrices contracted
  against 6 plane windows (the class matrices are (2, 6, 6) host
  constants; varcoef c contributes (2, Q, ny, nx) scale planes),
* the L2/H1 errors = the r+2 rule (gauss_simplex(4)) with q-DEPENDENT
  per-class P2 gradients (unlike P1 they do not collapse per class),
* the probe = closed-form cell/plane indexing (no cell_dofs gather).

Semantics match the parity implementations to summation-order roundoff
(identical element matrices and quadrature; reference
WaveEquationBase.cpp:148-222 energy/probe, :367-423 errors with the r+2
rule and the 1e-14 relative guard).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex
from tpuwave.models.grid_diag import energy_grad_sq
from tpuwave.ops.assembly import element_mass_class
from tpuwave.ops.stencil import P1_CLASS_CORNERS
from tpuwave.ops.stencil_p2 import (_P2_POSITIONS, _PLANES, flat_to_planes,
                                    p2_plane_shapes)
from tpuwave.utils.params import Params

__all__ = ["P2GridDiagnostics", "p2_plane_offsets", "p2_plane_coords",
           "p2_interpolate_flat"]

#: per-plane support-point offsets within the unit grid cell
_PLANE_OFFS = {"V": (0.0, 0.0), "H": (0.5, 0.0), "W": (0.0, 0.5),
               "D": (0.5, 0.5)}


def p2_plane_offsets(nx: int, ny: int):
    """Flat start offset of each plane in the P2 DoF vector (plane order
    V, H, W, D = the core.mesh numbering: vertices, h/v/d edges)."""
    shapes = p2_plane_shapes(nx, ny)
    out, off = {}, 0
    for p in _PLANES:
        out[p] = off
        r, c = shapes[p]
        off += r * c
    return out


def p2_plane_coords(mesh: StructuredTriMesh, dtype):
    """Per-plane (x, y) coordinate arrays from iota (device, O(grid))."""
    (x0, y0) = mesh.origin
    hx, hy = mesh.hx, mesh.hy
    out = {}
    for p, (r, c) in p2_plane_shapes(mesh.nx, mesh.ny).items():
        ox, oy = _PLANE_OFFS[p]
        xs = x0 + hx * (jax.lax.broadcasted_iota(dtype, (r, c), 1) + ox)
        ys = y0 + hy * (jax.lax.broadcasted_iota(dtype, (r, c), 0) + oy)
        out[p] = (xs, ys)
    return out


def p2_interpolate_flat(mesh: StructuredTriMesh, expr, t, dtype):
    """Nodal interpolation of ``expr`` on the flat P2 DoF vector
    (= VectorTools::interpolate at the vertex + edge-midpoint support
    points, reference WaveTheta.cpp:352-353), O(grid)."""
    shapes = p2_plane_shapes(mesh.nx, mesh.ny)
    if expr.is_zero:
        n = sum(r * c for r, c in shapes.values())
        return jnp.zeros(n, dtype)
    parts = []
    for p, (xs, ys) in p2_plane_coords(mesh, dtype).items():
        vals = jnp.broadcast_to(jnp.asarray(
            expr.evaluate(xs, ys, t), dtype), shapes[p])
        parts.append(vals.reshape(-1))
    return jnp.concatenate(parts)


class P2GridDiagnostics:
    """Drop-in for the runner-facing ``Discretization`` surface (P2
    structured rectangle only — the P2 fast engine's eligibility set)."""

    def __init__(self, params: Params, dtype=None):
        if params.r != 2:
            raise ValueError("P2GridDiagnostics needs R = 2")
        self.params = params
        self.mesh = StructuredTriMesh(params.nel, params.geometry)
        if dtype is None:
            dtype = jnp.zeros(0, dtype=float).dtype
        self.dtype = dtype
        nx, ny = self.mesh.nx, self.mesh.ny
        self.shapes = p2_plane_shapes(nx, ny)
        #: FeSpace is lazy — only shape/Jacobian data is touched here, no
        #: O(n_cells) connectivity is ever materialised
        self.space = FeSpace(self.mesh, 2)
        self.n_dofs = self.n_vec = self.space.n_dofs

        quad = gauss_simplex(3)                     # assembly rule r + 1
        self._m_class = np.asarray(element_mass_class(self.space, quad))
        #: per-(class, q) physical gradients (q-DEPENDENT for P2): the
        #: stiffness form is sum_q s_q |grad u(q)|^2 (energy_grad_sq)
        self._grads = np.asarray(self.space.physical_grads(
            self.space.shape_at(quad)))                  # (2, Q, 6, 2)
        c_const = params.c.constant_value
        if c_const is not None:
            self._k_weights = (float(c_const) ** 2 * self.mesh.det_j
                               * np.asarray(quad.weights))
        else:
            # varcoef: scale planes det * w_q * c^2(x_kq, 0) — the
            # reference freezes c at t = 0 for the energy operator too.
            # Rebuilt from iota INSIDE each jitted energy call (a concrete
            # (2, Q, ny, nx) capture lowers to an HLO literal — >500 MB
            # at bench scale)
            self._k_weights = None

        # probe: containing cell + P2 basis at the domain centre
        # (reference VectorTools::point_value, WaveEquationBase.cpp:170-222)
        from tpuwave.core.shape import simplex_shape
        cell, ref = self.mesh.locate_point(self.mesh.center)
        k = cell % 2
        ci = (cell // 2) % nx
        cj = (cell // 2) // nx
        offs = p2_plane_offsets(nx, ny)
        dofs = []
        for pa, (ox, oy) in _P2_POSITIONS[k]:
            ncols = self.shapes[pa][1]
            dofs.append(offs[pa] + (cj + oy) * ncols + (ci + ox))
        self._probe_dofs = jnp.asarray(dofs, dtype=jnp.int32)
        self._probe_vals = jnp.asarray(
            simplex_shape(2, np.asarray(ref, dtype=np.float64)).values[0],
            dtype=dtype)

        self._sol = params.solution

        self.energy = jax.jit(self._energy_impl)
        if self._sol is not None:
            self.errors = jax.jit(self._errors_impl)

    # -- interpolation / IO views ---------------------------------------
    def interpolate(self, expr, t=0.0):
        return p2_interpolate_flat(self.mesh, expr, t, self.dtype)

    def vertex_values(self, u):
        """DoF numbering starts with the vertices (plane V first)."""
        return u[:self.mesh.n_vertices]

    @property
    def has_forcing(self) -> bool:
        return not self.params.f.is_zero

    # -- quadratic forms (energy) ---------------------------------------
    def _windows(self, planes, k):
        """The 6 per-cell local-DoF windows of class ``k``: window[a] has
        shape (ny, nx) with entry (cj, ci) = the value of local DoF a of
        the class-k triangle of grid cell (ci, cj)."""
        ny, nx = self.mesh.ny, self.mesh.nx
        return [planes[pa][oy:oy + ny, ox:ox + nx]
                for pa, (ox, oy) in _P2_POSITIONS[k]]

    def _quad_form_class(self, win, a_kij):
        """sum_cells w^T A_k w for one class with constant (6, 6) A."""
        acc = None
        for i in range(6):
            for j in range(6):
                a = float(a_kij[i, j])
                if a == 0.0:
                    continue
                term = a * (win[i] * win[j])
                acc = term if acc is None else acc + term
        return jnp.sum(acc)

    def _energy_impl(self, u, v):
        """E = 1/2 (v^T M v + u^T K u) (reference WaveEquationBase.cpp:
        148-154; K contains c^2, frozen at t = 0 like the reference)."""
        nx, ny = self.mesh.nx, self.mesh.ny
        up = flat_to_planes(jnp.asarray(u, self.dtype), nx, ny)
        vp = flat_to_planes(jnp.asarray(v, self.dtype), nx, ny)
        em = ek = jnp.zeros((), self.dtype)
        scales = (self._scales_at(0.0) if self._k_weights is None
                  else None)
        for k in range(2):
            vw = self._windows(vp, k)
            uw = self._windows(up, k)
            em = em + self._quad_form_class(vw, self._m_class[k])
            for q in range(self._grads.shape[1]):
                gsq = energy_grad_sq(uw, self._grads[k, q])
                w = (self._k_weights[q] if scales is None
                     else scales[k, q])
                ek = ek + jnp.sum(w * gsq)
        return 0.5 * (em + ek)

    # -- probe ----------------------------------------------------------
    def probe(self, u):
        return jnp.vdot(u[self._probe_dofs], self._probe_vals)

    # -- varcoef scales --------------------------------------------------
    def _scales_at(self, t):
        """(2, Q, ny, nx) det * w_q * c^2(x_kq, t) planes (assembly rule)."""
        quad = gauss_simplex(3)
        ref = np.asarray(quad.points)
        w = np.asarray(quad.weights)
        det = float(self.mesh.det_j)
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 1)
        iy = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 0)
        rows = []
        for k in range(2):
            c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
            qrows = []
            for q in range(len(w)):
                fx = float(c0[0] + ref[q, 0] * (c1[0] - c0[0])
                           + ref[q, 1] * (c2_[0] - c0[0]))
                fy = float(c0[1] + ref[q, 0] * (c1[1] - c0[1])
                           + ref[q, 1] * (c2_[1] - c0[1]))
                c2v = jnp.asarray(self.params.c.evaluate(
                    x0 + (ix + fx) * hx, y0 + (iy + fy) * hy, t),
                    self.dtype) ** 2
                qrows.append((det * float(w[q]))
                             * jnp.broadcast_to(c2v, (ny, nx)))
            rows.append(jnp.stack(qrows))
        return jnp.stack(rows)

    # -- errors (r+2 rule, 1e-14 guard; WaveEquationBase.cpp:367-423) ---
    def _err_data(self):
        try:
            return self.__err_cache
        except AttributeError:
            pass
        quad = gauss_simplex(4)                         # r + 2 = 4
        sh = self.space.shape_at(quad)
        vals = np.asarray(sh.values)                    # (Q2, 6)
        grads = np.asarray(self.space.physical_grads(sh))   # (2, Q2, 6, 2)
        ref = np.asarray(quad.points)
        frac = np.empty((2, len(ref), 2))
        for k in range(2):
            c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
            frac[k] = (c0[None]
                       + ref[:, 0:1] * (c1 - c0)[None]
                       + ref[:, 1:2] * (c2_ - c0)[None])
        self.__err_cache = (vals, grads, frac,
                            np.asarray(quad.weights) * float(self.mesh.det_j))
        return self.__err_cache

    def _errors_impl(self, u, t):
        vals, grads, frac, w = self._err_data()
        sol = self._sol
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 1)
        iy = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 0)
        up = flat_to_planes(jnp.asarray(u, self.dtype), nx, ny)

        l2_sq = semi_sq = ex_l2_sq = ex_semi_sq = jnp.zeros((), self.dtype)
        for k in range(2):
            win = self._windows(up, k)
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                xs = x0 + (ix + fx) * hx
                ys = y0 + (iy + fy) * hy
                uh = sum(float(vals[q, a]) * win[a] for a in range(6))
                # P2 gradients are q-dependent: contract per (k, q)
                guh_x = sum(float(grads[k, q, a, 0]) * win[a]
                            for a in range(6))
                guh_y = sum(float(grads[k, q, a, 1]) * win[a]
                            for a in range(6))
                uex = jnp.broadcast_to(jnp.asarray(
                    sol.evaluate(xs, ys, t), self.dtype), (ny, nx))
                ones = jnp.ones_like(xs)
                gex_x = jax.jvp(lambda a: sol.evaluate(a, ys, t),
                                (xs,), (ones,))[1]
                gex_y = jax.jvp(lambda a: sol.evaluate(xs, a, t),
                                (ys,), (ones,))[1]
                gex_x = jnp.broadcast_to(jnp.asarray(gex_x, self.dtype),
                                         (ny, nx))
                gex_y = jnp.broadcast_to(jnp.asarray(gex_y, self.dtype),
                                         (ny, nx))
                wq = float(w[q])
                l2_sq = l2_sq + wq * jnp.sum((uh - uex) ** 2)
                semi_sq = semi_sq + wq * jnp.sum(
                    (guh_x - gex_x) ** 2 + (guh_y - gex_y) ** 2)
                ex_l2_sq = ex_l2_sq + wq * jnp.sum(uex ** 2)
                ex_semi_sq = ex_semi_sq + wq * jnp.sum(
                    gex_x ** 2 + gex_y ** 2)

        err_l2 = jnp.sqrt(l2_sq)
        err_h1 = jnp.sqrt(l2_sq + semi_sq)
        ex_l2 = jnp.sqrt(ex_l2_sq)
        ex_h1 = jnp.sqrt(ex_l2_sq + ex_semi_sq)
        rel_l2 = jnp.where(ex_l2 < 1e-14, err_l2, err_l2 / ex_l2)
        rel_h1 = jnp.where(ex_h1 < 1e-14, err_h1, err_h1 / ex_h1)
        return err_l2, err_h1, rel_l2, rel_h1

    # -- divergence guard (WaveEquationBase.cpp:425-431) ----------------
    @staticmethod
    def check_divergence(norm_u, norm_v, threshold=1e130):
        return (not np.isfinite(norm_u)) or (not np.isfinite(norm_v)) \
            or norm_u > threshold or norm_v > threshold
