"""O(grid) diagnostics surface for the product fast engine.

The parity ``Discretization`` carries O(n_cells)-shaped element arrays
(cell connectivity, per-cell quadrature anchors): O(n_cells) memory and
gather traffic that the grid engines do not need. The fast
grid-stencil engine never needs any of it: this class implements the run
driver's full diagnostics surface (models/runner.py) with pure grid-plane
arithmetic — iota-generated coordinates, slice-window quadratic forms and
per-class quadrature — so the ``--engine fast`` product path is O(grid)
end to end and runs at any mesh size the state itself fits.

Semantics match the parity implementations to summation-order roundoff
(identical element matrices and quadrature rules; reference
WaveEquationBase.cpp:148-222 energy/probe, :367-423 errors with the r+2
rule and the 1e-14 relative guard): at the CSVs' %.6g formatting the
digits are identical in practice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex
from tpuwave.ops.assembly import element_mass_class
from tpuwave.ops.stencil import P1_CLASS_CORNERS
from tpuwave.utils.params import Params

__all__ = ["GridDiagnostics"]


def energy_grad_sq(win, grads):
    """|grad u|^2 over all cells of one element class at one quadrature
    point, from the local-DoF windows ``win`` (one (ny, nx) plane per
    local DoF) and that point's physical basis gradients ``grads``
    (nloc, 2). Difference form: the basis gradients sum to zero, so
    grad u = sum_{i>0} (w_i - w_0) grad phi_i — no O(|u|) terms cancel,
    which keeps an f32 stiffness energy accurate where the direct
    w^T K w sum loses it to cancellation on fine meshes."""
    total = None
    for a in range(2):
        comp = None
        for i in range(1, len(win)):
            c = float(grads[i, a])
            if c == 0.0:
                continue
            term = c * (win[i] - win[0])
            comp = term if comp is None else comp + term
        if comp is not None:
            total = comp * comp if total is None else total + comp * comp
    return total


class GridDiagnostics:
    """Drop-in for the runner-facing ``Discretization`` surface (P1
    structured rectangle only — the fast engine's eligibility set)."""

    def __init__(self, params: Params, dtype=None):
        self.params = params
        self.mesh = StructuredTriMesh(params.nel, params.geometry)
        if dtype is None:
            dtype = jnp.zeros(0, dtype=float).dtype
        self.dtype = dtype
        ny1, nx1 = self.mesh.ny + 1, self.mesh.nx + 1
        self.shape = (ny1, nx1)
        self.n_dofs = self.n_vec = ny1 * nx1

        space = FeSpace(self.mesh, 1)
        quad = gauss_simplex(2)
        self._m_class = np.asarray(element_mass_class(space, quad))
        #: per-class physical gradients (q-independent for P1): the
        #: stiffness form is s_k |grad u|^2 per cell (energy_grad_sq)
        self._grads = np.asarray(space.physical_grads(
            space.shape_at(quad)))[:, 0]                # (2, 3, 2)
        c_const = params.c.constant_value
        if c_const is not None:
            s_k = (float(c_const) ** 2 * self.mesh.det_j
                   * float(np.sum(quad.weights)))
            self._k_scales = (s_k, s_k)
        else:
            # varcoef: per-cell scales det sum_q w_q c^2(x_q, 0) — the
            # reference freezes c at t = 0 for the energy operator too
            self._k_scales = self._scales_at(0.0)       # (2, ny, nx)

        # probe: containing cell + P1 basis at the domain centre
        # (reference VectorTools::point_value, WaveEquationBase.cpp:170-222)
        from tpuwave.core.shape import simplex_shape
        cell, ref = self.mesh.locate_point(self.mesh.center)
        k = cell % 2
        ci = (cell // 2) % self.mesh.nx
        cj = (cell // 2) // self.mesh.nx
        verts = []
        for (ox, oy) in P1_CLASS_CORNERS[k]:
            verts.append((cj + oy) * nx1 + (ci + ox))
        self._probe_dofs = jnp.asarray(verts, dtype=jnp.int32)
        self._probe_vals = jnp.asarray(
            simplex_shape(1, np.asarray(ref, dtype=np.float64)).values[0],
            dtype=dtype)

        if params.solution is not None:
            self._sol = params.solution
        else:
            self._sol = None

        # the plane-arithmetic diagnostics decompose into O(100) small
        # ops; jit them so each call is ONE device dispatch (eager
        # execution made the preset-cadence logging dispatch-bound)
        self.energy = jax.jit(self._energy_impl)
        if self._sol is not None:
            self.errors = jax.jit(self._errors_impl)

    # -- coordinates ----------------------------------------------------
    def _grid_coords(self):
        (x0, y0) = self.mesh.origin
        ny1, nx1 = self.shape
        xs = x0 + self.mesh.hx * jax.lax.broadcasted_iota(
            self.dtype, (ny1, nx1), 1)
        ys = y0 + self.mesh.hy * jax.lax.broadcasted_iota(
            self.dtype, (ny1, nx1), 0)
        return xs, ys

    @property
    def dof_coords(self):
        """Host (n_dofs, 2) support-point coordinates (used by the
        frozen-coefficient mg setup; never shipped to the device)."""
        return self.mesh.vertex_coords

    # -- interpolation / IO views ---------------------------------------
    def interpolate(self, expr, t=0.0):
        if expr.is_zero:
            return jnp.zeros(self.n_dofs, self.dtype)
        xs, ys = self._grid_coords()
        vals = jnp.broadcast_to(jnp.asarray(
            expr.evaluate(xs, ys, t), self.dtype), self.shape)
        return vals.reshape(-1)

    def vertex_values(self, u):
        return u     # P1: DoFs ARE the vertices, already in mesh order

    @property
    def has_forcing(self) -> bool:
        return not self.params.f.is_zero

    @property
    def lumped_mass(self):
        from tpuwave.ops.stencil import lumped_mass_grid
        return jnp.asarray(lumped_mass_grid(FeSpace(self.mesh, 1)),
                           self.dtype).reshape(-1)

    # -- quadratic forms (energy) ---------------------------------------
    def _windows(self, wg, k):
        ny, nx = self.mesh.ny, self.mesh.nx
        return [wg[oy:oy + ny, ox:ox + nx]
                for (ox, oy) in P1_CLASS_CORNERS[k]]

    def _quad_form(self, wg, a_class):
        """sum_cells w_e^T A_e w_e with per-class constant A."""
        total = None
        for k in range(2):
            win = self._windows(wg, k)
            acc = None
            for i in range(3):
                for j in range(3):
                    a = float(a_class[k, i, j])
                    if a == 0.0:
                        continue
                    term = a * (win[i] * win[j])
                    acc = term if acc is None else acc + term
            s = jnp.sum(acc)
            total = s if total is None else total + s
        return total

    def _energy_impl(self, u, v):
        """E = 1/2 (v^T M v + u^T K u) (reference WaveEquationBase.cpp:
        148-154; K contains c^2, frozen at t = 0 like the reference).
        Public surface: ``self.energy`` (jitted in __init__)."""
        ug = jnp.asarray(u, self.dtype).reshape(self.shape)
        vg = jnp.asarray(v, self.dtype).reshape(self.shape)
        em = self._quad_form(vg, self._m_class)
        ek = sum(jnp.sum(self._k_scales[k] * energy_grad_sq(
            self._windows(ug, k), self._grads[k])) for k in range(2))
        return 0.5 * (em + ek)

    # -- probe ----------------------------------------------------------
    def probe(self, u):
        return jnp.vdot(u[self._probe_dofs], self._probe_vals)

    # -- varcoef scales (shared by energy and errors machinery) ---------
    def _scales_at(self, t):
        """(2, ny, nx) det * sum_q w_q c^2(x_kq, t) planes."""
        quad = gauss_simplex(2)
        ref = np.asarray(quad.points)
        w = np.asarray(quad.weights)
        det = float(self.mesh.det_j)
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 1)
        iy = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 0)
        out = []
        for k in range(2):
            c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
            acc = None
            for q in range(len(w)):
                fx = float(c0[0] + ref[q, 0] * (c1[0] - c0[0])
                           + ref[q, 1] * (c2_[0] - c0[0]))
                fy = float(c0[1] + ref[q, 0] * (c1[1] - c0[1])
                           + ref[q, 1] * (c2_[1] - c0[1]))
                c2v = jnp.asarray(self.params.c.evaluate(
                    x0 + (ix + fx) * hx, y0 + (iy + fy) * hy, 0.0),
                    self.dtype) ** 2
                term = float(w[q]) * jnp.broadcast_to(c2v, (ny, nx))
                acc = term if acc is None else acc + term
            out.append(det * acc)
        return jnp.stack(out)

    # -- errors (r+2 rule, 1e-14 guard; WaveEquationBase.cpp:367-423) ---
    def _err_data(self):
        try:
            return self.__err_cache
        except AttributeError:
            pass
        space = FeSpace(self.mesh, 1)
        quad = gauss_simplex(3)                          # r + 2 = 3
        sh = space.shape_at(quad)
        vals = np.asarray(sh.values)                     # (Q2, 3)
        grads = np.asarray(space.physical_grads(sh))[:, 0]   # (2, 3, 2)
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
        ug = jnp.asarray(u, self.dtype).reshape(self.shape)

        l2_sq = semi_sq = ex_l2_sq = ex_semi_sq = jnp.zeros((), self.dtype)
        for k in range(2):
            win = self._windows(ug, k)
            # P1 gradients are q-independent: one (gx, gy) pair per class
            guh_x = sum(float(grads[k, a, 0]) * win[a] for a in range(3))
            guh_y = sum(float(grads[k, a, 1]) * win[a] for a in range(3))
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                xs = x0 + (ix + fx) * hx
                ys = y0 + (iy + fy) * hy
                uh = sum(float(vals[q, a]) * win[a] for a in range(3))
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
