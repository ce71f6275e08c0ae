"""Problem discretisation: mesh + space + operators + diagnostics.

The functional core that the reference's ``WaveEquationBase`` (C1) provides
imperatively: given :class:`tpuwave.utils.params.Params`, builds the
structured mesh, the P1/P2 space, the matrix-free mass/stiffness operators,
boundary data plumbing, nodal interpolation, the load-vector assembler, and
the diagnostics (energy WaveEquationBase.cpp:148-168, L2/H1 errors
:367-423, centre probe :170-222, divergence check :425-431) — all as pure
jit-traceable functions over arrays.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex
from tpuwave.ops.assembly import (cell_quad_geometry, element_mass_class,
                                  element_stiffness_class,
                                  element_stiffness_scaled)
from tpuwave.ops.operators import MatrixFreeOperator
from tpuwave.utils.expr import Expression
from tpuwave.utils.params import Params

__all__ = ["Discretization"]


def _expr_grad_fn(expr: Expression):
    """Per-point exact gradient of an expression via autodiff.

    The reference gets exact-solution gradients from deal.II's
    AutoDerivativeFunction finite differences (FunctionParser base class);
    here jax.grad gives them exactly — differences are far below the
    discretisation error.
    """
    def point_val(xy, t):
        return jnp.reshape(expr.evaluate(xy[0].reshape(1), xy[1].reshape(1), t), ())

    g = jax.grad(point_val, argnums=0)
    return jax.vmap(g, in_axes=(0, None))


class Discretization:
    def __init__(self, params: Params, dtype=None):
        self.params = params
        self.mesh = StructuredTriMesh(params.nel, params.geometry)
        self.space = FeSpace(self.mesh, params.r)
        self.quad = gauss_simplex(params.r + 1)       # assembly rule (ref :82)
        self.quad_err = gauss_simplex(params.r + 2)   # error rule (ref :371)
        if dtype is None:
            dtype = jnp.zeros(0, dtype=float).dtype
        self.dtype = dtype

        sp, quad = self.space, self.quad
        self.n_dofs = sp.n_dofs
        #: state-vector length; differs from n_dofs only for the banded
        #: DoF-partitioned unstructured layout (parallel/dofs.py)
        self.n_vec = self.n_dofs
        cell_dofs = sp.cell_dofs

        # wave speed: the reference never calls c.set_time, so a
        # t-dependent C is evaluated at t=0 (FunctionParser default time).
        c2_const = None
        if params.c.constant_value is not None:
            c2_const = params.c.constant_value ** 2

        m_class = element_mass_class(sp, quad)
        self.mass = MatrixFreeOperator(cell_dofs, self.n_dofs,
                                       a_class=m_class, dtype=dtype)
        if c2_const is not None:
            k_class = element_stiffness_class(sp, quad, c2_const)
            self.stiffness = MatrixFreeOperator(cell_dofs, self.n_dofs,
                                                a_class=k_class, dtype=dtype)
        else:
            xq = self._quad_coords_np(quad)  # (n_cells, Q, 2)
            cvals = np.asarray(params.c.evaluate(
                jnp.asarray(xq[..., 0]), jnp.asarray(xq[..., 1]), 0.0))
            scale, a = element_stiffness_scaled(sp, quad, cvals ** 2)
            if scale is not None:
                self.stiffness = MatrixFreeOperator(cell_dofs, self.n_dofs,
                                                    a_class=a, scale=scale,
                                                    dtype=dtype)
            else:
                self.stiffness = MatrixFreeOperator(cell_dofs, self.n_dofs,
                                                    a_full=a, dtype=dtype)

        self.mass_diag = self.mass.diagonal()
        self.lumped_mass = self.mass.row_sums()

        self.boundary_mask = jnp.asarray(sp.boundary_mask)
        bidx = np.flatnonzero(sp.boundary_mask)
        self.boundary_idx = jnp.asarray(bidx, dtype=jnp.int32)
        self.boundary_coords = jnp.asarray(sp.dof_coords[bidx], dtype=dtype)
        self.dof_coords = jnp.asarray(sp.dof_coords, dtype=dtype)

        # assembly-rule shape data for the load vector
        self._anchors, self._offsets = cell_quad_geometry(sp, quad)
        sh = sp.shape_at(quad)
        self._load_vals = jnp.asarray(sh.values, dtype=dtype)          # (Q, nloc)
        self._load_w = jnp.asarray(quad.weights * self.mesh.det_j, dtype=dtype)
        self._anchors_j = jnp.asarray(self._anchors, dtype=dtype)
        self._offsets_j = jnp.asarray(self._offsets, dtype=dtype)

        # error-rule shape data
        she = sp.shape_at(self.quad_err)
        self._err_vals = jnp.asarray(she.values, dtype=dtype)          # (Q2, nloc)
        self._err_grads = jnp.asarray(sp.physical_grads(she), dtype=dtype)  # (2,Q2,nloc,2)
        self._err_w = jnp.asarray(self.quad_err.weights * self.mesh.det_j, dtype=dtype)
        self._err_offsets = jnp.asarray(sp.quad_offsets(self.quad_err), dtype=dtype)

        # probe point = domain centre (reference WaveEquationBase.cpp:177-179)
        cell, ref = self.mesh.locate_point(self.mesh.center)
        pdofs, pvals = sp.eval_basis_at(cell, ref)
        self._probe_dofs = jnp.asarray(pdofs, dtype=jnp.int32)
        self._probe_vals = jnp.asarray(pvals, dtype=dtype)

        if params.solution is not None:
            self._sol_grad = _expr_grad_fn(params.solution)
        else:
            self._sol_grad = None

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------
    def _quad_coords_np(self, quad) -> np.ndarray:
        """(n_cells, Q, 2) physical quadrature coords (host, setup only)."""
        anchors, offsets = cell_quad_geometry(self.space, quad)
        xq = anchors[:, None, None, :] + offsets[None, :, :, :]
        return xq.reshape(self.mesh.n_cells, -1, 2)

    def _quad_coords(self, offsets):
        """jit-side quadrature coords: (grid_cells, 2, Q, 2)."""
        return self._anchors_j[:, None, None, :] + offsets[None, :, :, :]

    # ------------------------------------------------------------------
    # interpolation / boundary data
    # ------------------------------------------------------------------
    def interpolate(self, expr: Expression, t=0.0):
        """Nodal interpolation at DoF support points
        (= VectorTools::interpolate, reference WaveTheta.cpp:352-353)."""
        x = self.dof_coords[:, 0]
        y = self.dof_coords[:, 1]
        return expr.evaluate(x, y, t)

    def boundary_values(self, expr: Expression, t):
        """Dense vector with expr evaluated at boundary DoFs (zeros inside).

        Only boundary support points are evaluated
        (= VectorTools::interpolate_boundary_values)."""
        if expr.constant_value is not None:
            val = jnp.asarray(expr.constant_value, dtype=self.dtype)
            return jnp.where(self.boundary_mask,
                             val, jnp.zeros((), dtype=self.dtype))
        vals = expr.evaluate(self.boundary_coords[:, 0],
                             self.boundary_coords[:, 1], t)
        out = jnp.zeros(self.n_vec, dtype=self.dtype)
        return out.at[self.boundary_idx].set(vals)

    # ------------------------------------------------------------------
    # load vector
    # ------------------------------------------------------------------
    @property
    def has_forcing(self) -> bool:
        return not self.params.f.is_zero

    def load_vector(self, t):
        """L_i(t) = int f(x, t) phi_i dx assembled over all cells at once
        (the per-step forcing cell loop, reference WaveTheta.cpp:151-180)."""
        if not self.has_forcing:
            return jnp.zeros(self.n_dofs, dtype=self.dtype)
        xq = self._quad_coords(self._offsets_j)        # (G, 2, Q, 2)
        fq = self.params.f.evaluate(xq[..., 0], xq[..., 1], t)  # (G, 2, Q)
        cell_rhs = jnp.einsum("gkq,q,qi->gki", fq, self._load_w,
                              self._load_vals, precision="highest")
        cd = self.space.cell_dofs.reshape(-1)
        return jax.ops.segment_sum(cell_rhs.reshape(-1), jnp.asarray(cd),
                                   num_segments=self.n_dofs)

    # ------------------------------------------------------------------
    # time-dependent wave speed (tpuwave extension; the reference always
    # freezes c at t = 0 — FunctionParser default time, SURVEY.md C-note)
    # ------------------------------------------------------------------
    @property
    def _tdep_data(self):
        try:
            return self.__tdep_cache
        except AttributeError:
            pass
        sp, quad = self.space, self.quad
        sh = sp.shape_at(quad)
        grads = sp.physical_grads(sh)               # (2, Q, nloc, 2)
        # cache NUMPY arrays: the first access may happen inside a jit
        # trace, where jnp.asarray returns a Tracer — caching that leaks
        # it into later traces (UnexpectedTracerError). numpy constants
        # are lifted per trace instead.
        dt_np = np.dtype(self.dtype)
        if sp.degree == 1:
            # P1 gradients are q-independent: K_e = s_e(t) * G_class with
            # s_e = detJ * sum_q w_q c^2(x_q, t)
            g_class = np.einsum("cqia,cqja->cqij", grads, grads)[:, 0]
            self.__tdep_cache = (
                "scaled", np.asarray(g_class, dtype=dt_np),
                np.asarray(quad.weights * self.mesh.det_j, dtype=dt_np))
        else:
            gprod = np.einsum("q,kqia,kqja->kqij", quad.weights,
                              grads, grads) * self.mesh.det_j
            self.__tdep_cache = (
                "full", np.asarray(gprod, dtype=dt_np), None)
        return self.__tdep_cache

    def stiffness_payload_at(self, t):
        """The t-varying array payload of K(t): a per-element ``scale``
        (P1 class storage) or ``a_full`` element matrices (P2). Small
        enough to carry in a ``lax.scan`` state so K^{n+1} built on one
        step can be reused as K^n on the next (the theta stepper does
        this — halves the per-step operator builds)."""
        kind, data, wdet = self._tdep_data
        xq = self._quad_coords(self._offsets_j)      # (G, 2, Q, 2)
        c2 = self.params.c.evaluate(xq[..., 0], xq[..., 1], t) ** 2
        if kind == "scaled":
            return jnp.einsum("gkq,q->gk", c2, wdet,
                              precision="highest").reshape(-1)
        a_full = jnp.einsum("gkq,kqij->gkij", c2, data, precision="highest")
        return a_full.reshape(-1, a_full.shape[-1], a_full.shape[-1])

    def stiffness_from_payload(self, payload):
        """Rebuild the K(t) operator from :meth:`stiffness_payload_at`."""
        kind, data, _ = self._tdep_data
        cd = self.space.cell_dofs
        if kind == "scaled":
            return MatrixFreeOperator(cd, self.n_dofs, a_class=data,
                                      scale=payload, dtype=self.dtype)
        return MatrixFreeOperator(cd, self.n_dofs, a_full=payload,
                                  dtype=self.dtype)

    def stiffness_at(self, t):
        """K(t): stiffness with c^2 evaluated at time ``t`` (jit-traceable;
        used by the steppers when ``Time Dependent C`` is enabled)."""
        return self.stiffness_from_payload(self.stiffness_payload_at(t))

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def energy(self, u, v):
        """E = 1/2 (v^T M v + u^T K u), K already containing c^2
        (reference WaveEquationBase.cpp:148-154; README.md:181)."""
        return 0.5 * (jnp.vdot(v, self.mass(v)) + jnp.vdot(u, self.stiffness(u)))

    def probe(self, u):
        """u_h at the domain centre (reference WaveEquationBase.cpp:170-222)."""
        return jnp.vdot(u[self._probe_dofs], self._probe_vals)

    def vertex_values(self, u):
        """State values at mesh vertices in mesh order (VTU point data);
        DoF numbering starts with the vertices for every engine except
        the banded DoF-partitioned one, which overrides this."""
        return u[:self.mesh.n_vertices]

    def _fe_at_err_quads(self, u):
        """(uh, grad_uh) at the error-rule quadrature points.

        uh: (G, 2, Q2); grad_uh: (G, 2, Q2, 2), class-resolved.
        """
        cd = jnp.asarray(self.space.cell_dofs)
        ue = u[cd].reshape(-1, 2, self.space.n_local_dofs)   # (G, 2, nloc)
        uh = jnp.einsum("qi,eki->ekq", self._err_vals, ue, precision="highest")
        guh = jnp.einsum("kqia,eki->ekqa", self._err_grads, ue,
                         precision="highest")
        return uh, guh

    def _exact_at_err_quads(self, t):
        xq = self._quad_coords(self._err_offsets)            # (G, 2, Q2, 2)
        uex = self.params.solution.evaluate(xq[..., 0], xq[..., 1], t)
        flat = xq.reshape(-1, 2)
        gex = self._sol_grad(flat, t).reshape(xq.shape)
        return uex, gex

    def errors(self, u, t):
        """(L2, H1, rel_L2, rel_H1) of u_h vs the exact solution at time t.

        Quadrature degree r+2 and the exact-norm < 1e-14 guard exactly as
        the reference (WaveEquationBase.cpp:367-423). H1 is the full norm
        sqrt(L2^2 + |.|_{H1}^2) (deal.II VectorTools::H1_norm).
        """
        uh, guh = self._fe_at_err_quads(u)
        uex, gex = self._exact_at_err_quads(t)
        w = self._err_w
        l2_sq = jnp.einsum("ekq,q->", (uh - uex) ** 2, w, precision="highest")
        semi_sq = jnp.einsum("ekqa,q->", (guh - gex) ** 2, w,
                             precision="highest")
        ex_l2_sq = jnp.einsum("ekq,q->", uex ** 2, w, precision="highest")
        ex_semi_sq = jnp.einsum("ekqa,q->", gex ** 2, w, precision="highest")

        err_l2 = jnp.sqrt(l2_sq)
        err_h1 = jnp.sqrt(l2_sq + semi_sq)
        ex_l2 = jnp.sqrt(ex_l2_sq)
        ex_h1 = jnp.sqrt(ex_l2_sq + ex_semi_sq)
        rel_l2 = jnp.where(ex_l2 < 1e-14, err_l2, err_l2 / ex_l2)
        rel_h1 = jnp.where(ex_h1 < 1e-14, err_h1, err_h1 / ex_h1)
        return err_l2, err_h1, rel_l2, rel_h1

    @staticmethod
    def check_divergence(norm_u, norm_v, threshold=1e130):
        """Reference WaveEquationBase.cpp:425-431."""
        return (not np.isfinite(norm_u)) or (not np.isfinite(norm_v)) \
            or norm_u > threshold or norm_v > threshold
