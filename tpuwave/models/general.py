"""Discretisation on an imported unstructured mesh + the mesh-path factory.

Activates the reference's dormant ``Mesh File Name`` parameter
(ParameterReader.cpp:51-54; never consumed there — setup_mesh always
regenerates the structured rectangle, WaveEquationBase.cpp:37-72): when a
parameter file explicitly sets ``Mesh File Name``, tpuwave imports that
mesh (Gmsh .msh or legacy VTK, tpuwave/core/unstructured.py) and solves on
it with the identical scheme steppers — same boundary treatment, same CG
contract, same diagnostics.

Shape of the general path: geometry is per-cell (n_cells, ...) arrays
in device memory; operators are per-cell element matrices on the shared
gather -> batched matvec -> segment_sum path
(ops/operators.py ``a_full`` mode), so each apply is still one fused XLA
program. The structured fast paths (stencils) remain exclusive to
generated rectangle meshes, where geometry is compile-time constant.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.quadrature import gauss_simplex
from tpuwave.core.unstructured import (UnstructuredFeSpace, UnstructuredTriMesh,
                                       detect_structured, read_mesh_file)
from tpuwave.models.discretization import Discretization, _expr_grad_fn
from tpuwave.ops.operators import MatrixFreeOperator
from tpuwave.utils.expr import Expression
from tpuwave.utils.params import Params

__all__ = ["UnstructuredDiscretization", "make_discretization"]


def make_discretization(params: Params, dtype=None, *,
                        unstructured_sharding: str = "none") -> Discretization:
    """Factory: unstructured import when ``Mesh File Name`` was given,
    otherwise the structured rectangle discretisation.

    Imported meshes that are recognisably the structured rectangle
    triangulation (up to renumbering and IO roundoff;
    :func:`tpuwave.core.unstructured.detect_structured`) are renumbered
    onto the structured engines — the class-constant stencil operators and
    preconditioners — instead of the per-cell-geometry general path. The
    discrete problem is identical (same triangulation), so trajectories
    agree to solver roundoff; only the internal DoF ordering (and hence
    VTU vertex numbering) changes.

    ``unstructured_sharding``: parallel engine for genuinely unstructured
    imports — "none" (single-device operators), "cells" (cell-sharded,
    replicated vectors, parallel/cells.py), "dofs" (DoF-partitioned
    1-D y-band vectors, parallel/dofs.py) or "dofs2d" (2-D block
    partition with 8-neighbor ghost exchange, parallel/dofs2d.py — for
    meshes wide in both axes) over a mesh of all devices.
    Ignored for structured meshes (those shard via the grid solvers).
    """
    if unstructured_sharding not in ("none", "cells", "dofs", "dofs2d"):
        raise ValueError(f"unknown unstructured_sharding "
                         f"{unstructured_sharding!r}")
    if params.mesh_file is not None:
        mesh = read_mesh_file(params.mesh_file)
        hit = detect_structured(mesh)
        if hit is not None:
            nel, geometry = hit
            params = dataclasses.replace(params, nel=nel, geometry=geometry)
            return Discretization(params, dtype=dtype)
        device_mesh = None
        if unstructured_sharding != "none":
            from tpuwave.parallel.sharding import device_mesh as make_mesh
            device_mesh = make_mesh()
        return UnstructuredDiscretization(
            params, dtype=dtype, mesh=mesh, device_mesh=device_mesh,
            dof_sharded=unstructured_sharding in ("dofs", "dofs2d"),
            dof_partition="2d" if unstructured_sharding == "dofs2d"
            else "1d")
    return Discretization(params, dtype=dtype)


class UnstructuredDiscretization(Discretization):
    """Same public surface as :class:`Discretization`, per-cell geometry.

    The scheme steppers (ThetaSolver/NewmarkSolver) and the run driver only
    touch the shared surface — mass/stiffness operators, boundary plumbing,
    interpolate/load_vector, diagnostics — so they work on imported meshes
    unchanged. Time-independent wave speed: like the reference, ``c`` is
    evaluated at t = 0 (FunctionParser default time; SURVEY.md C-note).
    """

    def __init__(self, params: Params, dtype=None,
                 mesh: UnstructuredTriMesh = None, device_mesh=None,
                 dof_sharded: bool = False, dof_partition: str = "1d"):
        # deliberately NOT calling super().__init__ — the structured
        # constructor builds class-constant geometry that does not exist
        # here. Generic methods (interpolate, boundary_values, energy,
        # probe, check_divergence) are inherited and work off the
        # attributes set below.
        self.params = params
        self.mesh = mesh if mesh is not None else read_mesh_file(params.mesh_file)
        self.space = UnstructuredFeSpace(self.mesh, params.r)
        self.quad = gauss_simplex(params.r + 1)       # assembly rule (ref :82)
        self.quad_err = gauss_simplex(params.r + 2)   # error rule (ref :371)
        if dtype is None:
            dtype = jnp.zeros(0, dtype=float).dtype
        self.dtype = dtype

        sp, quad = self.space, self.quad
        self.n_dofs = sp.n_dofs
        cell_dofs = sp.cell_dofs
        det = self.mesh.det_j                          # (C,)
        sh = sp.shape_at(quad)
        w = quad.weights                               # (Q,)

        # per-cell element matrices (affine elements: mass = det-scaled
        # reference mass; stiffness needs the per-cell physical gradients)
        m_ref = np.einsum("q,qi,qj->ij", w, sh.values, sh.values)
        m_full = det[:, None, None] * m_ref[None]
        self.mass = MatrixFreeOperator(cell_dofs, self.n_dofs,
                                       a_full=m_full, dtype=dtype)

        g = sp.physical_grads(sh)                      # (C, Q, nloc, 2)
        xq = sp.quad_points(quad)                      # (C, Q, 2)
        c2 = np.asarray(params.c.evaluate(
            jnp.asarray(xq[..., 0]), jnp.asarray(xq[..., 1]), 0.0))
        c2 = np.broadcast_to(np.asarray(c2, dtype=np.float64) ** 2, xq.shape[:2])
        k_full = np.einsum("q,cq,cqia,cqja,c->cij", w, c2, g, g, det)
        self.stiffness = MatrixFreeOperator(cell_dofs, self.n_dofs,
                                            a_full=k_full, dtype=dtype)

        #: banded DoF-partition plan (parallel/dofs.py), None unless
        #: dof_sharded; when set, state vectors use the padded banded
        #: layout of length n_vec and every dof-indexed array below is
        #: renumbered through plan.new_of_old
        self.dof_plan = None
        self.n_vec = self.n_dofs
        self._real_mask = None
        if device_mesh is not None:
            if dof_sharded:
                # DoF-partitioned domain decomposition: cells AND vectors
                # sharded, nearest-neighbor ghost exchange per apply —
                # O(n_dofs / n_devices) memory per chip. "1d" = y-band
                # partition (parallel/dofs.py), "2d" = block partition
                # with 8-neighbor exchange (parallel/dofs2d.py)
                n_dev = int(device_mesh.devices.size)
                if dof_partition == "2d":
                    from tpuwave.parallel.dofs2d import (
                        ShardedDofOperator2D, build_dof_plan_2d)
                    cen = self.mesh.vertex_coords[self.mesh.cells].mean(
                        axis=1)
                    px = max(int(np.sqrt(n_dev)), 1)
                    while n_dev % px:
                        px -= 1
                    plan = build_dof_plan_2d(cell_dofs, self.n_dofs, cen,
                                             sp.dof_coords,
                                             (n_dev // px, px))
                    op_cls = ShardedDofOperator2D
                elif dof_partition == "1d":
                    from tpuwave.parallel.dofs import (ShardedDofOperator,
                                                       build_dof_plan)
                    cy = self.mesh.vertex_coords[self.mesh.cells].mean(
                        axis=1)[:, 1]
                    plan = build_dof_plan(cell_dofs, self.n_dofs, cy,
                                          n_dev)
                    op_cls = ShardedDofOperator
                else:
                    raise ValueError(
                        f"unknown dof_partition {dof_partition!r}")
                self.dof_plan = plan
                self.n_vec = plan.n_vec
                self.mass = op_cls.from_operator(self.mass, plan,
                                                 device_mesh)
                self.stiffness = op_cls.from_operator(self.stiffness, plan,
                                                      device_mesh)
            else:
                # cell-parallel decomposition: cells + element matrices
                # sharded, DoF vectors replicated, one psum per apply
                # (parallel/cells.py); simplest, memory O(n_dofs)/chip
                from tpuwave.parallel.cells import ShardedCellOperator
                self.mass = ShardedCellOperator.from_operator(self.mass,
                                                              device_mesh)
                self.stiffness = ShardedCellOperator.from_operator(
                    self.stiffness, device_mesh)

        self.mass_diag = self.mass.diagonal()
        self.lumped_mass = self.mass.row_sums()

        bidx = np.flatnonzero(sp.boundary_mask)
        if self.dof_plan is not None:
            noo = np.asarray(self.dof_plan.new_of_old, dtype=np.int64)
            bmask = np.zeros(self.n_vec, dtype=bool)
            bmask[noo] = sp.boundary_mask
            self.boundary_mask = jnp.asarray(bmask)
            self.boundary_idx = jnp.asarray(noo[bidx], dtype=jnp.int32)
            coords_pad = np.zeros((self.n_vec, 2))
            coords_pad[noo] = sp.dof_coords
            self.dof_coords = jnp.asarray(coords_pad, dtype=dtype)
            self._real_mask = jnp.asarray(~self.dof_plan.pad_mask,
                                          dtype=dtype)
            self._cd_vec = jnp.asarray(noo[np.asarray(sp.cell_dofs)],
                                       dtype=jnp.int32)
        else:
            self.boundary_mask = jnp.asarray(sp.boundary_mask)
            self.boundary_idx = jnp.asarray(bidx, dtype=jnp.int32)
            self.dof_coords = jnp.asarray(sp.dof_coords, dtype=dtype)
            self._cd_vec = jnp.asarray(sp.cell_dofs, dtype=jnp.int32)
        self.boundary_coords = jnp.asarray(sp.dof_coords[bidx], dtype=dtype)

        # assembly-rule data for the load vector: per-cell quadrature
        # coordinates and det-weighted quadrature weights
        self._load_vals = jnp.asarray(sh.values, dtype=dtype)      # (Q, nloc)
        self._load_w = jnp.asarray(w, dtype=dtype)                 # (Q,)
        self._load_xq = jnp.asarray(xq, dtype=dtype)               # (C, Q, 2)
        self._det_j = jnp.asarray(det, dtype=dtype)                # (C,)

        # assembly-rule physical gradients, kept for the time-dependent
        # wave-speed mode (stiffness_at)
        self._grads_j = jnp.asarray(g, dtype=dtype)            # (C, Q, nloc, 2)

        # error-rule data
        she = sp.shape_at(self.quad_err)
        self._err_vals = jnp.asarray(she.values, dtype=dtype)      # (Q2, nloc)
        self._err_grads = jnp.asarray(sp.physical_grads(she), dtype=dtype)
        self._err_w = jnp.asarray(self.quad_err.weights, dtype=dtype)
        self._err_xq = jnp.asarray(sp.quad_points(self.quad_err), dtype=dtype)

        # probe point = domain (bounding-box) centre
        cell, ref = self.mesh.locate_point(self.mesh.center)
        pdofs, pvals = sp.eval_basis_at(cell, ref)
        if self.dof_plan is not None:
            pdofs = np.asarray(self.dof_plan.new_of_old)[np.asarray(pdofs)]
        self._probe_dofs = jnp.asarray(pdofs, dtype=jnp.int32)
        self._probe_vals = jnp.asarray(pvals, dtype=dtype)

        if params.solution is not None:
            self._sol_grad = _expr_grad_fn(params.solution)
        else:
            self._sol_grad = None

    # ------------------------------------------------------------------
    # load vector (per-cell geometry)
    # ------------------------------------------------------------------
    def interpolate(self, expr, t=0.0):
        """Nodal interpolation; in the DoF-partitioned layout the padding
        slots carry dummy coordinates, so their values are zeroed to keep
        the padding-stays-zero invariant (parallel/dofs.py)."""
        vals = super().interpolate(expr, t)
        if self._real_mask is not None:
            vals = vals * self._real_mask
        return vals

    def vertex_values(self, u):
        """VTU point data in mesh vertex order (banded layout converts
        back through the plan)."""
        if self.dof_plan is not None:
            u = self.dof_plan.from_banded(u)
        return u[:self.mesh.n_vertices]

    # ------------------------------------------------------------------
    def load_vector(self, t):
        if not self.has_forcing:
            return jnp.zeros(self.n_vec, dtype=self.dtype)
        xq = self._load_xq                                     # (C, Q, 2)
        fq = self.params.f.evaluate(xq[..., 0], xq[..., 1], t)  # (C, Q)
        cell_rhs = jnp.einsum("cq,q,qi,c->ci", fq, self._load_w,
                              self._load_vals, self._det_j,
                              precision="highest")
        cd = self._cd_vec.reshape(-1)
        return jax.ops.segment_sum(cell_rhs.reshape(-1), cd,
                                   num_segments=self.n_vec)

    # ------------------------------------------------------------------
    # time-dependent wave speed (per-cell geometry)
    # ------------------------------------------------------------------
    def stiffness_payload_at(self, t):
        """Per-cell element matrices of K(t) (jit-traceable; the theta
        stepper carries this across steps, see theta.py)."""
        xq = self._load_xq                                     # (C, Q, 2)
        c2 = self.params.c.evaluate(xq[..., 0], xq[..., 1], t) ** 2
        c2 = jnp.broadcast_to(jnp.asarray(c2, self.dtype), xq.shape[:2])
        g = self._grads_j
        a_full = jnp.einsum("cq,q,cqia,cqja,c->cij", c2, self._load_w,
                            g, g, self._det_j, precision="highest")
        if self.dof_plan is not None:
            # permute + pad cells into the banded order so
            # stiffness_from_payload is free (parallel/dofs.py layout)
            perm = self.dof_plan.cell_perm
            af = jnp.where(jnp.asarray(perm >= 0)[:, None, None],
                           a_full[jnp.asarray(np.clip(perm, 0, None))],
                           jnp.zeros((), self.dtype))
            return af
        from tpuwave.parallel.cells import ShardedCellOperator
        if isinstance(self.mass, ShardedCellOperator):
            pad = self.mass.n_cells - a_full.shape[0]
            if pad:
                nloc = a_full.shape[-1]
                a_full = jnp.concatenate(
                    [a_full, jnp.zeros((pad, nloc, nloc), self.dtype)])
        return a_full

    def stiffness_from_payload(self, payload):
        """Rebuild K(t) from :meth:`stiffness_payload_at`, matching the
        engine (plain / cell-sharded / DoF-partitioned)."""
        if self.dof_plan is not None:
            # 1-D band or 2-D block engine — same constructor surface
            return type(self.mass)(self.dof_plan, payload,
                                   self.mass.mesh, dtype=self.dtype,
                                   _presharded=True)
        from tpuwave.parallel.cells import ShardedCellOperator
        if isinstance(self.mass, ShardedCellOperator):
            return ShardedCellOperator(self.mass.cell_dofs, self.n_dofs,
                                       payload, self.mass.mesh,
                                       dtype=self.dtype, _prepadded=True)
        return MatrixFreeOperator(self.space.cell_dofs, self.n_dofs,
                                  a_full=payload, dtype=self.dtype)

    def stiffness_at(self, t):
        """K(t) with c^2 evaluated at time ``t`` (jit-traceable)."""
        return self.stiffness_from_payload(self.stiffness_payload_at(t))

    # ------------------------------------------------------------------
    # errors (per-cell geometry)
    # ------------------------------------------------------------------
    def _fe_at_err_quads(self, u):
        """uh: (C, Q2); grad_uh: (C, Q2, 2)."""
        cd = self._cd_vec
        ue = u[cd]                                             # (C, nloc)
        uh = jnp.einsum("qi,ci->cq", self._err_vals, ue, precision="highest")
        guh = jnp.einsum("cqia,ci->cqa", self._err_grads, ue,
                         precision="highest")
        return uh, guh

    def _exact_at_err_quads(self, t):
        xq = self._err_xq                                      # (C, Q2, 2)
        uex = self.params.solution.evaluate(xq[..., 0], xq[..., 1], t)
        flat = xq.reshape(-1, 2)
        gex = self._sol_grad(flat, t).reshape(xq.shape)
        return uex, gex

    def errors(self, u, t):
        """Same contract as the structured version (quadrature degree r+2,
        < 1e-14 exact-norm guard, full H1 norm — reference
        WaveEquationBase.cpp:367-423), with per-cell |det J| weights."""
        uh, guh = self._fe_at_err_quads(u)
        uex, gex = self._exact_at_err_quads(t)
        w, det = self._err_w, self._det_j
        l2_sq = jnp.einsum("cq,q,c->", (uh - uex) ** 2, w, det,
                           precision="highest")
        semi_sq = jnp.einsum("cqa,q,c->", (guh - gex) ** 2, w, det,
                             precision="highest")
        ex_l2_sq = jnp.einsum("cq,q,c->", uex ** 2, w, det,
                              precision="highest")
        ex_semi_sq = jnp.einsum("cqa,q,c->", gex ** 2, w, det,
                                precision="highest")

        err_l2 = jnp.sqrt(l2_sq)
        err_h1 = jnp.sqrt(l2_sq + semi_sq)
        ex_l2 = jnp.sqrt(ex_l2_sq)
        ex_h1 = jnp.sqrt(ex_l2_sq + ex_semi_sq)
        rel_l2 = jnp.where(ex_l2 < 1e-14, err_l2, err_l2 / ex_l2)
        rel_h1 = jnp.where(ex_h1 < 1e-14, err_h1, err_h1 / ex_h1)
        return err_l2, err_h1, rel_l2, rel_h1
