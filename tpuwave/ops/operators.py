"""Matrix-free global operators and Dirichlet elimination.

Replaces ``TrilinosWrappers::SparseMatrix`` vmult/add/compress (reference
WaveTheta.cpp:103-116, 127-135) with a gather -> batched-matvec ->
segment_sum pipeline, and ``MatrixTools::apply_boundary_values(...,
eliminate_columns=true)`` (reference WaveTheta.cpp:258-273,
WaveNewmark.cpp:186-241) with mask-based symmetric elimination that
reproduces deal.II's exact semantics:

  * row j (boundary): zeroed except the ORIGINAL diagonal d_j;
    rhs_j = d_j * g_j; initial guess x_j = g_j
  * column j eliminated from every interior row: rhs_i -= A_ij g_j

so the constrained operator stays SPD and CG trajectories match.

Everything here is jit-traceable; `segment_sum` gives deterministic
scatter-adds (the array analogue of Trilinos ``compress(add)``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MatrixFreeOperator", "constrain_system"]


class MatrixFreeOperator:
    """y = A @ v applied cell-wise: y = scatter_add(A_e @ v[cells_e]).

    Three storage modes, cheapest first:
      * class:  a_class (2, nloc, nloc), cells interleaved [lower, upper]
      * scaled: class matrices times a per-element scalar (n_cells,)
      * full:   a_full (n_cells, nloc, nloc)
    """

    def __init__(self, cell_dofs, n_dofs: int, *, a_class=None, scale=None,
                 a_full=None, dtype=None):
        self.n_dofs = int(n_dofs)
        self.cell_dofs = jnp.asarray(cell_dofs, dtype=jnp.int32)
        self.n_cells, self.n_local = self.cell_dofs.shape
        if dtype is None:
            dtype = jnp.zeros(0, dtype=float).dtype
        self.dtype = dtype
        self.a_class = None if a_class is None else jnp.asarray(a_class, dtype=dtype)
        self.scale = None if scale is None else jnp.asarray(scale, dtype=dtype)
        self.a_full = None if a_full is None else jnp.asarray(a_full, dtype=dtype)
        if (self.a_class is None) == (self.a_full is None):
            raise ValueError("Provide exactly one of a_class / a_full")

    # -- application --------------------------------------------------------
    def __call__(self, v):
        cd = self.cell_dofs
        ve = v[cd]  # (n_cells, nloc) gather
        if self.a_full is not None:
            we = jnp.einsum("eij,ej->ei", self.a_full, ve, precision="highest")
        else:
            ve2 = ve.reshape(-1, 2, self.n_local)
            we2 = jnp.einsum("kij,ekj->eki", self.a_class, ve2,
                             precision="highest")
            if self.scale is not None:
                we2 = we2 * self.scale.reshape(-1, 2, 1)
            we = we2.reshape(-1, self.n_local)
        return jax.ops.segment_sum(we.reshape(-1), cd.reshape(-1),
                                   num_segments=self.n_dofs)

    # -- derived data -------------------------------------------------------
    def _element_diag(self):
        if self.a_full is not None:
            return jnp.diagonal(self.a_full, axis1=1, axis2=2)
        d = jnp.diagonal(self.a_class, axis1=1, axis2=2)  # (2, nloc)
        de = jnp.broadcast_to(d, (self.n_cells // 2, 2, self.n_local))
        if self.scale is not None:
            de = de * self.scale.reshape(-1, 2, 1)
        return de.reshape(-1, self.n_local)

    def diagonal(self):
        """Assembled diagonal (for Jacobi preconditioning / BC rows)."""
        de = self._element_diag()
        return jax.ops.segment_sum(de.reshape(-1), self.cell_dofs.reshape(-1),
                                   num_segments=self.n_dofs)

    def abs_row_sums(self):
        """Assembled per-row sums of element-level |entries| — an upper
        bound on the true Gershgorin row sums (triangle inequality over
        element contributions). Used for the traced per-step
        lambda_max(D^-1 A) bound when the operator changes every step
        (Time Dependent C + Chebyshev preconditioning)."""
        if self.a_full is not None:
            re = jnp.sum(jnp.abs(self.a_full), axis=2)
        else:
            r = jnp.sum(jnp.abs(self.a_class), axis=2)  # (2, nloc)
            re = jnp.broadcast_to(r, (self.n_cells // 2, 2, self.n_local))
            if self.scale is not None:
                re = re * jnp.abs(self.scale).reshape(-1, 2, 1)
            re = re.reshape(-1, self.n_local)
        return jax.ops.segment_sum(re.reshape(-1), self.cell_dofs.reshape(-1),
                                   num_segments=self.n_dofs)

    def row_sums(self):
        """Assembled row sums (row-sum mass lumping for the explicit path)."""
        if self.a_full is not None:
            re = jnp.sum(self.a_full, axis=2)
        else:
            r = jnp.sum(self.a_class, axis=2)  # (2, nloc)
            re = jnp.broadcast_to(r, (self.n_cells // 2, 2, self.n_local))
            if self.scale is not None:
                re = re * self.scale.reshape(-1, 2, 1)
            re = re.reshape(-1, self.n_local)
        return jax.ops.segment_sum(re.reshape(-1), self.cell_dofs.reshape(-1),
                                   num_segments=self.n_dofs)

    # -- algebra ------------------------------------------------------------
    def axpy(self, coef: float, other: "MatrixFreeOperator") -> "MatrixFreeOperator":
        """self + coef * other, merged into ONE operator when storage allows
        (the analogue of reference matrix_u = M + (theta dt)^2 K,
        WaveTheta.cpp:110-112 — one fused gather/scatter per apply)."""
        if self.cell_dofs is not other.cell_dofs and not (
                self.cell_dofs.shape == other.cell_dofs.shape):
            raise ValueError("Operators live on different connectivities")
        if (self.a_class is not None and other.a_class is not None
                and self.scale is None and other.scale is None):
            return MatrixFreeOperator(self.cell_dofs, self.n_dofs,
                                      a_class=self.a_class + coef * other.a_class,
                                      dtype=self.dtype)
        a = self._densify_elements()
        b = other._densify_elements()
        return MatrixFreeOperator(self.cell_dofs, self.n_dofs,
                                  a_full=a + coef * b, dtype=self.dtype)

    def _densify_elements(self):
        if self.a_full is not None:
            return self.a_full
        ae = jnp.broadcast_to(self.a_class,
                              (self.n_cells // 2, 2, self.n_local, self.n_local))
        if self.scale is not None:
            ae = ae * self.scale.reshape(-1, 2, 1, 1)
        return ae.reshape(-1, self.n_local, self.n_local)

    # -- testing helpers ----------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """Assemble the full dense matrix (tests / tiny meshes only)."""
        cd = np.asarray(self.cell_dofs)
        ae = np.asarray(self._densify_elements())
        out = np.zeros((self.n_dofs, self.n_dofs))
        for e in range(cd.shape[0]):
            out[np.ix_(cd[e], cd[e])] += ae[e]
        return out


def constrain_system(apply_a: Callable, diag_a, boundary_mask, boundary_values,
                     rhs, x_prev):
    """Symmetric Dirichlet elimination, matrix-free.

    Given the unconstrained operator ``apply_a`` with assembled diagonal
    ``diag_a``, the boundary mask b, prescribed values g (dense vector,
    arbitrary off-boundary entries), the raw rhs and the previous solution
    (warm start), returns ``(apply_constrained, rhs_constrained, x0)``
    reproducing deal.II apply_boundary_values(..., eliminate_columns=true):

        A~ v  = interior(A(interior(v))) + d * v      on boundary rows
        rhs~  = interior(rhs - A(g 1_b)) + d * g      on boundary rows
        x0    = x_prev with boundary entries set to g
    """
    bnd = boundary_mask
    interior = jnp.logical_not(bnd)
    g_ext = jnp.where(bnd, boundary_values, 0.0)

    def apply_constrained(v):
        w = apply_a(jnp.where(interior, v, 0.0))
        return jnp.where(interior, w, diag_a * v)

    rhs_c = jnp.where(interior, rhs - apply_a(g_ext), diag_a * g_ext)
    x0 = jnp.where(bnd, g_ext, x_prev)
    return apply_constrained, rhs_c, x0
