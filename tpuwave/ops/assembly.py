"""Batched finite-element assembly.

Array-native replacement for the reference's FEValues cell loop
(src/WaveTheta.cpp:56-117 / src/WaveNewmark.cpp:56-114): instead of
iterating cells and scatter-adding 3x3/6x6 blocks into a Trilinos sparse
matrix, element matrices are computed for ALL cells at once as einsum
contractions over tabulated shape data, and the global operator is kept
MATRIX-FREE (gather -> batched small matvec -> segment_sum), the
idiomatic accelerator representation — no sparse row structures.

Structure exploited: the structured mesh has exactly two congruent element
classes (lower/upper triangle) with constant Jacobians, so

  * the element MASS matrix is one (nloc x nloc) constant per class
    (actually identical across classes: values don't see the Jacobian,
    only detJ which is equal);
  * the element STIFFNESS matrix for piecewise-constant-per-element c^2 is
    a per-class constant scaled by a per-element scalar; for P1 this holds
    for ANY c (gradients are constant in the cell), giving s_e = int_e c^2.

All reference presets use constant wave speed, so both M and K collapse to
(2, nloc, nloc) constants — the operator application then streams only the
solution vector and connectivity, which is the HBM-bandwidth optimum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tpuwave.core.mesh import FeSpace
from tpuwave.core.quadrature import TriangleQuadrature

__all__ = [
    "element_mass_class",
    "element_stiffness_class",
    "element_stiffness_scaled",
    "cell_quad_geometry",
]


def element_mass_class(space: FeSpace, quad: TriangleQuadrature) -> np.ndarray:
    """(2, nloc, nloc) per-class element mass matrices: int phi_i phi_j.

    M_e[i,j] = sum_q w_q * detJ * N_q[i] * N_q[j]  (identical per class).
    """
    sh = space.shape_at(quad)
    m = np.einsum("q,qi,qj->ij", quad.weights, sh.values, sh.values)
    m = m * space.mesh.det_j
    return np.stack([m, m])


def element_stiffness_class(space: FeSpace, quad: TriangleQuadrature,
                            c2: float = 1.0) -> np.ndarray:
    """(2, nloc, nloc) per-class stiffness matrices for constant c^2.

    K_e[i,j] = c^2 * sum_q w_q * detJ * grad_i . grad_j  with physical
    (per-class) gradients.
    """
    sh = space.shape_at(quad)
    grads = space.physical_grads(sh)  # (2, Q, nloc, 2)
    k = np.einsum("q,cqia,cqja->cij", quad.weights, grads, grads)
    return c2 * k * space.mesh.det_j


def element_stiffness_scaled(space: FeSpace, quad: TriangleQuadrature,
                             c2_eq: np.ndarray) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Element stiffness for spatially varying c^2 at quadrature points.

    ``c2_eq`` has shape (n_cells, Q). Returns ``(scale, a)``:

    * P1: gradients are constant per cell, so K_e = s_e * G_class with
      s_e = detJ * sum_q w_q c2_eq -> returns ((n_cells,), (2,nloc,nloc)).
    * P2: no scalar factorisation; returns (None, (n_cells, nloc, nloc))
      full per-element matrices.
    """
    sh = space.shape_at(quad)
    grads = space.physical_grads(sh)  # (2, Q, nloc, 2)
    if space.degree == 1:
        g = np.einsum("cqia,cqja->cqij", grads, grads)
        # P1 gradients are q-independent; take q=0 representative.
        g_class = g[:, 0]
        scale = space.mesh.det_j * np.einsum("q,eq->e", quad.weights, c2_eq)
        return scale, g_class
    # P2: contract per element; interleave classes as the mesh does.
    e2 = c2_eq.reshape(-1, 2, c2_eq.shape[1])  # (grid_cells, 2, Q)
    a = np.einsum("q,ekq,kqia,kqja->ekij", quad.weights, e2, grads, grads)
    a = (a * space.mesh.det_j).reshape(-1, a.shape[-1], a.shape[-1])
    return None, a


def cell_quad_geometry(space: FeSpace, quad: TriangleQuadrature):
    """Geometry needed to evaluate f(x, t) at all quadrature points in jit.

    Returns ``(anchors, offsets)`` with anchors (grid_cells, 2) = the v00
    corner shared by both triangles of a grid cell, and offsets (2, Q, 2)
    per class; physical coords are anchors[:, None, None, :] + offsets.
    """
    m = space.mesh
    (x0, y0) = m.origin
    ii, jj = np.meshgrid(np.arange(m.nx), np.arange(m.ny), indexing="xy")
    anchors = np.stack([
        x0 + ii.ravel() * m.hx,
        y0 + jj.ravel() * m.hy,
    ], axis=-1)
    offsets = space.quad_offsets(quad)  # (2, Q, 2)
    return anchors, offsets
