"""Structured simplicial mesh of a rectangle + P1/P2 DoF layout.

Array-programmed replacement for deal.II's
``GridGenerator::subdivided_hyper_rectangle_with_simplices`` +
``DoFHandler``/``FE_SimplexP`` (reference WaveEquationBase.cpp:37-94): the
rectangle [x0,x1] x [y0,y1] is divided into nx*ny grid cells, each split
into two triangles along the lower-left -> upper-right diagonal:

      v01 ---- v11          upper triangle: (v00, v11, v01)
       |  \\     |           lower triangle: (v00, v10, v11)
       |    \\   |           cell index = 2*(j*nx + i) + {0: lower, 1: upper}
      v00 ---- v10          vertex index = j*(nx+1) + i   (x fastest)

Every triangle is congruent to one of TWO classes (lower/upper), so affine
Jacobians are per-class constants — no per-element geometry arrays, which is
what lets the hot operators run as pure stencils/batched contractions
with zero geometry traffic from device memory.

P1 DoFs are the vertices; P2 adds one DoF per edge (midpoint), numbered
after the vertices in the order [horizontal edges, vertical edges, diagonal
edges]. DoF counts match the reference exactly: (nx+1)(ny+1) for P1 and
(2nx+1)(2ny+1) for square P2 grids.

Everything here is *setup* code (host, numpy, lazily cached); jit-side
consumers receive plain arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np

from tpuwave.core.quadrature import TriangleQuadrature
from tpuwave.core.shape import SimplexShape, simplex_shape

__all__ = ["StructuredTriMesh", "FeSpace"]


@dataclass(frozen=True)
class StructuredTriMesh:
    nel: Tuple[int, int]
    geometry: Tuple[Tuple[float, float], Tuple[float, float]]

    # -- basic metrics ------------------------------------------------------
    @property
    def nx(self) -> int:
        return self.nel[0]

    @property
    def ny(self) -> int:
        return self.nel[1]

    @property
    def origin(self) -> Tuple[float, float]:
        return self.geometry[0]

    @property
    def extent(self) -> Tuple[float, float]:
        (x0, y0), (x1, y1) = self.geometry
        return (x1 - x0, y1 - y0)

    @property
    def hx(self) -> float:
        return self.extent[0] / self.nx

    @property
    def hy(self) -> float:
        return self.extent[1] / self.ny

    @property
    def n_vertices(self) -> int:
        return (self.nx + 1) * (self.ny + 1)

    @property
    def n_cells(self) -> int:
        return 2 * self.nx * self.ny

    @property
    def center(self) -> Tuple[float, float]:
        (x0, y0), (x1, y1) = self.geometry
        return (0.5 * (x0 + x1), 0.5 * (y0 + y1))

    # -- jacobians (per class: 0 = lower, 1 = upper) ------------------------
    @property
    def det_j(self) -> float:
        """|det J|, identical for both classes: hx * hy."""
        return self.hx * self.hy

    @cached_property
    def jacobians(self) -> np.ndarray:
        """(2, 2, 2) affine maps J (columns = edge vectors v1-v0, v2-v0)."""
        hx, hy = self.hx, self.hy
        j_lower = np.array([[hx, hx], [0.0, hy]])
        j_upper = np.array([[hx, 0.0], [hy, hy]])
        return np.stack([j_lower, j_upper])

    @cached_property
    def jinv_t(self) -> np.ndarray:
        """(2, 2, 2) inverse-transpose Jacobians (map ref grads -> physical)."""
        return np.transpose(np.linalg.inv(self.jacobians), (0, 2, 1))

    # -- connectivity -------------------------------------------------------
    def vertex_index(self, i, j):
        return j * (self.nx + 1) + i

    @cached_property
    def vertex_coords(self) -> np.ndarray:
        """(n_vertices, 2) float64 vertex positions."""
        (x0, y0) = self.origin
        xs = x0 + self.hx * np.arange(self.nx + 1)
        ys = y0 + self.hy * np.arange(self.ny + 1)
        xx, yy = np.meshgrid(xs, ys, indexing="xy")
        return np.stack([xx.ravel(), yy.ravel()], axis=-1)

    @cached_property
    def cells(self) -> np.ndarray:
        """(n_cells, 3) int32 triangle->vertex connectivity."""
        nx, ny = self.nx, self.ny
        if nx * ny >= 1 << 16:  # large meshes: native O(N) builder
            from tpuwave import native
            out = native.p1_cells(nx, ny)
            if out is not None:
                return out
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
        ii, jj = ii.ravel(), jj.ravel()
        v00 = self.vertex_index(ii, jj)
        v10 = self.vertex_index(ii + 1, jj)
        v11 = self.vertex_index(ii + 1, jj + 1)
        v01 = self.vertex_index(ii, jj + 1)
        lower = np.stack([v00, v10, v11], axis=-1)
        upper = np.stack([v00, v11, v01], axis=-1)
        cells = np.stack([lower, upper], axis=1).reshape(-1, 3)
        return cells.astype(np.int32)

    @cached_property
    def boundary_vertex_mask(self) -> np.ndarray:
        nx, ny = self.nx, self.ny
        mask = np.zeros((ny + 1, nx + 1), dtype=bool)
        mask[0, :] = mask[-1, :] = True
        mask[:, 0] = mask[:, -1] = True
        return mask.ravel()

    # -- edges (for P2) -----------------------------------------------------
    @property
    def n_h_edges(self) -> int:
        return self.nx * (self.ny + 1)

    @property
    def n_v_edges(self) -> int:
        return (self.nx + 1) * self.ny

    @property
    def n_d_edges(self) -> int:
        return self.nx * self.ny

    @property
    def n_edges(self) -> int:
        return self.n_h_edges + self.n_v_edges + self.n_d_edges

    def h_edge_index(self, i, j):
        return j * self.nx + i

    def v_edge_index(self, i, j):
        return self.n_h_edges + j * (self.nx + 1) + i

    def d_edge_index(self, i, j):
        return self.n_h_edges + self.n_v_edges + j * self.nx + i

    @cached_property
    def edge_midpoints(self) -> np.ndarray:
        """(n_edges, 2) midpoint coordinates, in edge-index order."""
        (x0, y0) = self.origin
        hx, hy, nx, ny = self.hx, self.hy, self.nx, self.ny

        def grid(ni, nj, off_x, off_y):
            ii, jj = np.meshgrid(np.arange(ni), np.arange(nj), indexing="xy")
            return np.stack([
                x0 + (ii.ravel() + off_x) * hx,
                y0 + (jj.ravel() + off_y) * hy,
            ], axis=-1)

        h = grid(nx, ny + 1, 0.5, 0.0)
        v = grid(nx + 1, ny, 0.0, 0.5)
        d = grid(nx, ny, 0.5, 0.5)
        return np.concatenate([h, v, d], axis=0)

    @cached_property
    def boundary_edge_mask(self) -> np.ndarray:
        """(n_edges,) True for edges lying on the domain boundary."""
        nx, ny = self.nx, self.ny
        h = np.zeros((ny + 1, nx), dtype=bool)
        h[0, :] = h[-1, :] = True
        v = np.zeros((ny, nx + 1), dtype=bool)
        v[:, 0] = v[:, -1] = True
        d = np.zeros((ny, nx), dtype=bool)
        return np.concatenate([h.ravel(), v.ravel(), d.ravel()])

    # -- point location (probe support) -------------------------------------
    def locate_point(self, p) -> Tuple[int, Tuple[float, float]]:
        """Containing cell + reference coords of physical point ``p``.

        Host-side equivalent of ``VectorTools::point_value``'s cell lookup
        (reference WaveEquationBase.cpp:170-222): trivial on the structured
        grid. Points on cell interfaces resolve to the lower-index cell —
        the FE function is continuous, so any containing cell gives the
        same value.
        """
        (x0, y0) = self.origin
        px, py = float(p[0]), float(p[1])
        i = min(max(int(np.floor((px - x0) / self.hx)), 0), self.nx - 1)
        j = min(max(int(np.floor((py - y0) / self.hy)), 0), self.ny - 1)
        # local coordinates within the grid cell
        ax = (px - (x0 + i * self.hx)) / self.hx
        ay = (py - (y0 + j * self.hy)) / self.hy
        if ay <= ax:  # lower triangle (v00, v10, v11): x = xi + eta*hx... map:
            # point = v00 + J_lower @ (xi, eta) with J_lower = [[hx,hx],[0,hy]]
            # => ax = xi + eta, ay = eta
            xi, eta = ax - ay, ay
            cell = 2 * (j * self.nx + i)
        else:  # upper triangle (v00, v11, v01): J_upper = [[hx,0],[hy,hy]]
            # => ax = xi, ay = xi + eta
            xi, eta = ax, ay - ax
            cell = 2 * (j * self.nx + i) + 1
        return cell, (xi, eta)


class FeSpace:
    """P1/P2 Lagrange space on a StructuredTriMesh.

    Provides the global DoF layout, boundary masks, support points (for
    nodal interpolation, reference ``VectorTools::interpolate``), cell->DoF
    connectivity, and per-class physical shape data at a quadrature rule.
    """

    def __init__(self, mesh: StructuredTriMesh, degree: int):
        if degree not in (1, 2):
            raise ValueError("Only P1 and P2 are supported")
        self.mesh = mesh
        self.degree = degree

    @property
    def n_local_dofs(self) -> int:
        return 3 if self.degree == 1 else 6

    @property
    def n_dofs(self) -> int:
        if self.degree == 1:
            return self.mesh.n_vertices
        return self.mesh.n_vertices + self.mesh.n_edges

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """(n_cells, nloc) int32 cell -> global DoF connectivity."""
        m = self.mesh
        if self.degree == 1:
            return m.cells
        nx, ny = m.nx, m.ny
        if nx * ny >= 1 << 16:
            from tpuwave import native
            out = native.p2_cell_dofs(nx, ny)
            if out is not None:
                return out
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
        ii, jj = ii.ravel(), jj.ravel()
        nv = m.n_vertices
        # lower (v00, v10, v11): e01 = h(i,j), e12 = v(i+1,j), e20 = d(i,j)
        lower_edges = np.stack([
            nv + m.h_edge_index(ii, jj),
            nv + m.v_edge_index(ii + 1, jj),
            nv + m.d_edge_index(ii, jj),
        ], axis=-1)
        # upper (v00, v11, v01): e01 = d(i,j), e12 = h(i,j+1), e20 = v(i,j)
        upper_edges = np.stack([
            nv + m.d_edge_index(ii, jj),
            nv + m.h_edge_index(ii, jj + 1),
            nv + m.v_edge_index(ii, jj),
        ], axis=-1)
        cells3 = m.cells.reshape(-1, 2, 3)
        lower = np.concatenate([cells3[:, 0, :], lower_edges], axis=-1)
        upper = np.concatenate([cells3[:, 1, :], upper_edges], axis=-1)
        out = np.stack([lower, upper], axis=1).reshape(-1, self.n_local_dofs)
        return out.astype(np.int32)

    @cached_property
    def dof_coords(self) -> np.ndarray:
        """(n_dofs, 2) support points (vertices [+ edge midpoints])."""
        if self.degree == 1:
            return self.mesh.vertex_coords
        return np.concatenate([self.mesh.vertex_coords,
                               self.mesh.edge_midpoints], axis=0)

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        """(n_dofs,) True at DoFs on the Dirichlet boundary (all of dOmega)."""
        if self.degree == 1:
            return self.mesh.boundary_vertex_mask
        return np.concatenate([self.mesh.boundary_vertex_mask,
                               self.mesh.boundary_edge_mask])

    def shape_at(self, quad: TriangleQuadrature) -> SimplexShape:
        return simplex_shape(self.degree, quad.points)

    def physical_grads(self, shape: SimplexShape) -> np.ndarray:
        """(2, Q, nloc, 2) physical-space shape gradients per element class."""
        # grads_phys[c, q, i, :] = jinv_t[c] @ grads_ref[q, i, :]
        return np.einsum("cab,qib->cqia", self.mesh.jinv_t, shape.grads)

    def quad_offsets(self, quad: TriangleQuadrature) -> np.ndarray:
        """(2, Q, 2) offsets of quadrature points from the cell anchor v00."""
        return np.einsum("cab,qb->cqa", self.mesh.jacobians, quad.points)

    def eval_basis_at(self, cell: int, ref_point) -> Tuple[np.ndarray, np.ndarray]:
        """(dofs, values) of all shape functions of ``cell`` at a ref point."""
        sh = simplex_shape(self.degree, np.asarray(ref_point, dtype=np.float64))
        return self.cell_dofs[cell], sh.values[0]
