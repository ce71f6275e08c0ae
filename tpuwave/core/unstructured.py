"""Unstructured simplicial mesh import + P1/P2 space on general geometry.

Brings the reference's declared-but-dormant ``Mesh File Name`` parameter
(ParameterReader.cpp:51-54 — declared with a ``mesh-square-40.msh`` default
yet never read back; setup always regenerates the structured rectangle,
WaveEquationBase.cpp:37-72) to life: tpuwave can solve on a general
unstructured triangle mesh imported from a Gmsh ``.msh`` file (ASCII v2.2
or v4.1) or a legacy-ASCII VTK triangulation (the format both the reference
and :func:`tpuwave.utils.vtu.write_mesh_vtk` emit).

Unlike :class:`tpuwave.core.mesh.StructuredTriMesh`, whose two congruent
element classes make all geometry compile-time constants, a general mesh
carries per-cell affine Jacobians. The consequence: operators
are built as per-cell element matrices (``a_full``) feeding the same
gather -> batched-matvec -> segment_sum matrix-free path
(ops/operators.py); geometry lives in device memory as (n_cells, ...) arrays,
traversal is still one fused XLA program with zero host round-trips.

Everything here is host-side setup code (numpy, lazily cached); jit-side
consumers receive plain arrays.
"""

from __future__ import annotations

from functools import cached_property
from pathlib import Path
from typing import Tuple

import numpy as np

from tpuwave.core.quadrature import TriangleQuadrature
from tpuwave.core.shape import SimplexShape, simplex_shape

__all__ = ["read_mesh_file", "write_msh", "detect_structured",
           "UnstructuredTriMesh", "UnstructuredFeSpace"]


# ---------------------------------------------------------------------------
# mesh file readers
# ---------------------------------------------------------------------------

def read_mesh_file(path) -> "UnstructuredTriMesh":
    """Read a triangle mesh from ``path`` (.msh Gmsh ASCII 2.2/4.1, or
    legacy ASCII VTK with CELL_TYPES 5). Returns an UnstructuredTriMesh.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Mesh file not found: {path}")
    text = path.read_bytes().decode("utf-8", errors="replace")
    if "$MeshFormat" in text:
        points, cells = _parse_msh(text, path)
    elif "DATASET UNSTRUCTURED_GRID" in text:
        points, cells = _parse_legacy_vtk(text, path)
    else:
        raise ValueError(
            f"Unrecognised mesh format in {path}: expected a Gmsh $MeshFormat "
            "header or a legacy-VTK 'DATASET UNSTRUCTURED_GRID'")
    return UnstructuredTriMesh(points, cells, name=path.stem)


def _parse_msh(text: str, path: Path):
    lines = text.splitlines()
    sections = {}
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        if ln.startswith("$") and not ln.startswith("$End"):
            name = ln[1:]
            j = i + 1
            while j < len(lines) and lines[j].strip() != f"$End{name}":
                j += 1
            sections[name] = lines[i + 1:j]
            i = j + 1
        else:
            i += 1
    if "MeshFormat" not in sections:
        raise ValueError(f"{path}: missing $MeshFormat")
    fmt = sections["MeshFormat"][0].split()
    version = float(fmt[0])
    if int(fmt[1]) != 0:
        raise ValueError(f"{path}: binary .msh is not supported (ASCII only)")
    if "Nodes" not in sections or "Elements" not in sections:
        raise ValueError(f"{path}: missing $Nodes/$Elements")
    if version >= 4.0:
        return _parse_msh4(sections, path)
    return _parse_msh2(sections, path)


def _parse_msh2(sections, path: Path):
    node_lines = sections["Nodes"]
    n_nodes = int(node_lines[0].split()[0])
    ids = np.empty(n_nodes, dtype=np.int64)
    pts = np.empty((n_nodes, 2), dtype=np.float64)
    z_max = 0.0
    for k in range(n_nodes):
        parts = node_lines[1 + k].split()
        ids[k] = int(parts[0])
        pts[k] = (float(parts[1]), float(parts[2]))
        z_max = max(z_max, abs(float(parts[3])))
    _check_planar(z_max, pts, path)
    id_map = {int(i): k for k, i in enumerate(ids)}

    elem_lines = sections["Elements"]
    n_elems = int(elem_lines[0].split()[0])
    tris = []
    for k in range(n_elems):
        parts = elem_lines[1 + k].split()
        etype = int(parts[1])
        if etype != 2:      # keep 3-node triangles; skip points/lines/quads
            continue
        ntags = int(parts[2])
        nodes = parts[3 + ntags:3 + ntags + 3]
        tris.append([id_map[int(n)] for n in nodes])
    if not tris:
        raise ValueError(f"{path}: no 3-node triangles in $Elements")
    return pts, np.asarray(tris, dtype=np.int32)


def _parse_msh4(sections, path: Path):
    node_lines = sections["Nodes"]
    header = node_lines[0].split()
    n_blocks, n_nodes = int(header[0]), int(header[1])
    ids = np.empty(n_nodes, dtype=np.int64)
    pts = np.empty((n_nodes, 2), dtype=np.float64)
    z_max = 0.0
    row = 1
    out = 0
    for _ in range(n_blocks):
        blk = node_lines[row].split()
        n_in_block = int(blk[3])
        row += 1
        blk_ids = [int(node_lines[row + k]) for k in range(n_in_block)]
        row += n_in_block
        for k in range(n_in_block):
            parts = node_lines[row + k].split()
            ids[out] = blk_ids[k]
            pts[out] = (float(parts[0]), float(parts[1]))
            z_max = max(z_max, abs(float(parts[2])))
            out += 1
        row += n_in_block
    _check_planar(z_max, pts, path)
    id_map = {int(i): k for k, i in enumerate(ids)}

    elem_lines = sections["Elements"]
    header = elem_lines[0].split()
    n_blocks = int(header[0])
    row = 1
    tris = []
    for _ in range(n_blocks):
        blk = elem_lines[row].split()
        etype, n_in_block = int(blk[2]), int(blk[3])
        row += 1
        if etype == 2:
            for k in range(n_in_block):
                parts = elem_lines[row + k].split()
                tris.append([id_map[int(n)] for n in parts[1:4]])
        row += n_in_block
    if not tris:
        raise ValueError(f"{path}: no 3-node triangles in $Elements")
    return pts, np.asarray(tris, dtype=np.int32)


def _check_planar(z_max: float, pts_xy, path: Path):
    """tpuwave solves the 2D problem: reject meshes that live off z = 0
    (a tet-volume or curved-surface export would otherwise import as a
    silently-flattened, overlapping 2D triangulation)."""
    extent = float(np.abs(pts_xy).max(initial=1.0))
    if z_max > 1e-10 * max(extent, 1.0):
        raise ValueError(
            f"{path}: mesh is not planar (|z| up to {z_max:g}); tpuwave "
            "solves the 2D wave equation on z = 0 meshes only")


def _parse_legacy_vtk(text: str, path: Path):
    tokens = text.split()
    def find(kw):
        try:
            return tokens.index(kw)
        except ValueError:
            raise ValueError(f"{path}: legacy VTK missing {kw}") from None

    ip = find("POINTS")
    n_pts = int(tokens[ip + 1])
    vals = np.asarray(tokens[ip + 3:ip + 3 + 3 * n_pts], dtype=np.float64)
    pts3 = vals.reshape(n_pts, 3)
    _check_planar(float(np.abs(pts3[:, 2]).max(initial=0.0)), pts3[:, :2], path)
    pts = pts3[:, :2].copy()

    ic = find("CELLS")
    n_cells = int(tokens[ic + 1])
    it = find("CELL_TYPES")
    ctypes = np.asarray(tokens[it + 2:it + 2 + n_cells], dtype=np.int64)
    conn = []
    pos = ic + 3
    for k in range(n_cells):
        n_loc = int(tokens[pos])
        if ctypes[k] == 5:          # VTK_TRIANGLE
            conn.append([int(tokens[pos + 1 + j]) for j in range(3)])
        pos += 1 + n_loc
    if not conn:
        raise ValueError(f"{path}: no VTK_TRIANGLE cells")
    return pts, np.asarray(conn, dtype=np.int32)


def detect_structured(mesh: "UnstructuredTriMesh", *, tol: float = 1e-12):
    """Recognise an imported mesh as the structured rectangle triangulation.

    Returns ``(nel, geometry)`` when ``mesh`` is — up to vertex and cell
    renumbering — exactly the grid that
    :class:`~tpuwave.core.mesh.StructuredTriMesh` generates (the deal.II
    ``subdivided_hyper_rectangle_with_simplices`` layout the reference
    always solves on, WaveEquationBase.cpp:42-46): a uniform (nx+1)x(ny+1)
    vertex lattice with every grid square split along its lower-left ->
    upper-right diagonal. Returns ``None`` otherwise (perturbed vertices,
    flipped/mixed diagonals, holes, genuinely unstructured meshes).

    Coordinates may differ from the exact lattice by IO roundoff: the
    match tolerance is ``tol`` relative to the coordinate/extent scale
    (Gmsh ASCII roundtrips at 16 significant digits sit at ~1e-16).
    A positive match lets the solvers run the class-constant structured
    engines (stencil operators, ``--precond mg``) instead
    of the per-cell-geometry general path — same triangulation, so the
    discrete problem is identical.
    """
    pts = mesh.vertex_coords
    n = pts.shape[0]
    if n < 4:
        return None
    (x0, y0), (x1, y1) = mesh.bbox
    ex, ey = x1 - x0, y1 - y0
    if ex <= 0.0 or ey <= 0.0:
        return None
    atol = (max(abs(x0), abs(x1), abs(y0), abs(y1)) + max(ex, ey)) * tol
    # lattice dimensions from the bottom-row / left-column vertex counts;
    # any miscount here is caught by the index-uniqueness check below
    nx = int(np.count_nonzero(pts[:, 1] <= y0 + atol)) - 1
    ny = int(np.count_nonzero(pts[:, 0] <= x0 + atol)) - 1
    if nx < 1 or ny < 1:
        return None
    if (nx + 1) * (ny + 1) != n or mesh.n_cells != 2 * nx * ny:
        return None
    hx, hy = ex / nx, ey / ny
    if atol >= 0.25 * min(hx, hy):  # tolerance must stay well below a cell
        return None
    i = np.rint((pts[:, 0] - x0) / hx).astype(np.int64)
    j = np.rint((pts[:, 1] - y0) / hy).astype(np.int64)
    if (np.abs(pts[:, 0] - (x0 + i * hx)) > atol).any():
        return None
    if (np.abs(pts[:, 1] - (y0 + j * hy)) > atol).any():
        return None
    perm = (j * (nx + 1) + i).astype(np.int64)  # imported vid -> lattice vid
    if not (np.bincount(perm, minlength=n) == 1).all():
        return None
    # triangulation match: compare the vertex-id SETS of the triangles
    # (element matrices are invariant under local vertex reordering, so
    # only the set of triangles matters)
    from tpuwave.core.mesh import StructuredTriMesh
    geometry = ((x0, y0), (x1, y1))
    ref = StructuredTriMesh((nx, ny), geometry)
    want = np.sort(ref.cells.astype(np.int64), axis=1)
    got = np.sort(perm[mesh.cells], axis=1)
    want = want[np.lexsort(want.T)]
    got = got[np.lexsort(got.T)]
    if not np.array_equal(want, got):
        return None
    return (nx, ny), geometry


def write_msh(path, points, cells) -> Path:
    """Write a triangle mesh as Gmsh ASCII v2.2 (readable by Gmsh, deal.II's
    GridIn, and :func:`read_mesh_file`)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(points, dtype=np.float64)
    cls = np.asarray(cells, dtype=np.int64)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat",
             "$Nodes", str(pts.shape[0])]
    for k, p in enumerate(pts):
        lines.append(f"{k + 1} {p[0]:.16g} {p[1]:.16g} 0")
    lines += ["$EndNodes", "$Elements", str(cls.shape[0])]
    for k, c in enumerate(cls):
        lines.append(f"{k + 1} 2 2 0 1 {c[0] + 1} {c[1] + 1} {c[2] + 1}")
    lines += ["$EndElements", ""]
    path.write_text("\n".join(lines))
    return path


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

class UnstructuredTriMesh:
    """General conforming triangle mesh with per-cell affine geometry.

    Mirrors the :class:`~tpuwave.core.mesh.StructuredTriMesh` surface where
    the consumers need it (n_vertices/n_cells/cells/vertex_coords/
    boundary_vertex_mask/edge data/locate_point/center), but every
    geometric quantity is a per-cell array. Cells are re-oriented
    counter-clockwise on construction so all Jacobian determinants are
    positive.
    """

    def __init__(self, points, cells, name: str = "unstructured"):
        pts = np.asarray(points, dtype=np.float64)
        cls = np.array(cells, dtype=np.int32)   # copy: orientation fix below
                                                # must not mutate the caller
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError("points must be (n, 2)")
        if cls.ndim != 2 or cls.shape[1] != 3:
            raise ValueError("cells must be (m, 3)")
        if cls.min() < 0 or cls.max() >= pts.shape[0]:
            raise ValueError("cell connectivity indexes out of range")
        # enforce CCW orientation (positive det) without changing the mesh
        v = pts[cls]
        det = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        if np.any(det == 0.0):
            raise ValueError("mesh contains degenerate (zero-area) triangles")
        flip = det < 0.0
        cls[flip] = cls[flip][:, [0, 2, 1]]
        self.name = name
        self._points = pts
        self._cells = cls

    # -- basic metrics ------------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._points.shape[0]

    @property
    def n_cells(self) -> int:
        return self._cells.shape[0]

    @cached_property
    def vertex_coords(self) -> np.ndarray:
        return self._points

    @cached_property
    def cells(self) -> np.ndarray:
        return self._cells

    @cached_property
    def bbox(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        lo = self._points.min(axis=0)
        hi = self._points.max(axis=0)
        return (float(lo[0]), float(lo[1])), (float(hi[0]), float(hi[1]))

    @property
    def center(self) -> Tuple[float, float]:
        (x0, y0), (x1, y1) = self.bbox
        return (0.5 * (x0 + x1), 0.5 * (y0 + y1))

    @cached_property
    def h_max(self) -> float:
        v = self._points[self._cells]
        e = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1],
                      v[:, 0] - v[:, 2]])
        return float(np.sqrt((e ** 2).sum(-1)).max())

    # -- per-cell affine geometry ------------------------------------------
    @cached_property
    def jacobians(self) -> np.ndarray:
        """(n_cells, 2, 2) affine maps (columns = edge vectors v1-v0, v2-v0)."""
        v = self._points[self._cells]
        return np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=-1)

    @cached_property
    def det_j(self) -> np.ndarray:
        """(n_cells,) Jacobian determinants (positive after orientation fix)."""
        j = self.jacobians
        return j[:, 0, 0] * j[:, 1, 1] - j[:, 0, 1] * j[:, 1, 0]

    @cached_property
    def jinv_t(self) -> np.ndarray:
        """(n_cells, 2, 2) inverse-transpose Jacobians."""
        j = self.jacobians
        d = self.det_j
        inv = np.empty_like(j)
        inv[:, 0, 0] = j[:, 1, 1] / d
        inv[:, 0, 1] = -j[:, 0, 1] / d
        inv[:, 1, 0] = -j[:, 1, 0] / d
        inv[:, 1, 1] = j[:, 0, 0] / d
        return np.transpose(inv, (0, 2, 1))

    # -- edges (P2 DoFs + boundary detection) -------------------------------
    @cached_property
    def _edge_data(self):
        c = self._cells
        raw = np.concatenate([c[:, [0, 1]], c[:, [1, 2]], c[:, [2, 0]]])
        key = np.sort(raw.astype(np.int64), axis=1)
        uniq, inverse, counts = np.unique(key, axis=0, return_inverse=True,
                                          return_counts=True)
        cell_edges = inverse.reshape(3, -1).T.astype(np.int32)  # (C,3): 01,12,20
        return uniq.astype(np.int32), cell_edges, counts

    @property
    def edges(self) -> np.ndarray:
        """(n_edges, 2) unique edges as sorted vertex pairs."""
        return self._edge_data[0]

    @property
    def cell_edges(self) -> np.ndarray:
        """(n_cells, 3) edge ids in local order (e01, e12, e20)."""
        return self._edge_data[1]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @cached_property
    def boundary_edge_mask(self) -> np.ndarray:
        """(n_edges,) True on edges adjacent to exactly one cell."""
        counts = self._edge_data[2]
        if counts.max() > 2:
            raise ValueError("non-conforming mesh: edge shared by >2 cells")
        return counts == 1

    @cached_property
    def boundary_vertex_mask(self) -> np.ndarray:
        mask = np.zeros(self.n_vertices, dtype=bool)
        mask[self.edges[self.boundary_edge_mask].ravel()] = True
        return mask

    @cached_property
    def edge_midpoints(self) -> np.ndarray:
        return 0.5 * (self._points[self.edges[:, 0]] +
                      self._points[self.edges[:, 1]])

    # -- point location (probe support) -------------------------------------
    def locate_point(self, p) -> Tuple[int, Tuple[float, float]]:
        """Containing cell + reference coords of physical point ``p``.

        Host-side brute-force barycentric search (setup-time only — the
        probe location is fixed for a run). Points on interfaces resolve
        to the least-violation cell; the FE function is continuous so any
        containing cell gives the same value.
        """
        p = np.asarray(p, dtype=np.float64)
        v0 = self._points[self._cells[:, 0]]
        rhs = p[None, :] - v0                       # (C, 2)
        j = self.jacobians
        d = self.det_j
        xi = (j[:, 1, 1] * rhs[:, 0] - j[:, 0, 1] * rhs[:, 1]) / d
        eta = (-j[:, 1, 0] * rhs[:, 0] + j[:, 0, 0] * rhs[:, 1]) / d
        violation = np.maximum.reduce([
            -xi, -eta, xi + eta - 1.0, np.zeros_like(xi)])
        cell = int(np.argmin(violation))
        if violation[cell] > 1e-9:
            # bbox centre of a non-convex domain (annulus, L-shape) can
            # fall outside the mesh; the basis would then EXTRAPOLATE
            import warnings
            warnings.warn(
                f"point {tuple(p)} lies outside the mesh (nearest-cell "
                f"reference-coordinate violation {violation[cell]:.3g}); "
                "probe values will extrapolate", stacklevel=2)
        return cell, (float(xi[cell]), float(eta[cell]))


# ---------------------------------------------------------------------------
# FE space
# ---------------------------------------------------------------------------

class UnstructuredFeSpace:
    """P1/P2 Lagrange space on an UnstructuredTriMesh.

    Same public surface as :class:`tpuwave.core.mesh.FeSpace` except that
    the physical shape data is per-cell: ``physical_grads`` returns
    (n_cells, Q, nloc, 2) and ``quad_points`` gives (n_cells, Q, 2)
    physical quadrature coordinates directly (no anchor/offset split —
    that trick only pays when offsets are class-constant).
    """

    def __init__(self, mesh: UnstructuredTriMesh, degree: int):
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
        """(n_cells, nloc) int32; P2 edge DoFs in local order (e01, e12, e20)
        matching shape.P2_EDGES."""
        m = self.mesh
        if self.degree == 1:
            return m.cells
        return np.concatenate(
            [m.cells, m.n_vertices + m.cell_edges], axis=1).astype(np.int32)

    @cached_property
    def dof_coords(self) -> np.ndarray:
        if self.degree == 1:
            return self.mesh.vertex_coords
        return np.concatenate([self.mesh.vertex_coords,
                               self.mesh.edge_midpoints], axis=0)

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        if self.degree == 1:
            return self.mesh.boundary_vertex_mask
        return np.concatenate([self.mesh.boundary_vertex_mask,
                               self.mesh.boundary_edge_mask])

    def shape_at(self, quad: TriangleQuadrature) -> SimplexShape:
        return simplex_shape(self.degree, quad.points)

    def physical_grads(self, shape: SimplexShape) -> np.ndarray:
        """(n_cells, Q, nloc, 2) physical-space shape gradients per cell."""
        return np.einsum("cab,qib->cqia", self.mesh.jinv_t, shape.grads)

    def quad_points(self, quad: TriangleQuadrature) -> np.ndarray:
        """(n_cells, Q, 2) physical quadrature coordinates."""
        v0 = self.mesh.vertex_coords[self.mesh.cells[:, 0]]
        off = np.einsum("cab,qb->cqa", self.mesh.jacobians, quad.points)
        return v0[:, None, :] + off

    def eval_basis_at(self, cell: int, ref_point):
        """(dofs, values) of all shape functions of ``cell`` at a ref point."""
        sh = simplex_shape(self.degree, np.asarray(ref_point, dtype=np.float64))
        return self.cell_dofs[cell], sh.values[0]
