"""Grid-stencil operators: the P1 structured-mesh fast path.

On the structured triangulated rectangle, P1 DoFs ARE the vertex grid
(ny+1, nx+1), and for constant wave speed both M and K reduce to CONSTANT
7-point stencils (the diagonal split couples (+1,+1) and (-1,-1) but not
the anti-diagonal). Applying K then costs ~7 shifted adds over a 2D array:
no gathers, no connectivity traffic, elementwise work at memory-streaming
speed (vs. the reference's CSR SpMV, src/WaveTheta.cpp:127-135).

Boundary-row caveat: the shifted adds wrap cyclically (jnp.roll semantics),
so ONLY interior rows of the result are exact. Every solver use masks
boundary rows anyway (Dirichlet elimination overrides them), so this is
free; diagnostics that need exact boundary rows (energy) use the
element-operator path.

Sharding: under `jax.sharding`/GSPMD the rolls lower to collective-permute
halo exchanges between devices automatically — this module contains no
explicit communication code.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace

__all__ = [
    "class_matrices_to_stencil",
    "apply_stencil",
    "apply_stencil_diff",
    "stencil_diag_interior",
    "lumped_mass_grid",
    "boundary_mask_grid",
    "GridStencilOperator",
]

# local DoF -> (di, dj) grid offset from the cell anchor v00, per class
_P1_OFFSETS = (
    ((0, 0), (1, 0), (1, 1)),  # lower triangle (v00, v10, v11)
    ((0, 0), (1, 1), (0, 1)),  # upper triangle (v00, v11, v01)
)


def class_matrices_to_stencil(a_class: np.ndarray) -> np.ndarray:
    """(2, 3, 3) per-class element matrices -> (3, 3) stencil coefficients.

    Output s[1 + dj, 1 + di] is the coupling of an INTERIOR node to its
    neighbour at grid offset (di, dj): the sum of A[i, j] over the six
    incident triangles where local i sits on the node and local j on the
    neighbour.
    """
    a = np.asarray(a_class)
    s = np.zeros((3, 3))
    for k in range(2):
        offs = _P1_OFFSETS[k]
        for i in range(3):
            for j in range(3):
                di = offs[j][0] - offs[i][0]
                dj = offs[j][1] - offs[i][1]
                s[1 + dj, 1 + di] += a[k, i, j]
    return s


def apply_stencil(u: jax.Array, s) -> jax.Array:
    """y[n] = sum_d s[d] * u[n + d] with cyclic wrap (rows: y, cols: x).

    Exact for interior nodes; boundary rows carry wrapped garbage that the
    callers mask. The nine shifted adds fuse into a single elementwise XLA
    kernel; shifts across shard boundaries become collective-permutes.
    """
    out = s[1][1] * u
    # axis 0 = y (dj), axis 1 = x (di); u[n + d] = roll(u, -d)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if (di, dj) == (0, 0):
                continue
            c = s[1 + dj][1 + di]
            if c == 0.0:
                continue
            shifted = jnp.roll(u, shift=(-dj, -di), axis=(0, 1))
            out = out + c * shifted
    return out


def apply_stencil_diff(u: jax.Array, s) -> jax.Array:
    """Zero-row-sum stencil in DIFFERENCE form:
    y[n] = sum_{d != 0} s[d] * (u[n + d] - u[n]).

    Algebraically equal to apply_stencil when the stencil rows sum to
    zero (s[1][1] == -sum of neighbours — true for every stiffness
    stencil: K * const = 0), and numerically quieter in f32: each
    neighbour difference rounds at eps * |u[n+d] - u[n]| ~ eps * h|grad u|
    instead of eps * |u|, removing the ARITHMETIC cancellation noise of
    the direct form. Measured gain on smooth fields is ~1.4x in total
    noise — the remaining (dominant) part is the input's f32
    representation noise propagated through K, which no evaluation order
    can remove. Same wrap caveat as apply_stencil; callers mask boundary
    rows.
    """
    out = None
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if (di, dj) == (0, 0):
                continue
            c = s[1 + dj][1 + di]
            if c == 0.0:
                continue
            shifted = jnp.roll(u, shift=(-dj, -di), axis=(0, 1))
            t = c * (shifted - u)
            out = t if out is None else out + t
    return out if out is not None else jnp.zeros_like(u)


def stencil_diag_interior(s) -> float:
    """The (constant) interior diagonal entry."""
    return float(np.asarray(s)[1, 1])


def lumped_mass_grid(space: FeSpace) -> np.ndarray:
    """(ny+1, nx+1) row-sum lumped mass, exact INCLUDING boundary rows.

    Each triangle contributes |T|/3 = detJ/6 to each of its vertices, so
    the lumped value is detJ/6 x (#incident triangles): 6 in the interior,
    3 on edges, and 1 or 2 at corners depending on the diagonal direction.
    """
    m = space.mesh
    nx, ny = m.nx, m.ny
    base = m.det_j / 6.0
    plane = np.full((ny + 1, nx + 1), 6.0)
    plane[0, :] = plane[-1, :] = 3.0
    plane[:, 0] = plane[:, -1] = 3.0
    plane[0, 0] = plane[-1, -1] = 2.0   # corners on the diagonal
    plane[0, -1] = plane[-1, 0] = 1.0   # corners off the diagonal
    return base * plane


def boundary_mask_grid(space: FeSpace) -> np.ndarray:
    """(ny+1, nx+1) boolean Dirichlet mask."""
    m = space.mesh
    mask = np.zeros((m.ny + 1, m.nx + 1), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return mask


class GridStencilOperator:
    """Constant-stencil operator with the same call surface as
    MatrixFreeOperator, acting on (ny+1, nx+1) grid arrays.

    ``diag`` is the interior diagonal broadcast everywhere — boundary rows
    are only ever used through Dirichlet elimination, where any nonzero
    diagonal yields x_b = g_b exactly.
    """

    def __init__(self, stencil: np.ndarray, shape: Tuple[int, int], dtype):
        self.stencil = tuple(tuple(float(c) for c in row) for row in np.asarray(stencil))
        self.shape = shape
        self.dtype = dtype

    def __call__(self, u):
        return apply_stencil(u, self.stencil)

    def diagonal(self):
        return jnp.full(self.shape, self.stencil[1][1], dtype=self.dtype)

    def axpy(self, coef: float, other: "GridStencilOperator") -> "GridStencilOperator":
        s = np.asarray(self.stencil) + coef * np.asarray(other.stencil)
        return GridStencilOperator(s, self.shape, self.dtype)


# ---------------------------------------------------------------------------
# variable-coefficient (per-element-scaled) stencil planes
# ---------------------------------------------------------------------------

#: corner offsets (x, y) of the two triangle classes per structured grid
#: cell (core/mesh.py::cells: lower (v00, v10, v11), upper (v00, v11, v01))
P1_CLASS_CORNERS = (((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1)))


def assemble_varcoef_planes(s, g_class_np, ny: int, nx: int, dtype):
    """Assembled variable-coefficient 9-point stencil on the vertex grid.

    ``s``: (ny, nx, 2) per-element scales (already det_j * sum_q w_q c^2,
    one per triangle class); ``g_class_np``: (2, 3, 3) reference-gradient
    products (q-independent for P1). Returns ``{(dx, dy): w_d}`` planes
    of shape (ny+1, nx+1) with ``y[I] = sum_d w_d[I] * u[I + d]``. Linear
    (hence differentiable/traceable) in ``s``; interior-exact, boundary
    rows must be masked by the caller. Shared by the FWI propagators
    (models/inverse.py) and the time-dependent-c fast path
    (models/fast.py::leapfrog_step_tdep).
    """
    planes = {}
    for k in range(2):
        sk = s[..., k]
        for i in range(3):
            oix, oiy = P1_CLASS_CORNERS[k][i]
            for j in range(3):
                g = float(g_class_np[k, i, j])
                if g == 0.0:
                    continue
                ojx, ojy = P1_CLASS_CORNERS[k][j]
                d = (ojx - oix, ojy - oiy)
                if d not in planes:
                    planes[d] = jnp.zeros((ny + 1, nx + 1), dtype)
                planes[d] = planes[d].at[oiy:oiy + ny,
                                         oix:oix + nx].add(g * sk)
    return planes


def apply_varcoef_planes(planes, ug):
    """y = sum_d w_d * roll(u, -d) on the (ny+1, nx+1) vertex grid (same
    wrap-garbage-on-boundary caveat as :func:`apply_stencil`)."""
    out = planes[(0, 0)] * ug
    for (dx, dy), w in planes.items():
        if (dx, dy) == (0, 0):
            continue
        out = out + w * jnp.roll(ug, shift=(-dy, -dx), axis=(0, 1))
    return out
