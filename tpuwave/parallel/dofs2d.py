"""2-D block DoF partition for unstructured (imported-mesh) operators.

:mod:`tpuwave.parallel.dofs` partitions DoFs into 1-D y-bands with ±1
neighbor ghost exchange — O(n_dofs/n_devices) memory, but bands thinner
than one cell (very wide-and-short meshes at high device counts) violate
its neighbor-only assumption. This module is the 2-D generalisation: cells
and DoFs are partitioned into a (py, px) grid of blocks cut at GLOBAL
centroid quantiles, and the ghost exchange runs over the 8-neighbor block
graph — one ``ppermute`` per occupied direction, nearest-neighbor device
traffic only, exactly like the 1-D engine but with the neighbor set
{±1, ±px, ±px±1} instead of {±1}.

Key invariants (mirroring parallel/dofs.py):

* vectors live in a banded padded layout (n_blocks * max_own,), sharded
  P('d') over a 1-D device axis of all py*px devices — the 2-D structure
  lives purely in the partition and the permutation graph;
* a DoF is OWNED by the block containing its coordinate (same global
  quantile cuts as the cell split), so any cell of block b only touches
  DoFs owned by b's 3x3 block neighborhood as long as blocks are wider
  than one cell — validated at plan build, with a clear error otherwise;
* padding send-slots index local DoF 0 and carry zero contributions
  (unreferenced ghost slots accumulate nothing), so the padded exchange
  is exact.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["DofPlan2D", "build_dof_plan_2d", "ShardedDofOperator2D"]

#: ghost direction offsets (dy, dx): the receiver's ghosts are owned by
#: the block at (by + dy, bx + dx)
_OFFSETS = ((0, 1), (0, -1), (1, 0), (-1, 0),
            (1, 1), (1, -1), (-1, 1), (-1, -1))


class DofPlan2D(NamedTuple):
    """Host-side 2-D partition plan (all numpy; built once per mesh)."""
    shape: Tuple[int, int]       # (py, px) block grid
    n_dofs: int
    n_vec: int                   # n_blocks * max_own
    max_own: int
    max_cells: int
    g_max: Tuple[int, ...]       # ghost count per direction (len 8)
    new_of_old: np.ndarray       # (n_dofs,) old dof id -> banded id
    cell_perm: np.ndarray        # (n_blocks*max_cells,) old cell id, -1 pad
    local_cell_dofs: np.ndarray  # (n_blocks*max_cells, nloc) local slots
    send: np.ndarray             # (n_blocks, sum(g_max)) local ids to send,
                                 # column-segmented per direction
    pad_mask: np.ndarray         # (n_vec,) True on padding slots

    def to_banded(self, v, dtype=None):
        v = jnp.asarray(v, dtype=dtype)
        out = jnp.zeros(self.n_vec, dtype=v.dtype)
        return out.at[jnp.asarray(self.new_of_old)].set(v)

    def from_banded(self, vb):
        return jnp.asarray(vb)[jnp.asarray(self.new_of_old)]


def _quantile_cuts(vals, n):
    """n-1 interior cut points splitting ``vals`` into n balanced groups."""
    qs = np.linspace(0.0, 1.0, n + 1)[1:-1]
    return np.quantile(vals, qs) if len(qs) else np.empty(0)


def build_dof_plan_2d(cell_dofs, n_dofs: int, centroids, dof_coords,
                      shape: Tuple[int, int]) -> DofPlan2D:
    """Partition into a (py, px) block grid at global centroid quantiles.

    ``centroids``: (n_cells, 2) cell centroid coordinates;
    ``dof_coords``: (n_dofs, 2) DoF support points (owners are assigned
    by coordinate against the same cuts). Raises ``ValueError`` when a
    cell touches a DoF outside its 3x3 block neighborhood (blocks
    thinner than one cell) — fall back to fewer devices or the 1-D/cell
    engines there.
    """
    py, px = int(shape[0]), int(shape[1])
    if py < 1 or px < 1:
        raise ValueError("block grid must be at least 1x1")
    cells = np.asarray(cell_dofs, dtype=np.int64)
    n_cells, nloc = cells.shape
    cen = np.asarray(centroids, dtype=float)
    dc = np.asarray(dof_coords, dtype=float)
    n_blocks = py * px

    cuts_x = _quantile_cuts(cen[:, 0], px)
    cuts_y = _quantile_cuts(cen[:, 1], py)

    def classify(xy):
        bx = np.searchsorted(cuts_x, xy[:, 0], side="right")
        by = np.searchsorted(cuts_y, xy[:, 1], side="right")
        return by * px + bx, by, bx

    cell_blk, cell_by, cell_bx = classify(cen)
    own_blk, own_by, own_bx = classify(dc)

    # neighbor-only validation: every (cell block, dof owner) pair must
    # differ by <= 1 per axis
    dby = np.abs(cell_by[:, None] - own_by[cells])
    dbx = np.abs(cell_bx[:, None] - own_bx[cells])
    bad = (dby > 1) | (dbx > 1)
    if bad.any():
        raise ValueError(
            f"{int(bad.any(axis=1).sum())} cells touch DoFs outside their "
            f"3x3 block neighborhood on the {py}x{px} grid — blocks are "
            "thinner than one cell; use fewer devices or the 1-D band / "
            "cell-sharded engines for this mesh")

    own_lists = [np.flatnonzero(own_blk == b) for b in range(n_blocks)]
    max_own = max(max((len(o) for o in own_lists), default=1), 1)
    local_of_old = np.full(n_dofs, -1, dtype=np.int64)
    new_of_old = np.empty(n_dofs, dtype=np.int64)
    for b, o in enumerate(own_lists):
        local_of_old[o] = np.arange(len(o))
        new_of_old[o] = b * max_own + local_of_old[o]

    def nb(b, d):
        by, bx = divmod(b, px)
        ny, nx = by + d[0], bx + d[1]
        if 0 <= ny < py and 0 <= nx < px:
            return ny * px + nx
        return -1

    block_cells = [np.flatnonzero(cell_blk == b) for b in range(n_blocks)]
    # ghosts_d[b] = sorted dofs owned by neighbor nb(b, d) that block b
    # touches; the sender side mirrors this ordering exactly
    ghosts = [[np.empty(0, dtype=np.int64)] * n_blocks
              for _ in _OFFSETS]
    for b in range(n_blocks):
        t = np.unique(cells[block_cells[b]])
        for di, d in enumerate(_OFFSETS):
            o = nb(b, d)
            if o >= 0:
                ghosts[di][b] = t[own_blk[t] == o]
    g_max = tuple(max((len(x) for x in ghosts[di]), default=0)
                  for di in range(len(_OFFSETS)))

    # send table: for direction d, SOURCE block s = nb(b, d) sends
    # ghosts_d[b]; indexed by source: send[s, seg_d] = local ids of
    # ghosts_d[b] with b = nb(s, -d)
    total = sum(g_max)
    send = np.zeros((n_blocks, total), dtype=np.int64)
    col = 0
    for di, d in enumerate(_OFFSETS):
        md = (-d[0], -d[1])
        for s in range(n_blocks):
            b = nb(s, md)
            if b >= 0:
                g = ghosts[di][b]
                send[s, col:col + len(g)] = local_of_old[g]
        col += g_max[di]

    # local slot ids: own | ghost segments in _OFFSETS order
    max_cells = max(max((len(x) for x in block_cells), default=1), 1)
    local_cd = np.zeros((n_blocks, max_cells, nloc), dtype=np.int64)
    cell_perm = np.full((n_blocks, max_cells), -1, dtype=np.int64)
    slot = np.zeros(n_dofs, dtype=np.int64)
    seg_base = np.concatenate([[0], np.cumsum(g_max)])[:-1] + max_own
    for b in range(n_blocks):
        o = own_lists[b]
        slot[o] = local_of_old[o]
        for di in range(len(_OFFSETS)):
            g = ghosts[di][b]
            slot[g] = seg_base[di] + np.arange(len(g))
        idx = block_cells[b]
        local_cd[b, :len(idx)] = slot[cells[idx]]
        cell_perm[b, :len(idx)] = idx

    n_vec = n_blocks * max_own
    pad_mask = np.ones(n_vec, dtype=bool)
    pad_mask[new_of_old] = False

    def i32(a):
        return np.asarray(a, dtype=np.int32)

    return DofPlan2D(
        shape=(py, px), n_dofs=int(n_dofs), n_vec=int(n_vec),
        max_own=int(max_own), max_cells=int(max_cells), g_max=g_max,
        new_of_old=i32(new_of_old), cell_perm=cell_perm.reshape(-1),
        local_cell_dofs=i32(local_cd.reshape(-1, nloc)),
        send=i32(send), pad_mask=pad_mask)


class ShardedDofOperator2D:
    """Matrix-free operator on 2-D-block DoF-partitioned banded vectors.

    Same stepper surface as :class:`~tpuwave.parallel.dofs.
    ShardedDofOperator` (``__call__``, ``diagonal``, ``row_sums``,
    ``abs_row_sums``), same banded vector layout, but the ghost exchange
    runs one ppermute per occupied direction of the 8-neighbor block
    graph.
    """

    def __init__(self, plan: DofPlan2D, a_full, mesh: Mesh, *, dtype=None,
                 _presharded: bool = False):
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedDofOperator2D expects a 1D device "
                             "mesh (the 2-D structure lives in the plan)")
        py, px = plan.shape
        if mesh.devices.size != py * px:
            raise ValueError(f"plan has {py * px} blocks but the mesh has "
                             f"{mesh.devices.size} devices")
        self.plan = plan
        self.mesh = mesh
        self.axis = ax = mesh.axis_names[0]
        self.n_dofs = plan.n_dofs
        if dtype is None:
            dtype = jnp.zeros(0, dtype=float).dtype
        self.dtype = dtype

        if _presharded:
            af = a_full
        else:
            src = np.asarray(a_full)
            perm = plan.cell_perm
            af = np.asarray(src[np.clip(perm, 0, None)],
                            dtype=np.dtype(dtype))
            af[perm < 0] = 0.0
            af = jax.device_put(jnp.asarray(af),
                                NamedSharding(mesh, P(ax, None, None)))
        self.a_full = af
        self.n_local = int(af.shape[-1])

        self.local_cell_dofs = jax.device_put(
            jnp.asarray(plan.local_cell_dofs),
            NamedSharding(mesh, P(ax, None)))
        self.send = jax.device_put(jnp.asarray(plan.send),
                                   NamedSharding(mesh, P(ax, None)))
        self._pad_one = jax.device_put(
            jnp.asarray(plan.pad_mask, dtype=dtype),
            NamedSharding(mesh, P(ax)))

        n_blocks = py * px
        max_own = plan.max_own
        g_max = plan.g_max
        L = max_own + sum(g_max)
        seg = np.concatenate([[0], np.cumsum(g_max)])

        def nb(b, d):
            by, bx = divmod(b, px)
            ny, nx = by + d[0], bx + d[1]
            return (ny * px + nx) if (0 <= ny < py and 0 <= nx < px) else -1

        # forward perms (sender s -> receiver nb(s, -d)) and the reverse
        perms_fwd, perms_bwd = [], []
        for d in _OFFSETS:
            md = (-d[0], -d[1])
            pairs = [(s, nb(s, md)) for s in range(n_blocks)
                     if nb(s, md) >= 0]
            perms_fwd.append(pairs)
            perms_bwd.append([(b, s) for (s, b) in pairs])

        def _gather_ghosts(send_blk, v_own):
            parts = [v_own]
            for di in range(len(_OFFSETS)):
                g = g_max[di]
                if g == 0:
                    continue
                payload = v_own[send_blk[seg[di]:seg[di] + g]]
                parts.append(jax.lax.ppermute(payload, ax, perms_fwd[di]))
            return jnp.concatenate(parts) if len(parts) > 1 else v_own

        def _scatter_back(cd_blk, we, send_blk):
            acc = jax.ops.segment_sum(we.reshape(-1), cd_blk.reshape(-1),
                                      num_segments=L)
            y = acc[:max_own]
            for di in range(len(_OFFSETS)):
                g = g_max[di]
                if g == 0:
                    continue
                sl = acc[max_own + seg[di]:max_own + seg[di] + g]
                back = jax.lax.ppermute(sl, ax, perms_bwd[di])
                y = y.at[send_blk[seg[di]:seg[di] + g]].add(back)
            return y

        specs = (P(ax, None), P(ax, None, None), P(ax, None))

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=specs + (P(ax),), out_specs=P(ax))
        def _apply(cd_blk, af_blk, send_blk, v_own):
            send_blk = send_blk.reshape(-1)
            v_loc = _gather_ghosts(send_blk, v_own)
            we = jnp.einsum("eij,ej->ei", af_blk, v_loc[cd_blk],
                            precision="highest")
            return _scatter_back(cd_blk, we, send_blk)

        def _assemble(reduce_fn):
            @partial(jax.shard_map, mesh=mesh, in_specs=specs,
                     out_specs=P(ax))
            def fn(cd_blk, af_blk, send_blk):
                return _scatter_back(cd_blk, reduce_fn(af_blk),
                                     send_blk.reshape(-1))
            return fn

        self._apply_fn = _apply
        self._diag_fn = _assemble(
            lambda a: jnp.diagonal(a, axis1=1, axis2=2))
        self._rows_fn = _assemble(lambda a: jnp.sum(a, axis=2))
        self._abs_rows_fn = _assemble(lambda a: jnp.sum(jnp.abs(a), axis=2))

    @classmethod
    def from_operator(cls, op, plan: DofPlan2D,
                      mesh: Mesh) -> "ShardedDofOperator2D":
        return cls(plan, np.asarray(op._densify_elements()), mesh,
                   dtype=op.dtype)

    # -- MatrixFreeOperator surface ------------------------------------
    def __call__(self, v):
        return self._apply_fn(self.local_cell_dofs, self.a_full, self.send,
                              jnp.asarray(v, dtype=self.dtype))

    def diagonal(self):
        return self._diag_fn(self.local_cell_dofs, self.a_full,
                             self.send) + self._pad_one

    def row_sums(self):
        return self._rows_fn(self.local_cell_dofs, self.a_full,
                             self.send) + self._pad_one

    def abs_row_sums(self):
        return self._abs_rows_fn(self.local_cell_dofs, self.a_full,
                                 self.send) + self._pad_one

    def axpy(self, coef: float, other) -> "ShardedDofOperator2D":
        """self + coef * other on the same plan (banded blocks combine
        elementwise; sharding preserved)."""
        if not isinstance(other, ShardedDofOperator2D) \
                or other.plan is not self.plan or other.mesh is not self.mesh:
            raise ValueError("axpy requires a ShardedDofOperator2D on the "
                             "same plan and device mesh")
        return ShardedDofOperator2D(self.plan,
                                    self.a_full + coef * other.a_full,
                                    self.mesh, dtype=self.dtype,
                                    _presharded=True)
