"""DoF-partitioned sharding for unstructured (imported-mesh) operators.

:mod:`tpuwave.parallel.cells` shards the CELLS and replicates the DoF
vector — zero halo bookkeeping, but O(n_dofs) memory per chip, which
caps the mesh size at one chip's HBM. This module is the scaling path:
both the cells AND the DoF vectors are partitioned, the counterpart
of the reference's ``partition_triangulation`` + owned/ghosted
``TrilinosWrappers::MPI::Vector`` (reference WaveEquationBase.cpp:65-69;
SURVEY.md §2.1).

Strategy (host-side numpy setup, device-side ``shard_map``):

1. Cells are sorted by centroid y and split into ``n_bands`` contiguous
   balanced bands (one per device) — the unstructured analogue of the
   structured row-block decomposition.
2. Each DoF is OWNED by the band containing most of its adjacent cells
   (ties to the lower band). Bands own contiguous renumbered blocks
   padded to a common ``max_own``: new id = band * max_own + local id.
3. A band's cells may reference DoFs owned by the PREVIOUS or NEXT band
   only (ghosts). Spatial band locality guarantees this for conforming
   planar meshes; :func:`build_dof_plan` validates it and raises
   (fall back to :class:`~tpuwave.parallel.cells.ShardedCellOperator`)
   if a mesh breaks the assumption.
4. Operator application per band: ``ppermute`` the ghost VALUES in from
   both neighbors, gather/contract/scatter locally (the same batched
   element kernel as everywhere else), then ``ppermute`` the ghost-slot
   CONTRIBUTIONS back to their owners and add — the matrix-free
   equivalent of deal.II's ``compress(VectorOperation::add)``, with
   nearest-neighbor device traffic only (no psum over the full vector).

Vectors live in the banded padded layout (length ``n_bands * max_own``,
sharded ``P('y')``); ``DofPlan.to_banded`` / ``from_banded`` convert at
setup/IO boundaries. Padding slots hold no physics: operators return
identity-like diagonal entries there (so Jacobi/CG stay finite) and any
zero-initialised padding entry stays exactly zero through the dynamics
(zero rows, zero rhs).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuwave.ops.operators import MatrixFreeOperator

__all__ = ["DofPlan", "build_dof_plan", "ShardedDofOperator"]


class DofPlan(NamedTuple):
    """Host-side partition plan (all numpy; built once per mesh)."""
    n_bands: int
    n_dofs: int          # real DoFs
    n_vec: int           # banded padded vector length = n_bands * max_own
    max_own: int
    max_cells: int
    g_prev_max: int
    g_next_max: int
    new_of_old: np.ndarray     # (n_dofs,) old dof id -> banded id
    cell_perm: np.ndarray      # (n_bands*max_cells,) old cell id, -1 = pad
    local_cell_dofs: np.ndarray  # (n_bands*max_cells, nloc) local slot ids
    send_next: np.ndarray      # (n_bands*g_prev_max,) local ids sent to b+1
    send_prev: np.ndarray      # (n_bands*g_next_max,) local ids sent to b-1
    pad_mask: np.ndarray       # (n_vec,) True on padding slots

    # -- vector layout conversion --------------------------------------
    def to_banded(self, v, dtype=None):
        """Old-numbering (n_dofs,) -> banded padded (n_vec,) (pad = 0)."""
        v = jnp.asarray(v, dtype=dtype)
        out = jnp.zeros(self.n_vec, dtype=v.dtype)
        return out.at[jnp.asarray(self.new_of_old)].set(v)

    def from_banded(self, vb):
        """Banded padded (n_vec,) -> old-numbering (n_dofs,)."""
        return jnp.asarray(vb)[jnp.asarray(self.new_of_old)]


def build_dof_plan(cell_dofs, n_dofs: int, centroid_y,
                   n_bands: int) -> DofPlan:
    """Partition ``n_dofs`` DoFs and their cells into y-bands.

    Raises ``ValueError`` if any band's cells touch a DoF owned by a
    non-adjacent band (the neighbor-only halo assumption; see module
    docstring)."""
    cells = np.asarray(cell_dofs, dtype=np.int64)
    n_cells, nloc = cells.shape
    cy = np.asarray(centroid_y)
    if n_bands < 1:
        raise ValueError("n_bands must be >= 1")

    order = np.argsort(cy, kind="stable")
    band_cells = np.array_split(order, n_bands)

    # streaming min/max touch per DoF: one O(n_dofs) bool scratch reused
    # per band instead of a dense (n_dofs, n_bands) counts matrix — host
    # memory stays O(n_dofs) however many bands the HBM-limited meshes
    # this engine serves are split into
    big = n_bands + 1
    min_touch = np.full(n_dofs, big, dtype=np.int64)
    max_touch = np.full(n_dofs, -1, dtype=np.int64)
    touched_b = np.empty(n_dofs, dtype=bool)
    for b, idx in enumerate(band_cells):
        touched_b[:] = False
        touched_b[cells[idx].ravel()] = True
        np.minimum(min_touch, np.where(touched_b, b, big), out=min_touch)
        np.maximum(max_touch, np.where(touched_b, b, -1), out=max_touch)
    untouched = max_touch < 0
    min_touch[untouched] = 0
    max_touch[untouched] = 0
    # owner = middle of the touching range: a DoF touched by bands
    # {b-1, b, b+1} (thin bands, coarse cells) lands on b with ghosts
    # exactly +-1; only a range wider than 3 bands is unservable
    if int(np.max(max_touch - min_touch)) > 2:
        ndof_bad = int(np.sum(max_touch - min_touch > 2))
        raise ValueError(
            f"{ndof_bad} DoFs are touched by cells spanning more than 3 "
            "bands — the mesh violates the neighbor-only halo assumption "
            "of the DoF-partitioned engine (bands thinner than one cell); "
            "use fewer bands or the cell-sharded engine "
            "(parallel/cells.py) for this mesh")
    owner = ((min_touch + max_touch) // 2).astype(np.int64)

    own_lists = [np.flatnonzero(owner == b) for b in range(n_bands)]
    max_own = max((len(o) for o in own_lists), default=1)
    max_own = max(max_own, 1)
    local_of_old = np.full(n_dofs, -1, dtype=np.int64)
    new_of_old = np.empty(n_dofs, dtype=np.int64)
    for b, o in enumerate(own_lists):
        local_of_old[o] = np.arange(len(o))
        new_of_old[o] = b * max_own + local_of_old[o]

    ghost_prev, ghost_next = [], []
    for b, idx in enumerate(band_cells):
        t = np.unique(cells[idx])
        ghost_prev.append(t[owner[t] == b - 1])
        ghost_next.append(t[owner[t] == b + 1])
    g_prev_max = max((len(x) for x in ghost_prev), default=0)
    g_next_max = max((len(x) for x in ghost_next), default=0)

    send_next = np.zeros((n_bands, g_prev_max), dtype=np.int64)
    for b in range(n_bands - 1):
        g = ghost_prev[b + 1]            # owned by band b, needed by b+1
        send_next[b, :len(g)] = local_of_old[g]
    send_prev = np.zeros((n_bands, g_next_max), dtype=np.int64)
    for b in range(1, n_bands):
        g = ghost_next[b - 1]            # owned by band b, needed by b-1
        send_prev[b, :len(g)] = local_of_old[g]

    max_cells = max((len(x) for x in band_cells), default=1)
    local_cd = np.zeros((n_bands, max_cells, nloc), dtype=np.int64)
    cell_perm = np.full((n_bands, max_cells), -1, dtype=np.int64)
    slot = np.zeros(n_dofs, dtype=np.int64)
    for b, idx in enumerate(band_cells):
        o = own_lists[b]
        slot[o] = local_of_old[o]
        gp, gn = ghost_prev[b], ghost_next[b]
        slot[gp] = max_own + np.arange(len(gp))
        slot[gn] = max_own + g_prev_max + np.arange(len(gn))
        local_cd[b, :len(idx)] = slot[cells[idx]]
        cell_perm[b, :len(idx)] = idx

    n_vec = n_bands * max_own
    pad_mask = np.ones(n_vec, dtype=bool)
    pad_mask[new_of_old] = False

    def i32(a):
        return np.asarray(a, dtype=np.int32)

    return DofPlan(
        n_bands=n_bands, n_dofs=int(n_dofs), n_vec=int(n_vec),
        max_own=int(max_own), max_cells=int(max_cells),
        g_prev_max=int(g_prev_max), g_next_max=int(g_next_max),
        new_of_old=i32(new_of_old),
        cell_perm=cell_perm.reshape(-1),
        local_cell_dofs=i32(local_cd.reshape(-1, nloc)),
        send_next=i32(send_next.reshape(-1)),
        send_prev=i32(send_prev.reshape(-1)),
        pad_mask=pad_mask)


class ShardedDofOperator:
    """Matrix-free operator on banded DoF-partitioned vectors.

    Drop-in for :class:`MatrixFreeOperator`'s stepper surface
    (``__call__``, ``diagonal``, ``row_sums``, ``axpy``), but input and
    output vectors are in the banded padded layout of ``plan``
    (length ``plan.n_vec``, sharded ``P('y')`` over ``mesh``).

    ``diagonal()`` / ``row_sums()`` return 1.0 on padding slots so
    Jacobi preconditioning and lumped-mass division stay finite; padding
    rows of the operator itself are exactly zero, so zero-initialised
    padding entries remain zero through any scheme.
    """

    def __init__(self, plan: DofPlan, a_full, mesh: Mesh, *, dtype=None,
                 _presharded: bool = False):
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedDofOperator expects a 1D device mesh")
        if mesh.devices.size != plan.n_bands:
            raise ValueError(f"plan has {plan.n_bands} bands but the mesh "
                             f"has {mesh.devices.size} devices")
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
            # permute cells into band order; -1 pads become zero matrices.
            # Built directly in the target dtype (one permuted copy, no
            # np.where broadcast temp) — the single copy is what
            # device_put needs to ship band-contiguous data anyway.
            perm = plan.cell_perm
            af = np.asarray(src[np.clip(perm, 0, None)],
                            dtype=np.dtype(dtype))
            af[perm < 0] = 0.0
            af = jax.device_put(jnp.asarray(af),
                                NamedSharding(mesh, P(ax, None, None)))
        self.a_full = af
        self.n_local = int(af.shape[-1])

        spec1 = NamedSharding(mesh, P(ax))
        self.local_cell_dofs = jax.device_put(
            jnp.asarray(plan.local_cell_dofs),
            NamedSharding(mesh, P(ax, None)))
        self.send_next = jax.device_put(jnp.asarray(plan.send_next), spec1)
        self.send_prev = jax.device_put(jnp.asarray(plan.send_prev), spec1)
        self._pad_one = jax.device_put(
            jnp.asarray(plan.pad_mask, dtype=dtype), spec1)

        nb = plan.n_bands
        max_own, gp, gn = plan.max_own, plan.g_prev_max, plan.g_next_max
        L = max_own + gp + gn
        perm_fwd = [(i, i + 1) for i in range(nb - 1)]
        perm_bwd = [(i + 1, i) for i in range(nb - 1)]

        def _gather_ghosts(snd_nxt, snd_prv, v_own):
            parts = [v_own]
            if gp:
                parts.append(jax.lax.ppermute(v_own[snd_nxt], ax, perm_fwd))
            if gn:
                parts.append(jax.lax.ppermute(v_own[snd_prv], ax, perm_bwd))
            return jnp.concatenate(parts) if len(parts) > 1 else v_own

        def _scatter_back(cd_blk, we, snd_nxt, snd_prv):
            acc = jax.ops.segment_sum(we.reshape(-1), cd_blk.reshape(-1),
                                      num_segments=L)
            y = acc[:max_own]
            if gp:
                back = jax.lax.ppermute(acc[max_own:max_own + gp], ax,
                                        perm_bwd)
                y = y.at[snd_nxt].add(back)
            if gn:
                back = jax.lax.ppermute(acc[max_own + gp:], ax, perm_fwd)
                y = y.at[snd_prv].add(back)
            return y

        specs = (P(ax, None), P(ax, None, None), P(ax), P(ax), P(ax))

        @partial(jax.shard_map, mesh=mesh, in_specs=specs, out_specs=P(ax))
        def _apply(cd_blk, af_blk, snd_nxt, snd_prv, v_own):
            v_loc = _gather_ghosts(snd_nxt, snd_prv, v_own)
            we = jnp.einsum("eij,ej->ei", af_blk, v_loc[cd_blk],
                            precision="highest")
            return _scatter_back(cd_blk, we, snd_nxt, snd_prv)

        @partial(jax.shard_map, mesh=mesh, in_specs=specs[:2] + specs[2:4],
                 out_specs=P(ax))
        def _assemble_diag(cd_blk, af_blk, snd_nxt, snd_prv):
            de = jnp.diagonal(af_blk, axis1=1, axis2=2)
            return _scatter_back(cd_blk, de, snd_nxt, snd_prv)

        @partial(jax.shard_map, mesh=mesh, in_specs=specs[:2] + specs[2:4],
                 out_specs=P(ax))
        def _assemble_rows(cd_blk, af_blk, snd_nxt, snd_prv):
            re = jnp.sum(af_blk, axis=2)
            return _scatter_back(cd_blk, re, snd_nxt, snd_prv)

        @partial(jax.shard_map, mesh=mesh, in_specs=specs[:2] + specs[2:4],
                 out_specs=P(ax))
        def _assemble_abs_rows(cd_blk, af_blk, snd_nxt, snd_prv):
            re = jnp.sum(jnp.abs(af_blk), axis=2)
            return _scatter_back(cd_blk, re, snd_nxt, snd_prv)

        self._apply_fn = _apply
        self._diag_fn = _assemble_diag
        self._rows_fn = _assemble_rows
        self._abs_rows_fn = _assemble_abs_rows

    @classmethod
    def from_operator(cls, op: MatrixFreeOperator, plan: DofPlan,
                      mesh: Mesh) -> "ShardedDofOperator":
        return cls(plan, np.asarray(op._densify_elements()), mesh,
                   dtype=op.dtype)

    # -- MatrixFreeOperator surface ------------------------------------
    def __call__(self, v):
        return self._apply_fn(self.local_cell_dofs, self.a_full,
                              self.send_next, self.send_prev,
                              jnp.asarray(v, dtype=self.dtype))

    def diagonal(self):
        d = self._diag_fn(self.local_cell_dofs, self.a_full,
                          self.send_next, self.send_prev)
        return d + self._pad_one

    def row_sums(self):
        r = self._rows_fn(self.local_cell_dofs, self.a_full,
                          self.send_next, self.send_prev)
        return r + self._pad_one

    def abs_row_sums(self):
        """Element-level |entry| row sums + 1 on padding slots (Gershgorin
        bound helper; see MatrixFreeOperator.abs_row_sums)."""
        r = self._abs_rows_fn(self.local_cell_dofs, self.a_full,
                              self.send_next, self.send_prev)
        return r + self._pad_one

    def axpy(self, coef: float, other) -> "ShardedDofOperator":
        """self + coef * other on the same plan (banded blocks combine
        elementwise; sharding preserved)."""
        if not isinstance(other, ShardedDofOperator) \
                or other.plan is not self.plan or other.mesh is not self.mesh:
            raise ValueError("axpy requires a ShardedDofOperator on the "
                             "same plan and device mesh")
        return ShardedDofOperator(self.plan,
                                  self.a_full + coef * other.a_full,
                                  self.mesh, dtype=self.dtype,
                                  _presharded=True)
