"""Cell-parallel sharding for unstructured (imported-mesh) operators.

The structured fast paths shard the vertex GRID by rows (parallel/
sharding.py) and let GSPMD turn stencil shifts into collective
permutes. An imported unstructured mesh has no grid, but the matrix-free
apply is a sum of independent per-cell contributions — the natural
decomposition is to shard the CELLS (and their element matrices) over the
device mesh and keep the DoF vector replicated:

    y = psum_over_devices( segment_sum(A_e @ v[cells_e]) )

Each device gathers from its replicated copy of ``v`` (no communication),
contracts its cell block, scatters into a local length-n accumulator, and
one ``psum`` over the mesh produces the replicated result — the exact
analogue of the reference's ghosted-vector ``compress(add)`` after its
owned-cell assembly loop (deal.II MPI::Vector semantics, SURVEY.md
section 2.1), expressed as a single collective.

This trades vector-replication memory for zero halo bookkeeping, which is
the right trade for cell-dominated FEM workloads (n_cells ~ 2 n_dofs and
the per-cell work carries the nloc^2 factor). The explicit LIMIT: memory
is O(n_dofs) per chip, so the mesh must fit one chip's HBM regardless of
device count. For meshes that motivate sharding in the first place, use
:mod:`tpuwave.parallel.dofs` (``dof_sharded=True``), which partitions the
DoF vectors too and replaces the full-vector psum with nearest-neighbor
ghost exchanges.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuwave.ops.operators import MatrixFreeOperator

__all__ = ["ShardedCellOperator"]


class ShardedCellOperator:
    """Drop-in for :class:`MatrixFreeOperator` (full storage mode) with
    cells sharded over a 1D device mesh; supports the surface the scheme
    steppers use: ``__call__``, ``diagonal``, ``row_sums``, ``axpy``.
    """

    def __init__(self, cell_dofs, n_dofs: int, a_full, mesh: Mesh, *,
                 dtype=None, _prepadded: bool = False):
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedCellOperator expects a 1D device mesh")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_dofs = int(n_dofs)
        if dtype is None:
            dtype = jnp.zeros(0, dtype=float).dtype
        self.dtype = dtype

        n_dev = mesh.devices.size
        if _prepadded:
            cd, af = cell_dofs, a_full
        else:
            cd = np.asarray(cell_dofs, dtype=np.int32)
            af = np.asarray(a_full)
            pad = (-cd.shape[0]) % n_dev
            if pad:
                # zero element matrices scattering into DoF 0: exact no-ops
                cd = np.concatenate([cd, np.zeros((pad, cd.shape[1]),
                                                  dtype=np.int32)])
                af = np.concatenate([af, np.zeros((pad,) + af.shape[1:],
                                                  dtype=af.dtype)])
        spec_cd = NamedSharding(mesh, P(self.axis, None))
        spec_af = NamedSharding(mesh, P(self.axis, None, None))
        self.cell_dofs = jax.device_put(jnp.asarray(cd, dtype=jnp.int32),
                                        spec_cd)
        self.a_full = jax.device_put(jnp.asarray(af, dtype=dtype), spec_af)
        self.n_cells, self.n_local = self.cell_dofs.shape

        n, axis = self.n_dofs, self.axis

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(axis, None), P(axis, None, None), P()),
                 out_specs=P())
        def _apply(cd_blk, af_blk, v):
            we = jnp.einsum("eij,ej->ei", af_blk, v[cd_blk],
                            precision="highest")
            y = jax.ops.segment_sum(we.reshape(-1), cd_blk.reshape(-1),
                                    num_segments=n)
            return jax.lax.psum(y, axis)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(axis, None), P(axis, None, None)),
                 out_specs=P())
        def _assemble_diag(cd_blk, af_blk):
            de = jnp.diagonal(af_blk, axis1=1, axis2=2)
            y = jax.ops.segment_sum(de.reshape(-1), cd_blk.reshape(-1),
                                    num_segments=n)
            return jax.lax.psum(y, axis)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(axis, None), P(axis, None, None)),
                 out_specs=P())
        def _assemble_rows(cd_blk, af_blk):
            re = jnp.sum(af_blk, axis=2)
            y = jax.ops.segment_sum(re.reshape(-1), cd_blk.reshape(-1),
                                    num_segments=n)
            return jax.lax.psum(y, axis)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(axis, None), P(axis, None, None)),
                 out_specs=P())
        def _assemble_abs_rows(cd_blk, af_blk):
            re = jnp.sum(jnp.abs(af_blk), axis=2)
            y = jax.ops.segment_sum(re.reshape(-1), cd_blk.reshape(-1),
                                    num_segments=n)
            return jax.lax.psum(y, axis)

        self._apply = _apply
        self._assemble_diag = _assemble_diag
        self._assemble_rows = _assemble_rows
        self._assemble_abs_rows = _assemble_abs_rows

    @classmethod
    def from_operator(cls, op: MatrixFreeOperator,
                      mesh: Mesh) -> "ShardedCellOperator":
        return cls(np.asarray(op.cell_dofs), op.n_dofs,
                   np.asarray(op._densify_elements()), mesh, dtype=op.dtype)

    # -- MatrixFreeOperator surface -----------------------------------------
    def __call__(self, v):
        return self._apply(self.cell_dofs, self.a_full,
                           jnp.asarray(v, dtype=self.dtype))

    def diagonal(self):
        return self._assemble_diag(self.cell_dofs, self.a_full)

    def row_sums(self):
        return self._assemble_rows(self.cell_dofs, self.a_full)

    def abs_row_sums(self):
        """Element-level |entry| row sums (Gershgorin bound helper; see
        MatrixFreeOperator.abs_row_sums)."""
        return self._assemble_abs_rows(self.cell_dofs, self.a_full)

    def axpy(self, coef: float, other) -> "ShardedCellOperator":
        """self + coef * other, staying sharded (same padded cell block)."""
        if not isinstance(other, ShardedCellOperator) \
                or other.mesh is not self.mesh \
                or other.cell_dofs.shape != self.cell_dofs.shape:
            raise ValueError("axpy requires a ShardedCellOperator on the "
                             "same mesh and connectivity")
        return ShardedCellOperator(self.cell_dofs,
                                   self.n_dofs,
                                   self.a_full + coef * other.a_full,
                                   self.mesh, dtype=self.dtype,
                                   _prepadded=True)
