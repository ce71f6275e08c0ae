"""Device-mesh layout for spatial domain decomposition.

The reference's ONLY parallelism is MPI domain decomposition of the mesh
(reference WaveEquationBase.cpp:65-69; SURVEY.md section 2.2). The
equivalent here: shard the (ny+1, nx+1) vertex grid by ROWS over a 1D
`jax.sharding.Mesh`. Every operator in the hot path is a 7-point stencil,
so GSPMD lowers the row shifts to nearest-neighbour collective-permutes
between devices (each shard talks to <= 2 neighbours, the analogue of the
reference's ghost-row exchange) and CG dot products to psum — no explicit
communication code.

2D meshes (rows x cols) are supported by the same helper for pods where a
single row-slab per chip would be too thin.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["device_mesh", "dcn_device_mesh", "grid_sharding", "replicated",
           "shard_grid_arrays", "init_distributed"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None) -> bool:
    """Multi-host initialisation (the jax.distributed counterpart of the
    reference's Utilities::MPI::MPI_InitFinalize, main-theta.cpp:25).

    Call once per host before any device use when running across hosts
    (multi-slice pods / DCN). Arguments default to the JAX coordination
    env vars; returns False (no-op) when no multi-host environment is
    configured, so single-host runs need no changes.
    """
    import os
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if not coordinator_address:
            return False
    # generic env channel for manual launches (scripts/jobs/
    # multihost_dryrun.sh; clusters with auto-detection — SLURM, OMPI —
    # can leave these unset and initialize() detects them itself)
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def device_mesh(n_devices: Optional[int] = None,
                shape: Optional[Tuple[int, int]] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh ('y',) over rows by default; pass shape=(ry, rx) for 2D
    ('y', 'x') row x column slabs."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        return Mesh(np.array(devs), ("y",))
    ry, rx = shape
    if ry * rx != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    return Mesh(np.array(devs).reshape(ry, rx), ("y", "x"))


def dcn_device_mesh() -> Mesh:
    """Host-aware 2D mesh for multi-host runs: grid ROWS over hosts
    (slow inter-host network, one halo-row exchange per host boundary) x
    grid COLUMNS over each host's local devices (fast intra-host links).

    Every stencil halo along the column split stays inside a host; only
    the thin row boundary between adjacent hosts crosses the network —
    the layout that minimises inter-host traffic for the row-major
    structured grid (SURVEY.md section 5, distributed communication
    backend). Single-process
    environments get a (1, n_local) mesh, so code written against this
    helper also runs unchanged on one host.
    """
    n_proc = jax.process_count()
    local = len(jax.local_devices())
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs).reshape(n_proc, local), ("y", "x"))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (ny+1, nx+1) grid state arrays: rows over 'y'
    (and columns over 'x' when the mesh is 2D)."""
    if "x" in mesh.axis_names:
        return NamedSharding(mesh, P("y", "x"))
    return NamedSharding(mesh, P("y", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_grid_arrays(mesh: Mesh, *arrays):
    """Place grid arrays with the row sharding."""
    sh = grid_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) != 1 else out[0]
