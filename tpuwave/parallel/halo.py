"""Explicit halo-exchange domain decomposition via shard_map + ppermute.

The GSPMD path (parallel/sharding.py + ops/stencil.py) lets the XLA
partitioner infer the nearest-neighbour communication. This module is the
explicitly-scheduled equivalent — the direct analogue of the
reference's ghost-row exchange (Trilinos import/export under
``compress()``/ghosted vectors, reference WaveEquationBase.cpp:182-185):
each row-shard ppermutes its first/last row to its neighbours,
pads the local block, and applies the stencil locally. Useful as a
control for validating the GSPMD schedule and as the template for
hand-tuned variants (e.g. overlapping the exchange with interior compute).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuwave.models.fast import FastWaveSolver, LeapfrogState

__all__ = ["make_halo_leapfrog_step", "make_multistep_halo_leapfrog"]


def _stencil_rows(u_pad, s, w):
    """Apply the 3x3 stencil to the padded (L+2, W) block; returns (L, W).

    Lane wrap from the rolls only affects the first/last columns, which are
    global Dirichlet boundary and masked by the caller.
    """
    out = None
    for dj in (-1, 0, 1):
        rows = u_pad[1 + dj: u_pad.shape[0] - 1 + dj, :]
        for di in (-1, 0, 1):
            c = s[1 + dj][1 + di]
            if c == 0.0:
                continue
            term = c * (rows if di == 0 else jnp.roll(rows, -di, axis=1))
            out = term if out is None else out + term
    return out


def make_halo_leapfrog_step(mesh: Mesh, solver: FastWaveSolver):
    """Build a jitted leapfrog step with explicit ppermute halo exchange.

    The solver's grid rows must divide evenly over mesh axis 'y'. Returns
    ``(step_fn, sharding)``; apply ``step_fn`` to a LeapfrogState whose
    arrays carry ``sharding``.
    """
    h, w = solver.shape
    n_shards = mesh.shape["y"]
    if h % n_shards != 0:
        raise ValueError(f"{h} rows do not divide over {n_shards} shards")
    local_rows = h // n_shards
    stencil = solver.stiff.stencil
    coef = solver.dt * solver.dt / solver.mesh.det_j
    sharding = NamedSharding(mesh, P("y", None))

    fwd = [(i, i + 1) for i in range(n_shards - 1)]   # send down (to i+1)
    bwd = [(i + 1, i) for i in range(n_shards - 1)]   # send up (to i-1)

    def local_step(u, up):
        # u, up: (local_rows, W) local blocks
        idx = jax.lax.axis_index("y")
        halo_above = jax.lax.ppermute(u[-1:, :], "y", fwd)  # neighbour i-1's last row
        halo_below = jax.lax.ppermute(u[:1, :], "y", bwd)   # neighbour i+1's first row
        u_pad = jnp.concatenate([halo_above, u, halo_below], axis=0)
        ku = _stencil_rows(u_pad, stencil, w)
        un = 2.0 * u - up - coef * ku

        gr = idx * local_rows + jax.lax.broadcasted_iota(jnp.int32,
                                                         (local_rows, w), 0)
        gc = jax.lax.broadcasted_iota(jnp.int32, (local_rows, w), 1)
        mask = (gr == 0) | (gr == h - 1) | (gc == 0) | (gc == w - 1)
        un = jnp.where(mask, 0.0, un).astype(u.dtype)
        return un, u

    shmapped = jax.shard_map(local_step, mesh=mesh,
                             in_specs=(P("y", None), P("y", None)),
                             out_specs=(P("y", None), P("y", None)))

    @jax.jit
    def step(state: LeapfrogState) -> LeapfrogState:
        un, u = shmapped(state.u, state.u_prev)
        return LeapfrogState(u=un, u_prev=u)

    return step, sharding


def make_multistep_halo_leapfrog(mesh: Mesh, solver: FastWaveSolver,
                                 k_steps: int = 4):
    """Temporally-blocked halo exchange: trade one k-row exchange for k
    local steps.

    Across many devices the per-step cost of the 1-row exchange is
    interconnect LATENCY, not bandwidth; exchanging k halo rows once and
    stepping k times locally (validity shrinking one row per step, exactly
    consumed by the k-row halo) amortises the latency k-fold.

    Returns (advance_fn, sharding): advance_fn advances a LeapfrogState by
    ``k_steps`` steps.
    """
    h, w = solver.shape
    n_shards = mesh.shape["y"]
    if h % n_shards != 0:
        raise ValueError(f"{h} rows do not divide over {n_shards} shards")
    local_rows = h // n_shards
    if k_steps >= local_rows:
        raise ValueError("k_steps must be smaller than the rows per shard")
    stencil = solver.stiff.stencil
    coef = solver.dt * solver.dt / solver.mesh.det_j
    sharding = NamedSharding(mesh, P("y", None))
    k = int(k_steps)

    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]

    def local_advance(u, up):
        idx = jax.lax.axis_index("y")

        def pad(x):
            above = jax.lax.ppermute(x[-k:, :], "y", fwd)
            below = jax.lax.ppermute(x[:k, :], "y", bwd)
            return jnp.concatenate([above, x, below], axis=0)

        cur, prev = pad(u), pad(up)
        h_loc = local_rows + 2 * k
        gr0 = idx * local_rows - k
        gr = gr0 + jax.lax.broadcasted_iota(jnp.int32, (h_loc, w), 0)
        gc = jax.lax.broadcasted_iota(jnp.int32, (h_loc, w), 1)
        mask = (gr <= 0) | (gr >= h - 1) | (gc == 0) | (gc == w - 1)

        for _ in range(k):
            up_rows = jnp.roll(cur, 1, axis=0)
            dn_rows = jnp.roll(cur, -1, axis=0)
            ku = None
            for rows, sj in ((cur, stencil[1]), (up_rows, stencil[0]),
                             (dn_rows, stencil[2])):
                for di in (-1, 0, 1):
                    c = sj[1 + di]
                    if c == 0.0:
                        continue
                    term = c * (rows if di == 0
                                else jnp.roll(rows, -di, axis=1))
                    ku = term if ku is None else ku + term
            nxt = jnp.where(mask, 0.0, 2.0 * cur - prev - coef * ku)
            prev = cur
            cur = nxt.astype(u.dtype)

        return cur[k:k + local_rows, :], prev[k:k + local_rows, :]

    shmapped = jax.shard_map(local_advance, mesh=mesh,
                             in_specs=(P("y", None), P("y", None)),
                             out_specs=(P("y", None), P("y", None)))

    @jax.jit
    def advance(state: LeapfrogState) -> LeapfrogState:
        un, up = shmapped(state.u, state.u_prev)
        return LeapfrogState(u=un, u_prev=up)

    return advance, sharding

