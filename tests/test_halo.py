"""Explicit shard_map/ppermute halo exchange == single-device trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuwave.models.fast import FastWaveSolver
from tpuwave.parallel.halo import make_halo_leapfrog_step
from tpuwave.parallel.sharding import device_mesh


def u0(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_halo_leapfrog_matches_single_device(n_shards):
    assert len(jax.devices()) >= n_shards
    mesh = device_mesh(n_shards)
    # 32 rows over n shards
    solver = FastWaveSolver((20, 31), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                            beta=0.0, dtype=jnp.float64)
    step, sharding = make_halo_leapfrog_step(mesh, solver)

    lf = solver.initial_leapfrog_state(u0)
    want = lf
    for _ in range(12):
        want = solver.leapfrog_step(want)

    got = type(lf)(*(jax.device_put(x, sharding) for x in lf))
    for _ in range(12):
        got = step(got)
    assert len(got.u.sharding.device_set) == n_shards
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("k", [1, 3])
def test_multistep_halo_matches_single_device(k):
    from tpuwave.parallel.halo import make_multistep_halo_leapfrog
    mesh = device_mesh(4)
    solver = FastWaveSolver((18, 23), ((0.0, 0.0), (1.0, 1.0)), 0.004,
                            beta=0.0, dtype=jnp.float64)
    advance, sharding = make_multistep_halo_leapfrog(mesh, solver, k_steps=k)

    lf = solver.initial_leapfrog_state(u0)
    want = lf
    for _ in range(3 * k):
        want = solver.leapfrog_step(want)

    got = type(lf)(*(jax.device_put(x, sharding) for x in lf))
    for _ in range(3):
        got = advance(got)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(got.u_prev),
                               np.asarray(want.u_prev),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("k", [4, 8])
def test_multistep_halo_wide_matches_single_device(k):
    """Wide halos (k = 4, 8 rows exchanged once per k local steps; 16
    rows per shard) reproduce the single-device trajectory exactly
    (f64): the shrinking-validity bookkeeping holds at depth."""
    from tpuwave.parallel.halo import make_multistep_halo_leapfrog
    mesh = device_mesh(4)
    solver = FastWaveSolver((30, 63), ((0.0, 0.0), (1.0, 1.0)), 0.004,
                            beta=0.0, dtype=jnp.float64)
    advance, sharding = make_multistep_halo_leapfrog(mesh, solver,
                                                     k_steps=k)

    lf = solver.initial_leapfrog_state(u0)
    want = lf
    for _ in range(2 * k):
        want = solver.leapfrog_step(want)

    got = type(lf)(*(jax.device_put(x, sharding) for x in lf))
    for _ in range(2):
        got = advance(got)
    assert len(got.u.sharding.device_set) == 4
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(got.u_prev),
                               np.asarray(want.u_prev),
                               rtol=1e-12, atol=1e-13)


def test_multistep_halo_rejects_uneven_split():
    from tpuwave.parallel.halo import make_multistep_halo_leapfrog
    mesh = device_mesh(4)
    solver = FastWaveSolver((30, 58), ((0.0, 0.0), (1.0, 1.0)), 0.004,
                            beta=0.0, dtype=jnp.float64)
    # 59 rows do not split over 4 shards
    with pytest.raises(ValueError, match="divide"):
        make_multistep_halo_leapfrog(mesh, solver, k_steps=4)


def test_multistep_halo_rejects_thin_shards():
    from tpuwave.parallel.halo import make_multistep_halo_leapfrog
    mesh = device_mesh(8)
    solver = FastWaveSolver((20, 31), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                            beta=0.0, dtype=jnp.float64)
    with pytest.raises(ValueError, match="k_steps"):
        make_multistep_halo_leapfrog(mesh, solver, k_steps=4)  # 4 rows/shard


def test_halo_rejects_uneven_split():
    mesh = device_mesh(8)
    solver = FastWaveSolver((10, 10), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                            beta=0.0, dtype=jnp.float64)
    with pytest.raises(ValueError, match="divide"):
        make_halo_leapfrog_step(mesh, solver)


def test_init_distributed_noop_without_env(monkeypatch):
    from tpuwave.parallel.sharding import init_distributed
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert init_distributed() is False


def test_dcn_device_mesh_single_process():
    """Single-process fallback: (1, n_local) hosts x chips mesh, usable by
    grid_sharding for a column split over the 'x' axis."""
    import jax
    from tpuwave.parallel.sharding import dcn_device_mesh, grid_sharding

    mesh = dcn_device_mesh()
    assert mesh.axis_names == ("y", "x")
    assert mesh.devices.shape == (1, len(jax.devices()))
    sh = grid_sharding(mesh)

    import jax.numpy as jnp
    x = jax.device_put(jnp.arange(64.0).reshape(8, 8), sh)
    assert float(jnp.sum(x)) == float(64 * 63 / 2)
