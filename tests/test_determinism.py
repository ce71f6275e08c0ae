"""Determinism: identical runs produce bitwise-identical trajectories.

The reference relies on MPI collective ordering for reproducibility
(SURVEY.md section 5 'race detection: none'); here the analogue is that
segment_sum scatter-adds and stencil reductions are deterministic — two
runs of the same program must agree bit-for-bit, including under 8-way
sharding."""

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.models.discretization import Discretization
from tpuwave.models.fast import FastWaveSolver
from tpuwave.models.theta import ThetaSolver
from tpuwave.utils.params import load_params

from tests.test_schemes import standing_mode


def test_parity_path_bitwise_deterministic():
    p = load_params(standing_mode(Nel="16", T="0.05", Dt="0.01"))

    def run():
        d = Discretization(p)
        s = ThetaSolver(d)
        st = s.initial_state()
        t = 0.0
        while t < p.t_final:
            t += p.dt
            st, _ = s.step(st, t)
        return np.asarray(st.u)

    a, b = run(), run()
    assert (a == b).all()  # bitwise


def test_sharded_fast_path_bitwise_deterministic():
    from tpuwave.parallel.sharding import device_mesh, grid_sharding
    sh = grid_sharding(device_mesh(8))

    def run():
        solver = FastWaveSolver((16, 15), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                                dtype=jnp.float64, sharding=sh)
        st = solver.initial_state(
            lambda xs, ys: jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys))
        return np.asarray(solver.run_scan(st, 20).u)

    a, b = run(), run()
    assert (a == b).all()
