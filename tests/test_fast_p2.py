"""P2 plane-stencil solver == flat parity path."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpuwave.models.discretization import Discretization
from tpuwave.models.fast_p2 import P2FastSolver
from tpuwave.models.newmark import NewmarkSolver
from tpuwave.utils.params import load_params

from tests.test_schemes import standing_mode


def u0(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)


def test_p2_fast_matches_parity_path():
    nel, dt, steps = 10, 0.005, 8
    fast = P2FastSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), dt,
                        beta=0.25, gamma=0.5, dtype=jnp.float64)
    st = fast.initial_state(u0)

    p = load_params(standing_mode(Nel=str(nel), R="2", Dt=str(dt),
                                  T=str(dt * steps)))
    d = Discretization(p)
    s = NewmarkSolver(d)
    ref = s.initial_state()

    # flat DoF orderings agree (vertices then h/v/d edges), so states are
    # directly comparable
    np.testing.assert_allclose(np.asarray(st.u), np.asarray(ref.u),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st.a), np.asarray(ref.a),
                               rtol=1e-5, atol=1e-7)

    t = 0.0
    for _ in range(steps):
        t += dt
        st = fast.step(st)
        ref, _ = s.step(ref, t)
    nrm = np.linalg.norm(np.asarray(ref.u))
    assert np.linalg.norm(np.asarray(st.u) - np.asarray(ref.u)) < 1e-6 * nrm


def test_p2_fast_tracks_exact_solution():
    nel, dt = 24, 0.004
    fast = P2FastSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), dt,
                        dtype=jnp.float64)
    st = fast.initial_state(u0)
    n = 25
    st = fast.run_scan(st, n)
    t = dt * n
    # compare the vertex plane against the exact standing mode
    from tpuwave.ops.stencil_p2 import flat_to_planes
    planes = flat_to_planes(st.u, nel, nel)
    xs = np.linspace(0, 1, nel + 1)
    exact = (np.cos(np.sqrt(2) * np.pi * t)
             * np.outer(np.sin(np.pi * xs), np.sin(np.pi * xs)).T)
    err = np.linalg.norm(np.asarray(planes["V"]) - exact) / np.linalg.norm(exact)
    assert err < 1e-3


def test_p2_canvas_solver_matches_plane_solver():
    nel, dt, steps = 10, 0.005, 6
    a = P2FastSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), dt,
                     dtype=jnp.float64)
    from tpuwave.models.fast_p2 import P2CanvasSolver
    b = P2CanvasSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), dt,
                       dtype=jnp.float64)
    sa = a.initial_state(u0)
    sb = b.initial_state(u0)
    np.testing.assert_allclose(np.asarray(b.to_flat(sb.u)),
                               np.asarray(sa.u), rtol=1e-12, atol=1e-12)
    for _ in range(steps):
        sa = a.step(sa)
        sb = b.step(sb)
    nrm = np.linalg.norm(np.asarray(sa.u))
    diff = np.linalg.norm(np.asarray(b.to_flat(sb.u)) - np.asarray(sa.u))
    assert diff < 1e-8 * nrm


def test_p2_canvas_solver_sharded_matches_single():
    """Row-sharded canvas stack over the 8-device mesh == single device —
    the multi-chip P2 path (SURVEY hard part 5)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpuwave.models.fast_p2 import P2CanvasSolver
    from tpuwave.parallel.sharding import device_mesh

    mesh = device_mesh(8)
    sh = NamedSharding(mesh, P(None, "y", None))
    kw = dict(dtype=jnp.float64)
    single = P2CanvasSolver((12, 12), ((0.0, 0.0), (1.0, 1.0)), 0.005, **kw)
    want = single.run_scan(single.initial_state(u0), 4)

    sharded = P2CanvasSolver((12, 12), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                             sharding=sh, row_multiple=8, **kw)
    st = sharded.initial_state(u0)
    assert len(st.u.sharding.device_set) == 8
    got = sharded.run_scan(st, 4)
    np.testing.assert_allclose(np.asarray(sharded.to_flat(got.u)),
                               np.asarray(single.to_flat(want.u)),
                               rtol=1e-10, atol=1e-12)


def test_p2_canvas_padded_matches_unpadded():
    """Canvas padding is transparent: a canvas padded to a row multiple
    of 8 (the sharded layout) reproduces the unpadded canvas on a
    non-square grid (whole steps; f64, so only a layout bug — not CG
    rounding — would show)."""
    from tpuwave.models.fast_p2 import P2CanvasSolver
    a = P2CanvasSolver((12, 28), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                       dtype=jnp.float64)
    b = P2CanvasSolver((12, 28), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                       dtype=jnp.float64, row_multiple=8)
    assert b.cshape[0] % 8 == 0 and b.cshape != a.cshape
    sa = a.initial_state(u0)
    sb = b.initial_state(u0)
    np.testing.assert_allclose(np.asarray(b.to_flat(sb.a)),
                               np.asarray(a.to_flat(sa.a)),
                               rtol=1e-10, atol=1e-12)
    for _ in range(3):
        sa = a.step(sa)
        sb = b.step(sb)
    np.testing.assert_allclose(np.asarray(b.to_flat(sb.u)),
                               np.asarray(a.to_flat(sa.u)),
                               rtol=1e-10, atol=1e-13)


def test_p2_theta_matches_flat_theta_solver():
    """P2FastSolver theta stepping == the parity ThetaSolver trajectory
    (same operators, tolerances; f64)."""
    import jax.numpy as jnp
    import numpy as np
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.fast_p2 import P2FastSolver
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params
    from pathlib import Path

    base = Path(__file__).resolve().parent.parent / "parameters" / \
        "standing-mode-wsol.json"
    params = load_params(base, overrides={
        "Nel": "8", "R": "2", "Dt": "0.01", "T": "0.05", "Theta": "0.5",
        "Save Solution": False, "Enable Logging": False, "Log Every": 0})
    disc = Discretization(params)
    ref = ThetaSolver(disc)
    st_ref = ref.initial_state()
    for i in range(1, 6):
        st_ref, _ = ref.step(st_ref, i * 0.01)

    s = P2FastSolver((8, 8), params.geometry, 0.01, scheme="theta",
                     theta=0.5, dtype=jnp.float64)
    st = s.initial_state(lambda xs, ys: params.u0.evaluate(xs, ys, 0.0))
    for _ in range(5):
        st = s.step(st)

    np.testing.assert_allclose(np.asarray(st.u), np.asarray(st_ref.u),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(st.v), np.asarray(st_ref.v),
                               rtol=1e-8, atol=1e-10)


def test_p1_consistent_a0_matches_newmark_solver():
    """FastWaveSolver.initial_state_consistent == NewmarkSolver a0 (f64)."""
    import jax.numpy as jnp
    import numpy as np
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.fast import FastWaveSolver
    from tpuwave.models.newmark import NewmarkSolver
    from tpuwave.utils.params import load_params
    from pathlib import Path

    base = Path(__file__).resolve().parent.parent / "parameters" / \
        "standing-mode-wsol.json"
    params = load_params(base, overrides={
        "Nel": "12", "R": "1", "Dt": "0.01", "T": "0.05", "Beta": "0.25",
        "Save Solution": False, "Enable Logging": False, "Log Every": 0})
    ref = NewmarkSolver(Discretization(params))
    st_ref = ref.initial_state()

    s = FastWaveSolver((12, 12), params.geometry, 0.01, scheme="newmark",
                       beta=0.25, lumped=False, dtype=jnp.float64)
    st = s.initial_state_consistent(
        lambda xs, ys: params.u0.evaluate(xs, ys, 0.0))
    np.testing.assert_allclose(np.asarray(st.a).ravel(),
                               np.asarray(st_ref.a), rtol=1e-9, atol=1e-10)


def test_p2_canvas_theta_matches_plane_theta():
    """Canvas theta stepping == P2FastSolver theta (flat) trajectory."""
    from tpuwave.models.fast_p2 import P2CanvasSolver
    nel, dt, steps = 10, 0.005, 5
    a = P2FastSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), dt,
                     scheme="theta", theta=0.5, dtype=jnp.float64)
    b = P2CanvasSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), dt,
                       scheme="theta", theta=0.5, dtype=jnp.float64)
    sa = a.initial_state(u0)
    sb = b.initial_state(u0)
    for _ in range(steps):
        sa = a.step(sa)
        sb = b.step(sb)
    nrm = np.linalg.norm(np.asarray(sa.u))
    diff = np.linalg.norm(np.asarray(b.to_flat(sb.u)) - np.asarray(sa.u))
    assert diff < 1e-8 * nrm
    diff_v = np.linalg.norm(np.asarray(b.to_flat(sb.v)) - np.asarray(sa.v))
    assert diff_v < 1e-7 * max(np.linalg.norm(np.asarray(sa.v)), 1.0)


def test_p2_canvas_theta_sharded_matches_single():
    """Row-sharded canvas theta over the 8-device mesh == single device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpuwave.models.fast_p2 import P2CanvasSolver
    from tpuwave.parallel.sharding import device_mesh

    mesh = device_mesh(8)
    sh = NamedSharding(mesh, P(None, "y", None))
    kw = dict(scheme="theta", theta=0.5, dtype=jnp.float64)
    single = P2CanvasSolver((12, 12), ((0.0, 0.0), (1.0, 1.0)), 0.005, **kw)
    want = single.run_scan(single.initial_state(u0), 4)

    sharded = P2CanvasSolver((12, 12), ((0.0, 0.0), (1.0, 1.0)), 0.005,
                             sharding=sh, row_multiple=8, **kw)
    st = sharded.initial_state(u0)
    assert len(st.u.sharding.device_set) == 8
    got = sharded.run_scan(st, 4)
    np.testing.assert_allclose(np.asarray(sharded.to_flat(got.u)),
                               np.asarray(single.to_flat(want.u)),
                               rtol=1e-10, atol=1e-12)
