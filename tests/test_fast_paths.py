"""XLA grid-stencil fast paths against plain references: the explicit
leapfrog scan, the implicit CG / Chebyshev-iteration solves, the stencil
forms and the Chebyshev block, each checked against f64 or dense-matrix
arithmetic (runs on the CPU backend)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpuwave.models.fast import FastWaveSolver

GEOM = ((0.0, 0.0), (1.0, 1.0))


def u0(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)


@pytest.mark.parametrize("steps", [5, 8, 16])
def test_leapfrog_f32_scan_tracks_f64(steps):
    """The f32 leapfrog scan follows the f64 trajectory to f32 rounding
    (no matmul in the step; the tolerance is pure f32 arithmetic)."""
    s32 = FastWaveSolver((63, 63), GEOM, 1e-3, beta=0.0, dtype=jnp.float32)
    s64 = FastWaveSolver((63, 63), GEOM, 1e-3, beta=0.0, dtype=jnp.float64)
    got = s32.run_leapfrog_scan(s32.initial_leapfrog_state(u0), steps)
    want = s64.run_leapfrog_scan(s64.initial_leapfrog_state(u0), steps)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.u_prev),
                               np.asarray(want.u_prev), rtol=1e-4, atol=1e-6)


def test_leapfrog_scan_rectangular_matches_newmark():
    """On a non-square grid (50 x 41 vertices) the leapfrog scan equals
    the 3-array lumped Newmark beta=0 recurrence (f64)."""
    solver = FastWaveSolver((40, 49), GEOM, 1e-3, beta=0.0,
                            dtype=jnp.float64)
    st3 = solver.step(solver.initial_state(u0))
    for _ in range(3):
        st3 = solver.step(st3)
    got = solver.run_leapfrog_scan(solver.initial_leapfrog_state(u0), 3)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(st3.u),
                               rtol=1e-12, atol=1e-14)


def test_leapfrog_equals_newmark_explicit():
    """Leapfrog recurrence == lumped Newmark beta=0 trajectory."""
    solver = FastWaveSolver((24, 24), GEOM, 0.005, beta=0.0,
                            dtype=jnp.float64)
    st3 = solver.initial_state(u0)
    lf = solver.initial_leapfrog_state(u0)   # already at step 1
    st3 = solver.step(st3)
    for _ in range(10):
        st3 = solver.step(st3)
        lf = solver.leapfrog_step(lf)
    np.testing.assert_allclose(np.asarray(lf.u), np.asarray(st3.u),
                               rtol=1e-12, atol=1e-14)
    # velocity reconstruction: v^n = (u^{n+1} - u^{n-1}) / 2dt == Newmark v^n
    lf_next = solver.leapfrog_step(lf)
    v = solver.leapfrog_velocity(lf_next, lf)
    np.testing.assert_allclose(np.asarray(v), np.asarray(st3.v),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(scheme="newmark", beta=0.25, gamma=0.5, lumped=False),
    dict(scheme="theta", theta=0.5, lumped=False),
])
def test_implicit_f32_tracks_f64(kw):
    """The f32 implicit CG stepping follows the f64 trajectory to the
    1e-6 CG contract plus f32 rounding."""
    s32 = FastWaveSolver((40, 40), GEOM, 0.01, dtype=jnp.float32, **kw)
    s64 = FastWaveSolver((40, 40), GEOM, 0.01, dtype=jnp.float64, **kw)
    got = s32.run_scan(s32.initial_state(u0), 4)
    want = s64.run_scan(s64.initial_state(u0), 4)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=1e-3, atol=1e-5)


def test_cheby_block_matches_dense_polynomial():
    """One restarted Chebyshev block on the constrained stencil operator
    equals the same three-term recurrence run with the dense matrix of
    that operator (f64)."""
    from tpuwave.solve.cheby_iter import (chebyshev_block,
                                          chebyshev_coefficients,
                                          stencil_symbol_bounds)
    solver = FastWaveSolver((14, 11), GEOM, 0.01, scheme="newmark",
                            beta=0.25, lumped=False, dtype=jnp.float64)
    lo, hi = stencil_symbol_bounds(solver.system.stencil)
    theta_c, coeffs = chebyshev_coefficients(lo, hi, 6)
    apply_c = solver._constrained(solver.system)
    h, w = solver.shape
    n = h * w
    dense = np.stack([np.asarray(apply_c(jnp.asarray(
        np.eye(n)[i].reshape(h, w)))).ravel() for i in range(n)], axis=1)
    rng = np.random.default_rng(3)
    interior = np.asarray(solver.interior)
    x = np.where(interior, rng.normal(size=(h, w)), 0.0).ravel()
    r = np.where(interior, rng.normal(size=(h, w)), 0.0).ravel()
    got_x, got_r = chebyshev_block(apply_c, jnp.asarray(x.reshape(h, w)),
                                   jnp.asarray(r.reshape(h, w)),
                                   theta_c, coeffs)
    d = r / theta_c
    x_w, r_w = x + d, r - dense @ d
    for a, b in coeffs:
        d = a * d + b * r_w
        x_w, r_w = x_w + d, r_w - dense @ d
    np.testing.assert_allclose(np.asarray(got_x).ravel(), x_w,
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(got_r).ravel(), r_w,
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("fam,degree", [("newmark", 8), ("theta", 6),
                                        ("theta", 10)])
def test_cheby_solver_engine_matches_cg(fam, degree):
    """``--solver cheby`` on the P1 product engine meets the same
    ReductionControl contract as the CG path: trajectories agree to the
    solve-tolerance class whatever the block degree."""
    from tpuwave.models.fast_engine import make_fast_solver
    from tpuwave.utils.params import load_params
    from tests.test_schemes import standing_mode
    p = load_params(standing_mode(Nel="20", T="0.04", Dt="0.01",
                                  Beta="0.25", Theta="0.5"))
    cg = make_fast_solver(p, fam)
    ch = make_fast_solver(p, fam, solver="cheby",
                          cheby_solver_degree=degree)
    sc, sh = cg.initial_state(), ch.initial_state()
    t = 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        sc, _ = cg.step(sc, t)
        sh, _ = ch.step(sh, t)
    nu = float(jnp.linalg.norm(sc.u))
    assert float(jnp.linalg.norm(sc.u - sh.u)) < 1e-5 * nu


def test_stencil_diff_matches_direct():
    """apply_stencil_diff == apply_stencil for a zero-row-sum stencil on
    interior nodes (f64)."""
    from tpuwave.core.mesh import FeSpace, StructuredTriMesh
    from tpuwave.core.quadrature import gauss_simplex
    from tpuwave.ops.assembly import element_stiffness_class
    from tpuwave.ops.stencil import (apply_stencil, apply_stencil_diff,
                                     class_matrices_to_stencil)
    sp = FeSpace(StructuredTriMesh((31, 23), ((0.0, 0.0), (1.0, 0.7))), 1)
    st = class_matrices_to_stencil(
        element_stiffness_class(sp, gauss_simplex(2), 1.0))
    x = jnp.asarray(np.random.default_rng(3).normal(size=(24, 32)))
    want = np.asarray(apply_stencil(x, st))[1:-1, 1:-1]
    got = np.asarray(apply_stencil_diff(x, st))[1:-1, 1:-1]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_stiffness_stencil_matches_element_operator():
    """The grid stiffness (difference form, the 2-term r0 pass) equals
    the gather -> element matvec -> segment_sum operator on interior
    rows (f64)."""
    from tpuwave.core.quadrature import gauss_simplex
    from tpuwave.ops.assembly import element_stiffness_class
    from tpuwave.ops.operators import MatrixFreeOperator
    s = FastWaveSolver((18, 13), GEOM, 0.01, scheme="newmark", beta=0.25,
                       lumped=False, dtype=jnp.float64)
    k = MatrixFreeOperator(
        s.space.cell_dofs, s.space.n_dofs,
        a_class=element_stiffness_class(s.space, gauss_simplex(2), 1.0),
        dtype=jnp.float64)
    u = jnp.asarray(np.random.default_rng(7).normal(size=s.shape))
    want = np.asarray(k(u.reshape(-1))).reshape(s.shape)
    interior = np.asarray(s.interior)
    np.testing.assert_allclose(np.asarray(s._stiff_diff(u))[interior],
                               want[interior], rtol=1e-11, atol=1e-11)


def test_theta_step_matches_dense_solve():
    """One stencil theta step (two constrained CG solves, homogeneous
    data) equals the dense-matrix solve of the same two systems (f64)."""
    th, dt = 0.5, 0.01
    s = FastWaveSolver((12, 9), GEOM, dt, scheme="theta", theta=th,
                       lumped=False, dtype=jnp.float64, cg_reduction=1e-13)
    h, w = s.shape
    n = h * w
    interior = np.asarray(s.interior).ravel()

    def dense(op):
        cols = [np.asarray(op(jnp.asarray(np.eye(n)[i].reshape(h, w))))
                .ravel() for i in range(n)]
        return np.stack(cols, axis=1)

    m, k = dense(s.mass), dense(s.stiff)
    st = s.initial_state(u0)
    u, v = np.asarray(st.u).ravel(), np.asarray(st.v).ravel()
    ii = np.ix_(interior, interior)
    a = (m + (th * dt) ** 2 * k)[ii]
    rhs_u = (m @ u - dt * dt * th * (1 - th) * (k @ u) + dt * (m @ v))
    u_new = np.zeros(n)
    u_new[interior] = np.linalg.solve(a, rhs_u[interior])
    rhs_v = m @ v - dt * (1 - th) * (k @ u) - dt * th * (k @ u_new)
    v_new = np.zeros(n)
    v_new[interior] = np.linalg.solve(m[ii], rhs_v[interior])
    got = s.step(st)
    np.testing.assert_allclose(np.asarray(got.u).ravel(), u_new,
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.v).ravel(), v_new,
                               rtol=1e-8, atol=1e-10)
