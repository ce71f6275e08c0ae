"""Geometric multigrid (solve/multigrid.py): transfer-operator adjointness,
Galerkin exactness via nestedness, SPD symmetry of the V-cycle, dt- and
h-independent MG-PCG convergence, and stepper-level agreement with the
Jacobi-CG implicit path.

The reference solves these systems with ML-AMG-CG (WaveTheta.cpp:276-293);
parity is solution accuracy, and the MG path exists for the large-dt
regime where single-level solvers need O(dt/h) iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex
from tpuwave.models.fast import FastState, FastWaveSolver
from tpuwave.ops.assembly import element_mass_class, element_stiffness_class
from tpuwave.ops.stencil import apply_stencil, class_matrices_to_stencil
from tpuwave.solve.cg import pcg
from tpuwave.solve.multigrid import (gmg_for_system, prolong_p1,
                                     restrict_p1)

GEOM = ((0.0, 0.0), (1.0, 1.0))


def _stencils(nx, ny, c=1.0, geom=GEOM):
    space = FeSpace(StructuredTriMesh((nx, ny), geom), 1)
    quad = gauss_simplex(2)
    m = class_matrices_to_stencil(element_mass_class(space, quad))
    k = class_matrices_to_stencil(element_stiffness_class(space, quad, c * c))
    return m, k


def _interior(h, w):
    ri = np.arange(h)[:, None]
    ci = np.arange(w)[None, :]
    return jnp.asarray((ri > 0) & (ri < h - 1) & (ci > 0) & (ci < w - 1))


def _constrained(stencil, interior):
    st = tuple(map(tuple, stencil))

    def apply_c(x):
        xi = jnp.where(interior, x, 0.0)
        return jnp.where(interior, apply_stencil(xi, st), st[1][1] * x)
    return apply_c


def test_transfer_adjoint():
    """<P c, f> == <c, R f>: restriction is the exact transpose of
    prolongation (up to the masked boundary, excluded here)."""
    rng = np.random.default_rng(3)
    c = jnp.asarray(rng.standard_normal((5, 7)))
    f = rng.standard_normal((9, 13))
    f[0, :] = f[-1, :] = 0.0   # R reads zero-padded ghosts only for
    f[:, 0] = f[:, -1] = 0.0   # boundary coarse rows; zero them
    f = jnp.asarray(f)
    lhs = float(jnp.vdot(prolong_p1(c), f))
    rhs = float(jnp.vdot(c, restrict_p1(f)))
    assert abs(lhs - rhs) < 1e-12


def test_prolong_is_p1_interpolation():
    """Prolonging the nodal values of a LINEAR function reproduces its
    fine-grid nodal values exactly (P1 nested interpolation), including
    the diagonal-edge midpoints."""
    nyc, nxc = 4, 6
    xs = np.linspace(0.0, 1.0, nxc + 1)
    ys = np.linspace(0.0, 2.0, nyc + 1)
    f = lambda x, y: 0.3 * x - 1.7 * y + 0.25
    c = jnp.asarray(f(xs[None, :], ys[:, None]))
    xf = np.linspace(0.0, 1.0, 2 * nxc + 1)
    yf = np.linspace(0.0, 2.0, 2 * nyc + 1)
    want = f(xf[None, :], yf[:, None])
    np.testing.assert_allclose(np.asarray(prolong_p1(c)), want, atol=1e-14)


def test_galerkin_equals_coarse_assembly():
    """R A_h P == A_2h on interior coarse nodes (nested P1 spaces) — the
    property that makes the geometric hierarchy exact, for an anisotropic
    geometry and an asymmetric Nel."""
    geom = ((0.0, 0.0), (3.0, 1.0))
    nx, ny = 8, 12
    coef = 0.37
    mf, kf = _stencils(nx, ny, c=1.3, geom=geom)
    mc, kc = _stencils(nx // 2, ny // 2, c=1.3, geom=geom)
    af = tuple(map(tuple, mf + coef * kf))
    ac = mc + coef * kc
    hc, wc = ny // 2 + 1, nx // 2 + 1
    for (i, j) in [(1, 1), (2, 3), (hc - 2, wc - 2)]:
        e = jnp.zeros((hc, wc)).at[i, j].set(1.0)
        w = restrict_p1(apply_stencil(prolong_p1(e), af))
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                assert abs(float(w[i + dj, j + di]) - ac[1 + dj, 1 + di]) \
                    < 1e-13


def test_vcycle_is_spd():
    """The V-cycle as a matrix is symmetric positive definite — the
    requirement for use as a CG preconditioner."""
    pre = gmg_for_system((8, 8), GEOM, 1.0, 0.37)
    n = 81
    b = np.zeros((n, n))
    for i in range(n):
        e = jnp.zeros((9, 9)).at[i // 9, i % 9].set(1.0)
        b[:, i] = np.asarray(pre(e)).ravel()
    assert np.abs(b - b.T).max() < 1e-12
    assert np.linalg.eigvalsh(0.5 * (b + b.T)).min() > 0.0


@pytest.mark.parametrize("dt2", [1e-4, 1e-2, 1.0])
def test_mg_pcg_iterations_dt_independent(dt2):
    """MG-PCG converges in a small, dt-independent iteration count on the
    stiffness-dominated system (Jacobi-CG needs O(dt/h)) and matches the
    Jacobi-CG solution."""
    nel = 64
    m_st, k_st = _stencils(nel, nel)
    a_st = m_st + dt2 * k_st
    h = w = nel + 1
    interior = _interior(h, w)
    apply_c = _constrained(a_st, interior)
    rng = np.random.default_rng(0)
    b = jnp.asarray(np.where(interior, rng.standard_normal((h, w)), 0.0))
    pre = gmg_for_system((nel, nel), GEOM, 1.0, dt2)
    res = pcg(apply_c, b, jnp.zeros_like(b), precond_inv_diag=pre,
              reduction=1e-10)
    assert bool(res.converged)
    assert int(res.iterations) <= 15
    res_j = pcg(apply_c, b, jnp.zeros_like(b),
                precond_inv_diag=1.0 / a_st[1, 1], reduction=1e-10,
                max_iter=100000)
    diff = float(jnp.linalg.norm(res.x - res_j.x)
                 / jnp.linalg.norm(res_j.x))
    assert diff < 1e-7


def test_levels_stop_at_odd_nel():
    """Coarsening stops when an axis goes odd; the hierarchy still solves."""
    pre = gmg_for_system((24, 20), GEOM, 1.0, 1e-2)
    assert [lev.shape for lev in pre.levels] == [(21, 25), (11, 13)]
    m_st, k_st = _stencils(24, 20)
    a_st = m_st + 1e-2 * k_st
    interior = _interior(21, 25)
    apply_c = _constrained(a_st, interior)
    rng = np.random.default_rng(1)
    b = jnp.asarray(np.where(interior, rng.standard_normal((21, 25)), 0.0))
    res = pcg(apply_c, b, jnp.zeros_like(b), precond_inv_diag=pre,
              reduction=1e-8)
    assert bool(res.converged)


def _standing_u0(x, y):
    return jnp.sin(np.pi * x) * jnp.sin(np.pi * y)


@pytest.mark.parametrize("scheme,kw", [
    ("newmark", dict(beta=0.25, gamma=0.5, lumped=False)),
    ("theta", dict(theta=0.5)),
])
def test_stepper_mg_matches_jacobi_path(scheme, kw):
    """run_implicit_mg reproduces the Jacobi-CG implicit trajectory (both
    solve to the same ReductionControl contract) at a CFL-breaking dt."""
    mk = lambda: FastWaveSolver((32, 32), GEOM, 0.02, scheme=scheme,
                                dtype=jnp.float64, cg_reduction=1e-11, **kw)
    s1, s2 = mk(), mk()
    st = s1.initial_state(_standing_u0)
    ref = s1.run_scan(st, 20)
    got = s2.run_implicit_mg(st, 20)
    for name in ("u", "v"):
        r, g = getattr(ref, name), getattr(got, name)
        denom = float(jnp.linalg.norm(r)) or 1.0
        assert float(jnp.linalg.norm(r - g)) / denom < 1e-8


def test_stepper_mg_sharded():
    """MG stepping under 8-way row sharding matches single-device."""
    from tpuwave.parallel.sharding import device_mesh, grid_sharding
    mesh = device_mesh(8)
    sh = grid_sharding(mesh)
    mk = lambda s: FastWaveSolver((16, 23), GEOM, 0.02, scheme="theta",
                                  theta=1.0, dtype=jnp.float64, sharding=s)
    single = mk(None)
    st = single.initial_state(_standing_u0)
    ref = single.run_implicit_mg(st, 10)
    sharded = mk(sh)
    st_s = sharded.initial_state(_standing_u0)
    assert len(st_s.u.sharding.device_set) == 8
    got = sharded.run_implicit_mg(st_s, 10)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               atol=1e-12)


# ----------------------------------------------------------------------
# general (parity) path: --precond mg on the flat-DoF solvers
# ----------------------------------------------------------------------

def test_general_theta_mg_mode():
    """ThetaSolver(precond='mg') reproduces the Jacobi trajectory at a
    CFL-breaking dt with far fewer u-solve iterations."""
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params

    p = load_params(standing_mode(Nel="40", Dt="0.2", T="1.0"))
    d = Discretization(p)
    s_j = ThetaSolver(d)
    s_m = ThetaSolver(d, precond="mg")
    st_j, st_m = s_j.initial_state(), s_m.initial_state()
    t = 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        st_j, info_j = s_j.step(st_j, t)
        st_m, info_m = s_m.step(st_m, t)
    nrm = float(jnp.linalg.norm(st_j.u))
    assert float(jnp.linalg.norm(st_j.u - st_m.u)) < 1e-4 * nrm
    assert int(info_m["iterations_1"]) < int(info_j["iterations_1"])


def test_general_newmark_mg_mode():
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.newmark import NewmarkSolver
    from tpuwave.utils.params import load_params

    p = load_params(standing_mode(Nel="32", Dt="0.1", T="0.5"))
    d = Discretization(p)
    s_j = NewmarkSolver(d)
    s_m = NewmarkSolver(d, precond="mg")
    st_j, st_m = s_j.initial_state(), s_m.initial_state()
    t = 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        st_j, _ = s_j.step(st_j, t)
        st_m, _ = s_m.step(st_m, t)
    nrm = float(jnp.linalg.norm(st_j.u))
    assert float(jnp.linalg.norm(st_j.u - st_m.u)) < 1e-4 * nrm


def test_general_mg_mode_rejects_variable_c():
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params

    pc = load_params(standing_mode(
        Nel="8", C={"Function expression": "1.0 + 0.5*x",
                    "Variable names": "x, y, t"}))
    with pytest.raises(ValueError, match="constant"):
        ThetaSolver(Discretization(pc), precond="mg")


# ----------------------------------------------------------------------
# P2: the (p+h)-multigrid
# ----------------------------------------------------------------------

def test_p2_transfer_adjoint():
    """<P c, f>_P2 == <c, R f>_P1 for the P2 <- P1 nodal inclusion."""
    from tpuwave.ops.stencil_p2 import p2_plane_shapes
    from tpuwave.solve.multigrid import prolong_p1_to_p2, restrict_p2_to_p1

    rng = np.random.default_rng(5)
    nx, ny = 6, 4
    c = jnp.asarray(rng.standard_normal((ny + 1, nx + 1)))
    planes = {p: jnp.asarray(rng.standard_normal(s))
              for p, s in p2_plane_shapes(nx, ny).items()}
    pc = prolong_p1_to_p2(c)
    lhs = sum(float(jnp.vdot(pc[p], planes[p])) for p in pc)
    rhs = float(jnp.vdot(c, restrict_p2_to_p1(planes)))
    assert abs(lhs - rhs) < 1e-12


def test_p2_galerkin_is_p1_operator():
    """R A_P2 P == A_P1 on interior nodes (P1 subset of P2, same mesh)."""
    from tpuwave.ops.stencil_p2 import P2PlaneStencil, planes_to_flat, \
        flat_to_planes
    from tpuwave.solve.multigrid import prolong_p1_to_p2, restrict_p2_to_p1

    geom = ((0.0, 0.0), (2.0, 1.0))
    nx, ny = 6, 4
    coef = 0.23
    space2 = FeSpace(StructuredTriMesh((nx, ny), geom), 2)
    quad = gauss_simplex(3)
    m2 = P2PlaneStencil(space2, element_mass_class(space2, quad),
                        jnp.float64)
    k2 = P2PlaneStencil(space2,
                        element_stiffness_class(space2, quad, 1.69),
                        jnp.float64)
    a2 = m2.axpy(coef, k2)
    m1, k1 = _stencils(nx, ny, c=1.3, geom=geom)
    a1 = m1 + coef * k1
    for (i, j) in [(1, 1), (2, 3), (ny - 1, nx - 1)]:
        e = jnp.zeros((ny + 1, nx + 1)).at[i, j].set(1.0)
        w = restrict_p2_to_p1(flat_to_planes(
            a2(planes_to_flat(prolong_p1_to_p2(e))), nx, ny))
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                assert abs(float(w[i + dj, j + di]) - a1[1 + dj, 1 + di]) \
                    < 1e-13


def test_p2_vcycle_is_spd():
    from tpuwave.solve.multigrid import p2_gmg_for_system

    nx = ny = 6
    pre = p2_gmg_for_system((nx, ny), GEOM, 1.0, 0.1)
    n = (nx + 1) * (ny + 1) + (ny + 1) * nx + ny * (nx + 1) + nx * ny
    b = np.zeros((n, n))
    for i in range(n):
        e = jnp.zeros(n).at[i].set(1.0)
        b[:, i] = np.asarray(pre(e))
    assert np.abs(b - b.T).max() < 1e-11
    assert np.linalg.eigvalsh(0.5 * (b + b.T)).min() > 0.0


@pytest.mark.parametrize("dt2", [1e-3, 1.0])
def test_p2_mg_pcg_dt_independent(dt2):
    """MG-PCG on the P2 system: small iteration count at any dt, matching
    the Jacobi-CG solution."""
    from tpuwave.models.fast_p2 import P2FastSolver
    from tpuwave.solve.multigrid import p2_gmg_for_system

    nel = 32
    s = P2FastSolver((nel, nel), GEOM, 1.0, scheme="theta", theta=1.0,
                     dtype=jnp.float64)
    a_op = s.mass.axpy(dt2, s.stiff)
    interior = s._interior
    diag = a_op.diagonal()

    def apply_c(x):
        xi = jnp.where(interior, x, 0.0)
        return jnp.where(interior, a_op(xi), diag * x)

    rng = np.random.default_rng(0)
    b = jnp.asarray(np.where(np.asarray(interior),
                             rng.standard_normal(s.n_dofs), 0.0))
    pre = p2_gmg_for_system((nel, nel), GEOM, 1.0, dt2)
    res = pcg(apply_c, b, jnp.zeros_like(b), precond_inv_diag=pre,
              reduction=1e-10)
    assert bool(res.converged)
    assert int(res.iterations) <= 20
    res_j = pcg(apply_c, b, jnp.zeros_like(b), precond_inv_diag=1.0 / diag,
                reduction=1e-10, max_iter=100000)
    diff = float(jnp.linalg.norm(res.x - res_j.x)
                 / jnp.linalg.norm(res_j.x))
    assert diff < 1e-7


def test_p2_solver_mg_matches_jacobi_path():
    """P2FastSolver(precond='mg') reproduces the Jacobi trajectory at a
    CFL-breaking dt."""
    from tpuwave.models.fast_p2 import P2FastSolver

    u0 = _standing_u0
    mk = lambda prec: P2FastSolver((16, 16), GEOM, 0.05, scheme="newmark",
                                   beta=0.25, dtype=jnp.float64,
                                   cg_reduction=1e-11, precond=prec)
    s_j, s_m = mk("jacobi"), mk("mg")
    st = s_j.initial_state(u0)
    ref = s_j.run_scan(st, 10)
    got = s_m.run_scan(st, 10)
    for name in ("u", "v"):
        r, g = getattr(ref, name), getattr(got, name)
        denom = float(jnp.linalg.norm(r)) or 1.0
        assert float(jnp.linalg.norm(r - g)) / denom < 1e-8


@pytest.mark.parametrize("scheme,kw", [
    ("newmark", {"beta": 0.25}),
    ("theta", {"theta": 0.5}),
])
def test_p2canvas_mg_matches_jacobi(scheme, kw):
    """P2CanvasSolver(precond='mg') — the shardable canvas layout —
    reproduces the Jacobi trajectory at a CFL-breaking dt."""
    from tpuwave.models.fast_p2 import P2CanvasSolver

    mk = lambda prec: P2CanvasSolver((16, 16), GEOM, 0.05, scheme=scheme,
                                     dtype=jnp.float64, cg_reduction=1e-11,
                                     precond=prec, **kw)
    s_j, s_m = mk("jacobi"), mk("mg")
    st = s_j.initial_state(_standing_u0)
    ref = s_j.run_scan(st, 10)
    got = s_m.run_scan(st, 10)
    for name in ("u", "v"):
        r, g = s_j.to_flat(getattr(ref, name)), s_m.to_flat(getattr(got, name))
        denom = float(jnp.linalg.norm(r)) or 1.0
        assert float(jnp.linalg.norm(r - g)) / denom < 1e-8


def test_p2canvas_mg_matches_flat_cycle():
    """The canvas V-cycle is the SAME polynomial as the flat
    P2GmgPreconditioner — identical output on matching residuals."""
    from tpuwave.models.fast_p2 import P2CanvasSolver
    from tpuwave.solve.multigrid import p2_gmg_for_system

    nel, dt = 12, 0.05
    s = P2CanvasSolver((nel, nel), GEOM, dt, scheme="newmark", beta=0.25,
                       dtype=jnp.float64, precond="mg",
                       mg_pre_degree=1, mg_smooth_range=8.0)
    coef = 0.25 * dt * dt
    flat_pre = p2_gmg_for_system((nel, nel), GEOM, 1.0, coef,
                                 pre_degree=1, smooth_range=8.0)
    rng = np.random.default_rng(3)
    b_flat = jnp.asarray(np.where(np.asarray(flat_pre.interior),
                                  rng.standard_normal(s.n_dofs), 0.0))
    from tpuwave.ops.stencil_p2 import flat_to_planes, planes_to_canvases
    b_canvas = planes_to_canvases(flat_to_planes(b_flat, nel, nel), s.cshape)
    z_flat = flat_pre(b_flat)
    z_canvas = s.to_flat(s._sys_prec(b_canvas))
    np.testing.assert_allclose(np.asarray(z_canvas), np.asarray(z_flat),
                               rtol=1e-12, atol=1e-13)


def test_p2canvas_mg_padded_matches_unpadded():
    """Canvas MG on a canvas padded to a row multiple of 8 (the sharded
    layout) matches the unpadded canvas-MG trajectory: pads stay pinned
    through the smoothing and the p<->h transfers."""
    from tpuwave.models.fast_p2 import P2CanvasSolver

    mk = lambda rm: P2CanvasSolver(
        (16, 16), GEOM, 0.05, scheme="newmark", beta=0.25,
        dtype=jnp.float64, cg_reduction=1e-11, precond="mg",
        row_multiple=rm)
    s_x, s_p = mk(1), mk(8)
    assert s_p.cshape != s_x.cshape
    ref = s_x.run_scan(s_x.initial_state(_standing_u0), 6)
    got = s_p.run_scan(s_p.initial_state(_standing_u0), 6)
    r, g = s_x.to_flat(ref.u), s_p.to_flat(got.u)
    denom = float(jnp.linalg.norm(r)) or 1.0
    assert float(jnp.linalg.norm(r - g)) / denom < 1e-9


def test_p2canvas_mg_sharded_matches_single():
    """Canvas MG composes with row sharding: the V-cycle's transfers and
    the P1 hierarchy lower under GSPMD, 8-device == single device."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpuwave.models.fast_p2 import P2CanvasSolver
    from tpuwave.parallel.sharding import device_mesh

    mesh = device_mesh(8)
    sh = NamedSharding(mesh, P(None, "y", None))
    kw = dict(dtype=jnp.float64, cg_reduction=1e-11, precond="mg",
              scheme="newmark", beta=0.25)
    single = P2CanvasSolver((12, 12), GEOM, 0.05, **kw)
    want = single.run_scan(single.initial_state(_standing_u0), 4)
    sharded = P2CanvasSolver((12, 12), GEOM, 0.05, sharding=sh,
                             row_multiple=8, **kw)
    st = sharded.initial_state(_standing_u0)
    assert len(st.u.sharding.device_set) == 8
    got = sharded.run_scan(st, 4)
    np.testing.assert_allclose(np.asarray(sharded.to_flat(got.u)),
                               np.asarray(single.to_flat(want.u)),
                               rtol=1e-10, atol=1e-12)


def test_p2canvas_unknown_precond_raises():
    from tpuwave.models.fast_p2 import P2CanvasSolver
    with pytest.raises(ValueError, match="preconditioner"):
        P2CanvasSolver((8, 8), GEOM, 0.01, precond="amg")


def test_general_theta_p2_mg_mode():
    """ThetaSolver(precond='mg') on R=2: the flat general-path numbering
    matches the plane concatenation, so the P2 cycle drops straight in."""
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params

    p = load_params(standing_mode(Nel="16", R="2", Dt="0.2", T="0.6"))
    d = Discretization(p)
    s_j = ThetaSolver(d)
    s_m = ThetaSolver(d, precond="mg")
    st_j, st_m = s_j.initial_state(), s_m.initial_state()
    t = 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        st_j, info_j = s_j.step(st_j, t)
        st_m, info_m = s_m.step(st_m, t)
    nrm = float(jnp.linalg.norm(st_j.u))
    assert float(jnp.linalg.norm(st_j.u - st_m.u)) < 1e-4 * nrm
    assert int(info_m["iterations_1"]) < int(info_j["iterations_1"])


@pytest.mark.parametrize("family", ["theta", "newmark"])
def test_general_mg_time_dependent_g(family):
    """precond='mg' under NONZERO time-dependent Dirichlet data: the
    cycle only ever sees constrained residuals (zero on boundary rows),
    so trajectories must match the Jacobi path — including Newmark's
    derived acceleration BCs."""
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.newmark import NewmarkSolver
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params

    case = standing_mode(
        Nel="12", Dt="0.1", T="0.5",
        U0={"Function expression": "0.0", "Variable names": "x, y"},
        G={"Function expression": "0.2*sin(3*t)*x", "Variable names": "x, y, t"},
        DGDT={"Function expression": "0.6*cos(3*t)*x",
              "Variable names": "x, y, t"})
    case.pop("Solution")
    p = load_params(case)
    d = Discretization(p)
    mk = ThetaSolver if family == "theta" else NewmarkSolver
    s_j, s_m = mk(d), mk(d, precond="mg")
    st_j, st_m = s_j.initial_state(), s_m.initial_state()
    t = 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        st_j, _ = s_j.step(st_j, t)
        st_m, _ = s_m.step(st_m, t)
    nrm = float(jnp.linalg.norm(st_j.u)) or 1.0
    assert float(jnp.linalg.norm(st_j.u - st_m.u)) / nrm < 1e-5
    # boundary values are pinned to g(t) exactly in both
    bnd = np.asarray(d.boundary_mask)
    g_t = np.asarray(d.boundary_values(p.g, t))
    np.testing.assert_allclose(np.asarray(st_m.u)[bnd], g_t[bnd],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("aspect,max_iters", [(2.0, 14), (8.0, 40)])
def test_mg_pcg_anisotropic_mesh(aspect, max_iters):
    """Point-smoothing GMG degrades gracefully under cell anisotropy
    (hx != hy weakens the smoother in the strong direction); CG
    compensates — convergence is kept, iterations grow mildly
    (measured 10 -> 19 -> 32 at 1:1 -> 4:1 -> 8:1)."""
    geom = ((0.0, 0.0), (aspect, 1.0))
    nel = (64, 64)
    m_st, k_st = _stencils(*nel, geom=geom)
    a_st = m_st + 1e-2 * k_st
    h, w = nel[1] + 1, nel[0] + 1
    interior = _interior(h, w)
    apply_c = _constrained(a_st, interior)
    rng = np.random.default_rng(0)
    b = jnp.asarray(np.where(interior, rng.standard_normal((h, w)), 0.0))
    pre = gmg_for_system(nel, geom, 1.0, 1e-2)
    res = pcg(apply_c, b, jnp.zeros_like(b), precond_inv_diag=pre,
              reduction=1e-10)
    assert bool(res.converged)
    assert int(res.iterations) <= max_iters


def test_vcycle_is_linear_and_confined():
    """The multi-level V-cycle is a fixed linear operator (a valid CG
    preconditioner needs no data-dependent steps) whose output stays on
    the interior (pinned rows come back zero) at a 3-level hierarchy."""
    nel, dt2 = 32, 0.37
    pre = gmg_for_system((nel, nel), GEOM, 1.0, dt2)
    assert len(pre.levels) >= 3
    h = w = nel + 1
    interior = _interior(h, w)
    rng = np.random.default_rng(7)
    b1, b2 = (jnp.asarray(np.where(interior, rng.standard_normal((h, w)),
                                   0.0)) for _ in range(2))
    z = pre(2.5 * b1 + b2)
    np.testing.assert_allclose(np.asarray(z),
                               np.asarray(2.5 * pre(b1) + pre(b2)),
                               rtol=1e-12, atol=1e-13)
    assert float(jnp.abs(jnp.where(interior, 0.0, z)).max()) == 0.0


@pytest.mark.parametrize("scheme,kw", [
    ("theta", {"theta": 1.0}),
    ("newmark", {"beta": 0.25, "gamma": 0.6, "lumped": False}),
])
def test_stepper_mg_matches_jacobi_path_rectangular(scheme, kw):
    """run_implicit_mg reproduces the Jacobi-CG trajectory for backward
    Euler and dissipative Newmark on a rectangular grid at a
    CFL-breaking dt."""
    mk = lambda: FastWaveSolver((32, 24), GEOM, 0.02, scheme=scheme,
                                dtype=jnp.float64, cg_reduction=1e-11, **kw)
    s1, s2 = mk(), mk()
    st = s1.initial_state(_standing_u0)
    ref = s1.run_scan(st, 8)
    got = s2.run_implicit_mg(st, 8)
    for name in ("u", "v"):
        r, g = getattr(ref, name), getattr(got, name)
        denom = float(jnp.linalg.norm(r)) or 1.0
        assert float(jnp.linalg.norm(r - g)) / denom < 1e-8


def test_stepper_mg_single_level_grid():
    """A grid too small to coarsen (one-level hierarchy: the V-cycle is
    just the coarse Chebyshev solve) still reproduces the Jacobi-CG
    trajectory."""
    mk = lambda: FastWaveSolver((8, 8), GEOM, 0.02, scheme="theta",
                                theta=1.0, dtype=jnp.float64,
                                cg_reduction=1e-11)
    s1, s2 = mk(), mk()
    assert len(s2.gmg_preconditioner().levels) == 1
    st = s1.initial_state(_standing_u0)
    ref = s1.run_scan(st, 5)
    got = s2.run_implicit_mg(st, 5)
    denom = float(jnp.linalg.norm(ref.u))
    assert float(jnp.linalg.norm(got.u - ref.u)) / denom < 1e-8


# ----------------------------------------------------------------------
# displacement-form (two-array) implicit Newmark
# (FastWaveSolver.run_implicit_mg_2term)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scheme,kw,check_a", [
    ("newmark", dict(beta=0.25, gamma=0.5, lumped=False), True),
    ("newmark", dict(beta=0.25, gamma=0.6, lumped=False), True),
    ("theta", dict(theta=0.5), False),
    ("theta", dict(theta=1.0), False),
    ("theta", dict(theta=0.7), False),
])
def test_implicit_2term_matches_3array(scheme, kw, check_a):
    """The 3-term displacement recurrence + exact (u,u_prev)->(u,v[,a])
    conversion reproduces the 3-array implicit trajectory for BOTH
    families; the elimination of the auxiliary variables is
    algebraically exact, so agreement is to the CG tolerances, not
    O(dt). (theta carries no acceleration state, so a is not compared
    there.)"""
    mk = lambda: FastWaveSolver((32, 32), GEOM, 0.02, scheme=scheme,
                                dtype=jnp.float64, cg_reduction=1e-11, **kw)
    s1, s2 = mk(), mk()
    st = (s1.initial_state_consistent(_standing_u0) if scheme == "newmark"
          else s1.initial_state(_standing_u0))
    n = 20
    ref = s1.run_implicit_mg(st, n)
    lf = s2.run_implicit_mg_2term(s2.implicit_2term_init(st), n - 1)
    got = s2.implicit_2term_finish(lf)
    names = (("u", 1e-8), ("v", 1e-8)) + ((("a", 1e-5),) if check_a else ())
    for name, tol in names:
        # a's looser bound: CG-tolerance residuals amplified by
        # M^{-1} (~tau/lam_min(M)) on BOTH paths' consistent-a solves
        r, g = getattr(ref, name), getattr(got, name)
        denom = float(jnp.linalg.norm(r)) or 1.0
        assert float(jnp.linalg.norm(r - g)) / denom < tol, name


def test_implicit_2term_chunks_compose():
    """The 2-term scan is a pure function of the state pair: 8 steps in
    one compiled scan == two scans of 4."""
    s = FastWaveSolver((32, 32), GEOM, 0.02, scheme="newmark", beta=0.25,
                       lumped=False, dtype=jnp.float64)
    lf0 = s.implicit_2term_init(s.initial_state_consistent(_standing_u0))
    ref = s.run_implicit_mg_2term(lf0, 8)
    got = s.run_implicit_mg_2term(s.run_implicit_mg_2term(lf0, 4), 4)
    denom = float(jnp.linalg.norm(ref.u))
    assert float(jnp.linalg.norm(ref.u - got.u)) / denom < 1e-13
    assert float(jnp.linalg.norm(ref.u_prev - got.u_prev)) / denom < 1e-13


@pytest.mark.parametrize("scheme,kw,check_a", [
    ("newmark", dict(beta=0.25, gamma=0.5), True),
    ("theta", dict(theta=0.5), False),
    ("theta", dict(theta=1.0), False),
])
def test_p2canvas_2term_matches_3array(scheme, kw, check_a):
    """P2CanvasSolver.run_implicit_2term + exact conversions reproduce
    the canvas 3-array trajectory (see test_implicit_2term_matches_3array
    for the P1 version and the bound rationale)."""
    from tpuwave.models.fast_p2 import P2CanvasSolver

    mk = lambda: P2CanvasSolver((12, 12), GEOM, 0.05, scheme=scheme,
                                dtype=jnp.float64, cg_reduction=1e-11,
                                precond="mg", **kw)
    s1, s2 = mk(), mk()
    st = s1.initial_state(_standing_u0)
    n = 12
    ref = s1.run_scan(st, n)
    pair = s2.run_implicit_2term(s2.implicit_2term_init(st), n - 1)
    got = s2.implicit_2term_finish(pair)
    names = (("u", 1e-8), ("v", 1e-8)) + ((("a", 1e-5),) if check_a else ())
    for name, tol in names:
        r = s1.to_flat(getattr(ref, name))
        g = s2.to_flat(getattr(got, name))
        denom = float(jnp.linalg.norm(r)) or 1.0
        assert float(jnp.linalg.norm(r - g)) / denom < tol, name


def test_implicit_2term_sharded_matches_single():
    """The XLA 2-term path under 8-way row sharding (GSPMD collective-
    permute halos + psum'd norms) matches single-device."""
    from tpuwave.parallel.sharding import device_mesh, grid_sharding
    mesh = device_mesh(8)
    sh = grid_sharding(mesh)
    mk = lambda s: FastWaveSolver((16, 23), GEOM, 0.02, scheme="newmark",
                                  beta=0.25, lumped=False,
                                  dtype=jnp.float64, sharding=s)
    single = mk(None)
    st = single.initial_state_consistent(_standing_u0)
    ref = single.run_implicit_mg_2term(single.implicit_2term_init(st), 10)
    sharded = mk(sh)
    st_s = sharded.initial_state_consistent(_standing_u0)
    got = sharded.run_implicit_mg_2term(sharded.implicit_2term_init(st_s),
                                        10)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               atol=1e-12)


def test_implicit_2term_compensated_beats_plain():
    """run_implicit_mg_2term_comp with a tightened noise floor tracks the
    f64 2-term trajectory well below the plain f32 path (the CG-leftover
    + state-rounding kicks; measured 78x at 256^2/300 steps with
    tol_factor=1e-3 — assert a conservative 8x here)."""
    n, dt, steps = 128, 4e-3, 150
    mk = lambda d: FastWaveSolver((n, n), GEOM, dt, scheme="newmark",
                                  beta=0.25, lumped=False, dtype=d)
    s64 = mk(jnp.float64)
    ref = s64.run_implicit_mg_2term(
        s64.implicit_2term_init(s64.initial_state_consistent(_standing_u0)),
        steps - 1)
    s32 = mk(jnp.float32)
    st32 = s32.initial_state_consistent(_standing_u0)
    plain = s32.run_implicit_mg_2term(s32.implicit_2term_init(st32),
                                      steps - 1)
    comp = s32.run_implicit_mg_2term_comp(
        s32.implicit_2term_init_comp(st32), steps - 1,
        tol_factor=1e-3)
    den = float(jnp.linalg.norm(ref.u))
    ep = float(jnp.linalg.norm(plain.u.astype(jnp.float64) - ref.u)) / den
    full = comp.u.astype(jnp.float64) + comp.u_lo.astype(jnp.float64)
    ec = float(jnp.linalg.norm(full - ref.u)) / den
    assert ec < ep / 8
    got = s32.implicit_2term_finish_comp(comp)
    assert got.u.shape == ref.u.shape  # conversion path wired


def test_implicit_2term_comp_driven_tracks_f64():
    """run_implicit_mg_2term_comp_driven (round-5: the compensated row
    measured on the DRIVEN config) tracks the f64 driven 2-term product
    engine trajectory at ~f48 accuracy: a broken boundary lift would err
    at O(dt^2 g_tt) ~ 1e-3, a missing boundary fill at O(1); measured
    4.2e-7 rel at 24^2/20 steps."""
    from tpuwave.models.fast_engine import make_fast_solver
    from tpuwave.utils.params import load_params
    n, dt, steps = 24, 1e-2, 20
    case = {
        "Nel": str(n), "R": "1", "T": "1.0", "Theta": "0.5",
        "Dt": str(dt), "Save Solution": "false", "Log Every": "0",
        "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
        "F": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "U0": {"Function expression": "0.0", "Variable names": "x, y"},
        "V0": {"Function expression": "0.0", "Variable names": "x, y"},
        "G": {"Function expression":
              "if(y < 0.0001 && x < 0.34, sin(4*pi*t), 0)",
              "Variable names": "x, y, t"},
        "DGDT": {"Function expression":
                 "if(y < 0.0001 && x < 0.34, 4*pi*cos(4*pi*t), 0)",
                 "Variable names": "x, y, t"},
    }
    eng = make_fast_solver(load_params(case), "theta", solver="2term",
                           precond="mg")
    assert eng.dtype == jnp.float64   # conftest x64 parity mode
    ts = dt * (1.0 + jnp.arange(steps, dtype=jnp.float64))
    out, _ = eng.run_steps(eng.initial_state(), ts)
    u_ref = np.asarray(eng.disc.vertex_values(out.u),
                       np.float64).reshape(n + 1, n + 1)

    s32 = FastWaveSolver((n, n), GEOM, dt, scheme="theta", theta=0.5,
                         lumped=False, dtype=jnp.float32)

    def g_strip(xs, ys, t):
        return jnp.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                         jnp.sin(4.0 * jnp.pi * t), 0.0)

    def u0_zero(x, y):
        return jnp.zeros_like(x)

    cs = s32.implicit_2term_init_comp(s32.initial_state(u0_zero))
    ts32 = dt * (1.0 + jnp.arange(steps, dtype=jnp.float32))
    got = s32.run_implicit_mg_2term_comp_driven(cs, ts32, g_strip)
    full = np.asarray(got.u, np.float64) + np.asarray(got.u_lo, np.float64)
    rel = (np.max(np.abs(full - u_ref))
           / max(np.max(np.abs(u_ref)), 1e-30))
    assert rel < 3e-6, rel


def test_implicit_2term_comp_rejects_f64():
    s = FastWaveSolver((16, 16), GEOM, 0.02, scheme="newmark", beta=0.25,
                       lumped=False, dtype=jnp.float64)
    st = s.initial_state(_standing_u0)
    with pytest.raises(ValueError):
        s.run_implicit_mg_2term_comp(s.implicit_2term_init_comp(st), 2)


def test_implicit_2term_rejects_explicit_newmark():
    s = FastWaveSolver((16, 16), GEOM, 0.02, scheme="newmark", beta=0.0)
    st = s.initial_state(_standing_u0)
    from tpuwave.models.fast import LeapfrogState
    with pytest.raises(ValueError):
        s.run_implicit_mg_2term(LeapfrogState(u=st.u, u_prev=st.u), 2)


# ----------------------------------------------------------------------
# precond='auto' (solve/multigrid.py::auto_precond)
# ----------------------------------------------------------------------

def test_auto_precond_resolution():
    """'auto' resolves to mg exactly when the system is stiffness-
    dominated (q = coef*c^2/(hx*hy) >= AUTO_MG_THRESHOLD) on an
    mg-eligible discretisation, jacobi otherwise."""
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.newmark import NewmarkSolver
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params

    # CFL-breaking dt: q = (0.5*0.5)^2 * 32^2 = 64 (theta) / 64 (newmark)
    d_big = Discretization(load_params(standing_mode(Nel="32", Dt="0.5")))
    assert ThetaSolver(d_big, precond="auto").precond == "mg"
    assert NewmarkSolver(d_big, precond="auto").precond == "mg"
    # CFL-scale dt: q = 0.0256 -> jacobi
    d_small = Discretization(load_params(standing_mode(Nel="32", Dt="0.01")))
    assert ThetaSolver(d_small, precond="auto").precond == "jacobi"
    assert NewmarkSolver(d_small, precond="auto").precond == "jacobi"
    # explicit Newmark beta=0 at any dt: the a-system is M -> jacobi
    d_exp = Discretization(load_params(standing_mode(Nel="32", Dt="0.5",
                                                     Beta="0")))
    assert NewmarkSolver(d_exp, precond="auto").precond == "jacobi"
    # explicit theta=0 (FE): the u-system is M -> jacobi
    d_fe = Discretization(load_params(standing_mode(Nel="32", Dt="0.5",
                                                    Theta="0")))
    assert ThetaSolver(d_fe, precond="auto").precond == "jacobi"


def test_auto_precond_ineligible_cases_fall_back():
    """auto stays conservative under time-dependent C (resolves to
    jacobi); an EXPLICIT mg request builds the frozen-coefficient
    hierarchy instead of raising (round 3 — a fixed SPD V-cycle is a
    valid preconditioner for the per-step-varying system)."""
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params

    case = standing_mode(
        Nel="16", Dt="0.5",
        C={"Function expression": "1.0 + 0.1*t", "Variable names": "x, y, t"},
        **{"Time Dependent C": "true"})
    case.pop("Solution")
    d = Discretization(load_params(case))
    s = ThetaSolver(d, precond="auto")
    assert s.precond == "jacobi"
    s_mg = ThetaSolver(d, precond="mg")
    assert s_mg.precond == "mg" and callable(s_mg.prec_u)


def test_auto_precond_matches_jacobi_trajectory():
    """At large dt the auto(=mg) and jacobi solvers agree to CG tolerance
    — preconditioning changes the path to the solution, not the
    solution."""
    from tests.test_schemes import standing_mode
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.theta import ThetaSolver
    from tpuwave.utils.params import load_params

    # q = (0.5*0.4)^2 * 16^2 = 10.24 >= AUTO_MG_THRESHOLD -> mg
    p = load_params(standing_mode(Nel="16", Dt="0.4", T="1.2"))
    d = Discretization(p)
    s_a, s_j = ThetaSolver(d, precond="auto"), ThetaSolver(d)
    assert s_a.precond == "mg"
    st_a, st_j = s_a.initial_state(), s_j.initial_state()
    t = 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        st_a, _ = s_a.step(st_a, t)
        st_j, _ = s_j.step(st_j, t)
    nrm = float(jnp.linalg.norm(st_j.u))
    assert float(jnp.linalg.norm(st_a.u - st_j.u)) < 1e-4 * nrm


def test_auto_precond_p2_solvers():
    """The fast P2 solvers resolve 'auto' the same way."""
    from tpuwave.models.fast_p2 import P2CanvasSolver, P2FastSolver

    big = P2FastSolver((16, 16), GEOM, 0.5, dtype=jnp.float64,
                       precond="auto")
    assert big.precond == "mg"
    small = P2FastSolver((16, 16), GEOM, 0.01, dtype=jnp.float64,
                         precond="auto")
    assert small.precond == "jacobi"
    cbig = P2CanvasSolver((16, 16), GEOM, 0.5, dtype=jnp.float64,
                          precond="auto")
    assert cbig.precond == "mg"
