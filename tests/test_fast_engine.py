"""Fast grid-stencil engine on the product surface (models/fast_engine.py).

Pins the round-3 contract: driven time-dependent Dirichlet data and
quadrature-consistent forcing run on the stencil fast path with
trajectories matching the parity engine to f64 solver tolerance
(reference rhs assembly WaveTheta.cpp:119-186, derived acceleration BCs
WaveNewmark.cpp:177-262), and the CLI reaches the fast engine via
``--engine fast|auto`` with identical run-folder artifacts.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from tpuwave.models.discretization import Discretization
from tpuwave.models.fast_engine import (FastNewmarkSolver, FastThetaSolver,
                                        fast_engine_ineligible_reason)
from tpuwave.models.newmark import NewmarkSolver
from tpuwave.models.theta import ThetaSolver
from tpuwave.utils.params import load_params

from tests.test_schemes import standing_mode

DRIVEN = {
    "F": {"Function expression": "sin(3*pi*x)*cos(2*pi*y)*cos(5*t)",
          "Variable names": "x, y, t"},
    "G": {"Function expression": "0.1*sin(2*t)*(1+x*y)",
          "Variable names": "x, y, t"},
    "DGDT": {"Function expression": "0.2*cos(2*t)*(1+x*y)",
             "Variable names": "x, y, t"},
}


def driven_case(**over):
    case = standing_mode(**DRIVEN)
    case.pop("Solution")
    case.update(over)
    return case


def _run(solver, p):
    st = solver.initial_state()
    t, info = 0.0, None
    while t < p.t_final - 1e-12:
        t += p.dt
        st, info = solver.step(st, t)
    return st, info


@pytest.mark.parametrize("fam,over", [
    ("theta", {"Theta": "0.5"}),
    ("theta", {"Theta": "1.0"}),
    ("newmark", {"Beta": "0.25"}),
    ("newmark", {"Beta": "0.0"}),
])
def test_driven_forced_matches_parity(fam, over):
    """Driven g(t) + forcing: fast engine == parity engine to f64 CG
    tolerance (measured agreement ~1e-14; same iteration counts)."""
    p = load_params(driven_case(**over))
    d = Discretization(p)
    if fam == "theta":
        ref, fast = ThetaSolver(d), FastThetaSolver(d)
    else:
        ref, fast = NewmarkSolver(d), FastNewmarkSolver(d)
    st_r, info_r = _run(ref, p)
    st_f, info_f = _run(fast, p)
    nu = float(jnp.linalg.norm(st_r.u))
    nv = float(jnp.linalg.norm(st_r.v))
    assert float(jnp.linalg.norm(st_r.u - st_f.u)) < 1e-11 * nu
    assert float(jnp.linalg.norm(st_r.v - st_f.v)) < 1e-11 * nv
    assert int(info_r["iterations_1"]) == int(info_f["iterations_1"])


def test_driven_scan_path_matches_per_step():
    """ScanMixin whole-loop scans reproduce the per-step trajectory (the
    runner's chunked fast path) on a driven problem."""
    p = load_params(driven_case())
    d = Discretization(p)
    fast = FastThetaSolver(d)
    st_steps, _ = _run(fast, p)
    times = []
    t = 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        times.append(t)
    st_scan, infos = fast.run_steps(fast.initial_state(), times)
    assert float(jnp.linalg.norm(st_steps.u - st_scan.u)) == 0.0
    assert infos["iterations_1"].shape == (len(times),)


def test_grid_load_matches_parity_load_vector():
    """grid_load is the SAME r+1-rule quadrature assembly as the parity
    Discretization.load_vector (reference WaveTheta.cpp:164-172) — they
    agree to f64 roundoff, not just in accuracy class."""
    p = load_params(driven_case())
    d = Discretization(p)
    fast = FastThetaSolver(d)
    for t in (0.0, 0.37, 1.42):
        L_ref = d.load_vector(t)
        L_fast = fast.fs.grid_load(p.f.evaluate, t).reshape(-1)
        rel = float(jnp.linalg.norm(L_ref - L_fast)
                    / jnp.linalg.norm(L_ref))
        assert rel < 1e-13


def test_mms_rough_forcing_spatial_order():
    """MMS with a rough forcing: the consistent load keeps the fast
    engine at the P1 spatial order (L2 slope ~2; a vertex-lumped load
    measurably degrades the constant). u_ex = sin(3 pi x) sin(2 pi y)
    cos t -> f = (13 pi^2 - 1) u_ex."""
    mms = {
        "U0": {"Function expression": "sin(3*pi*x)*sin(2*pi*y)",
               "Variable names": "x, y"},
        "V0": {"Function expression": "0.0", "Variable names": "x, y"},
        "F": {"Function expression":
              "(13*pi^2 - 1)*sin(3*pi*x)*sin(2*pi*y)*cos(t)",
              "Variable names": "x, y, t"},
        "G": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "DGDT": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "Solution": {"Function expression":
                     "sin(3*pi*x)*sin(2*pi*y)*cos(t)",
                     "Variable names": "x, y, t"},
        "T": "0.1", "Dt": "0.002", "Theta": "0.5",
    }
    errs = []
    for nel in (16, 32):
        p = load_params(standing_mode(**mms, Nel=str(nel)))
        d = Discretization(p)
        fast = FastThetaSolver(d)
        st, _ = _run(fast, p)
        errs.append(float(d.errors(st.u, p.t_final)[2]))
    slope = np.log2(errs[0] / errs[1])
    assert 1.8 < slope < 2.2, (errs, slope)


def test_leapfrog_driven_forcing_mms():
    """Explicit lumped leapfrog with driven g AND consistent forcing
    converges at order 2 on the same rough MMS (models/fast.py
    leapfrog_step_driven + grid_load)."""
    from tpuwave.models.fast import FastWaveSolver

    def u_ex(x, y, t):
        return jnp.sin(3 * jnp.pi * x) * jnp.sin(2 * jnp.pi * y) * jnp.cos(t)

    def f_fn(x, y, t):
        return (13 * jnp.pi ** 2 - 1) * u_ex(x, y, t)

    def g_fn(x, y, t):
        return jnp.zeros_like(x)

    errs = []
    for nel in (16, 32):
        dt = 0.2 / nel  # CFL-safe, scaled
        fs = FastWaveSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), dt,
                            beta=0.0, dtype=jnp.float64)
        st = fs.initial_leapfrog_state(lambda xs, ys: u_ex(xs, ys, 0.0),
                                       f_fn=f_fn, g_fn=g_fn)
        n = int(round(0.1 / dt))
        t = dt  # initial_leapfrog_state already took the first step
        for _ in range(n - 1):
            t += dt
            st = fs.leapfrog_step_driven(st, t, g_fn, f_fn)
        xs, ys = fs.grid_coords()
        err = float(jnp.linalg.norm(st.u - u_ex(xs, ys, t))
                    / jnp.linalg.norm(u_ex(xs, ys, t)))
        errs.append(err)
    slope = np.log2(errs[0] / errs[1])
    assert 1.7 < slope < 2.4, (errs, slope)


def test_ineligible_reasons():
    assert fast_engine_ineligible_reason(
        Discretization(load_params(driven_case()))) is None
    # R=2 is fast-eligible since round 4 (models/fast_engine_p2.py)
    p2 = Discretization(load_params(driven_case(R="2")))
    assert fast_engine_ineligible_reason(p2) is None
    # spatially varying c IS eligible (static varcoef planes)
    varc = Discretization(load_params(driven_case(
        C={"Function expression": "1.0 + 0.5*x",
           "Variable names": "x, y, t"})))
    assert fast_engine_ineligible_reason(varc) is None


@pytest.mark.parametrize("fam", ["theta", "newmark"])
def test_varcoef_matches_parity(fam):
    """Spatially varying c on the fast engine (static 9-plane operator):
    same element algebra as the parity assembly -> f64 agreement."""
    case = driven_case(C={"Function expression": "1.0 + 0.5*x + 0.25*y*y",
                          "Variable names": "x, y, t"})
    p = load_params(case)
    d = Discretization(p)
    if fam == "theta":
        ref, fast = ThetaSolver(d), FastThetaSolver(d)
    else:
        ref, fast = NewmarkSolver(d), FastNewmarkSolver(d)
    st_r, info_r = _run(ref, p)
    st_f, info_f = _run(fast, p)
    assert float(jnp.linalg.norm(st_r.u - st_f.u)) \
        < 1e-11 * float(jnp.linalg.norm(st_r.u))
    assert int(info_r["iterations_1"]) == int(info_f["iterations_1"])


@pytest.mark.parametrize("fam", ["theta", "newmark"])
def test_tdep_matches_parity(fam):
    """`Time Dependent C` on the fast engine: per-step plane rebuild
    inside the jitted step (theta carries K(t^n) scales) — matches the
    parity engine's per-step operator rebuild to f64 tolerance."""
    from tests.test_tdep_c import tdep_case
    p = load_params(tdep_case(Dt="0.02", T="0.1"))
    d = Discretization(p)
    if fam == "theta":
        ref, fast = ThetaSolver(d), FastThetaSolver(d)
    else:
        ref, fast = NewmarkSolver(d), FastNewmarkSolver(d)
    st_r, _ = _run(ref, p)
    st_f, _ = _run(fast, p)
    assert float(jnp.linalg.norm(st_r.u - st_f.u)) \
        < 1e-10 * float(jnp.linalg.norm(st_r.u))
    # MMS accuracy carried over (Nel=16 discretisation error ~8e-3)
    assert float(d.errors(st_f.u, p.t_final)[2]) < 2e-2


# ---------------------------------------------------------------------------
# CLI routing
# ---------------------------------------------------------------------------

def _write(tmp_path, case, name="case.json"):
    path = tmp_path / name
    path.write_text(json.dumps(case))
    return path


def _cli(main, path, tmp_path, root, extra=()):
    return main([str(path), "--results-root", str(tmp_path / root),
                 "--mesh-root", str(tmp_path / "mesh"), "--quiet", *extra])


def test_cli_engine_fast_matches_parity(tmp_path):
    """`--engine fast` produces the standard run folder with CSVs matching
    `--engine parity` digit-for-digit on a driven + forced case."""
    from tpuwave.cli import theta as cli_theta
    case = driven_case(**{"Log Every": "1", "T": "0.05"})
    path = _write(tmp_path, case)
    assert _cli(cli_theta.main, path, tmp_path, "fast",
                ("--engine", "fast")) == 0
    assert _cli(cli_theta.main, path, tmp_path, "par",
                ("--engine", "parity")) == 0
    sub = "theta-case/run-R1-N16x16-dt0_01-T0_05-theta0_5"
    for csv in ("probe.csv", "energy.csv", "iterations.csv"):
        fa = (tmp_path / "fast" / sub / csv).read_text()
        pa = (tmp_path / "par" / sub / csv).read_text()
        assert fa == pa, csv


def test_cli_engine_auto_routes_and_falls_back(tmp_path, capsys):
    from tpuwave.cli import newmark as cli_newmark
    case = driven_case(**{"T": "0.03"})
    path = _write(tmp_path, case)
    assert _cli(cli_newmark.main, path, tmp_path, "a") == 0
    # auto on an ineligible (Nel=1: no interior band) problem silently
    # falls back to parity (R=2 is fast-eligible since round 4)
    path2 = _write(tmp_path, driven_case(Nel="1", T="0.03"), "n1.json")
    assert _cli(cli_newmark.main, path2, tmp_path, "b") == 0
    # explicit --engine fast on the ineligible problem is a hard error
    assert _cli(cli_newmark.main, path2, tmp_path, "c",
                ("--engine", "fast")) == 1


def test_leapfrog_driven_scan_matches_steps():
    """run_leapfrog_driven (the whole loop as one jitted scan) reproduces
    the per-step driven leapfrog exactly in f64, with and without the
    consistent forcing pass."""
    from tpuwave.models.fast import FastWaveSolver

    def g_fn(x, y, t):
        return 0.1 * jnp.sin(3.0 * t) * (1.0 + x * y)

    def f_fn(x, y, t):
        return jnp.sin(2 * jnp.pi * x) * jnp.cos(jnp.pi * y) * jnp.cos(t)

    fs = FastWaveSolver((24, 20), ((0.0, 0.0), (1.0, 1.0)), 5e-3,
                        beta=0.0, dtype=jnp.float64)
    times = 5e-3 * (1.0 + np.arange(12))
    for forcing in (f_fn, None):
        st = fs.initial_leapfrog_state(
            lambda xs, ys: jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys),
            f_fn=forcing, g_fn=g_fn)
        want = st
        for t in times:
            want = fs.leapfrog_step_driven(want, float(t), g_fn, forcing)
        got = fs.run_leapfrog_driven(st, times, g_fn, forcing)
        nu = float(jnp.linalg.norm(want.u))
        assert float(jnp.linalg.norm(got.u - want.u)) < 1e-13 * nu


def test_grid_diagnostics_matches_parity():
    """GridDiagnostics (O(grid) surface used by Params-built fast
    engines) reproduces the parity Discretization's energy / errors /
    probe / interpolate to f64 summation roundoff — identical at the
    CSVs' %.6g formatting."""
    from tpuwave.models.grid_diag import GridDiagnostics

    for c_expr in ("1.0", "1.0 + 0.5*x + 0.25*y*y"):
        case = standing_mode(Nel="13,9",
                             C={"Function expression": c_expr,
                                "Variable names": "x, y, t"})
        p = load_params(case)
        d = Discretization(p)
        g = GridDiagnostics(p)
        rng = np.random.default_rng(3)
        u = jnp.asarray(rng.standard_normal(d.n_dofs))
        v = jnp.asarray(rng.standard_normal(d.n_dofs))
        e_ref, e_grid = float(d.energy(u, v)), float(g.energy(u, v))
        assert abs(e_ref - e_grid) < 1e-12 * abs(e_ref)
        pr_ref, pr_grid = float(d.probe(u)), float(g.probe(u))
        assert abs(pr_ref - pr_grid) < 1e-13 * max(1.0, abs(pr_ref))
        er = [float(x) for x in d.errors(u, 0.3)]
        eg = [float(x) for x in g.errors(u, 0.3)]
        for a, b in zip(er, eg):
            assert abs(a - b) < 1e-11 * abs(a), (er, eg)
        iu_r = np.asarray(d.interpolate(p.u0))
        iu_g = np.asarray(g.interpolate(p.u0))
        np.testing.assert_allclose(iu_g, iu_r, rtol=0, atol=1e-14)


def test_params_built_engine_runs_and_matches(tmp_path):
    """make_fast_solver(Params, ...) (the bench-scale product path) gives
    the same trajectory and diagnostics as the Discretization-built
    engine."""
    from tpuwave.models.fast_engine import make_fast_solver
    p = load_params(driven_case(T="0.04"))
    d = Discretization(p)
    s_d = make_fast_solver(d, "newmark")
    s_p = make_fast_solver(p, "newmark")
    st_d, _ = _run(s_d, p)
    st_p, _ = _run(s_p, p)
    assert float(jnp.linalg.norm(st_d.u - st_p.u)) == 0.0
    e_d = float(s_d.disc.energy(st_d.u, st_d.v))
    e_p = float(s_p.disc.energy(st_p.u, st_p.v))
    assert abs(e_d - e_p) < 1e-12 * abs(e_d)


@pytest.mark.parametrize("fam,prec", [("theta", "jacobi"),
                                      ("newmark", "mg"),
                                      ("theta", "chebyshev")])
def test_product_engine_solve_matches_parity(fam, prec):
    """The Params-built P1 product engine's solve path (constrained grid
    stencils, boundary lift, per-step system preconditioner) against the
    f64 parity engine running the same preconditioner on a driven +
    forced problem: identical iteration counts where the preconditioners
    are the same operator (jacobi); the solve-tolerance class where they
    are built differently (the grid mg hierarchy, analytic vs estimated
    chebyshev bounds)."""
    from tpuwave.models.fast_engine import make_fast_solver
    p = load_params(driven_case(Nel="24", T="0.04"))
    d = Discretization(p)
    fast = make_fast_solver(p, fam, precond=prec)
    ref = (ThetaSolver if fam == "theta" else NewmarkSolver)(d, precond=prec)
    st_f, info_f = _run(fast, p)
    st_r, info_r = _run(ref, p)
    nu = float(jnp.linalg.norm(st_r.u))
    if prec == "jacobi":
        assert float(jnp.linalg.norm(st_r.u - st_f.u)) < 1e-10 * nu
        assert int(info_r["iterations_1"]) == int(info_f["iterations_1"])
    else:
        assert float(jnp.linalg.norm(st_r.u - st_f.u)) < 1e-5 * nu


@pytest.mark.parametrize("preset", ["sine-membrane", "oscillating-boundary",
                                    "square-pulsing"])
@pytest.mark.parametrize("fam", ["theta", "newmark"])
def test_driven_presets_fast_matches_parity(parameters_dir, preset, fam):
    """The round-3 done criterion verbatim: the three DRIVEN presets run
    on the fast engine with trajectories matching the parity engine to
    f64 tolerance (shortened T; full-length fast-engine artifacts live in
    analysis/data/full-runs/)."""
    import json
    case = json.loads((parameters_dir / f"{preset}.json").read_text())
    case["T"] = "0.1"
    case["Save Solution"] = "false"
    p = load_params(case)
    d = Discretization(p)
    if fam == "theta":
        ref, fast = ThetaSolver(d), FastThetaSolver(d)
    else:
        ref, fast = NewmarkSolver(d), FastNewmarkSolver(d)
    st_r, _ = _run(ref, p)
    st_f, _ = _run(fast, p)
    nu = float(jnp.linalg.norm(st_r.u)) + 1e-30
    assert float(jnp.linalg.norm(st_r.u - st_f.u)) < 1e-10 * nu, preset


def test_cli_fast_engine_checkpoint_resume(tmp_path):
    """--checkpoint-every/--resume through the fast engine: the resumed
    run reproduces the uninterrupted trajectory (FastGridState fields,
    including the optional tdep payload slot, round-trip the npz)."""
    from tpuwave.cli import theta as cli_theta
    case = driven_case(**{"T": "0.06", "Log Every": "2",
                          "Time Dependent C": "true",
                          "C": {"Function expression":
                                "sqrt(1 + 0.5*sin(2*t))",
                                "Variable names": "x, y, t"}})
    path = _write(tmp_path, case)
    # uninterrupted reference
    assert _cli(cli_theta.main, path, tmp_path, "full") == 0
    # interrupted at step 3 (wall-clock limit can't be set via CLI, so
    # emulate by running T=0.03 into the same folder, then resuming the
    # full T with --resume from the checkpoint)
    case_half = dict(case, T="0.03")
    p_half = _write(tmp_path, case_half, "case_half.json")
    assert _cli(cli_theta.main, p_half, tmp_path, "res",
                ("--checkpoint-every", "1")) == 0
    import shutil
    half_dir = tmp_path / "res" / \
        "theta-case_half/run-R1-N16x16-dt0_01-T0_03-theta0_5"
    full_dir = tmp_path / "res" / \
        "theta-case/run-R1-N16x16-dt0_01-T0_06-theta0_5"
    full_dir.mkdir(parents=True)
    for f in half_dir.glob("checkpoint_*.npz"):
        shutil.copy(f, full_dir / f.name)
    assert _cli(cli_theta.main, path, tmp_path, "res", ("--resume",)) == 0
    got = (full_dir / "probe.csv").read_text()
    want = (tmp_path / "full" /
            "theta-case/run-R1-N16x16-dt0_01-T0_06-theta0_5/probe.csv"
            ).read_text()
    # rows logged after the resume point must match the uninterrupted run
    assert got.splitlines()[-1] == want.splitlines()[-1]


def test_newmark_nonzero_boundary_data_decays_like_parity():
    """Review regression: with g == 0 but initial data NONZERO on the
    boundary, the derived accel BC (g - z)/(beta dt^2) must still drive
    u|boundary toward g (the homogeneous shortcut applies only to the
    beta = 0 second-difference formula)."""
    case = standing_mode(Nel="8", T="0.03", Dt="0.01", Beta="0.25",
                         U0={"Function expression": "1 + x*y",
                             "Variable names": "x, y"})
    case.pop("Solution")
    p = load_params(case)
    d = Discretization(p)
    ref, fast = NewmarkSolver(d), FastNewmarkSolver(d)
    st_r, _ = _run(ref, p)
    st_f, _ = _run(fast, p)
    nu = float(jnp.linalg.norm(st_r.u))
    assert float(jnp.linalg.norm(st_r.u - st_f.u)) < 1e-10 * nu
    # and the boundary values have actually decayed toward g = 0
    bnd = np.asarray(d.boundary_mask)
    assert float(np.max(np.abs(np.asarray(st_f.u)[bnd]))) < 1e-5


def test_api_parity_kwargs_keep_routing_to_parity():
    """Review regression: parity-solver-specific kwargs (lumped_explicit)
    through build_solver/solve keep working under the auto engine."""
    import tpuwave
    from tpuwave.models.newmark import NewmarkSolver as ParityNewmark
    p = load_params(standing_mode(Nel="8", T="0.02", Dt="0.01",
                                  Beta="0.0"))
    s = tpuwave.build_solver(p, "newmark", lumped_explicit=True)
    assert isinstance(s, ParityNewmark) and s.lumped_explicit


def test_sharded_product_engine_matches_single_device():
    """Round-4 contract: the product fast engine partitions across the
    device mesh (reference analogue: every run partitionable,
    GridTools::partition_triangulation, WaveEquationBase.cpp:65-69).
    Driven + forced + mg-preconditioned Newmark on the 8-device virtual
    mesh reproduces the single-device trajectory, iteration counts and
    diagnostics."""
    import jax
    from tpuwave.models.fast_engine import make_fast_solver
    from tpuwave.parallel.sharding import device_mesh, grid_sharding
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    p = load_params(driven_case(**{"Nel": "16,15", "Beta": "0.25",
                                   "T": "0.03"}))
    sh = grid_sharding(device_mesh(8))
    s1 = make_fast_solver(p, "newmark", precond="mg")
    s8 = make_fast_solver(p, "newmark", precond="mg", sharding=sh)
    st1 = s1.initial_state()
    st8 = s8.initial_state()
    assert len(st8.u.sharding.device_set) == 8
    t, i1, i8 = 0.0, None, None
    while t < p.t_final - 1e-12:
        t += p.dt
        st1, i1 = s1.step(st1, t)
        st8, i8 = s8.step(st8, t)
    assert len(st8.u.sharding.device_set) == 8
    nu = float(jnp.linalg.norm(st1.u))
    assert float(jnp.linalg.norm(st1.u - st8.u)) < 1e-13 * nu
    assert int(i1["iterations_1"]) == int(i8["iterations_1"])
    e1 = float(s1.disc.energy(st1.u, st1.v))
    e8 = float(s8.disc.energy(st8.u, st8.v))
    assert abs(e1 - e8) < 1e-12 * abs(e1)


def test_cli_shard_rows_csv_parity(tmp_path, capsys):
    """`--shard rows` through the CLI: the partitioned run's CSVs match
    the unsharded run digit-for-digit (the sharded==single-device
    CSV-parity criterion; psum reduction-order noise stays below the
    %.6g formatting)."""
    import jax
    from tpuwave.cli import newmark as cli_newmark
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device backend")
    case = driven_case(**{"Log Every": "1", "T": "0.05", "Beta": "0.25"})
    path = _write(tmp_path, case)
    assert _cli(cli_newmark.main, path, tmp_path, "one") == 0
    assert cli_newmark.main([str(path), "--results-root",
                             str(tmp_path / "sharded"), "--mesh-root",
                             str(tmp_path / "mesh"),
                             "--shard", "rows"]) == 0
    out = capsys.readouterr().out
    assert "Sharding: rows over" in out
    sub = "newmark-case/run-R1-N16x16-dt0_01-T0_05-gamma0_5-beta0_25"
    for csv in ("probe.csv", "energy.csv", "iterations.csv"):
        fa = (tmp_path / "one" / sub / csv).read_text()
        pa = (tmp_path / "sharded" / sub / csv).read_text()
        assert fa == pa, csv


@pytest.mark.parametrize("nel", [(24, 70), (33, 17), (8, 8)])
def test_leapfrog_driven_scan_matches_steps_on_grid_shapes(nel):
    """The driven leapfrog scan on non-square, odd and tiny grids (the
    stencil's roll wrap meets the pinned boundary rows on every edge)
    reproduces the per-step driven recurrence exactly in f64."""
    from tpuwave.models.fast import FastWaveSolver

    def g_fn(x, y, t):
        return 0.1 * jnp.sin(3.0 * t) * (1.0 + x * y)

    fs = FastWaveSolver(nel, ((0.0, 0.0), (1.0, 1.0)), 5e-3,
                        beta=0.0, dtype=jnp.float64)
    st = fs.initial_leapfrog_state(
        lambda xs, ys: jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys),
        g_fn=g_fn)
    times = 5e-3 * (1.0 + np.arange(16))
    want = st
    for t in times:
        want = fs.leapfrog_step_driven(want, float(t), g_fn)
    got = fs.run_leapfrog_driven(st, times, g_fn)
    nu = float(jnp.linalg.norm(want.u))
    assert float(jnp.linalg.norm(got.u - want.u)) < 1e-13 * nu
    assert float(jnp.linalg.norm(got.u_prev - want.u_prev)) < 1e-13 * nu


@pytest.mark.parametrize("r", ["1", "2"])
def test_engine_choice_on_gpu_is_plain_xla(monkeypatch, r):
    """With the first device reported as a GPU, the f32 constant-c
    product engines (the configuration that once auto-selected
    hand-written fused kernels off the CPU) build and trace a step of
    plain XLA operations only."""
    import jax
    from tpuwave import config
    from tpuwave.models.fast_engine import make_fast_solver

    class _Gpu:
        platform, device_kind, id = "gpu", "NVIDIA H100 80GB HBM3", 0

    monkeypatch.setattr(jax, "devices", lambda *a: [_Gpu()])
    config.use_x64(False)
    try:
        p = load_params(driven_case(Nel="16", R=r, T="0.02",
                                    Beta="0.25"))
        s = make_fast_solver(p, "newmark", precond="mg")
        assert s.dtype == jnp.float32
        st = s.initial_state()
        jaxpr = str(jax.make_jaxpr(s._step_impl)(st, 0.01))
        assert "pallas" not in jaxpr and "custom_call" not in jaxpr
        assert not any("pallas" in k for k in vars(s))
    finally:
        config.use_x64(True)


@pytest.mark.parametrize("r", ["1", "2"])
def test_f32_energy_keeps_precision_on_fine_meshes(r):
    """The O(grid) diagnostics evaluate the stiffness energy in gradient
    difference form, so an f32 state's energy matches the f64 energy of
    the same values to f32 rounding — even where u^T K u is tiny next to
    |u|^2 (a direct w^T K w sum in f32 loses it to cancellation)."""
    from tpuwave.models.grid_diag import GridDiagnostics
    from tpuwave.models.p2_diag import P2GridDiagnostics
    case = standing_mode(Nel="192", R=r)
    p = load_params(case)
    cls = GridDiagnostics if r == "1" else P2GridDiagnostics
    d32, d64 = cls(p, dtype=jnp.float32), cls(p, dtype=jnp.float64)
    x = d64.interpolate(load_params(standing_mode(
        U0={"Function expression": "1 + 0.01*sin(pi*x)*sin(pi*y)",
            "Variable names": "x, y"})).u0)
    u32 = jnp.asarray(x, jnp.float32)
    v32 = jnp.zeros_like(u32)
    e32 = float(d32.energy(u32, v32))
    e64 = float(d64.energy(u32.astype(jnp.float64),
                           v32.astype(jnp.float64)))
    assert abs(e32 - e64) < 1e-4 * abs(e64)
