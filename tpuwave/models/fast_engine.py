"""Product-surface adapters for the fast grid-stencil engines.

The reference's mains run its one (best) engine directly
(/root/reference/src/main-newmark.cpp:24-169, src/main-theta.cpp:23-152).
tpuwave's CLI equivalents historically always built the gather-path parity
``Discretization``; the stencil fast paths were Python-API-only and
restricted to homogeneous boundaries and zero forcing.

This module closes both gaps: :class:`FastThetaSolver` and
:class:`FastNewmarkSolver` implement the EXACT parity step algebra of
models/theta.py / models/newmark.py — symmetric Dirichlet elimination with
time-dependent g (reference solve_u/solve_v WaveTheta.cpp:251-339), the
derived acceleration boundary formulas (WaveNewmark.cpp:177-262), the
theta-weighted quadrature-consistent forcing (WaveTheta.cpp:119-186), the
consistent a0 solve (WaveNewmark.cpp:298-390), and the same
ReductionControl stopping contract — but on grid-plane operators instead
of the gather -> batched-matvec -> segment_sum path (measured ~11x faster
per operator apply). Driven presets (sine-membrane, oscillating-boundary,
square-pulsing) therefore run at grid-stencil speed with trajectories
matching the parity engine to solver tolerance.

Wave-speed coverage (the full reference problem class):

* constant c          -> constant 7-point stencils (ops/stencil.py)
* spatially varying c -> static variable-coefficient 9-plane operator
                         (assemble_varcoef_planes; identical element
                         algebra to the parity assembly — per-class G
                         scaled by det sum_q w_q c^2(x_q))
* `Time Dependent C`  -> the planes are rebuilt from c(x, y, t) INSIDE
                         the jitted step; the theta family carries the
                         K(t^n) planes across steps (one build per step,
                         mirroring models/theta.py's payload carry)

State vectors stay FLAT (n_dofs,) so the run driver's diagnostics/IO
(models/runner.py, via the parity ``Discretization``) work unchanged; the
steppers reshape to the (ny+1, nx+1) vertex grid internally (free: the P1
DoF numbering is row-major over the grid, core/mesh.py:12).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from tpuwave.models._scan import ScanMixin
from tpuwave.models.discretization import Discretization
from tpuwave.models.fast import FastWaveSolver
from tpuwave.solve.cg import pcg
from tpuwave.utils.params import Params

__all__ = ["FastGridState", "FastThetaSolver", "FastNewmarkSolver",
           "fast_engine_ineligible_reason", "make_fast_solver",
           "resolve_engine"]


class FastGridState(NamedTuple):
    u: jax.Array   # flat (n_dofs,)
    v: jax.Array
    a: jax.Array   # consistent acceleration (Newmark); zeros for theta
    #: K(t^n) varcoef scale array (ny, nx, 2) carried across steps under
    #: `Time Dependent C` (theta family only; None otherwise) — mirrors
    #: ThetaState.k_payload; array form keeps it checkpoint-safe
    k_payload: Optional[jax.Array] = None


class _Op(NamedTuple):
    """Grid operator quad: apply(u), assembled diagonal (scalar or
    plane), an upper eigenvalue bound (for the f32 backward-error
    stopping floor and Chebyshev), and — for constant-coefficient
    operators — the 3x3 stencil (its symbol bounds drive ``--solver
    cheby``; None for varcoef/tdep operators)."""
    apply: Callable
    diag: Any
    lam_hi: Any
    stencil: Any = None


def fast_engine_ineligible_reason(problem) -> Optional[str]:
    """None when ``problem`` (a Params or a built Discretization) can run
    on the grid-stencil engine, else why not. Eligibility = structured
    rectangle triangulation with P1 or P2 elements (the reference's
    degree-generic engine, WaveEquationBase.cpp:74-84: R=1 routes to the
    vertex-grid solvers here, R=2 to the plane-stencil solvers of
    models/fast_engine_p2.py); the wave speed may be constant, spatially
    varying, or (with `Time Dependent C`) time-dependent — each maps to a
    grid-plane operator form (module docstring).

    Passing Params routes diagnostics through the O(grid)
    :class:`~tpuwave.models.grid_diag.GridDiagnostics` /
    :class:`~tpuwave.models.p2_diag.P2GridDiagnostics` surface — the
    product path at bench scale, where building the gather-path parity
    ``Discretization`` costs O(n_cells)-shaped gather buffers.
    """
    if isinstance(problem, Params):
        p = problem
        if p.mesh_file is not None:
            return "imported mesh (factory routes recognisable rectangles)"
    else:
        from tpuwave.core.mesh import StructuredTriMesh
        p = problem.params
        if type(problem) is not Discretization or \
                type(problem.mesh) is not StructuredTriMesh:
            return "mesh is not a generated structured rectangle"
    if p.r not in (1, 2):
        return f"fast engine supports R = 1/2 (R = {p.r})"
    if min(p.nel) < 2:
        return "mesh has no interior band (Nel < 2)"
    return None


def make_fast_solver(problem, family: str, *,
                     precond: str = "jacobi", cheby_degree: int = 3,
                     solver: str = "3term", **engine_kwargs):
    """Factory used by the CLI/api ``engine fast|auto`` routing.

    ``problem``: a Params (O(grid) diagnostics — the scalable product
    path) or an already-built structured Discretization (its gather-path
    diagnostics are then reused, byte-identical to the parity engine).
    R = 2 problems route to the P2 plane-stencil engines
    (models/fast_engine_p2.py — the reference's engine is degree-generic,
    WaveEquationBase.cpp:74-84).

    ``solver``: the implicit-solve strategy (``--solver``):
    * ``3term`` — the parity CG contract (default)
    * ``2term`` — displacement-form recurrence, ~1 MG-PCG iteration per
      step (models/fast_engine_2term.py; P1, static c)
    * ``cheby`` — restarted Chebyshev iteration, dot-product-free fused
      solve blocks (P1, constant c)
    """
    p = problem if isinstance(problem, Params) else problem.params
    if p.r == 2:
        if solver == "2term":
            from tpuwave.models.fast_engine_p2_2term import (
                FastP22TermNewmarkSolver, FastP22TermThetaSolver)
            cls2 = {"theta": FastP22TermThetaSolver,
                    "newmark": FastP22TermNewmarkSolver}.get(family)
        else:
            from tpuwave.models.fast_engine_p2 import (FastP2NewmarkSolver,
                                                       FastP2ThetaSolver)
            cls2 = {"theta": FastP2ThetaSolver,
                    "newmark": FastP2NewmarkSolver}.get(family)
        if cls2 is None:
            raise ValueError(f"unknown solver family {family!r}")
        allowed = {"sharding", "cheby_solver_degree", "mg_pre_degree",
                   "mg_smooth_range"}
        if set(engine_kwargs) - allowed:
            raise TypeError("P2 fast engine does not accept "
                            f"{sorted(set(engine_kwargs) - allowed)}")
        if solver != "2term":
            engine_kwargs["solver"] = solver
        return cls2(problem, precond=precond, cheby_degree=cheby_degree,
                    **engine_kwargs)
    if solver == "2term":
        from tpuwave.models.fast_engine_2term import (Fast2TermNewmarkSolver,
                                                      Fast2TermThetaSolver)
        cls = {"theta": Fast2TermThetaSolver,
               "newmark": Fast2TermNewmarkSolver}.get(family)
        if cls is None:
            raise ValueError(f"unknown solver family {family!r}")
        return cls(problem, precond=precond, cheby_degree=cheby_degree,
                   **engine_kwargs)
    if family == "theta":
        return FastThetaSolver(problem, precond=precond,
                               cheby_degree=cheby_degree, solver=solver,
                               **engine_kwargs)
    if family == "newmark":
        return FastNewmarkSolver(problem, precond=precond,
                                 cheby_degree=cheby_degree, solver=solver,
                                 **engine_kwargs)
    raise ValueError(f"unknown solver family {family!r}")


def resolve_engine(params, family: str, engine: str, *, make_disc,
                   **solver_kwargs):
    """Shared ``--engine auto|fast|parity`` resolution for the CLI and
    :mod:`tpuwave.api` (review finding: the two sites had drifted).

    ``make_disc``: zero-arg callable building the parity discretisation
    (invoked lazily — never for Params-eligible fast runs, so the
    bench-scale product path stays O(grid)). Returns
    ``(solver_or_None, disc_or_None, reason_or_None)``:

    * solver set          -> a fast engine was built (disc may be None)
    * solver None, parity -> caller builds the parity solver on ``disc``
    * solver None + engine == 'fast' -> unsatisfiable; error with reason
    """
    if engine == "parity":
        return None, make_disc(), None
    if engine not in ("auto", "fast"):
        raise ValueError(f"Unknown engine {engine!r}")
    reason = fast_engine_ineligible_reason(params)
    if reason is None:
        return (make_fast_solver(params, family, **solver_kwargs),
                None, None)
    # the factory renumbers recognisable imported rectangles onto the
    # structured engines — retry eligibility on the built discretisation
    disc = make_disc()
    reason2 = fast_engine_ineligible_reason(disc)
    if reason2 is None:
        return (make_fast_solver(disc, family, **solver_kwargs),
                disc, None)
    return None, disc, reason2


class _FastEngineBase(ScanMixin):
    """Shared plumbing: operators, boundary/forcing data, elimination."""

    def __init__(self, problem, *, precond: str = "jacobi",
                 cheby_degree: int = 3, sharding=None,
                 solver: str = "3term", cheby_solver_degree: int = 8):
        reason = fast_engine_ineligible_reason(problem)
        if reason is not None:
            raise ValueError(f"fast engine unavailable: {reason}")
        if solver not in ("3term", "cheby"):
            raise ValueError(f"unknown solver {solver!r} for this engine "
                             "(3term | cheby; 2term is the displacement-"
                             "form classes in models/fast_engine_2term.py)")
        p_r = (problem if isinstance(problem, Params) else problem.params).r
        if p_r != 1:
            raise ValueError("FastThetaSolver/FastNewmarkSolver are the P1 "
                             "engines; R = 2 routes to models/"
                             "fast_engine_p2.py (use make_fast_solver)")
        if isinstance(problem, Params):
            from tpuwave.models.grid_diag import GridDiagnostics
            disc = GridDiagnostics(problem)
        else:
            disc = problem
        self.disc = disc
        p = disc.params
        self.dt = p.dt
        c_const = p.c.constant_value
        self.time_dep_c = p.time_dependent_c and p.c.time_dependent
        if self.time_dep_c:
            self._c_mode = "tdep"
        elif c_const is None:
            self._c_mode = "varcoef"
        else:
            self._c_mode = "const"
        #: device-mesh row layout (parallel/sharding.py::grid_sharding):
        #: every run partitions across devices exactly like the
        #: reference's GridTools::partition_triangulation across MPI
        #: ranks (WaveEquationBase.cpp:65-69). GSPMD lowers the stencil
        #: rolls to nearest-neighbour collective-permutes and the CG /
        #: diagnostics reductions to psum. Grids whose row count divides the
        #: mesh keep a persistently row-sharded state (device_put); other row
        #: counts (e.g. 2^k + 1) get in-step ``with_sharding_constraint``
        #: layouts instead — GSPMD pads the uneven tiling internally (jax
        #: device_put rejects it).
        self.sharding = sharding
        self._flat_sharding = None
        self._even_shards = False
        if sharding is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            spec = tuple(sharding.spec)
            shape = (p.nel[1] + 1, p.nel[0] + 1)
            divides = all(
                name is None or shape[d] % sharding.mesh.shape[name] == 0
                for d, name in enumerate(spec))
            # flat device_put needs the row split to align with flat
            # chunks: 1-D row sharding only
            self._even_shards = (divides and spec and spec[0] is not None
                                 and all(n is None for n in spec[1:]))
            if self._even_shards:
                self._flat_sharding = NamedSharding(sharding.mesh,
                                                    PartitionSpec(spec[0]))
        self.fs = FastWaveSolver(
            p.nel, p.geometry, p.dt,
            c=1.0 if c_const is None else float(c_const),
            scheme=self.method_name, beta=p.beta, gamma=p.gamma,
            theta=p.theta, lumped=False, dtype=disc.dtype,
            sharding=sharding if self._even_shards else None)
        fs = self.fs
        self.dtype = fs.dtype
        self._max_iter = 10000 if self.dtype == jnp.float64 else 2000

        # problem data as jittable grid-plane evaluators
        self._g = p.g
        self._dgdt = p.dgdt
        self._f = p.f if not p.f.is_zero else None
        self._c_eval = p.c.evaluate

        #: system coefficient: M + coef * K
        self.coef = (p.beta * p.dt * p.dt if self.method_name == "newmark"
                     else (p.theta * p.dt) ** 2)

        from tpuwave.solve.cheby_iter import stencil_symbol_bounds
        self._mass_op = _Op(fs.mass, fs.mass.stencil[1][1],
                            stencil_symbol_bounds(fs.mass.stencil)[1],
                            fs.mass.stencil)
        if self._c_mode == "const":
            self._k_static = _Op(fs.stiff, fs.stiff.stencil[1][1],
                                 stencil_symbol_bounds(fs.stiff.stencil)[1],
                                 fs.stiff.stencil)
        elif self._c_mode == "varcoef":
            # static 9-plane operator, built once (concrete device arrays)
            self._k_static = self._k_from_scales(
                fs._tdep_scales(self._c_eval, 0.0))
        else:
            self._k_static = None   # rebuilt per step from c(x, y, t)

        # preconditioner for the implicit system; the theta v-system is
        # the bare mass — mesh-independent conditioning, Jacobi always
        # (models/fast.py::_theta_step note)
        if solver == "cheby":
            precond = "jacobi"   # cheby IS the solver; skip mg setup
        elif precond == "auto":
            from tpuwave.solve.multigrid import auto_precond
            precond = auto_precond(disc, self.coef)
        self.precond = precond
        self.cheby_degree = int(cheby_degree)
        if precond == "mg":
            # geometric V-cycle. Non-constant / time-dependent c freezes
            # the hierarchy at the rms wave speed (a FIXED SPD V-cycle
            # stays a valid CG preconditioner for a varying SPD system —
            # models/theta.py frozen-coefficient note)
            from tpuwave.solve.multigrid import gmg_for_system
            if c_const is None:
                from tpuwave.models.theta import _frozen_c_ref
                c_ref = _frozen_c_ref(disc)
            else:
                c_ref = float(c_const)
            self._prec_sys = gmg_for_system(
                (fs.mesh.nx, fs.mesh.ny), fs.mesh.geometry, c_ref,
                self.coef)
        elif precond in ("jacobi", "chebyshev"):
            self._prec_sys = None   # derived from the (per-step) system op
        else:
            raise ValueError(f"Unknown preconditioner {precond!r}")
        self._prec_mass = 1.0 / fs.mass.stencil[1][1]

        #: inner linear solver: "3term" = the parity CG contract;
        #: "cheby" = restarted Chebyshev iteration with analytic
        #: stencil-symbol eigenvalue bounds (solve/cheby_iter.py — no dot
        #: products inside a block). Constant wave speed only (the symbol
        #: bounds are per-stencil constants); same ReductionControl stopping
        #: contract, different iteration counts (documented perf mode).
        self._solver = solver
        self._cheby_solver_degree = int(cheby_solver_degree)
        if solver == "cheby" and self._c_mode != "const":
            raise ValueError(
                "--solver cheby needs a constant wave speed (analytic "
                "stencil-symbol bounds); use 3term/2term for varcoef or "
                "time-dependent C")
        self._step = jax.jit(self._step_impl)

    # -- operator construction -----------------------------------------
    def _k_from_planes(self, planes) -> _Op:
        """Varcoef K operator from 9 coefficient planes: Gershgorin
        majorant sum_d |w_d[I]| as the eigenvalue bound."""
        from tpuwave.ops.stencil import apply_varcoef_planes

        def apply(u, _p=planes):
            return apply_varcoef_planes(_p, u)
        lam_hi = sum(jnp.max(jnp.abs(w)) for w in planes.values())
        return _Op(apply, planes[(0, 0)], lam_hi)

    def _k_from_scales(self, s) -> _Op:
        return self._k_from_planes(self.fs._planes_from_scales(s))

    def _k_at(self, t) -> _Op:
        if self._k_static is not None:
            return self._k_static
        return self._k_from_scales(self.fs._tdep_scales(self._c_eval, t))

    def _system_of(self, k_op: _Op) -> _Op:
        coef = self.coef
        if coef == 0.0:   # theta = 0 / beta = 0: the system is bare mass
            return self._mass_op
        m = self._mass_op

        def apply(u):
            return m.apply(u) + coef * k_op.apply(u)
        st = None
        if k_op.stencil is not None:
            st = tuple(tuple(mc + coef * kc for mc, kc in zip(mr, kr))
                       for mr, kr in zip(m.stencil, k_op.stencil))
        return _Op(apply, m.diag + coef * k_op.diag,
                   m.lam_hi + coef * k_op.lam_hi, st)

    def _sys_precond(self, sys_op: _Op):
        """Resolve the preconditioner for (this step's) system operator."""
        if self.precond == "mg":
            return self._prec_sys
        inv_diag = 1.0 / sys_op.diag
        if self.precond == "jacobi":
            return inv_diag
        # chebyshev: built on the CONSTRAINED apply is unnecessary here —
        # the symbol/Gershgorin bound majorises the constrained operator
        # (pinned rows are pure diagonal) exactly as in models/theta.py
        from tpuwave.solve.chebyshev import chebyshev_apply
        apply_c = self._constrained_apply(sys_op)
        dmin = jnp.min(jnp.asarray(sys_op.diag))
        lmax = sys_op.lam_hi / dmin
        deg = self.cheby_degree

        def prec(r):
            return chebyshev_apply(apply_c, inv_diag, r, lambda_max=lmax,
                                   degree=deg)
        return prec

    # -- helpers -------------------------------------------------------
    def _shard_grid(self, x):
        """Pin the device-mesh grid layout inside the jitted step for
        row counts that cannot be device_put-sharded (uneven tiling —
        GSPMD pads internally); no-op otherwise."""
        if self.sharding is None or self._even_shards:
            return x
        return jax.lax.with_sharding_constraint(x, self.sharding)

    def _plane(self, expr, t):
        """expr(x, y, t) on the full vertex grid (only boundary entries
        are ever consumed; interior values are masked away). Coordinates
        are iota-generated inside the trace — no captured HBM constants."""
        if expr.is_zero:
            return jnp.zeros(self.fs.shape, self.dtype)
        cv = expr.constant_value
        if cv is not None:
            return jnp.full(self.fs.shape, cv, self.dtype)
        xs, ys = self.fs.grid_coords()
        return jnp.broadcast_to(jnp.asarray(
            expr.evaluate(xs, ys, t), self.dtype), self.fs.shape)

    def _constrained_apply(self, op: _Op):
        fs = self.fs

        def apply_c(w):
            return jnp.where(fs.interior,
                             op.apply(jnp.where(fs.interior, w, 0.0)),
                             op.diag * w)
        return apply_c

    def _constrain(self, op: _Op, rhs, g_plane, x_prev, *, g_zero: bool):
        """Grid-plane form of ops.operators.constrain_system (deal.II
        apply_boundary_values with eliminate_columns=true): pinned
        diagonal boundary rows, rhs lifted by -A(g 1_b), warm start with
        boundary entries set to g. ``g_zero`` statically skips the lift
        apply for homogeneous data."""
        fs = self.fs
        apply_c = self._constrained_apply(op)
        if g_zero:
            rhs_c = jnp.where(fs.interior, rhs, 0.0)
            x0 = jnp.where(fs.interior, x_prev, 0.0)
            return apply_c, rhs_c, x0
        g_ext = jnp.where(fs.boundary, g_plane, 0.0)
        rhs_c = jnp.where(fs.interior, rhs - op.apply(g_ext),
                          op.diag * g_ext)
        x0 = jnp.where(fs.boundary, g_ext, x_prev)
        return apply_c, rhs_c, x0

    def _abs_tol(self, rhs, x0, op: _Op):
        """Reference 1e-12 floor in f64; backward-error floor in f32
        (models/fast.py::_solve_abs_tol rationale), with the operator
        bound taken from the _Op triple (symbol bound for constant
        stencils, Gershgorin majorant for varcoef planes)."""
        if self.dtype == jnp.float64:
            return 1e-12
        eta = 8 * float(jnp.finfo(self.dtype).eps)
        return eta * (op.lam_hi * jnp.linalg.norm(x0)
                      + jnp.linalg.norm(rhs))

    def _solve(self, op: _Op, rhs, g_plane, x_prev, precond, *,
               g_zero: bool):
        apply_c, rhs_c, x0 = self._constrain(op, rhs, g_plane, x_prev,
                                             g_zero=g_zero)
        if self._solver == "cheby":
            return self._solve_cheby(op, rhs_c, x0)
        return pcg(apply_c, rhs_c, x0, precond_inv_diag=precond,
                   abs_tol=self._abs_tol(rhs_c, x0, op),
                   max_iter=self._max_iter, reduction=self.fs.cg_reduction)

    def _solve_cheby(self, op: _Op, rhs_c, x0):
        """Restarted Chebyshev iteration on the constrained system
        (--solver cheby): data-independent coefficient schedules from the
        analytic stencil-symbol bounds, so there are no dot products in
        the iteration — blocks of ``cheby_solver_degree`` iterations run
        between residual checks. Same ReductionControl stopping contract
        as the CG paths."""
        from tpuwave.solve.cheby_iter import (chebyshev_solve,
                                              stencil_symbol_bounds)
        lo, hi = stencil_symbol_bounds(op.stencil)
        deg = self._cheby_solver_degree
        abs_tol = self._abs_tol(rhs_c, x0, op)
        return chebyshev_solve(
            self._constrained_apply(op), rhs_c, x0, lam_min=lo,
            lam_max=hi, degree=deg, abs_tol=abs_tol,
            reduction=self.fs.cg_reduction, max_iter=self._max_iter)

    def step(self, state: FastGridState, t):
        return self._step(state, t)


class FastThetaSolver(_FastEngineBase):
    """theta-method on the grid planes — parity algebra of
    models/theta.py (reference WaveTheta.cpp:119-339) at fast-path speed,
    including time-dependent Dirichlet g, theta-weighted forcing, and
    variable / time-dependent wave speed."""

    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return "-theta" + clean_double(self.fs.theta)

    def initial_state(self) -> FastGridState:
        d = self.disc
        u0 = jnp.asarray(d.interpolate(d.params.u0), self.dtype)
        v0 = jnp.asarray(d.interpolate(d.params.v0), self.dtype)
        if self._flat_sharding is not None:
            u0 = jax.device_put(u0, self._flat_sharding)
            v0 = jax.device_put(v0, self._flat_sharding)
        pay = (self.fs._tdep_scales(self._c_eval, 0.0)
               if self._c_mode == "tdep" else None)
        return FastGridState(u=u0, v=v0, a=jnp.zeros_like(u0),
                             k_payload=pay)

    def _step_impl(self, state: FastGridState, t):
        fs = self.fs
        dt, th = self.dt, fs.theta
        u = self._shard_grid(state.u.reshape(fs.shape))
        v = self._shard_grid(state.v.reshape(fs.shape))

        pay_np1 = None
        if self._c_mode == "tdep":
            # K^n from the carried payload (built as K^{n+1} last step);
            # K^{n+1} rebuilt from c(x, y, t) — one build per step
            k_n = (self._k_from_scales(state.k_payload)
                   if state.k_payload is not None
                   else self._k_at(t - dt))
            pay_np1 = fs._tdep_scales(self._c_eval, t)
            k_np1 = self._k_from_scales(pay_np1)
        else:
            k_n = k_np1 = self._k_at(t)
        sys_op = self._system_of(k_np1)
        prec_sys = self._sys_precond(sys_op)

        mu, ku, mv = self._mass_op.apply(u), k_n.apply(u), \
            self._mass_op.apply(v)

        if self._f is not None:
            f_avg = (th * fs.grid_load(self._f.evaluate, t)
                     + (1.0 - th) * fs.grid_load(self._f.evaluate, t - dt))
        else:
            f_avg = None

        # u system (WaveTheta.cpp:119-186, 251-294)
        rhs_u = mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv
        if f_avg is not None:
            rhs_u = rhs_u + (th * dt * dt) * f_avg
        res_u = self._solve(sys_op, rhs_u, self._plane(self._g, t), u,
                            prec_sys, g_zero=self._g.is_zero)
        u_new = res_u.x.astype(self.dtype)

        # v system (WaveTheta.cpp:188-249, 296-339)
        rhs_v = mv - (dt * (1.0 - th)) * ku - (dt * th) * k_np1.apply(u_new)
        if f_avg is not None:
            rhs_v = rhs_v + dt * f_avg
        res_v = self._solve(self._mass_op, rhs_v,
                            self._plane(self._dgdt, t), v,
                            self._prec_mass, g_zero=self._dgdt.is_zero)
        v_new = res_v.x.astype(self.dtype)

        new_state = FastGridState(u=u_new.reshape(-1), v=v_new.reshape(-1),
                                  a=state.a, k_payload=pay_np1)
        info = {
            "iterations_1": res_u.iterations,
            "iterations_2": res_v.iterations,
            "norm_u": jnp.linalg.norm(u_new),
            "norm_v": jnp.linalg.norm(v_new),
        }
        return new_state, info


class FastNewmarkSolver(_FastEngineBase):
    """Newmark-beta on the grid planes — parity algebra of
    models/newmark.py (reference WaveNewmark.cpp:116-390) at fast-path
    speed: consistent-mass a-solve (also at beta = 0), derived
    acceleration boundary formulas, consistent a0, per-step forcing,
    variable / time-dependent wave speed."""

    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return ("-gamma" + clean_double(self.fs.gamma)
                + "-beta" + clean_double(self.fs.beta))

    # -- acceleration boundary data (WaveNewmark.cpp:177-262) ----------
    def _accel_bc_plane(self, t, z):
        fs, dt = self.fs, self.dt
        if fs.beta > 1e-12:
            return (self._plane(self._g, t) - z) / (fs.beta * dt * dt)
        g_p = self._plane(self._g, t)
        g_0 = self._plane(self._g, t - dt)
        g_m = self._plane(self._g, t - 2.0 * dt)
        return (g_p - 2.0 * g_0 + g_m) / (dt * dt)

    def initial_state(self) -> FastGridState:
        """u0, v0 interpolation + consistent M a0 = F(0) - K(0) u0 with
        a0|b = (g(dt) - 2 g(0) + g(-dt)) / dt^2 (reference :298-390)."""
        d, fs, dt = self.disc, self.fs, self.dt
        u0 = jnp.asarray(d.interpolate(d.params.u0), self.dtype)
        v0 = jnp.asarray(d.interpolate(d.params.v0), self.dtype)
        if self._flat_sharding is not None:
            u0 = jax.device_put(u0, self._flat_sharding)
            v0 = jax.device_put(v0, self._flat_sharding)
        u0g = u0.reshape(fs.shape)
        rhs = -self._k_at(0.0).apply(u0g)
        if self._f is not None:
            rhs = rhs + fs.grid_load(self._f.evaluate, 0.0)
        g_p = self._plane(self._g, dt)
        g_0 = self._plane(self._g, 0.0)
        g_m = self._plane(self._g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc, jnp.zeros_like(u0g),
                          self._prec_mass, g_zero=self._g.is_zero)
        self.initial_iterations = int(res.iterations)
        return FastGridState(u=u0, v=v0,
                             a=res.x.astype(self.dtype).reshape(-1))

    def _step_impl(self, state: FastGridState, t):
        fs = self.fs
        dt, beta, gamma = self.dt, fs.beta, fs.gamma
        u = self._shard_grid(state.u.reshape(fs.shape))
        v = self._shard_grid(state.v.reshape(fs.shape))
        a = self._shard_grid(state.a.reshape(fs.shape))

        # the elastic force acts at t^{n+1} (models/newmark.py tdep note)
        k_np1 = self._k_at(t)
        sys_op = self._system_of(k_np1)
        prec_sys = self._sys_precond(sys_op)

        # z = u + dt v + dt^2 (1/2 - beta) a  (WaveNewmark.cpp:123-126)
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = -k_np1.apply(z)
        if self._f is not None:
            rhs = rhs + fs.grid_load(self._f.evaluate, t)

        a_bc = self._accel_bc_plane(t, z)
        # NB for beta > 0 the derived BC (g - z)/(beta dt^2) is nonzero
        # even for g == 0 whenever the state is nonzero on the boundary
        # (inconsistent initial data decays to g, reference
        # WaveNewmark.cpp:196-210) — the homogeneous shortcut applies
        # only to the beta = 0 second-difference formula
        res = self._solve(sys_op, rhs, a_bc, a, prec_sys,
                          g_zero=self._g.is_zero and fs.beta <= 1e-12)
        a_new = res.x.astype(self.dtype)

        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        new_state = FastGridState(u=u_new.reshape(-1).astype(self.dtype),
                                  v=v_new.reshape(-1).astype(self.dtype),
                                  a=a_new.reshape(-1))
        info = {
            "iterations_1": res.iterations,
            "iterations_2": jnp.asarray(0, jnp.int32),
            "norm_u": jnp.linalg.norm(u_new),
            "norm_v": jnp.linalg.norm(v_new),
        }
        return new_state, info
