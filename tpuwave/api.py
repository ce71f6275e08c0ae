"""One-call convenience API.

    import tpuwave
    result = tpuwave.solve_problem("parameters/standing-mode-wsol.json",
                                   family="newmark")

wraps params -> discretisation -> solver -> run driver, the same pipeline
as the CLI entry points.
"""

from __future__ import annotations

from typing import Optional

from tpuwave.models.discretization import Discretization
from tpuwave.models.general import make_discretization
from tpuwave.models.newmark import NewmarkSolver
from tpuwave.models.runner import RunConfig, RunResult, run_solver
from tpuwave.models.theta import ThetaSolver
from tpuwave.utils.params import Params, load_params

__all__ = ["solve", "build_solver"]


def build_solver(params: Params, family: str = "theta",
                 engine: str = "auto", **solver_kwargs):
    """Discretise and construct a stepper ('theta' or 'newmark').

    ``engine``: 'auto' (DEFAULT — the fast grid-stencil engine whenever
    the problem is a structured P1/P2 rectangle, falling back to the
    parity engine), 'fast' (require it; ValueError when ineligible) or
    'parity' (the general gather-path engine). Mirrors the CLI
    ``--engine`` flag, as do ``solver=`` ('3term'/'2term'/'cheby') and
    ``sharding=`` (a grid NamedSharding — the device-mesh row
    partitioning of ``--shard rows``).
    """
    if family not in ("theta", "newmark"):
        raise ValueError(f"Unknown solver family {family!r}")
    from tpuwave.config import enable_compile_cache
    enable_compile_cache()
    # parity-solver-specific kwargs (e.g. lumped_explicit) keep routing to
    # the parity engine under 'auto', preserving the pre-engine-routing
    # build_solver contract; the fast engine accepts only these:
    _fast_kwargs = {"precond", "cheby_degree", "solver", "sharding",
                    "cheby_solver_degree"}
    if engine == "auto" and set(solver_kwargs) - _fast_kwargs:
        engine = "parity"
    from tpuwave.models.fast_engine import resolve_engine
    solver, disc, reason = resolve_engine(
        params, family, engine,
        make_disc=lambda: make_discretization(params), **solver_kwargs)
    if solver is not None:
        return solver
    if reason is not None and engine == "fast":
        raise ValueError(f"engine='fast' unavailable: {reason}")
    if family == "theta":
        return ThetaSolver(disc, **solver_kwargs)
    return NewmarkSolver(disc, **solver_kwargs)


def solve(parameters, family: str = "theta", *, problem_name: Optional[str] = None,
          overrides=None, config: Optional[RunConfig] = None,
          **solver_kwargs) -> RunResult:
    """Load parameters (path or dict), run the full simulation, return the
    RunResult (final state, errors, timings, output folder)."""
    params = load_params(parameters, overrides=overrides)
    solver = build_solver(params, family, **solver_kwargs)
    if problem_name is None:
        from pathlib import Path
        stem = (Path(params.source_path).stem if params.source_path
                else "case")
        problem_name = f"{family}-{stem}"
    return run_solver(solver, problem_name, config or RunConfig(quiet=True))
