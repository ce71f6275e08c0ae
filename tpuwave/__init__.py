"""tpuwave — a JAX/XLA framework for the 2D scalar wave equation.

Re-implements, accelerator-first, the full capability surface of the reference
deal.II/Trilinos/MPI solver ``AlessandroGhiotto/nmpde-wave-equation``:

    u_tt - c^2 lap(u) = f      in Omega x (0,T]
    u = g                      on dOmega x [0,T]   (Dirichlet, time-dependent)
    u(.,0) = u0, u_t(.,0) = v0

Two time-integration families (theta-method and Newmark-beta), P1/P2
simplicial Lagrange elements on a structured triangulated rectangle,
matrix-free operators, preconditioned CG, energy/error/probe diagnostics,
CSV + VTU output, parameter-file driven CLI, and sweep harnesses.

Architecture (bottom-up), all compute jit-compiled by XLA:

- ``tpuwave.utils.expr``    muparser-compatible expression -> JAX compiler
- ``tpuwave.utils.params``  parameter files (JSON/PRM) -> typed config
- ``tpuwave.core``          structured simplicial mesh, P1/P2 spaces,
                            Gauss-simplex quadrature
- ``tpuwave.ops``           batched element kernels, matrix-free M/K
                            operators, lumped mass, stencil fast path
- ``tpuwave.solve``         preconditioned CG (ReductionControl semantics)
- ``tpuwave.models``        theta / Newmark steppers + run drivers
- ``tpuwave.parallel``      jax.sharding mesh layout + halo exchange
- ``tpuwave.cli``           main-theta / main-newmark equivalents

Unlike the reference there is no MPI: parallelism is GSPMD sharding of the
DoF/element axes over a ``jax.sharding.Mesh`` with XLA collectives.
"""

__version__ = "0.1.0"

from tpuwave import config as config  # noqa: F401


def __getattr__(name):
    # lazy re-exports (keep `import tpuwave` light — no jax import).
    # NB: `tpuwave.solve` is the solver subpackage; the one-call helper is
    # exported as `solve_problem` (== tpuwave.api.solve).
    if name == "solve_problem":
        from tpuwave.api import solve
        return solve
    if name == "build_solver":
        from tpuwave.api import build_solver
        return build_solver
    if name == "load_params":
        from tpuwave.utils.params import load_params
        return load_params
    if name == "FwiProblem":
        from tpuwave.models.inverse import FwiProblem
        return FwiProblem
    raise AttributeError(f"module 'tpuwave' has no attribute {name!r}")
