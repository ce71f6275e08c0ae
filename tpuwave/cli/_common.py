"""Shared CLI plumbing for the two entry points.

Contract mirrors the reference executables (src/main-theta.cpp:23-152,
src/main-newmark.cpp): one optional positional argument = parameter file
(default ``parameters/sine-membrane.json``); problem name =
``<family>-<param-file-stem>``; env flags ``NMPDE_SAVE_SOLUTION`` /
``NMPDE_LOG_EVERY`` / ``NMPDE_PARAM_FILE`` exported for downstream
consumers, and friendly parse-error hints with exit(1).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from tpuwave import config
from tpuwave.models.discretization import Discretization
from tpuwave.models.general import make_discretization
from tpuwave.models.runner import RunConfig, run_solver
from tpuwave.utils.params import ParamError, load_params

DEFAULT_PARAM_FILE = "parameters/sine-membrane.json"


def run_main(family: str, make_solver, argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"tpuwave-{family}",
        description=f"{family}-method solver for the 2D wave equation")
    parser.add_argument("parameters", nargs="?", default=None,
                        help="path to a JSON/PRM parameter file")
    parser.add_argument("--results-root", default="results")
    parser.add_argument("--mesh-root", default="mesh")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--f32", action="store_true",
                        help="run single precision (default: f64 parity mode)")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="snapshot state every N steps (0 = off)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint in the run folder")
    parser.add_argument("--profile-dir", default=None,
                        help="capture a jax.profiler trace into this directory")
    parser.add_argument("--phase-timing", action="store_true",
                        help="print per-phase wall-clock breakdown")
    parser.add_argument("--engine", choices=("auto", "fast", "parity"),
                        default="auto",
                        help="solver engine: fast = grid-stencil operators "
                             "on structured rectangles (full problem "
                             "class: driven g(t), forcing, constant / "
                             "spatially varying / time-dependent C, "
                             "models/fast_engine.py), parity = the general "
                             "gather-path engine, auto = fast when "
                             "eligible else parity")
    parser.add_argument("--precond",
                        choices=["jacobi", "chebyshev", "mg", "auto"],
                        default="jacobi",
                        help="CG preconditioner (chebyshev = AMG stand-in "
                             "for stiffness-dominated theta systems; mg = "
                             "geometric multigrid, dt-independent iteration "
                             "counts at CFL-breaking dt — structured "
                             "R=1/2; varying/time-dependent C freezes the "
                             "hierarchy at the rms wave speed; auto = mg "
                             "when the system is stiffness-dominated and "
                             "mg-eligible, else jacobi)")
    parser.add_argument("--solver", choices=("3term", "2term", "cheby"),
                        default="3term",
                        help="implicit-solve strategy for the fast "
                             "engine: 3term = the parity CG contract "
                             "(default); 2term = displacement-form "
                             "recurrence, ~1 MG-PCG iteration per step — "
                             "the fastest implicit path, pair with "
                             "--precond mg (R=1/2, static c, Beta > 0 "
                             "for newmark; velocity reconstructed at log "
                             "points, models/fast_engine_2term.py and "
                             "models/fast_engine_p2_2term.py); "
                             "cheby = dot-product-free restarted "
                             "Chebyshev solve blocks with analytic "
                             "symbol bounds (R=1/2, constant c)")
    parser.add_argument("--shard", choices=("none", "rows", "blocks"),
                        default="none",
                        help="partition the fast-engine run across the "
                             "local devices (the analogue of the "
                             "reference's mpirun -np N domain "
                             "decomposition, WaveEquationBase.cpp:65-69): "
                             "rows = 1-D row slabs, blocks = 2-D "
                             "row x column blocks over a 2-D device "
                             "mesh (halves halo surface at 8+ devices). "
                             "GSPMD lowers stencil halos to collective-"
                             "permutes and CG/diagnostics reductions to "
                             "psum. Structured R=1/2 fast runs (the "
                             "parity engine runs unsharded)")
    parser.add_argument("--unstructured-sharding",
                        choices=("none", "cells", "dofs", "dofs2d"),
                        default="none",
                        help="parallel engine for imported unstructured "
                             "meshes: cells = cell-sharded operators with "
                             "replicated DoF vectors (parallel/cells.py); "
                             "dofs = DoF-partitioned 1-D y-band vectors "
                             "with neighbor ghost exchange, "
                             "O(n_dofs/n_devices) memory "
                             "(parallel/dofs.py); dofs2d = 2-D block "
                             "partition with 8-neighbor exchange for "
                             "meshes wide in both axes "
                             "(parallel/dofs2d.py)")
    parser.add_argument("--vtu-pieces", type=int, default=1,
                        help="VTU pieces per output record, one per shard "
                             "(0 = one per local device)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host run: call jax.distributed.initialize "
                             "from the JAX coordination env vars (the "
                             "counterpart of the reference's mpirun launch)")
    args = parser.parse_args(argv)

    if args.distributed:
        from tpuwave.parallel.sharding import init_distributed
        if not init_distributed():
            print("--distributed: no coordination env configured "
                  "(JAX_COORDINATOR_ADDRESS unset); continuing single-host",
                  file=sys.stderr)

    config.use_x64(not args.f32)
    config.enable_compile_cache()

    import jax
    primary = jax.process_index() == 0
    if not primary:
        args.quiet = True

    parameters_file = args.parameters
    if parameters_file is None:
        parameters_file = DEFAULT_PARAM_FILE
        if primary:
            print(f"Usage: tpuwave-{family} <path-to-parameters-file>")
            print(f"Using default parameter file: {parameters_file}")
    elif primary:
        print(f"Using parameter file from argument: {parameters_file}")
    if primary:
        print("===============================================")

    try:
        params = load_params(parameters_file)
    except (ParamError, FileNotFoundError, OSError) as e:
        print(f"Error while reading the parameter file:\n  {e}", file=sys.stderr)
        print("Hint: check that the file exists and matches the documented "
              "JSON schema (see parameters/*.json).", file=sys.stderr)
        return 1

    # export the reference's env channels for the duration of the run only
    # (the reference mains setenv these for the subprocess; in-process we
    # must not leak them into subsequent runs)
    env_save = {k: os.environ.get(k) for k in
                ("NMPDE_PARAM_FILE", "NMPDE_SAVE_SOLUTION", "NMPDE_LOG_EVERY")}
    os.environ["NMPDE_PARAM_FILE"] = str(parameters_file)
    os.environ["NMPDE_SAVE_SOLUTION"] = "1" if params.save_solution else "0"
    os.environ["NMPDE_LOG_EVERY"] = str(params.effective_log_every)

    problem_name = f"{family}-{Path(parameters_file).stem}"
    # counterpart of main-newmark's MPI library/size report
    devs = jax.devices()
    if primary:
        print(f"  Problem name: {problem_name}")
        print(f"  Backend: {devs[0].platform}, {len(devs)} device(s), "
              f"{jax.process_count()} process(es)")

    solver_kwargs = {"precond": args.precond, "solver": args.solver}
    if args.shard != "none":
        if params.mesh_file is None:
            from tpuwave.parallel.sharding import device_mesh, grid_sharding
            if args.shard == "blocks":
                n = len(devs)
                ry = 1
                for d in range(int(n ** 0.5), 0, -1):
                    if n % d == 0:
                        ry = d
                        break
                mesh = device_mesh(shape=(max(ry, n // ry),
                                          min(ry, n // ry)))
            else:
                mesh = device_mesh()
            solver_kwargs["sharding"] = grid_sharding(mesh)
            if primary:
                print(f"  Sharding: {args.shard} over {len(devs)} "
                      f"device(s)")
        elif primary:
            print(f"  (--shard {args.shard} ignored: only structured "
                  "fast runs shard)")

    try:
        from tpuwave.models.fast_engine import resolve_engine
        try:
            solver, disc, reason = resolve_engine(
                params, family, args.engine,
                make_disc=lambda: make_discretization(
                    params,
                    unstructured_sharding=args.unstructured_sharding),
                **solver_kwargs)
        except ValueError as e:
            if args.solver == "3term":
                raise
            print(f"--solver {args.solver} unavailable for this problem: "
                  f"{e}\nHint: use the default --solver 3term.",
                  file=sys.stderr)
            return 1
        if solver is None and args.solver != "3term":
            print(f"--solver {args.solver} requires the fast engine "
                  f"(ineligible here: {reason}); the parity engine runs "
                  "the 3term form only.", file=sys.stderr)
            return 1
        if solver is not None:
            if primary:
                banner = "  Engine: fast (grid-stencil)"
                if args.solver != "3term":
                    banner += f" [{args.solver}]"
                print(banner)
        elif reason is not None:
            if args.engine == "fast":
                print("--engine fast unavailable for this problem: "
                      f"{reason}\nHint: use --engine auto (falls back "
                      "to the parity engine) or --engine parity.",
                      file=sys.stderr)
                return 1
            if primary:
                print(f"  Engine: parity (fast engine ineligible: "
                      f"{reason})")
        if solver is None:
            solver = make_solver(disc, precond=args.precond)
        cfg = RunConfig(results_root=args.results_root,
                        mesh_root=args.mesh_root, quiet=args.quiet,
                        checkpoint_every=args.checkpoint_every,
                        resume=args.resume, phase_timing=args.phase_timing,
                        vtu_pieces=args.vtu_pieces)
        from tpuwave.utils.profiling import trace
        with trace(args.profile_dir):
            result = run_solver(solver, problem_name, cfg)
    finally:
        for k, v in env_save.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return 2 if result.diverged else 0
