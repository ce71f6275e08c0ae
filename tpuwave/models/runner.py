"""Run driver: the time loop + diagnostics/IO orchestration.

Host-side equivalent of the reference ``run()`` methods
(WaveTheta.cpp:341-447, WaveNewmark.cpp:280-491): time accumulation
(``time += dt`` while ``time < T`` — reproduced with the same float
accumulation so step counts and time stamps match bit-for-bit), divergence
early-break at 1e130, log_every/print_every cadence, per-step VTU output,
and the final convergence.csv row with wall-clock time.

Device work per step is ONE jitted call (rhs + BC + CG solve(s)); the
driver only fetches the two solution norms (needed every step for the
divergence check, as in the reference) plus whatever the logging cadence
requires.
"""

from __future__ import annotations

import math
import os
import shutil
import time as _time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from tpuwave.config import env_flag_enabled
from tpuwave.utils.csvlog import RunLogs, fmt_e
from tpuwave.utils.naming import mesh_file_name, run_folder_name
from tpuwave.utils.vtu import write_mesh_vtk, write_vtu_record

__all__ = ["RunConfig", "RunResult", "run_solver", "time_steps"]

DIVERGENCE_THRESHOLD = 1e130


@dataclass
class RunConfig:
    results_root: str = "results"
    mesh_root: str = "mesh"
    quiet: bool = False
    write_mesh: bool = True
    #: abort the time loop after this many wall-clock seconds (the
    #: in-process analogue of the sweep scripts' subprocess timeout-kill,
    #: reference convergence_sweep.py:228-231). None = no limit.
    max_wall_s: Optional[float] = None
    #: snapshot the stepper state every N steps (0 = off); see
    #: tpuwave.utils.checkpoint (a capability the reference lacks)
    checkpoint_every: int = 0
    #: resume from the newest checkpoint in the run folder, if any
    resume: bool = False
    #: print a host-side per-phase wall-clock breakdown at the end (the
    #: working version of the reference's commented-out StackedTimer,
    #: WaveNewmark.cpp:404-423)
    phase_timing: bool = False
    #: number of VTU pieces per output record (one per shard, mirroring the
    #: reference's one-VTU-per-MPI-rank output with the ``partitioning``
    #: cell field = rank id); 0 = one piece per local device
    vtu_pieces: int = 1


class RunResult(NamedTuple):
    state: object
    timestep_number: int
    final_time: float
    elapsed_s: float
    total_iterations_1: int
    total_iterations_2: int
    diverged: bool
    rel_l2: Optional[float]
    rel_h1: Optional[float]
    output_folder: Path
    timed_out: bool = False


def time_steps(t_final: float, dt: float):
    """The exact time stamps the reference's ``while (time < T)`` loop
    visits, including its float accumulation (WaveTheta.cpp:372-375)."""
    times = []
    t = 0.0
    while t < t_final:
        t += dt
        times.append(t)
    return times


def run_solver(solver, problem_name: str, config: Optional[RunConfig] = None) -> RunResult:
    cfg = config or RunConfig()
    d = solver.disc
    p = d.params

    # rank-0 semantics in multi-host runs (reference ConditionalOStream
    # pcout, WaveEquationBase.hpp:355: only MPI rank 0 prints/writes)
    import jax
    primary = jax.process_index() == 0

    def pcout(*args):
        if not cfg.quiet and primary:
            print(*args)

    pcout("===============================================")
    pcout(f"Initializing the mesh\n  Number of elements = {d.mesh.n_cells}")
    pcout(f"Initializing the finite element space\n  Degree                     = {p.r}")
    pcout(f"Initializing the DoF handler\n  Number of DoFs = {d.n_dofs}")

    imported_mesh = p.mesh_file is not None
    if imported_mesh:
        pcout(f"  Mesh imported from {p.mesh_file}")
        from tpuwave.core.mesh import StructuredTriMesh
        if isinstance(d.mesh, StructuredTriMesh):
            pcout(f"  Recognised as a structured {p.nel[0]}x{p.nel[1]} "
                  "rectangle -> structured engines")
    if cfg.write_mesh and primary and not imported_mesh:
        if d.mesh.n_cells > 2_000_000:
            # bench-scale meshes: the serial VTK snapshot alone would be
            # ~100s of MB of host IO (the reference writes it always, but
            # never ran meshes this size)
            pcout("  (mesh VTK snapshot skipped: > 2M cells)")
        else:
            try:
                write_mesh_vtk(
                    mesh_file_name(cfg.mesh_root, p.nel, p.geometry),
                    d.mesh.vertex_coords, d.mesh.cells)
            except OSError:
                pass

    folder = run_folder_name(cfg.results_root, problem_name, p.r, p.nel,
                             p.dt, p.t_final, solver.method_params_suffix())
    folder.mkdir(parents=True, exist_ok=True)
    pcout(f"Output folder: {folder}/")

    # copy the parameter file for reproducibility
    # (reference WaveEquationBase.cpp:110-131 via NMPDE_PARAM_FILE)
    param_src = os.environ.get("NMPDE_PARAM_FILE") or p.source_path
    if primary and param_src and Path(param_src).exists():
        shutil.copyfile(param_src, folder / "parameters.json")

    # checkpoint/resume (capability beyond the reference; utils/checkpoint.py)
    restored = None
    if cfg.resume:
        from tpuwave.utils.checkpoint import load_latest, truncate_logs_after
        restored = load_latest(folder)
        if restored is not None:
            pcout(f"Resuming from checkpoint at step {restored[0]}, "
                  f"t = {restored[1]}")
            # drop rows logged after the checkpoint so the resumed run
            # doesn't duplicate timesteps
            truncate_logs_after(folder, restored[0])

    convergence_path = None
    if p.has_exact_solution:
        convergence_path = Path(cfg.results_root) / problem_name / "convergence.csv"
    logs = RunLogs(folder, convergence_path, append=restored is not None,
                   enabled=primary)

    # env-variable overrides (reference main-theta.cpp:104-114)
    save_solution = env_flag_enabled("NMPDE_SAVE_SOLUTION", p.save_solution)
    log_every = p.effective_log_every
    env_log = os.environ.get("NMPDE_LOG_EVERY")
    if env_log is not None:
        try:
            log_every = int(env_log)
        except ValueError:
            pass

    # velocity accessor: displacement-form (2-term) solvers carry v
    # implicitly in the state pair and reconstruct it on demand
    # (models/fast_engine_2term.py::state_velocity); 3-array solvers
    # store it directly
    _sv = getattr(solver, "state_velocity", None)

    def state_v(st, t):
        return st.v if _sv is None else _sv(st, t)

    pcout("Setting initial conditions...")
    state = solver.initial_state()
    if restored is not None:
        import jax.numpy as jnp
        _, _, fields = restored
        state = type(state)(**{k: jnp.asarray(v, dtype=getattr(state, k).dtype)
                               for k, v in fields.items()})
    # device-side norms: np.asarray here would pull the full state to
    # the host (268 MB at 4096^2 P2)
    import jax.numpy as _jnp
    norm_u0 = float(_jnp.linalg.norm(state.u))
    norm_v0 = float(_jnp.linalg.norm(state_v(state, 0.0)))
    pcout(f"||u0|| = {norm_u0}")
    pcout(f"||v0|| = {norm_v0}")
    pcout("-----------------------------------------------")

    n_pieces = cfg.vtu_pieces
    if n_pieces == 0:
        import jax
        n_pieces = len(jax.local_devices())

    # shard id per cell: contiguous row blocks of the structured mesh by
    # centroid y — the same domain decomposition the sharded grid solvers
    # use (rows over the device mesh), so the ``partitioning`` field shows
    # the real shard layout (reference: MPI rank per cell). Built lazily:
    # the O(n_cells) host arrays are only materialised when VTU output is
    # actually written (at bench-scale meshes they cost ~GBs).
    _shard_cache = []

    def cell_shard():
        if not _shard_cache:
            coords = np.asarray(d.mesh.vertex_coords)
            cy = coords[np.asarray(d.mesh.cells), 1].mean(axis=1)
            y0, y1 = coords[:, 1].min(), coords[:, 1].max()
            _shard_cache.append(np.minimum(
                (np.maximum(cy - y0, 0.0) / max(y1 - y0, 1e-300)
                 * n_pieces).astype(np.int64), n_pieces - 1))
        return _shard_cache[0]

    # multi-host: each process writes only the pieces owned by its local
    # devices (row-block shard i of n lives on jax.devices()[i] when the
    # piece count matches the device count); process 0 writes the .pvtu
    # referencing all of them — the reference's per-rank VTU + collective
    # record (WaveEquationBase.cpp:363-364) without funnelling every
    # shard's data through one host.
    import jax as _jax
    if _jax.process_count() > 1:
        devs = _jax.devices()
        me = _jax.process_index()
        local_pieces = frozenset(
            pid for pid in range(n_pieces)
            if devs[min(pid * len(devs) // n_pieces,
                        len(devs) - 1)].process_index == me)
    else:
        local_pieces = None  # single process writes everything

    def output(timestep: int, t: float):
        if not save_solution:
            return
        if not primary and not local_pieces:
            return
        point_data = {"u": np.asarray(d.vertex_values(state.u)),
                      "v": np.asarray(d.vertex_values(state_v(state, t)))}
        if p.has_exact_solution:
            ex = d.interpolate(p.solution, t)
            point_data["u_exact"] = np.asarray(d.vertex_values(ex))
        write_vtu_record(folder, "solution", timestep, d.mesh.vertex_coords,
                         d.mesh.cells, point_data, cell_shard=cell_shard(),
                         only_pieces=local_pieces, write_record=primary)

    timestep_number = 0
    current_time = 0.0
    if restored is None:
        output(0, 0.0)

    total_it1 = total_it2 = 0
    current_energy = 0.0
    diverged = False
    timed_out = False
    times = time_steps(p.t_final, p.dt)
    if restored is not None:
        timestep_number = restored[0]
        current_time = restored[1]
        times = times[restored[0]:]

    from tpuwave.utils.profiling import PhaseTimer
    phases = PhaseTimer(enabled=cfg.phase_timing)

    start = _time.perf_counter()

    # Whole-loop scan fast path: when the host needs nothing per step
    # beyond CSV rows (no VTU, no checkpoints), the time loop runs as
    # chunked lax.scan device programs instead of one jit call per step —
    # identical trajectory, CG counts, console cadence and CSV bytes, but
    # ~chunk x fewer host->device dispatches. log_every == 1 (the
    # dissipation-sweep regime) additionally computes energy/errors/probe
    # INSIDE the scan and gathers post-hoc
    # (SURVEY.md section 7 step 6). NB the wall-clock limit is checked
    # between chunks only, so it can overshoot by one device call.
    scan_ok = (not save_solution and cfg.checkpoint_every == 0
               and restored is None and not cfg.phase_timing)
    if scan_ok and ((log_every == 0 and hasattr(solver, "run_steps"))
                    or (log_every == 1
                        and hasattr(solver, "run_steps_diag"))
                    or (log_every > 1 and hasattr(solver, "run_steps"))):
        import jax.numpy as jnp

        with_diag = log_every == 1
        #: log_every > 1 (the preset-default cadence): scan chunks of
        #: exactly log_every steps so every chunk END is a log point,
        #: where energy/errors/probe run as one host-side device call —
        #: per-step dispatch eliminated at any logging cadence
        host_diag = log_every > 1
        has_sol = p.has_exact_solution

        def diag_fn(st, t):
            out = {"energy": d.energy(st.u, state_v(st, t)),
                   "probe": d.probe(st.u)}
            if has_sol:
                out["err"] = jnp.stack(d.errors(st.u, t))
            return out

        chunk_len = 256
        i = 0
        while i < len(times):
            if cfg.max_wall_s is not None and \
                    _time.perf_counter() - start > cfg.max_wall_s:
                pcout(f"Wall-clock limit {cfg.max_wall_s}s exceeded at step "
                      f"{timestep_number}; aborting run.")
                timed_out = True
                break
            if host_diag:
                # chunk up to the next log point, capped so the
                # wall-clock check keeps its granularity at huge
                # Log Every values; only log-point-aligned chunk ends
                # trigger the host diagnostics below
                until_log = log_every - (timestep_number % log_every)
                chunk = times[i:i + min(until_log, chunk_len)]
            else:
                chunk = times[i:i + chunk_len]
            if with_diag:
                state, infos = solver.run_steps_diag(state, chunk, diag_fn)
            else:
                state, infos = solver.run_steps(state, chunk)
            it1 = np.asarray(infos["iterations_1"])
            it2 = np.asarray(infos["iterations_2"])
            nu = np.asarray(infos["norm_u"])
            nv = np.asarray(infos["norm_v"])
            if with_diag:
                en = np.asarray(infos["energy"])
                pr = np.asarray(infos["probe"])
                err = np.asarray(infos["err"]) if has_sol else None
            n_ok = len(chunk)
            bad = False
            for j in range(len(chunk)):
                if d.check_divergence(float(nu[j]), float(nv[j]),
                                      DIVERGENCE_THRESHOLD):
                    n_ok, bad = j + 1, True
                    break
            total_it1 += int(it1[:n_ok].sum())
            total_it2 += int(it2[:n_ok].sum())
            # the host loop breaks BEFORE logging/printing the diverged step
            for j in range(n_ok - 1 if bad else n_ok):
                ts_no = timestep_number + j + 1
                tj = float(chunk[j])
                if with_diag:
                    current_energy = float(en[j])
                    logs.log_energy(ts_no, tj, current_energy)
                    if has_sol:
                        logs.log_error(ts_no, tj,
                                       *(float(x) for x in err[j]))
                    logs.log_probe(ts_no, tj, float(pr[j]))
                    logs.log_iterations(ts_no, tj, int(it1[j]),
                                        int(it2[j]))
                elif host_diag and j == n_ok - 1 and not bad \
                        and ts_no % log_every == 0:
                    # full aligned chunk: its final state IS the log-point
                    # state (the partial last chunk of a non-divisible run
                    # ends off-cadence and logs nothing, like the per-step
                    # loop)
                    current_energy = float(d.energy(state.u,
                                                    state_v(state, tj)))
                    logs.log_energy(ts_no, tj, current_energy)
                    if has_sol:
                        logs.log_error(ts_no, tj,
                                       *(float(x) for x in
                                         d.errors(state.u, tj)))
                    logs.log_probe(ts_no, tj, float(d.probe(state.u)))
                    logs.log_iterations(ts_no, tj, int(it1[j]),
                                        int(it2[j]))
                if ts_no % p.print_every == 0:
                    line = (f"Step {ts_no:6d},  t={tj:9.3e}"
                            f",  ||u||={float(nu[j]):9.3e}"
                            f",  ||v||={float(nv[j]):9.3e}")
                    if log_every > 0:
                        line += f",  E={current_energy:9.3e}"
                    pcout(line)
            timestep_number += n_ok
            current_time = float(chunk[n_ok - 1])
            if bad:
                # NB: state is end-of-chunk, not at the diverged step (the
                # per-step loop would stop exactly there); a diverged
                # run's final errors are garbage either way, as in the
                # reference.
                pcout(f"Divergence detected at step {timestep_number}, "
                      f"t = {current_time}; stopping simulation.")
                diverged = True
                break
            i += n_ok
        times = []   # the per-step loop below is skipped

    for t in times:
        if cfg.max_wall_s is not None and \
                _time.perf_counter() - start > cfg.max_wall_s:
            pcout(f"Wall-clock limit {cfg.max_wall_s}s exceeded at step "
                  f"{timestep_number}; aborting run.")
            timed_out = True
            break
        current_time = t
        timestep_number += 1
        with phases.phase("step"):
            state, info = solver.step(state, t)
            it1 = int(info["iterations_1"])
            it2 = int(info["iterations_2"])
        total_it1 += it1
        total_it2 += it2
        norm_u = float(info["norm_u"])
        norm_v = float(info["norm_v"])

        if d.check_divergence(norm_u, norm_v, DIVERGENCE_THRESHOLD):
            pcout(f"Divergence detected at step {timestep_number}, "
                  f"t = {current_time}; stopping simulation.")
            diverged = True
            break

        if log_every > 0 and timestep_number % log_every == 0:
            with phases.phase("diagnostics"):
                current_energy = float(d.energy(state.u,
                                                state_v(state,
                                                        current_time)))
                logs.log_energy(timestep_number, current_time, current_energy)
                if p.has_exact_solution:
                    l2, h1, rl2, rh1 = (float(x) for x in
                                        d.errors(state.u, current_time))
                    logs.log_error(timestep_number, current_time,
                                   l2, h1, rl2, rh1)
                logs.log_probe(timestep_number, current_time,
                               float(d.probe(state.u)))
                logs.log_iterations(timestep_number, current_time, it1, it2)

        if timestep_number % p.print_every == 0:
            line = (f"Step {timestep_number:6d},  t={current_time:9.3e}"
                    f",  ||u||={norm_u:9.3e},  ||v||={norm_v:9.3e}")
            if log_every > 0:
                line += f",  E={current_energy:9.3e}"
            pcout(line)

        if cfg.checkpoint_every > 0 and primary and \
                timestep_number % cfg.checkpoint_every == 0:
            from tpuwave.utils.checkpoint import save_checkpoint
            save_checkpoint(folder, timestep_number, current_time, state)

        with phases.phase("output"):
            output(timestep_number, current_time)

    elapsed = _time.perf_counter() - start
    if cfg.phase_timing:
        pcout(phases.report())

    pcout(f"\nSimulation completed: {timestep_number} steps, "
          f"final time t = {current_time}")
    pcout(f"Elapsed time: {elapsed:.3f} seconds")
    avg1 = total_it1 / timestep_number if timestep_number else 0.0
    pcout(f"Total CG iterations (1): {total_it1}, avg per step: {avg1:.1f}")
    if total_it2:
        avg2 = total_it2 / timestep_number if timestep_number else 0.0
        pcout(f"Total CG iterations (2): {total_it2}, avg per step: {avg2:.1f}")

    rel_l2 = rel_h1 = None
    if p.has_exact_solution and not timed_out:
        _, _, rl2, rh1 = (float(x) for x in d.errors(state.u, current_time))
        rel_l2, rel_h1 = rl2, rh1
        is_theta = solver.method_name == "theta"
        h = 1.0 / math.sqrt(p.nel[0] * p.nel[1])
        logs.log_convergence(
            h=h, nel=p.nel, r=p.r, dt=p.dt, t_final=p.t_final,
            problem_name=problem_name,
            theta=p.theta if is_theta else None,
            beta=None if is_theta else p.beta,
            gamma=None if is_theta else p.gamma,
            rel_l2=rl2, rel_h1=rh1, elapsed_s=elapsed)
        pcout("Final (last-iteration) errors:")
        pcout(f"  Relative L2 error  = {fmt_e(rl2)}")
        pcout(f"  Relative H1 error  = {fmt_e(rh1)}")

    logs.close()
    return RunResult(state=state, timestep_number=timestep_number,
                     final_time=current_time, elapsed_s=elapsed,
                     total_iterations_1=total_it1, total_iterations_2=total_it2,
                     diverged=diverged, rel_l2=rel_l2, rel_h1=rel_h1,
                     output_folder=folder, timed_out=timed_out)
