#!/usr/bin/env python3
"""Strong-scaling sweep: fixed problem, varying device count.

In-process port of the reference scalability harness
(scripts/scalability_sweep.py in /root/reference): same fixed problem
(standing mode, Nel=640, r=1, dt=8e-5, T=0.05 => 625 steps, IO disabled),
same output schema (scheme,binary,nprocs,repeat,...,seconds, min-of-repeats
convention) — but "processes" are devices in a jax.sharding mesh, and
the solver is the grid-stencil fast path (models/fast.py) with the whole
loop compiled as one scan.

On a host without N real chips, pass --virtual-devices N to fan out over a
virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args():
    p = argparse.ArgumentParser(description="Scalability sweep (tpuwave)")
    p.add_argument("--devices", type=int, nargs="+", default=[1],
                   help="Device counts to test (like the reference's p sweep)")
    p.add_argument("--virtual-devices", type=int, default=0,
                   help="Force N virtual CPU devices (testing without chips)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--nel", type=int, default=640)
    p.add_argument("--r", type=int, default=1)
    p.add_argument("--dt", type=float, default=0.00008)
    p.add_argument("--T", type=float, default=0.05)
    p.add_argument("--schemes", nargs="+",
                   default=["theta-0.0", "theta-0.5", "theta-1.0",
                            "newmark-0.00", "newmark-0.25"])
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--job-id", default=os.environ.get("PBS_JOBID", ""))
    p.add_argument("--distributed", action="store_true",
                   help="multi-host run: jax.distributed.initialize + a "
                        "host-aware (hosts x local devices) 2D mesh")
    p.add_argument("--profile-dir", default=None,
                   help="archive a jax.profiler device trace per "
                        "(scheme, device-count) next to the CSVs")
    return p.parse_args()


def main():
    args = parse_args()
    if args.virtual_devices:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={args.virtual_devices}"
        ).strip()

    import jax
    import jax.numpy as jnp

    from tpuwave.harness import SCHEME_DEFS
    from tpuwave.models.fast import FastWaveSolver
    from tpuwave.models.runner import time_steps
    from tpuwave.parallel.sharding import (dcn_device_mesh, device_mesh,
                                           grid_sharding, init_distributed)

    if args.distributed:
        init_distributed()

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    n_steps = len(time_steps(args.T, args.dt))
    n_avail = len(jax.devices())
    print(f"devices available: {n_avail} ({jax.devices()[0].platform}), "
          f"{n_steps} steps per run")

    def u0(xs, ys):
        return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)

    job_suffix = f"-{args.job_id}" if args.job_id else ""
    out_path = Path(f"scalability-results-{max(args.devices)}{job_suffix}.csv")
    with out_path.open("w") as f:
        f.write("scheme,binary,nprocs,repeat,Nel,R,Dt,T,Theta,Beta,Gamma,"
                "returncode,seconds\n")
        for n_dev in args.devices:
            if n_dev > n_avail:
                print(f"[SKIP] {n_dev} devices requested, {n_avail} available")
                continue
            if args.distributed:
                # multi-host: every process must participate in every
                # collective, so only the full-device count is valid (a
                # prefix mesh would leave some hosts with no addressable
                # devices and crash); smaller counts are skipped
                if n_dev != n_avail:
                    print(f"[SKIP] --distributed: n={n_dev} != all "
                          f"{n_avail} devices (partial meshes cannot span "
                          "all hosts)")
                    continue
                # hosts x local devices: row halos cross the network only
                # at host boundaries, column halos stay inside a host
                sharding = grid_sharding(dcn_device_mesh())
            else:
                sharding = grid_sharding(device_mesh(n_dev)) if n_dev > 1 \
                    else None
            for scheme_name in args.schemes:
                sdef = SCHEME_DEFS[scheme_name]
                ov = sdef["overrides"]
                theta = ov.get("Theta", "")
                beta = ov.get("Beta", "")
                gamma = ov.get("Gamma", "")
                if sdef["family"] == "theta":
                    solver = FastWaveSolver(
                        (args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                        args.dt, scheme="theta", theta=float(theta),
                        lumped=False, dtype=dtype, sharding=sharding)
                else:
                    solver = FastWaveSolver(
                        (args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                        args.dt, scheme="newmark", beta=float(beta),
                        gamma=float(gamma), lumped=float(beta) == 0.0,
                        dtype=dtype, sharding=sharding)
                state0 = solver.initial_state(u0)
                # compile outside the timed region (the reference's timing
                # also excludes setup: it reports the binary's own loop time
                # in convergence.csv but wall-clock here; we keep wall-only
                # on the compiled loop, min over repeats)
                warm = solver.run_scan(state0, n_steps)
                jax.block_until_ready(warm)
                if args.profile_dir:
                    # device trace of one warm run, archived next to the
                    # CSVs (kept outside the timed repeats below)
                    from tpuwave.utils.profiling import trace
                    tdir = (Path(args.profile_dir)
                            / f"{scheme_name}-p{n_dev}")
                    with trace(str(tdir)):
                        jax.block_until_ready(
                            solver.run_scan(state0, n_steps))
                for rep in range(1, args.repeats + 1):
                    t0 = time.perf_counter()
                    out = solver.run_scan(state0, n_steps)
                    jax.block_until_ready(out)
                    secs = time.perf_counter() - t0
                    dof_steps = solver.n_dofs * n_steps
                    print(f"p={n_dev} {scheme_name} rep{rep}: {secs:.3f}s "
                          f"({dof_steps / secs:.3e} DoF*steps/s)")
                    f.write(f"{scheme_name},tpuwave-fast,{n_dev},{rep},"
                            f"{args.nel},{args.r},{args.dt},{args.T},"
                            f"{theta},{beta},{gamma},0,{secs:.6f}\n")
                    f.flush()

    print(f"Done. Results: {out_path}")


if __name__ == "__main__":
    main()
