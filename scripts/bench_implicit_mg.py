#!/usr/bin/env python3
"""Benchmark the large-dt implicit MG-PCG fast paths.

The regime where multigrid pays: dt far above the explicit CFL limit, so
single-level solvers need O(dt/h) iterations. Times
``FastWaveSolver.run_implicit_mg`` (3-array form) and
``run_implicit_mg_2term`` (displacement form) on the same trajectory and
reports ms/step and the relative end-state difference.

Run on a GPU for real numbers; ``--nel 64 --steps 3`` is a CPU smoke.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tpuwave.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def parse_args():
    p = argparse.ArgumentParser(description="Implicit MG fast-path bench")
    p.add_argument("--nel", type=int, default=4096)
    p.add_argument("--dt", type=float, default=1e-3,
                   help="time step (default: CFL-breaking at 4096^2)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--schemes", nargs="+",
                   default=["theta-1.0", "theta-0.5", "newmark-0.25"])
    return p.parse_args()


def main():
    args = parse_args()
    from tpuwave.models.fast import FastWaveSolver

    print(jax.devices())
    geom = ((0.0, 0.0), (1.0, 1.0))
    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64

    def u0(x, y):
        return jnp.sin(np.pi * x) * jnp.sin(np.pi * y)

    def measure(label, fn, state, n, repeats):
        # progress markers: compiles at 4096^2 take a while
        print(f"  [{label}] compiling + warm run ...", flush=True)
        t0 = time.perf_counter()
        out = fn(state, n)          # compile + warm
        jax.block_until_ready(out)
        print(f"  [{label}] compile+warm {time.perf_counter() - t0:.1f} s",
              flush=True)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn(state, n)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / n)
        return best, out

    for name in args.schemes:
        family, val = name.rsplit("-", 1)
        kw = ({"theta": float(val)} if family == "theta"
              else {"beta": float(val), "lumped": False})
        s = FastWaveSolver((args.nel, args.nel), geom, args.dt,
                           scheme=family, dtype=dtype, **kw)
        st = s.initial_state(u0)
        t_x, out_x = measure(f"{name} xla-mg", s.run_implicit_mg,
                             st, args.steps, args.repeats)
        print(f"{name} nel={args.nel} dt={args.dt}: "
              f"MG {t_x * 1e3:.2f} ms/step")

        # displacement-form two-array path (one O(dt^2)-residual MG
        # solve per step, no mass/velocity solve; both families)
        lf0 = s.implicit_2term_init(st)

        t_2, out_2 = measure(f"{name} 2term-mg", s.run_implicit_mg_2term,
                             lf0,
                             args.steps - 1, args.repeats)
        rel2 = float(jnp.linalg.norm(out_x.u - out_2.u)
                     / jnp.linalg.norm(out_x.u))
        print(f"{name} nel={args.nel} dt={args.dt}: "
              f"2term MG {t_2 * 1e3:.2f} ms/step "
              f"({t_x / t_2:.2f}x vs 3-array mg), rel diff {rel2:.2e}")


if __name__ == "__main__":
    main()
