#!/usr/bin/env python3
"""Benchmark the P2 canvas solver's preconditioners at large dt.

The (p+h)-multigrid on the canvas layout (P2CanvasGmgPreconditioner)
exists for CFL-breaking dt where Jacobi-CG iteration counts blow up with
O(dt/h). Compares precond=jacobi vs precond=mg on the same trajectory
(implicit Newmark-AA by default) and reports ms/step + end-state diff.

Run on a GPU for real numbers; a small --nel on the CPU is a correctness
smoke.
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
    p = argparse.ArgumentParser(description="P2 canvas MG bench")
    p.add_argument("--nel", type=int, default=4096)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--scheme", default="newmark",
                   choices=["newmark", "theta"])
    p.add_argument("--preconds", nargs="+", default=["mg", "jacobi"])
    p.add_argument("--mg-pre-degree", type=int, default=2)
    p.add_argument("--mg-smooth-range", type=float, default=8.0)
    return p.parse_args()


def main():
    args = parse_args()
    from tpuwave.models.fast_p2 import P2CanvasSolver

    print(jax.devices(), flush=True)
    geom = ((0.0, 0.0), (1.0, 1.0))

    def u0(x, y):
        return jnp.sin(np.pi * x) * jnp.sin(np.pi * y)

    outs = {}
    for precond in args.preconds:
        s = P2CanvasSolver((args.nel, args.nel), geom, args.dt,
                           scheme=args.scheme, precond=precond,
                           mg_pre_degree=args.mg_pre_degree,
                           mg_smooth_range=args.mg_smooth_range)
        st = s.initial_state(u0)
        print(f"  [{precond}] compiling + warm run ...", flush=True)
        t0 = time.perf_counter()
        out = s.run_scan(st, args.steps)
        jax.block_until_ready(out)
        print(f"  [{precond}] compile+warm {time.perf_counter() - t0:.1f} s",
              flush=True)
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = s.run_scan(st, args.steps)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / args.steps)
        outs[precond] = out
        dofs = s.n_dofs
        print(f"{args.scheme} P2 nel={args.nel} dt={args.dt} "
              f"precond={precond}: {best * 1e3:.2f} ms/step "
              f"({dofs / best:.3e} DoF*steps/s)", flush=True)

        # displacement-form 2-term path on the same solver/precond
        pair0 = s.implicit_2term_init(st)
        n2 = args.steps - 1
        print(f"  [{precond} 2term] compiling + warm run ...", flush=True)
        t0 = time.perf_counter()
        out2 = s.run_implicit_2term(pair0, n2)
        jax.block_until_ready(out2)
        print(f"  [{precond} 2term] compile+warm "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        best2 = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out2 = s.run_implicit_2term(pair0, n2)
            jax.block_until_ready(out2)
            best2 = min(best2, (time.perf_counter() - t0) / n2)
        rel2 = float(jnp.linalg.norm(out2.u - out.u)
                     / jnp.linalg.norm(out.u))
        print(f"{args.scheme} P2 nel={args.nel} dt={args.dt} "
              f"precond={precond} 2term: {best2 * 1e3:.2f} ms/step "
              f"({dofs / best2:.3e} DoF*steps/s, {best / best2:.2f}x, "
              f"rel diff {rel2:.2e})", flush=True)

    if len(outs) == 2:
        a, b = (outs[p].u for p in args.preconds)
        rel = float(jnp.linalg.norm(a - b) / jnp.linalg.norm(a))
        print(f"end-state rel diff {args.preconds[0]} vs "
              f"{args.preconds[1]}: {rel:.2e}", flush=True)


if __name__ == "__main__":
    main()
