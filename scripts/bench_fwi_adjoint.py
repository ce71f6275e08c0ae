#!/usr/bin/env python3
"""Benchmark the FWI adjoint modes: remat autodiff vs time-reversal.

Compares ``FwiProblem(adjoint="remat")`` (jax.checkpoint'd scan — XLA
stores the two-field carry per step, so gradient memory grows linearly
in n_steps) against ``adjoint="reversal"`` (custom_vjp backward pass
that RECONSTRUCTS forward states by running the time-reversible
leapfrog backwards — O(1) memory in n_steps; models/inverse.py).

For each step count it reports the wall time of one jitted
``value_and_grad(misfit)`` evaluation per mode, the gradient agreement,
and — the headline — the step count where remat runs out of HBM while
reversal keeps going.

Run on a GPU for real numbers; ``--nel 64 --steps 20 40`` works as a CPU
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


def parse_args():
    p = argparse.ArgumentParser(description="FWI adjoint-mode bench")
    p.add_argument("--nel", type=int, default=1024)
    p.add_argument("--dt", type=float, default=2e-4)
    p.add_argument("--steps", type=int, nargs="+",
                   default=[500, 2000, 8000])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--modes", nargs="+",
                   default=["remat", "reversal"],
                   choices=["remat", "reversal"],
                   help="adjoint modes, both on the stencil-plane engine")
    p.add_argument("--forward-only", action="store_true",
                   help="time p.simulate instead of value_and_grad")
    p.add_argument("--sponge", type=float, default=0.0,
                   help="absorbing-layer width (physical units; 0 = hard "
                        "walls). With 'reversal' this exercises the "
                        "boundary-saving path (damped strip stored per "
                        "step)")
    p.add_argument("--boundary-save", choices=("strip", "ring"),
                   default="strip",
                   help="reversal+sponge storage: every damped vertex "
                        "(exact everywhere) or just the interface ring "
                        "(exact on the physical region, O(perimeter) "
                        "memory)")
    return p.parse_args()


def main():
    args = parse_args()
    from tpuwave import config
    if args.dtype == "f64":
        config.use_x64()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tpuwave.models.inverse import FwiProblem

    print(jax.devices())
    geom = ((0.0, 0.0), (1.0, 1.0))
    recs = [(x, y) for x in (0.15, 0.5, 0.85) for y in (0.15, 0.85)]

    rows = []
    for n_steps in args.steps:
        grads = {}
        for mode in args.modes:
            p = FwiProblem((args.nel, args.nel), geom, args.dt, n_steps,
                           source=(0.25, 0.5), receivers=recs,
                           engine="stencil", adjoint=mode,
                           sponge_width=args.sponge,
                           boundary_save=args.boundary_save)
            if args.sponge > 0.0 and p._sponge_rects is not None:
                frac = p._sponge_saved_size / p.n_vertices
                print(f"  boundary save ({p.boundary_save}): "
                      f"{p._sponge_saved_size} vertices "
                      f"({100 * frac:.1f}% of the grid) saved per step")
            cent = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1)
            inside = np.sum((cent - [0.6, 0.5]) ** 2, 1) < 0.18 ** 2
            c2_true = jnp.asarray(np.where(inside, 0.65, 1.0), p.dtype)
            c2_hom = jnp.ones(p.n_cells, p.dtype)
            def time_fn(fn, *fargs):
                """(first-call seconds, best-of-repeats seconds, result)."""
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(*fargs))
                first = time.perf_counter() - t0
                best = float("inf")
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(*fargs))
                    best = min(best, time.perf_counter() - t0)
                return first, best, out

            try:
                if args.forward_only:
                    compile_s, best, d_obs = time_fn(jax.jit(p.simulate),
                                                     c2_true)
                    val = 0.5 * float(jnp.sum(d_obs * d_obs))
                    vlabel = "obs energy"   # no residual in forward mode
                    g = jnp.zeros(1, p.dtype)
                else:
                    d_obs = jax.block_until_ready(p.simulate(c2_true))
                    vg = jax.jit(jax.value_and_grad(p.misfit))
                    compile_s, best, (val, g) = time_fn(vg, c2_hom, d_obs)
                    vlabel = "misfit"
            except Exception as e:  # noqa: BLE001 - report OOM and move on
                kind = type(e).__name__
                msg = str(e).splitlines()[0][:100]
                print(f"nel={args.nel} steps={n_steps:>6} {mode:>8}:"
                      f"  FAILED ({kind}: {msg})")
                rows.append((n_steps, mode, None, None))
                continue
            grads[mode] = np.asarray(g)
            unit = "s/fwd" if args.forward_only else "s/grad"
            print(f"nel={args.nel} steps={n_steps:>6} {mode:>8}:"
                  f"  {best:8.3f} {unit}  (compile+1st {compile_s:.1f} s,"
                  f"  {vlabel} {float(val):.6e})")
            rows.append((n_steps, mode, best, float(val)))
        if len(grads) >= 2 and not args.forward_only:
            base_mode = next(iter(grads))
            a = grads[base_mode]
            na = np.linalg.norm(a)
            for other, b in list(grads.items())[1:]:
                if na == 0.0:
                    print("              grad agreement: base grad is zero "
                          "(wavefront has not reached anomaly+receivers)")
                    break
                rel = np.linalg.norm(a - b) / na
                print(f"              grad agreement {base_mode} vs "
                      f"{other}: rel l2 diff {rel:.3e}")

    header = "".join(f"{m:>16}" for m in args.modes)
    print(f"\nsteps  s/grad:{header}")
    by = {}
    for n_steps, mode, best, _ in rows:
        by.setdefault(n_steps, {})[mode] = best
    for n_steps in args.steps:
        r = by.get(n_steps, {})
        fmt = lambda v: f"{v:16.3f}" if v is not None else "             OOM"
        print(f"{n_steps:>6} " + "".join(fmt(r.get(m)) for m in args.modes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
