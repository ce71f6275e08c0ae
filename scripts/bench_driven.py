#!/usr/bin/env python3
"""GPU bench for DRIVEN (time-dependent Dirichlet) cases at 4096^2.

Round-2 verdict: the 9372x headline applied only to free vibration; the
driven presets could run only at gather-path speed. Round 3 put driven
g(t) + quadrature-consistent forcing on the fast paths — this script
measures them at the bench scale (sine-membrane-style drive: an
oscillating strip on one edge, reference parameters/sine-membrane.json):

  * explicit leapfrog, driven boundary (lumped; run_leapfrog_driven)
  * explicit leapfrog, driven + consistent forcing load
  * implicit CN via the product fast engine (FastThetaSolver, MG-PCG)
    with driven g — the --engine fast CLI path at scale

Usage (GPU): python -u scripts/bench_driven.py [--nel 4096 --steps 64]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tpuwave.config import enable_compile_cache  # noqa: E402

enable_compile_cache()


def u0_fn(xs, ys):
    return jnp.zeros_like(xs)


def g_fn(xs, ys, t):
    # sine-membrane-style drive: sin(4 pi t) on the x in [0, 1/3] strip of
    # the y=0 edge (the boundary mask selects the edge; the where selects
    # the strip)
    return jnp.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                     jnp.sin(4.0 * jnp.pi * t), 0.0)


def f_fn(xs, ys, t):
    return jnp.sin(2.0 * jnp.pi * xs) * jnp.sin(jnp.pi * ys) \
        * jnp.cos(3.0 * t)


def sync(x):
    return jax.block_until_ready(x)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nel", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    _legs = ["driven", "forced", "implicit", "implicit-2term",
             "implicit-cheby", "p2-implicit", "p2-2term"]
    ap.add_argument("--skip", nargs="*",
                    default=["p2-implicit", "p2-2term"], choices=_legs)
    ap.add_argument("--only", nargs="*", default=None, choices=_legs)
    args = ap.parse_args()
    if args.only is not None:
        args.skip = [n for n in _legs if n not in args.only]

    from tpuwave.models.fast import FastWaveSolver

    nel, steps = args.nel, args.steps
    geo = ((0.0, 0.0), (1.0, 1.0))
    dt = 8e-5
    print(f"# platform={jax.devices()[0].platform} nel={nel} steps={steps}",
          flush=True)

    s = FastWaveSolver((nel, nel), geo, dt, beta=0.0, dtype=jnp.float32)
    times = dt * (1.0 + jnp.arange(steps, dtype=jnp.float32))

    def bench(label, run, state):
        t0 = time.perf_counter()
        out = run(state)
        sync(out.u)
        print(f"# {label}: compile+first {time.perf_counter() - t0:.1f} s",
              flush=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(out)
            sync(out.u)
            best = min(best, time.perf_counter() - t0)
        print(f"{label}: {best / steps * 1e6:9.1f} us/step  "
              f"{s.n_dofs * steps / best:.3e} DoF*steps/s", flush=True)

    if "driven" not in args.skip:
        lf = s.initial_leapfrog_state(u0_fn, g_fn=g_fn)
        bench("explicit driven g(t)          ",
              lambda st: s.run_leapfrog_driven(st, times, g_fn), lf)

    if "forced" not in args.skip:
        lf = s.initial_leapfrog_state(u0_fn, f_fn=f_fn, g_fn=g_fn)
        bench("explicit driven + forcing load",
              lambda st: s.run_leapfrog_driven(st, times, g_fn, f_fn), lf)

    if "implicit" not in args.skip:
        # the product --engine fast CLI path at scale: CN, driven strip,
        # MG-PCG (built via the engine adapter on a synthetic param set)
        from tpuwave.models.fast_engine import FastThetaSolver
        from tpuwave.utils.params import load_params
        case = {
            "Nel": str(nel), "R": "1", "T": "1.0", "Theta": "0.5",
            "Dt": str(1e-3), "Save Solution": "false", "Log Every": "0",
            "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
            "F": {"Function expression": "0.0", "Variable names": "x, y, t"},
            "U0": {"Function expression": "0.0", "Variable names": "x, y"},
            "V0": {"Function expression": "0.0", "Variable names": "x, y"},
            "G": {"Function expression":
                  "if(y < 0.0001 && x < 0.34, sin(4*pi*t), 0)",
                  "Variable names": "x, y, t"},
            "DGDT": {"Function expression":
                     "if(y < 0.0001 && x < 0.34, 4*pi*cos(4*pi*t), 0)",
                     "Variable names": "x, y, t"},
        }
        from tpuwave import config
        config.use_x64(False)
        # Params-based construction -> O(grid) diagnostics; the gather
        # Discretization's tile-padded buffers would exceed HBM here
        eng = FastThetaSolver(load_params(case), precond="mg")
        d = eng.disc
        st = eng.initial_state()
        ts = 1e-3 * (1.0 + jnp.arange(steps, dtype=jnp.float32))

        def run(state):
            out, infos = eng.run_steps(state, ts)
            return out

        t0 = time.perf_counter()
        out = run(st)
        sync(out.u)
        print(f"# implicit CN driven (fast engine, mg): compile+first "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(out)
            sync(out.u)
            best = min(best, time.perf_counter() - t0)
        print(f"implicit CN driven (fast engine, mg, dt=1e-3): "
              f"{best / steps * 1e6:9.1f} us/step  "
              f"{d.n_dofs * steps / best:.3e} DoF*steps/s", flush=True)

    def implicit_case():
        return {
            "Nel": str(nel), "R": "1", "T": "1.0", "Theta": "0.5",
            "Dt": str(1e-3), "Save Solution": "false", "Log Every": "0",
            "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
            "F": {"Function expression": "0.0", "Variable names": "x, y, t"},
            "U0": {"Function expression": "0.0", "Variable names": "x, y"},
            "V0": {"Function expression": "0.0", "Variable names": "x, y"},
            "G": {"Function expression":
                  "if(y < 0.0001 && x < 0.34, sin(4*pi*t), 0)",
                  "Variable names": "x, y, t"},
            "DGDT": {"Function expression":
                     "if(y < 0.0001 && x < 0.34, 4*pi*cos(4*pi*t), 0)",
                     "Variable names": "x, y, t"},
        }

    def bench_engine(label, eng):
        st = eng.initial_state()
        ts = 1e-3 * (1.0 + jnp.arange(steps, dtype=jnp.float32))

        def run(state):
            out, infos = eng.run_steps(state, ts)
            return out

        t0 = time.perf_counter()
        out = run(st)
        sync(out.u)
        print(f"# {label}: compile+first {time.perf_counter() - t0:.1f} s",
              flush=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(out)
            sync(out.u)
            best = min(best, time.perf_counter() - t0)
        print(f"{label}: {best / steps * 1e6:9.1f} us/step  "
              f"{eng.disc.n_dofs * steps / best:.3e} DoF*steps/s",
              flush=True)

    if "implicit-2term" not in args.skip:
        # round-4: the displacement-form product engine (--solver 2term)
        # with the driven boundary lift — the <= ~25 ms/step target
        from tpuwave.models.fast_engine import make_fast_solver
        from tpuwave.utils.params import load_params
        from tpuwave import config
        config.use_x64(False)
        eng2 = make_fast_solver(load_params(implicit_case()), "theta",
                                solver="2term", precond="mg")
        bench_engine("implicit CN driven (2term, mg, dt=1e-3)", eng2)

    if "p2-implicit" not in args.skip:
        # the R=2 product engine at the SAME geometry (67.1M DoF at
        # --nel 4096): driven implicit Newmark-AA through the canvas
        # solves. Default-skipped (slow leg); enable with --only p2-implicit.
        from tpuwave.models.fast_engine import make_fast_solver
        from tpuwave.utils.params import load_params
        from tpuwave import config
        config.use_x64(False)
        case2 = implicit_case()
        case2["R"] = "2"
        case2["Beta"] = "0.25"
        engp2 = make_fast_solver(load_params(case2), "newmark",
                                 precond="mg")
        bench_engine("implicit NM-AA driven P2 (mg,  dt=1e-3)", engp2)

    if "p2-2term" not in args.skip:
        # round-5: --solver 2term at R=2 (models/fast_engine_p2_2term.py)
        # — the displacement recurrence on the canvas planes with the
        # driven boundary lift; the driven-implicit-P2 north-star leg
        from tpuwave.models.fast_engine import make_fast_solver
        from tpuwave.utils.params import load_params
        from tpuwave import config
        config.use_x64(False)
        case3 = implicit_case()
        case3["R"] = "2"
        case3["Beta"] = "0.25"
        engp22 = make_fast_solver(load_params(case3), "newmark",
                                  solver="2term", precond="mg")
        bench_engine("implicit NM-AA driven P2 (2term, mg, dt=1e-3)",
                     engp22)

    if "implicit-cheby" not in args.skip:
        from tpuwave.models.fast_engine import make_fast_solver
        from tpuwave.utils.params import load_params
        from tpuwave import config
        config.use_x64(False)
        engc = make_fast_solver(load_params(implicit_case()), "theta",
                                solver="cheby")
        bench_engine("implicit CN driven (cheby,    dt=1e-3)", engc)


if __name__ == "__main__":
    main()
