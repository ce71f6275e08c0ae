#!/usr/bin/env python3
"""f64 and compensated-f32 explicit throughput at the 4096^2 bench scale.

Measures, at the SAME 4096^2 standing-mode leapfrog configuration:

  * f32 XLA roll scan
  * compensated f32 (TwoSum carries, ~f48 effective; models/fast.py
    CompensatedState — 2 stencil applies + TwoSum bookkeeping per step)
  * f64 XLA roll scan

Usage (GPU): python -u scripts/bench_precision.py [--nel 4096 --steps 64]
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


def u0(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)


def sync(x):
    return jax.block_until_ready(x)


def time_path(label, run, state, n_dofs, steps, repeats=3):
    t0 = time.perf_counter()
    out = run(state)
    sync(out.u)
    print(f"# {label}: compile+first {time.perf_counter() - t0:.1f} s",
          flush=True)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run(out)
        sync(out.u)
        best = min(best, time.perf_counter() - t0)
    rate = n_dofs * steps / best
    print(f"{label}: {best / steps * 1e6:9.1f} us/step  "
          f"{rate:.3e} DoF*steps/s", flush=True)
    return rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nel", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=["f32", "comp", "f64", "imp-f32", "imp-comp",
                             "imp-f64"])
    ap.add_argument("--only", nargs="*", default=None,
                    choices=["f32", "comp", "f64", "imp-f32", "imp-comp",
                             "imp-f64"])
    args = ap.parse_args()
    if args.only is not None:
        all_names = ["f32", "comp", "f64", "imp-f32", "imp-comp",
                     "imp-f64"]
        args.skip = [n for n in all_names if n not in args.only]

    from tpuwave.models.fast import FastWaveSolver

    nel, steps = args.nel, args.steps
    geo = ((0.0, 0.0), (1.0, 1.0))
    print(f"# platform={jax.devices()[0].platform} nel={nel} steps={steps}",
          flush=True)

    if "f32" not in args.skip:
        s32 = FastWaveSolver((nel, nel), geo, 8e-5, beta=0.0,
                             dtype=jnp.float32)
        lf = s32.initial_leapfrog_state(u0)
        time_path("f32  roll scan   ",
                  lambda st: s32.run_leapfrog_scan(st, steps), lf,
                  s32.n_dofs, steps)

    if "comp" not in args.skip:
        s32 = FastWaveSolver((nel, nel), geo, 8e-5, beta=0.0,
                             dtype=jnp.float32)
        cs = s32.initial_compensated_state(u0)
        time_path("f32c compensated ",
                  lambda st: s32.run_leapfrog_compensated(st, steps), cs,
                  s32.n_dofs, steps)

    if "f64" not in args.skip:
        from tpuwave import config
        config.use_x64(True)
        s64 = FastWaveSolver((nel, nel), geo, 8e-5, beta=0.0,
                             dtype=jnp.float64)
        lf = s64.initial_leapfrog_state(u0)
        time_path("f64  roll scan   ",
                  lambda st: s64.run_leapfrog_scan(st, steps), lf,
                  s64.n_dofs, steps)

    # ------------------------------------------------------------------
    # implicit MG rows (round-4 verdict ask 7): driven CN at the same
    # scale through the product engine (--solver 2term --precond mg),
    # f32 / f64; the compensated-f32 implicit row runs the same
    # displacement recurrence with TwoSum carries
    # (run_implicit_mg_2term_comp, CN form)
    # ------------------------------------------------------------------
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
        st0 = eng.initial_state()
        ts = 1e-3 * (1.0 + jnp.arange(steps, dtype=eng.dtype))

        def run(state):
            out, _ = eng.run_steps(state, ts)
            return out

        time_path(label, run, st0, eng.disc.n_dofs, steps)

    from tpuwave import config
    from tpuwave.models.fast_engine import make_fast_solver
    from tpuwave.utils.params import load_params

    if "imp-f32" not in args.skip:
        config.use_x64(False)
        bench_engine("f32  implicit CN driven (2term mg)",
                     make_fast_solver(load_params(implicit_case()),
                                      "theta", solver="2term",
                                      precond="mg"))

    if "imp-comp" not in args.skip:
        # compensated displacement recurrence (CN form) on the DRIVEN
        # configuration — the same strip drive as the f32 row above, so
        # the correction solve runs the driven ~3-iteration regime, not
        # the standing-mode ~1 (round-5 verdict ask 7;
        # models/fast.py::run_implicit_mg_2term_comp_driven)
        config.use_x64(False)
        sc = FastWaveSolver((nel, nel), geo, 1e-3, scheme="theta",
                            theta=0.5, lumped=False, dtype=jnp.float32)

        def g_strip(xs, ys, t):
            return jnp.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                             jnp.sin(4.0 * jnp.pi * t), 0.0)

        cs = sc.implicit_2term_init_comp(sc.initial_state(u0))
        ts_d = 1e-3 * (1.0 + jnp.arange(steps, dtype=jnp.float32))
        time_path("f32c implicit CN compensated 2term driven",
                  lambda st: sc.run_implicit_mg_2term_comp_driven(
                      st, ts_d, g_strip),
                  cs, sc.n_dofs, steps)
        # standing-mode companion (the round-4 row) for the iteration-
        # count comparison sentence
        cs2 = sc.implicit_2term_init_comp(sc.initial_state(u0))
        time_path("f32c implicit CN compensated 2term standing",
                  lambda st: sc.run_implicit_mg_2term_comp(st, steps),
                  cs2, sc.n_dofs, steps)

    if "imp-f64" not in args.skip:
        config.use_x64(True)
        bench_engine("f64  implicit CN driven (2term mg)",
                     make_fast_solver(load_params(implicit_case()),
                                      "theta", solver="2term",
                                      precond="mg"))


if __name__ == "__main__":
    main()
