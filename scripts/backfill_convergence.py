#!/usr/bin/env python3
"""Backfill exactly the reference convergence rows missing from our dataset.

Reads the reference's published convergence CSV (analysis/data/
convergence-results.csv in /root/reference) and our merged dataset, computes
the (scheme, Nel, r, dt) combinations the reference ran that we have not,
and runs them through the same in-process harness the main sweep uses
(tpuwave.harness.run_case), cheapest first. Each completed row is appended
to our merged dataset CSV and the runlog IMMEDIATELY, so a long grind can be
interrupted and committed at any point.

Intended engines: the default backend (a GPU) or CPU with
JAX_PLATFORMS=cpu.

Usage:
    python scripts/backfill_convergence.py [--limit N] [--max-steps N]
        [--dataset analysis/data/convergence-results.csv]
        [--reference /root/reference/analysis/data/convergence-results.csv]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuwave import config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def scheme_of(row) -> str:
    """Map a reference CSV row to a harness scheme name."""
    if "theta" in row.get("method", ""):
        th = float(row["theta"])
        return f"theta-{th:.1f}"
    be = float(row["beta"])
    return f"newmark-{be:.2f}"


def key_of(row):
    return (scheme_of(row), int(row["N_el_x"]), int(row["r"]),
            float(row["dt"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", default="/root/reference/analysis/data/"
                                           "convergence-results.csv")
    ap.add_argument("--dataset",
                    default=str(REPO / "analysis/data/convergence-results.csv"))
    ap.add_argument("--runlog",
                    default=str(REPO / "analysis/data/convergence-runlog.csv"))
    ap.add_argument("--results-root", default="results")
    ap.add_argument("--base-params",
                    default=str(REPO / "parameters/standing-mode-wsol.json"))
    ap.add_argument("--limit", type=int, default=0,
                    help="run at most N rows (0 = all)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="skip rows needing more than N time steps (0 = all)")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--reduction", type=float, default=1e-6,
                    help="CG relative-reduction factor for the fast engine "
                         "(1e-9 matches the reference AMG-CG's effective "
                         "over-convergence on fine meshes)")
    ap.add_argument("--engine", choices=["harness", "fast"], default="harness",
                    help="harness = full parity solvers (host cadence); "
                         "fast = f64 grid/plane-stencil solvers with the "
                         "whole loop scanned on device (same operators, "
                         "CG tolerances and consistent-mass algebra; "
                         "requires the homogeneous standing-mode preset)")
    args = ap.parse_args()

    config.use_x64(not args.f32)

    from tpuwave.harness import PARAM_STEM, cfl_limit, run_case, SCHEME_DEFS

    ref_rows = list(csv.DictReader(open(args.reference)))
    our_rows = list(csv.DictReader(open(args.dataset)))
    have = {key_of(r) for r in our_rows}
    missing = [r for r in ref_rows if key_of(r) not in have]
    # cheapest first: cost ~ steps * DoF (DoF ~ (r*Nel)^2); FE (theta-0,
    # unconditionally unstable -> blowup rows, device-fault-prone on
    # emulated f64) deferred to the end so one bad row can't block the
    # stable queue
    missing.sort(key=lambda r: (scheme_of(r) == "theta-0.0",
                                (float(r["T"]) / float(r["dt"]))
                                * (int(r["r"]) * int(r["N_el_x"])) ** 2))
    if args.max_steps:
        missing = [r for r in missing
                   if float(r["T"]) / float(r["dt"]) <= args.max_steps]
    if args.limit:
        missing = missing[:args.limit]
    print(f"{len(ref_rows)} reference rows, {len(our_rows)} ours, "
          f"{len(missing)} to backfill")

    if args.engine == "fast":
        run_fast_backfill(args, missing)
        return

    results_base = Path(args.results_root)
    for row in missing:
        scheme, nel, r, dt = key_of(row)
        sdef = SCHEME_DEFS[scheme]
        steps = float(row["T"]) / dt
        print(f"[backfill] {scheme} Nel={nel} r={r} dt={dt} "
              f"({steps:.0f} steps)", flush=True)

        # fresh per-family convergence.csv so we pick up exactly this row
        fam_csv = results_base / f"{sdef['family']}-{PARAM_STEM}" / \
            "convergence.csv"
        if fam_csv.exists():
            fam_csv.unlink()

        overrides = {"Nel": str(nel), "R": str(r), "Dt": str(dt),
                     "T": row["T"], "Save Solution": False,
                     "Enable Logging": False, "Log Every": 0}
        code, elapsed, _ = run_case(scheme, args.base_params, overrides,
                                    results_root=args.results_root,
                                    timeout_s=args.timeout)
        print(f"  -> code={code} in {elapsed:.1f}s", flush=True)

        cfl = (cfl_limit(nel, r) if sdef["explicit"] else float("inf"))
        with open(args.runlog, "a") as lf:
            lf.write(f"{scheme},{nel},{r},{dt},{row['T']},{code},"
                     f"{elapsed:.3f},{cfl:.8f}\n")
        if code != 0 or not fam_csv.exists():
            continue
        new = fam_csv.read_text().splitlines()
        with open(args.dataset, "a") as out:
            for line in new[1:]:
                out.write(line + "\n")
    print("backfill done")


def run_fast_backfill(args, missing):
    """Backfill rows through the f64 stencil fast paths with the time loop
    scanned on device — same discrete operators (tested equivalent to the
    flat assembly), same CG stopping rule (1e-12 abs / 1e-6 relative),
    consistent-mass solves incl. the Newmark a0. Orders of magnitude
    faster than the host-cadence harness for many-step rows."""
    import math
    import time as _time

    import jax
    import jax.numpy as jnp

    from tpuwave.harness import SCHEME_DEFS, cfl_limit
    from tpuwave.models.discretization import Discretization
    from tpuwave.models.fast import FastWaveSolver
    from tpuwave.models.fast_p2 import P2FastSolver
    from tpuwave.models.runner import time_steps
    from tpuwave.utils.csvlog import fmt_e, fmt_g, to_string
    from tpuwave.utils.params import load_params

    dtype = jnp.float32 if args.f32 else jnp.float64

    for row in missing:
        scheme, nel, r, dt = key_of(row)
        sdef = SCHEME_DEFS[scheme]
        t_final = float(row["T"])
        overrides = {**sdef["overrides"],
                     "Nel": str(nel), "R": str(r), "Dt": str(dt),
                     "T": row["T"], "Save Solution": False,
                     "Enable Logging": False, "Log Every": 0}
        params = load_params(args.base_params, overrides=overrides)
        if (not params.g.is_zero or not params.f.is_zero
                or params.c.constant_value is None):
            print(f"[fast-backfill] SKIP {scheme} Nel={nel} r={r} dt={dt}: "
                  "fast engine needs homogeneous g, zero forcing, const c")
            continue
        geom = params.geometry
        times = time_steps(t_final, dt)
        print(f"[fast-backfill] {scheme} Nel={nel} r={r} dt={dt} "
              f"({len(times)} steps)", flush=True)

        def u0_fn(xs, ys):
            return params.u0.evaluate(xs, ys, 0.0)

        def v0_fn(xs, ys):
            return params.v0.evaluate(xs, ys, 0.0)

        c0 = float(params.c.constant_value)
        t0 = _time.perf_counter()
        if sdef["family"] == "theta":
            kw = dict(scheme="theta", theta=params.theta)
        else:
            kw = dict(scheme="newmark", beta=params.beta,
                      gamma=params.gamma)
        # chunk the scan so the divergence check runs between chunks.
        # FE blowup growth can exceed e^30 per 500 steps, jumping from
        # below any threshold straight past the f64 range inside
        # one chunk — use short chunks for the unstable scheme.
        chunk = 128 if scheme == "theta-0.0" else 500
        kw["cg_reduction"] = args.reduction
        if r == 1:
            s = FastWaveSolver((nel, nel), geom, dt, c=c0, lumped=False,
                               dtype=dtype, **kw)
            st = (s.initial_state_consistent(u0_fn, v0_fn)
                  if sdef["family"] == "newmark"
                  else s.initial_state(u0_fn, v0_fn))
        else:
            s = P2FastSolver((nel, nel), geom, dt, c=c0, dtype=dtype, **kw)
            st = s.initial_state(u0_fn, v0_fn=v0_fn)
        n = len(times)
        done = 0
        diverged = False
        while done < n:
            k = min(chunk, n - done)
            st = s.run_scan(st, k)
            jax.block_until_ready(st.u)
            done += k
            # divergence early-break (reference WaveEquationBase.cpp:
            # 425-431). The threshold is far below the reference's 1e130:
            # any magnitude past 1e15 is a blown run in either code.
            mx = float(jnp.max(jnp.abs(st.u)))
            diverged = not math.isfinite(mx) or mx > 1e15
            if diverged:
                print(f"  diverged by step {done} (|u|max={mx:.3g}); "
                      "stopping early", flush=True)
                break
        if diverged:
            # the error quadrature would overflow on the blown state; a
            # blown row only needs a
            # >1e10 magnitude for the blowup classification
            rl2 = rh1 = mx
        else:
            u_flat = st.u.reshape(-1) if r == 1 else st.u
            jax.block_until_ready(u_flat)
            disc = Discretization(params)
            current_time = float(times[-1])
            _, _, rl2, rh1 = (float(x) for x in
                              disc.errors(jnp.asarray(u_flat, jnp.float64),
                                          current_time))
        elapsed = _time.perf_counter() - t0
        print(f"  -> relL2={rl2:.6e} relH1={rh1:.6e} in {elapsed:.1f}s",
              flush=True)

        h = 1.0 / math.sqrt(nel * nel)
        is_theta = sdef["family"] == "theta"
        fields = (fmt_g(h), nel, nel, r, fmt_g(dt), fmt_g(t_final),
                  f"{sdef['family']}-conv-params",
                  to_string(params.theta) if is_theta else "N/A",
                  "N/A" if is_theta else to_string(params.beta),
                  "N/A" if is_theta else to_string(params.gamma),
                  fmt_e(rl2), fmt_e(rh1), f"{elapsed:.3f}")
        with open(args.dataset, "a") as out_f:
            out_f.write(",".join(str(f) for f in fields) + "\n")
        cfl = cfl_limit(nel, r) if sdef["explicit"] else float("inf")
        with open(args.runlog, "a") as lf:
            lf.write(f"{scheme},{nel},{r},{dt},{row['T']},0,"
                     f"{elapsed:.3f},{cfl:.8f}\n")
    print("backfill done")


if __name__ == "__main__":
    sys.exit(main() or 0)
