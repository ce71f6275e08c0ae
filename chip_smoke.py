#!/usr/bin/env python3
"""Smoke run of tpuwave on one GPU, through the solver CLI.

    python3 chip_smoke.py           # one card: the phases below
    python3 chip_smoke.py --four    # four cards: the sharded path only

Phases on one card, all in this one process:

* ``anchor`` — the reference's published accuracy anchor (BASELINE.md):
  Newmark beta=0.25, gamma=0.5, R=2, Nel=320, dt=1e-4, T=1 on the
  standing-mode problem, f64, through ``tpuwave-newmark``. The final
  relative errors must match rel L2 2.647e-7 (rtol 1e-2: the L2 error sits
  at the CG 1e-6 stopping floor) and rel H1 9.276e-6 (rtol 1e-3).
* ``fill`` — driven, forced, implicit P2 at 4096^2 (67.1M DoF) with
  ``--precond mg``, a few steps in f32 and in f64; the two runs' probe.csv
  and energy.csv must agree to FILL_RTOL of each column's largest value.
  Prints peak device memory after each run and the compiled memory
  analysis of one f64 step.
* ``parity`` — the fast (grid-stencil) engine against the parity (gather)
  engine, P1 f64 at 2048^2, driven and forced, a few steps through the CLI;
  probe.csv and energy.csv must agree to PARITY_RTOL.
* ``stream`` — one step of the XLA leapfrog scan at 8192^2 P1 f32 against
  an a + b stream over the same three arrays, timed in the same process;
  both as a share of the card's 3.35 TB/s.

``--four`` runs the fill case in f64 with ``--shard rows`` and ``--shard
blocks`` over four cards against the one-card run, and compares the CSVs
to SHARD_RTOL (the reductions run in another order across cards, so
byte equality is not expected).

Earlier lines carry the card's name and power limit, each phase's numbers
with their tolerance, and its time. The last line is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed. Without a GPU the script exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ANCHOR_REL_L2, ANCHOR_L2_RTOL = 2.647e-7, 1e-2
ANCHOR_REL_H1, ANCHOR_H1_RTOL = 9.276e-6, 1e-3
#: f32 vs f64 runs of the fill case: the f32 CG stops at its backward-error
#: floor (8 eps ||A|| ||x||) and every diagnostic is a 67M-term f32 sum
FILL_RTOL = 1e-3
#: fast vs parity engine, both f64 with the same CG contract: the CSVs
#: print 6 (energy) and 11 (probe) significant digits, so the bound is one
#: unit in the sixth digit
PARITY_RTOL = 2e-6
#: sharded vs one-card f64 run: same algebra, other reduction order
SHARD_RTOL = 1e-9
HBM_PEAK_BPS = 3.35e12   # H100 SXM data sheet

DRIVEN = {
    "F": {"Function expression": "sin(3*pi*x)*cos(2*pi*y)*cos(5*t)",
          "Variable names": "x, y, t"},
    "G": {"Function expression": "0.1*sin(2*t)*(1+x*y)",
          "Variable names": "x, y, t"},
    "DGDT": {"Function expression": "0.2*cos(2*t)*(1+x*y)",
             "Variable names": "x, y, t"},
}


# -- helpers (pure; exercised by tests/test_chip_smoke.py) ------------------

def parse_nvidia_smi(text: str):
    """``name,power.limit`` CSV lines -> [(name, power_limit_str)]."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if name:
            cards.append((name.strip(), limit.strip()))
    return cards


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last stdout line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def _number(text: str):
    try:
        return float(text)
    except ValueError:
        return text


def read_csv_columns(path: Path):
    """CSV file -> {column: [value, ...]}, numbers parsed as floats."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        raise ValueError(f"{path}: no data rows")
    return {k: [_number(r[k]) for r in rows] for k in rows[0]}


def max_rel_diff(a, b) -> float:
    """max |a - b| over the columns' shared rows, relative to max |b|."""
    if len(a) != len(b):
        raise ValueError(f"row counts differ: {len(a)} vs {len(b)}")
    scale = max(abs(x) for x in b) or 1.0
    return max(abs(x - y) for x, y in zip(a, b)) / scale


def compare_runs(run_a: Path, run_b: Path, files=("probe.csv",
                                                  "energy.csv")):
    """{file:column -> max relative difference} of two run folders' CSVs
    (value columns only; timestep/time must match exactly)."""
    out = {}
    for name in files:
        ca, cb = read_csv_columns(run_a / name), read_csv_columns(run_b / name)
        if ca["timestep"] != cb["timestep"]:
            raise ValueError(f"{name}: timesteps differ")
        for col in ca:
            if col in ("timestep", "time"):
                continue
            out[f"{name}:{col}"] = max_rel_diff(ca[col], cb[col])
    return out


def run_folder(results_root: Path) -> Path:
    """The single run folder a CLI call created under ``results_root``."""
    found = [p.parent for p in results_root.glob("*/run-*/probe.csv")]
    if len(found) != 1:
        raise RuntimeError(f"expected one run under {results_root}, "
                           f"found {found}")
    return found[0]


def standing_case(**over) -> dict:
    case = json.loads((ROOT / "parameters" /
                       "standing-mode-wsol.json").read_text())
    case.update({"Save Solution": "false", **over})
    return case


def anchor_case() -> dict:
    """BASELINE.md's accuracy anchor on the standing-mode preset."""
    return standing_case(**{"Nel": "320", "R": "2", "T": "1.0",
                            "Dt": "0.0001", "Beta": "0.25", "Gamma": "0.5",
                            "Log Every": "1000", "Print Every": "1000"})


def driven_case(nel: int, r: int, steps: int, dt: float = 1e-3) -> dict:
    """Driven + forced implicit Newmark on the unit square."""
    case = standing_case(**{"Nel": str(nel), "R": str(r),
                            "T": repr(steps * dt), "Dt": repr(dt),
                            "Beta": "0.25", "Gamma": "0.5",
                            "Log Every": "1", "Print Every": "1000000",
                            **DRIVEN})
    case.pop("Solution")
    return case


# -- phases ------------------------------------------------------------------

def run_cli(family: str, case: dict, workdir: Path, tag: str, *flags):
    """Run ``tpuwave-<family>`` on ``case`` in-process; returns the run
    folder (its own results root under ``workdir``)."""
    from tpuwave.cli import newmark, theta
    main = {"newmark": newmark.main, "theta": theta.main}[family]
    param = workdir / f"{tag}.json"
    param.write_text(json.dumps(case))
    root = workdir / tag
    rc = main([str(param), "--results-root", str(root), "--mesh-root",
               str(workdir / "mesh"), "--quiet", *flags])
    if rc != 0:
        raise RuntimeError(f"tpuwave-{family} {tag} exited {rc}")
    return run_folder(root)


def check(label: str, value: float, want: float, rtol: float) -> bool:
    rel = abs(value - want) / abs(want)
    ok = rel <= rtol
    print(f"  {label}: {value:.6e} (want {want:.4e}, rel {rel:.2e} "
          f"<= {rtol:g}: {'ok' if ok else 'FAIL'})")
    return ok


def check_compare(label: str, diffs: dict, rtol: float) -> bool:
    ok = True
    for key, d in diffs.items():
        good = d <= rtol
        ok &= good
        print(f"  {label} {key}: max rel diff {d:.3e} <= {rtol:g}: "
              f"{'ok' if good else 'FAIL'}")
    return ok


def peak_bytes() -> int:
    """The first device's peak bytes in use (-1 where not reported)."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", -1)


def phase_anchor(workdir: Path, case=None) -> bool:
    run = run_cli("newmark", case or anchor_case(), workdir, "anchor")
    conv = read_csv_columns(run.parent / "convergence.csv")
    rl2 = conv["rel_L2_error_final"][-1]
    rh1 = conv["rel_H1_error_final"][-1]
    print(f"  run time {conv['elapsed_time_s'][-1]:.3f} s (solver loop)")
    ok = check("rel L2", rl2, ANCHOR_REL_L2, ANCHOR_L2_RTOL)
    return check("rel H1", rh1, ANCHOR_REL_H1, ANCHOR_H1_RTOL) and ok


def step_memory_analysis(case: dict):
    """Compiled memory analysis of one f64 engine step for ``case``."""
    import jax
    from tpuwave import config
    from tpuwave.api import build_solver
    from tpuwave.models.fast_engine import FastGridState
    from tpuwave.utils.params import load_params
    config.use_x64(True)
    solver = build_solver(load_params(case), "newmark", precond="mg")
    shape = (4,) + tuple(solver._cshape)
    arr = jax.ShapeDtypeStruct(shape, solver.dtype)
    lowered = solver._step.lower(FastGridState(arr, arr, arr),
                                 jax.ShapeDtypeStruct((), solver.dtype))
    return lowered.compile().memory_analysis()


def phase_fill(workdir: Path, nel: int = 4096, steps: int = 4) -> bool:
    case = driven_case(nel, 2, steps)
    # f32 first: the process-wide peak after the f64 run is then the f64
    # run's own peak
    run32 = run_cli("newmark", case, workdir, "fill-f32", "--precond", "mg",
                    "--f32")
    print(f"  f32 run: peak_bytes_in_use {peak_bytes()}")
    run64 = run_cli("newmark", case, workdir, "fill-f64", "--precond", "mg")
    print(f"  f64 run: peak_bytes_in_use {peak_bytes()}")
    mem = step_memory_analysis(case)
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    print("  f64 step memory_analysis: " + ", ".join(
        f"{f} {getattr(mem, f, 'n/a')}" for f in fields))
    iters = read_csv_columns(run64 / "iterations.csv")["iterations_1"]
    print(f"  f64 CG iterations per step: {iters}")
    return check_compare("f32 vs f64", compare_runs(run32, run64), FILL_RTOL)


def phase_parity(workdir: Path, nel: int = 2048, steps: int = 3) -> bool:
    case = driven_case(nel, 1, steps)
    fast = run_cli("newmark", case, workdir, "parity-fast", "--engine",
                   "fast")
    ref = run_cli("newmark", case, workdir, "parity-gather", "--engine",
                  "parity")
    return check_compare("fast vs parity",
                         compare_runs(fast, ref,
                                      ("probe.csv", "energy.csv",
                                       "iterations.csv")), PARITY_RTOL)


def time_call(fn, *args, calls: int = 1, repeats: int = 5) -> float:
    """Median wall seconds per call of ``fn(*args)`` over ``repeats``
    samples of ``calls`` back-to-back calls, after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / calls)
    return sorted(times)[len(times) // 2]


def nvidia_smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading (csv, no header)."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def phase_stream(nel: int = 8192, steps: int = 20) -> bool:
    """Leapfrog step vs an a + b stream over the same three arrays."""
    import jax
    import jax.numpy as jnp
    from tpuwave import config
    from tpuwave.models.fast import FastWaveSolver
    config.use_x64(False)
    solver = FastWaveSolver((nel, nel), ((0.0, 0.0), (1.0, 1.0)), 1e-5,
                            beta=0.0, dtype=jnp.float32)
    state = solver.initial_leapfrog_state(
        lambda xs, ys: jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys))
    t_step = time_call(solver.run_leapfrog_scan, state, steps) / steps
    add = jax.jit(lambda a, b: a + b)
    t_add = time_call(add, state.u, state.u_prev, calls=steps)
    nbytes = 3 * state.u.size * state.u.dtype.itemsize
    for label, t in (("leapfrog step (XLA scan)", t_step),
                     ("a + b stream", t_add)):
        bw = nbytes / t
        print(f"  {label}: {t * 1e6:.1f} us, {bw / 1e9:.0f} GB/s over "
              f"{nbytes / 1e6:.0f} MB = {bw / HBM_PEAK_BPS:.1%} of 3.35 TB/s")
    print(f"  leapfrog / stream time ratio: {t_step / t_add:.3f}")
    print("  clocks.sm, clocks.mem, power.draw after the window: "
          + nvidia_smi("clocks.sm,clocks.mem,power.draw"))
    return bool(jnp.all(jnp.isfinite(solver.run_leapfrog_scan(state,
                                                              steps).u)))


def phase_four(workdir: Path, nel: int = 4096, steps: int = 4) -> bool:
    case = driven_case(nel, 2, steps)
    one = run_cli("newmark", case, workdir, "four-one", "--precond", "mg")
    ok = True
    for layout in ("rows", "blocks"):
        run = run_cli("newmark", case, workdir, f"four-{layout}",
                      "--precond", "mg", "--shard", layout)
        ok &= check_compare(f"--shard {layout} vs one card",
                            compare_runs(run, one), SHARD_RTOL)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four cards")
    ap.add_argument("--workdir", default=str(ROOT / "results" /
                                             "chip_smoke"),
                    help="parameter files and run folders")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {devs[0].platform} "
              f"({devs[0].device_kind}).", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke {'--four ' if args.four else ''}needs {want} "
              f"GPU(s); JAX found {len(devs)}.", file=sys.stderr)
        return 2

    from tpuwave.config import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}")
    for name, limit in parse_nvidia_smi(nvidia_smi("name,power.limit")):
        print(f"card: {name}, {limit}")
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    workdir = Path(args.workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    if args.four:
        phases = [("four", lambda: phase_four(workdir))]
    else:
        phases = [("anchor", lambda: phase_anchor(workdir)),
                  ("fill", lambda: phase_fill(workdir)),
                  ("parity", lambda: phase_parity(workdir)),
                  ("stream", phase_stream)]
    failed = []
    for name, fn in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:   # a phase boundary: report, run the rest, fail
            traceback.print_exc()
            ok = False
        print(f"[{name}] {'ok' if ok else 'FAILED'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            failed.append(name)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(result_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
