#!/usr/bin/env python3
"""Explicit Newmark (lumped mass) throughput on one GPU.

Runs the reference's strong-scaling configuration at 4096^2: standing-mode
problem, P1 elements, IO disabled (reference scripts/scalability_sweep.py:
85-120), explicit central-difference Newmark through the XLA leapfrog scan
(``FastWaveSolver.run_leapfrog_scan``). Metric: DoF*steps/second, against
the reference's best CPU number, 1.14e7 DoF*steps/s (Newmark beta=0, 32 MPI
ranks on 2x28-core Xeon, BASELINE.md).

Prints one JSON line on stdout:
``{"metric", "value", "unit", "vs_baseline", "device"}`` with the device as
JAX reports it. Refuses to run (exit 1, message on stderr, nothing on
stdout) when JAX finds no GPU: a CPU number is not a device number.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

REFERENCE_BASELINE = 1.14e7  # DoF*steps/s, reference p=32 explicit Newmark
NEL = 4096
CHUNK = 96
REPEATS = 3


def device_info() -> dict:
    """The first device as JAX reports it (platform, kind, count)."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main() -> int:
    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev['platform']} "
              f"({dev['kind']}). Refusing to report a device number.",
              file=sys.stderr)
        return 1

    from tpuwave.config import enable_compile_cache
    from tpuwave.models.fast import FastWaveSolver
    enable_compile_cache()

    solver = FastWaveSolver((NEL, NEL), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                            beta=0.0, dtype=jnp.float32)
    state = solver.initial_leapfrog_state(
        lambda xs, ys: jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys))

    t0 = time.perf_counter()
    st = jax.block_until_ready(solver.run_leapfrog_scan(state, CHUNK))
    print(f"# compile + first call {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        st = jax.block_until_ready(solver.run_leapfrog_scan(st, CHUNK))
        best = min(best, time.perf_counter() - t0)
    value = solver.n_dofs * CHUNK / best
    print(json.dumps({
        "metric": f"explicit Newmark (leapfrog, lumped) DoF*steps/s, "
                  f"{NEL}x{NEL} P1, f32, XLA scan",
        "value": value,
        "unit": "DoF*steps/s",
        "vs_baseline": value / REFERENCE_BASELINE,
        "device": dev,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
