#!/usr/bin/env python3
"""Scan MG smoother parameters (pre_degree x smooth_range) on the P1
MG-PCG fast path (run_implicit_mg) — per-step time at CFL-breaking dt.

Usage: python -u scripts/scan_mg_degree.py [nel] [dt] [scheme-val] \
           [degs (comma-sep)] [ranges (comma-sep)]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tpuwave.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.models.fast import FastWaveSolver

NEL = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
DT = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-3
NAME = sys.argv[3] if len(sys.argv) > 3 else "theta-1.0"
DEGS = ([int(d) for d in sys.argv[4].split(",")]
        if len(sys.argv) > 4 else [1, 2, 3])
RANGES = ([float(r) for r in sys.argv[5].split(",")]
          if len(sys.argv) > 5 else [4.0, 8.0, 16.0])
STEPS, REPEATS = 20, 2

family, val = NAME.rsplit("-", 1)
kw = ({"theta": float(val)} if family == "theta"
      else {"beta": float(val), "lumped": False})

print(jax.devices(), flush=True)
s = FastWaveSolver((NEL, NEL), ((0.0, 0.0), (1.0, 1.0)), DT,
                   scheme=family, dtype=jnp.float32, **kw)
st = s.initial_state(
    lambda x, y: jnp.sin(np.pi * x) * jnp.sin(np.pi * y))

for pre_degree in DEGS:
    for smooth_range in RANGES:
        run = lambda st_, n: s.run_implicit_mg(
            st_, n, pre_degree=pre_degree, smooth_range=smooth_range)
        t0 = time.perf_counter()
        out = run(st, STEPS)
        jax.block_until_ready(out)
        warm = time.perf_counter() - t0
        best = float("inf")
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = run(st, STEPS)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / STEPS)
        print(f"{NAME} nel={NEL} dt={DT} deg={pre_degree} "
              f"range={smooth_range}: {best * 1e3:.2f} ms/step "
              f"(compile+warm {warm:.0f} s)", flush=True)
