#!/usr/bin/env python3
"""Benchmark the encoded-source and linearized-imaging paths on a GPU.

Three measurements over an S-shot surface acquisition (models/inverse.py):

1. ``sequential``: one jitted value_and_grad of ``misfit_shots`` — the
   classic gradient, S propagation pairs per evaluation.
2. ``encoded``: one jitted value_and_grad of ``misfit_encoded`` — the
   Krebs et al. 2009 supershot: ONE propagation pair regardless of S,
   so the expected speedup is ~S×.
3. ``lsrtm-iter``: one CGLS iteration of least-squares RTM = one Born
   modeling (jvp) + one migration (vjp) over the full acquisition.

Run on a GPU for real numbers; ``--nel 64 --steps 60`` is a CPU smoke.
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
    p = argparse.ArgumentParser(description="encoded/imaging FWI bench")
    p.add_argument("--nel", type=int, default=512)
    p.add_argument("--dt", type=float, default=4e-4)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--shots", type=int, default=8)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--modes", nargs="+",
                   default=["sequential", "encoded", "lsrtm-iter"],
                   choices=["sequential", "encoded", "lsrtm-iter"])
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
    n = args.nel
    recs = [(x, 0.9) for x in np.linspace(0.1, 0.9, 9)]
    p = FwiProblem((n, n), geom, args.dt, args.steps,
                   source=(0.5, 0.1), receivers=recs,
                   engine="stencil", adjoint="reversal",
                   dtype=jnp.float64 if args.dtype == "f64"
                   else jnp.float32)
    srcs = p.snap_vertices([(x, 0.1)
                            for x in np.linspace(0.1, 0.9, args.shots)])
    rng = np.random.default_rng(0)
    c2 = jnp.asarray(1.0 + 0.05 * rng.random(p.n_cells), p.dtype)
    dm = jnp.asarray(rng.normal(size=p.n_cells), p.dtype)
    print(f"{n}x{n} grid ({p.n_vertices/1e6:.2f}M vertices), "
          f"{args.steps} steps, {args.shots} shots, {args.dtype}")
    # shot-by-shot synthesis: one compiled single-shot program reused S
    # times (vmapping S reversal sims has compiled pathologically slowly)
    sim1 = jax.jit(lambda m, s: p._reversal_sim(m, s, p.wavelet)
                   if p.adjoint == "reversal"
                   else p._propagate(m, s, p.wavelet))
    m_true = jnp.full(p.n_cells, 1.1, p.dtype)
    obs = jnp.stack([jax.block_until_ready(sim1(m_true, s)) for s in srcs])
    codes = jnp.asarray(rng.choice([-1.0, 1.0], args.shots), p.dtype)

    def timeit(f, *xs):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*xs))
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*xs))
            best = min(best, time.perf_counter() - t0)
        return best, compile_s

    results = {}
    if "sequential" in args.modes:
        # one-shot gradient × S: the cost of classic shot-by-shot FWI
        # (grad-of-vmap over S reversal custom_vjps has compiled
        # pathologically slowly at production sizes, and on one device
        # the vmap buys nothing — shots run back to back either way)
        f = jax.jit(jax.value_and_grad(
            lambda m: p.misfit(m, obs[0], wavelet=p.wavelet)))
        s1, cs = timeit(f, c2)
        s = s1 * args.shots
        results["sequential"] = s
        print(f"sequential grad: {s1:.3f} s/shot x {args.shots} shots "
              f"= {s:.3f} s (compile {cs:.1f} s)")
    if "encoded" in args.modes:
        f = jax.jit(jax.value_and_grad(
            lambda m, cd: p.misfit_encoded(m, srcs, cd, obs)))
        s, cs = timeit(f, c2, codes)
        results["encoded"] = s
        print(f"encoded grad (1 supershot): {s:.3f} s "
              f"(compile {cs:.1f} s)")
    if "lsrtm-iter" in args.modes:
        # per-shot Born and migration (the data map is additive over
        # shots, so production LSRTM runs a shot loop and accumulates;
        # one compiled single-shot program each, reused S times)
        fb = jax.jit(lambda m, d_: p.born(m, d_))
        fm = jax.jit(lambda m, r_: p.migrate(m, r_))
        sb, cb = timeit(fb, c2, dm)
        sm, cm = timeit(fm, c2, obs[0])
        tot = (sb + sm) * args.shots
        results["lsrtm-iter"] = tot
        print(f"born {sb:.3f} s + migrate {sm:.3f} s per shot x "
              f"{args.shots} shots = {tot:.3f} s / CGLS iter "
              f"(compile {cb:.0f}+{cm:.0f} s)")
    if "sequential" in results and "encoded" in results:
        print(f"encoding speedup: "
              f"{results['sequential'] / results['encoded']:.2f}x "
              f"(ideal {args.shots}x)")


if __name__ == "__main__":
    main()
