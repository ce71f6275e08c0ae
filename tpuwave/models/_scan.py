"""Shared whole-loop scan helpers for the parity solvers.

``run_steps`` / ``run_steps_diag`` compile ``len(times)`` steps of a
solver's ``_step_impl`` into ONE device program (`lax.scan` of the step
body) — the whole-loop compilation of the reference while
loop (SURVEY.md section 3.1). Trajectories and CG iteration counts are
identical to per-step calls; the runner uses these when nothing must be
observed on the host between steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["ScanMixin"]


class ScanMixin:
    """Adds scanned multi-step execution to a solver exposing
    ``_step_impl(state, t) -> (state, info)``."""

    def run_steps(self, state, times):
        """Advance ``len(times)`` steps as one compiled scan; returns
        (final_state, stacked per-step info)."""
        if getattr(self, "_scan", None) is None:
            self._scan = jax.jit(lambda st, ts: jax.lax.scan(
                self._step_impl, st, ts))
        return self._scan(state, jnp.asarray(times))

    def run_steps_diag(self, state, times, diag_fn):
        """``run_steps`` with per-step diagnostics computed INSIDE the
        scan: ``diag_fn(new_state, t) -> dict of scalars`` is evaluated on
        device after every step and stacked — the post-hoc-gather CSV
        cadence of SURVEY.md section 7 step 6. The compiled scan is
        memoized per ``diag_fn`` identity."""
        cache = getattr(self, "_scan_diag", None)
        if cache is None:
            cache = self._scan_diag = {}
        fn = cache.get(id(diag_fn))
        if fn is None:
            def body(st, t):
                new, info = self._step_impl(st, t)
                return new, {**info, **diag_fn(new, t)}
            fn = cache[id(diag_fn)] = jax.jit(
                lambda st, ts: jax.lax.scan(body, st, ts))
        return fn(state, jnp.asarray(times))
