"""Displacement-form (2-term) implicit solvers on the product surface.

The repo's fastest implicit path (models/fast.py::run_implicit_mg_2term —
one O(dt^2)-residual system solve per step, ~1 MG-PCG iteration, two-array
state) was bench-script-only and homogeneous. This module generalises the
3-term displacement recurrence to the FULL reference problem class and
puts it behind ``--solver 2term``:

Eliminating the auxiliary variables from the schemes (using the
semi-discrete relations M a^j = F^j - K u^j for Newmark and the two theta
update equations) gives, for interior rows, with A the implicit system:

  Newmark: A u^{n+1} = M (2u^n - u^{n-1})
                       - dt^2 (g + 1/2 - 2b) K u^n - dt^2 (1/2 - g + b) K u^{n-1}
                       + dt^2 [ b F^{n+1} + (g + 1/2 - 2b) F^n + (1/2 - g + b) F^{n-1} ]
  theta:   A u^{n+1} = M (2u^n - u^{n-1})
                       - dt^2 K [ 2t(1-t) u^n + (1-t)^2 u^{n-1} ]
                       + dt^2 [ t^2 F^{n+1} + 2t(1-t) F^n + (1-t)^2 F^{n-1} ]

(b = beta, g = gamma, t = theta.) The matvecs act on the FULL vectors —
boundary entries carry their true driven values u^j|b = g(t^j) — so the
free extrapolated warm start x0 = 2u^n - u^{n-1} (boundary = g(t^{n+1}))
leaves the O(dt^2)-small residual

  r0 = -dt^2 K [ c_u u^n + c_up u^{n-1} ] + dt^2 F-combo - A (delta 1_b),
  delta = g(t^{n+1}) - 2 g(t^n) + g(t^{n-1})   (~ dt^2 g_tt, O(dt^2))

with c_u = gamma + 1/2 / 2 theta and c_up = 1/2 - gamma / 1 - 2 theta —
the driven-boundary lift of the homogeneous recurrence (the delta term
vanishes for g == 0). Each step costs one stencil pass for r0
(+ one A pass for the lift when g != 0) plus ~1 MG-PCG iteration — no
mass/velocity solve. Replaces the reference's two AMG-CG solves per theta
step / one per Newmark step (WaveTheta.cpp:251-339,
WaveNewmark.cpp:177-262) with one near-converged solve for either family.

Velocity is implicit in the state pair. The exact v is reconstructed on
demand (``state_velocity`` — the runner calls it at diagnostics/IO points
only):

  theta:   M v^N = M (u^N - u^{N-1})/dt - dt(1-t) K [t u^N + (1-t) u^{N-1}]
                   + dt(1-t) [t F^N + (1-t) F^{N-1}],  v|b = dg/dt(t^N)
           (exact to solve tolerance — derived from the step equations)
  Newmark: v^N = (u^N - u^{N-1})/dt + dt [(1/2+b-g) a^{N-1} + (g-b) a^N]
           with consistent M a^j = F^j - K u^j. The BOUNDARY acceleration
           follows the derived-BC recurrence a^{n+1}|b = (g - z)/(b dt^2)
           — an undamped boundary integrator whose values are NOT
           recoverable from two displacement slices (measured: ignoring
           it puts ~0.5 relative error on v|b). The state therefore
           carries O(perimeter) strips (v_b, a_b, a_b^{prev}) advanced by
           the exact boundary recurrence each step (negligible cost);
           reconstruction pins the a-solves with the carried strips and
           reads v|b from v_b directly — parity-exact to solve tolerance.

Per-step console ||v|| uses the backward difference ||(u^{n+1} - u^n)/dt||
(divergence-check proxy; CSV rows at log points use the exact
reconstruction). Accuracy class: identical to the parity engine in f64 up
to solve tolerance; in f32 the implicit-velocity noise amplification
documented at models/fast.py::run_implicit_mg_2term applies.

Scope: constant or spatially varying wave speed (the elimination assumes
K static in time; `Time Dependent C` stays on the 3-term engines) and
beta > 0 for Newmark (beta = 0 boundary handling follows a different
recurrence; the explicit paths cover it).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuwave.models.fast_engine import _FastEngineBase, _Op
from tpuwave.solve.cg import pcg
from tpuwave.utils.params import Params

__all__ = ["Fast2TermState", "Fast2TermThetaSolver",
           "Fast2TermNewmarkSolver"]


class Fast2TermState(NamedTuple):
    u: jax.Array        #: flat u^n (boundary = g(t^n))
    u_prev: jax.Array   #: flat u^{n-1} (zeros before the first step)
    v0: jax.Array       #: initial velocity (consumed by step 1 + t=0 IO)
    a0: jax.Array       #: consistent initial acceleration (Newmark)
    n: jax.Array        #: int32 step counter (0 = no step taken yet)
    #: Newmark boundary strips (4, max(h, w)): rows = bottom/top/left/
    #: right edge values of v^n, a^n and a^{n-1} on the boundary —
    #: advanced by the exact derived-BC recurrence (class docstring).
    #: Zeros for the theta family (v|b = dg/dt is pinned directly there).
    vb: jax.Array
    ab: jax.Array
    ab_prev: jax.Array


class _Fast2TermBase(_FastEngineBase):
    """Shared 2-term machinery on top of the P1 product-engine base
    (operators, boundary/forcing evaluators, elimination, mg plumbing
    all inherited)."""

    def __init__(self, problem, *, precond: str = "mg", **kw):
        kw.pop("solver", None)
        super().__init__(problem, precond=precond, **kw)
        if self._c_mode == "tdep":
            raise ValueError(
                "--solver 2term needs a time-static wave speed (the "
                "displacement elimination assumes K constant in time); "
                "use the 3term engine for `Time Dependent C`")
        if self.method_name == "newmark":
            if self.fs.beta <= 1e-12:
                raise ValueError(
                    "--solver 2term needs Beta > 0 for Newmark (explicit "
                    "beta = 0 is the leapfrog path)")
            self._c_u = self.fs.gamma + 0.5
            self._c_up = 0.5 - self.fs.gamma
            b, g = self.fs.beta, self.fs.gamma
            self._f_w = (b, g + 0.5 - 2.0 * b, 0.5 - g + b)
        else:
            th = self.fs.theta
            self._c_u = 2.0 * th
            self._c_up = 1.0 - 2.0 * th
            self._f_w = (th * th, 2.0 * th * (1.0 - th),
                         (1.0 - th) ** 2)
        # the boundary lift A(delta 1_b) is needed whenever the state's
        # boundary values can differ from the pure extrapolation: driven
        # g, any Newmark run (derived-BC decay), or theta with initial
        # data nonzero on the boundary (parity pins u^1|b = 0, so the
        # n=1 extrapolation still sees u^0|b)
        self._needs_lift = (not self._g.is_zero
                            or self.method_name == "newmark")
        if not self._needs_lift:
            u0 = jnp.asarray(self.disc.interpolate(self.disc.params.u0),
                             self.dtype).reshape(self.fs.shape)
            self._needs_lift = bool(jnp.any(
                jnp.where(self.fs.boundary, u0, 0.0) != 0.0))
        # noise-anchored f32 stopping scale (run_implicit_mg_2term note):
        # r0's own computation noise is ~ eps * s_abs * |u| elementwise
        k = self._k_static
        if k.stencil is not None:
            k_mag = sum(abs(c) for row in k.stencil for c in row)
        else:
            k_mag = k.lam_hi   # Gershgorin-class majorant (varcoef)
        self._s_abs = (abs(self._c_u) + abs(self._c_up)) \
            * self.dt * self.dt * k_mag

        self._sys_op_static = self._system_of(k)

    # -- forcing -------------------------------------------------------
    def _f_combo(self, t):
        """dt^2-scaled three-point forcing combination of the recurrence
        (None when the problem has no forcing)."""
        if self._f is None:
            return None
        dt = self.dt
        w1, w0, wm = self._f_w
        load = self.fs.grid_load
        out = None
        for w, tt in ((w1, t), (w0, t - dt), (wm, t - 2.0 * dt)):
            if w == 0.0:
                continue
            term = (dt * dt * w) * load(self._f.evaluate, tt)
            out = term if out is None else out + term
        return out

    def _k_diff(self, x):
        """K x with the f32 cancellation noise removed where possible
        (zero-row-sum difference form for the constant stencil; the
        assembled varcoef planes otherwise). Interior rows are exact for
        arbitrary boundary values; edge-row wrap garbage is masked by
        every consumer."""
        if self._k_static.stencil is not None:
            return self.fs._stiff_diff(x)
        return self._k_static.apply(x)

    # -- correction solve ----------------------------------------------
    def _solve_corr(self, sys_op: _Op, r0, x0_norm):
        """PCG for A w = r0 from w = 0 (the O(dt^2) correction), with
        the noise-anchored stopping rule of run_implicit_mg_2term:
        ALWAYS demand >= a 2x reduction (min with 0.5 ||r0||) — a floor
        above ||r0|| silently degenerates the recurrence to pure
        extrapolation."""
        rn2 = jnp.vdot(r0, r0)
        if self.dtype == jnp.float64:
            abs_tol = jnp.minimum(jnp.asarray(1e-12, self.dtype),
                                  0.5 * jnp.sqrt(rn2).astype(self.dtype))
        else:
            eta = float(jnp.finfo(self.dtype).eps)
            abs_tol = jnp.minimum(
                eta * self._s_abs * x0_norm,
                0.5 * jnp.sqrt(rn2)).astype(self.dtype)
        prec = self._sys_precond(sys_op)
        apply_c = self._constrained_apply(sys_op)
        return pcg(apply_c, r0, jnp.zeros_like(r0), r0=r0, norm0_sq=rn2,
                   precond_inv_diag=prec, abs_tol=abs_tol,
                   max_iter=self._max_iter, reduction=self.fs.cg_reduction)

    # -- boundary strips (Newmark driven-v machinery) -------------------
    @property
    def _strip_len(self):
        return max(self.fs.shape)

    def _edge_coords(self):
        fs = self.fs
        (x0, y0) = fs.mesh.origin
        hx, hy = fs.mesh.hx, fs.mesh.hy
        h, w = fs.shape
        xs = x0 + hx * jnp.arange(w, dtype=self.dtype)
        ys = y0 + hy * jnp.arange(h, dtype=self.dtype)
        x1 = jnp.asarray(x0 + hx * (w - 1), self.dtype)
        y1 = jnp.asarray(y0 + hy * (h - 1), self.dtype)
        return xs, ys, jnp.asarray(x0, self.dtype), x1, \
            jnp.asarray(y0, self.dtype), y1

    def _edge_vals(self, expr, t):
        """(4, L) bottom/top/left/right edge values of expr(x, y, t),
        zero-padded to L = max(h, w)."""
        h, w = self.fs.shape
        L = self._strip_len
        if expr.is_zero:
            return jnp.zeros((4, L), self.dtype)
        xs, ys, x0, x1, y0, y1 = self._edge_coords()

        def row(vals, n):
            v = jnp.broadcast_to(jnp.asarray(vals, self.dtype), (n,))
            return jnp.zeros(L, self.dtype).at[:n].set(v)

        return jnp.stack([
            row(expr.evaluate(xs, jnp.full_like(xs, y0), t), w),
            row(expr.evaluate(xs, jnp.full_like(xs, y1), t), w),
            row(expr.evaluate(jnp.full_like(ys, x0), ys, t), h),
            row(expr.evaluate(jnp.full_like(ys, x1), ys, t), h),
        ])

    def _grid_edges(self, xg):
        """(4, L) edge extraction of a (h, w) grid array."""
        h, w = self.fs.shape
        L = self._strip_len
        z = jnp.zeros(L, self.dtype)
        return jnp.stack([z.at[:w].set(xg[0, :]),
                          z.at[:w].set(xg[h - 1, :]),
                          z.at[:h].set(xg[:, 0]),
                          z.at[:h].set(xg[:, w - 1])])

    def _strip_plane(self, strip):
        """(4, L) strip -> (h, w) plane with the strip values on the four
        edges (zeros inside; corners consistent — the four recurrences
        agree there)."""
        h, w = self.fs.shape
        out = jnp.zeros(self.fs.shape, self.dtype)
        out = out.at[:, 0].set(strip[2, :h])
        out = out.at[:, w - 1].set(strip[3, :h])
        out = out.at[0, :].set(strip[0, :w])
        out = out.at[h - 1, :].set(strip[1, :w])
        return out

    def _advance_strips(self, vb, ab, ub, t):
        """One exact step of the parity boundary recurrence
        (WaveNewmark.cpp:177-278 restricted to boundary rows):
        z_b = u_b + dt v_b + dt^2(1/2-b) a_b; a' = (g(t) - z_b)/(b dt^2);
        v' = v_b + dt((1-g) a_b + g a'). ``ub`` = u^n edge values."""
        dt, beta, gamma = self.dt, self.fs.beta, self.fs.gamma
        g_np1 = self._edge_vals(self._g, t)
        z_b = ub + dt * vb + (dt * dt * (0.5 - beta)) * ab
        a_new = (g_np1 - z_b) / (beta * dt * dt)
        v_new = vb + dt * ((1.0 - gamma) * ab + gamma * a_new)
        return v_new, a_new

    # -- stepping ------------------------------------------------------
    def initial_state(self) -> Fast2TermState:
        d = self.disc
        u0 = jnp.asarray(d.interpolate(d.params.u0), self.dtype)
        v0 = jnp.asarray(d.interpolate(d.params.v0), self.dtype)
        if self._flat_sharding is not None:
            u0 = jax.device_put(u0, self._flat_sharding)
            v0 = jax.device_put(v0, self._flat_sharding)
        L = self._strip_len
        zb = jnp.zeros((4, L), self.dtype)
        if self.method_name == "newmark":
            a0 = self._consistent_a0(u0)
            fsh = self.fs.shape
            vb = self._grid_edges(v0.reshape(fsh))
            ab = self._grid_edges(a0.reshape(fsh))
        else:
            a0 = jnp.zeros_like(u0)
            vb = ab = zb
        return Fast2TermState(u=u0, u_prev=jnp.zeros_like(u0), v0=v0,
                              a0=a0, n=jnp.asarray(0, jnp.int32),
                              vb=vb, ab=ab, ab_prev=zb)

    def _consistent_a0(self, u0_flat):
        """M a0 = F(0) - K u0 with the second-difference accel BC
        (reference WaveNewmark.cpp:298-390) — same algebra as the 3-array
        engine's initial_state."""
        fs, dt = self.fs, self.dt
        u0 = u0_flat.reshape(fs.shape)
        rhs = -self._k_diff(u0)
        if self._f is not None:
            rhs = rhs + fs.grid_load(self._f.evaluate, 0.0)
        g_p = self._plane(self._g, dt)
        g_0 = self._plane(self._g, 0.0)
        g_m = self._plane(self._g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc,
                          jnp.zeros_like(u0), self._prec_mass,
                          g_zero=self._g.is_zero)
        return res.x.astype(self.dtype).reshape(-1)

    def _first_step(self, state: Fast2TermState, t):
        """Step 1 solved directly in u-form (composing u^1 from the
        3-array step injects acceleration noise the undamped recurrence
        amplifies — models/fast.py::implicit_2term_init note):
          theta:   A u^1 = M u^0 - dt^2 t(1-t) K u^0 + dt M v^0
                           + t dt^2 [t F^1 + (1-t) F^0]
          Newmark: A u^1 = M z + b dt^2 F^1,
                   z = u^0 + dt v^0 + dt^2 (1/2 - b) a^0
        with u^1|b = g(t^1) by the standard elimination."""
        fs, dt = self.fs, self.dt
        u0 = self._shard_grid(state.u.reshape(fs.shape))
        v0 = self._shard_grid(state.v0.reshape(fs.shape))
        k_op = self._k_static
        sys_op = self._system_of(k_op)
        if self.method_name == "theta":
            th = fs.theta
            rhs = self._mass_op.apply(u0) \
                - (dt * dt * th * (1.0 - th)) * k_op.apply(u0) \
                + dt * self._mass_op.apply(v0)
            if self._f is not None:
                fa = (th * fs.grid_load(self._f.evaluate, t)
                      + (1.0 - th) * fs.grid_load(self._f.evaluate,
                                                  t - dt))
                rhs = rhs + (th * dt * dt) * fa
            x_prev = u0
        else:
            beta = fs.beta
            a0 = self._shard_grid(state.a0.reshape(fs.shape))
            z = u0 + dt * v0 + (dt * dt * (0.5 - beta)) * a0
            rhs = self._mass_op.apply(z)
            if self._f is not None:
                rhs = rhs + (beta * dt * dt) * fs.grid_load(
                    self._f.evaluate, t)
            x_prev = z
        res = self._solve(sys_op, rhs, self._plane(self._g, t), x_prev,
                          self._sys_precond(sys_op),
                          g_zero=self._g.is_zero)
        u1 = res.x.astype(self.dtype)
        if self.method_name == "newmark":
            vb1, ab1 = self._advance_strips(state.vb, state.ab,
                                            self._grid_edges(u0), t)
            strips = (vb1, ab1, state.ab)
        else:
            strips = (state.vb, state.ab, state.ab_prev)
        return self._pack(u1, u0, state, res.iterations, strips)

    def _recur_step(self, state: Fast2TermState, t):
        fs, dt = self.fs, self.dt
        c_u, c_up = self._c_u, self._c_up
        u = self._shard_grid(state.u.reshape(fs.shape))
        up = self._shard_grid(state.u_prev.reshape(fs.shape))
        sys_op = self._sys_op_static

        combo = (u if (c_u == 1.0 and c_up == 0.0)
                 else c_u * u + c_up * up)
        r0 = -(dt * dt) * self._k_diff(combo)
        fc = self._f_combo(t)
        if fc is not None:
            r0 = r0 + fc
        if self._needs_lift:
            # driven lift: x0's boundary is g(t^{n+1}), not the
            # extrapolation 2 u^n|b - u^{n-1}|b — subtract A(delta 1_b).
            # delta comes from the ACTUAL state boundary values (not g
            # evaluations at earlier times), so inconsistent initial
            # boundary data is exact too; _needs_lift statically skips
            # the extra apply only when delta is identically zero.
            delta = self._plane(self._g, t) - 2.0 * u + up
            delta_ext = jnp.where(fs.boundary, delta, 0.0)
            r0 = r0 - sys_op.apply(delta_ext)
        r0 = jnp.where(fs.interior, r0, 0.0)
        x0 = jnp.where(fs.interior, 2.0 * u - up, 0.0)
        res = self._solve_corr(sys_op, r0, jnp.linalg.norm(x0))
        if self._g.is_zero:
            u_new = jnp.where(fs.interior, x0 + res.x, 0.0)
        else:
            u_new = jnp.where(fs.interior, x0 + res.x,
                              self._plane(self._g, t))
        if self.method_name == "newmark":
            # u^n boundary = g(t^n) exactly from step 1 on (derived BC)
            vb1, ab1 = self._advance_strips(
                state.vb, state.ab, self._edge_vals(self._g, t - dt), t)
            strips = (vb1, ab1, state.ab)
        else:
            strips = (state.vb, state.ab, state.ab_prev)
        return self._pack(u_new.astype(self.dtype), u, state,
                          res.iterations, strips)

    def _pack(self, u_new, u_old, state, iters, strips):
        u_flat = u_new.reshape(-1)
        new_state = Fast2TermState(u=u_flat, u_prev=u_old.reshape(-1),
                                   v0=state.v0, a0=state.a0,
                                   n=state.n + 1, vb=strips[0],
                                   ab=strips[1], ab_prev=strips[2])
        info = {
            "iterations_1": iters,
            "iterations_2": jnp.asarray(0, jnp.int32),
            "norm_u": jnp.linalg.norm(u_new),
            # backward-difference proxy (module docstring): divergence
            # check + console only; CSVs reconstruct the exact v
            "norm_v": jnp.linalg.norm(u_flat - u_old.reshape(-1))
            / self.dt,
        }
        return new_state, info

    def _step_impl(self, state: Fast2TermState, t):
        return jax.lax.cond(state.n == 0,
                            lambda _: self._first_step(state, t),
                            lambda _: self._recur_step(state, t),
                            None)

    # -- velocity reconstruction (diagnostics/IO cadence only) ---------
    def state_velocity(self, state: Fast2TermState, t):
        """Exact (u, u_prev) -> v at time ``t`` (flat). Called by the
        run driver at log/output points; O(1-2) mass solves."""
        return jax.lax.cond(state.n == 0,
                            lambda _: state.v0,
                            lambda _: self._reconstruct_v(state, t),
                            None)

    def _reconstruct_v(self, state, t):
        fs, dt = self.fs, self.dt
        u = state.u.reshape(fs.shape)
        up = state.u_prev.reshape(fs.shape)
        diff = (u - up) / dt
        if self.method_name == "theta":
            th = fs.theta
            rhs = self._mass_op.apply(diff)
            if th != 1.0:
                combo = (up if th == 0.0
                         else th * u + (1.0 - th) * up)
                rhs = rhs - (dt * (1.0 - th)) * self._k_diff(combo)
                if self._f is not None:
                    fa = (th * fs.grid_load(self._f.evaluate, t)
                          + (1.0 - th) * fs.grid_load(self._f.evaluate,
                                                      t - dt))
                    rhs = rhs + (dt * (1.0 - th)) * fa
            res = self._solve(self._mass_op, rhs,
                              self._plane(self._dgdt, t), diff,
                              self._prec_mass,
                              g_zero=self._dgdt.is_zero)
            return res.x.astype(self.dtype).reshape(-1)
        beta, gamma = fs.beta, fs.gamma
        a_n = self._consistent_a(u, t, state.ab)
        a_m = self._consistent_a(up, t - dt, state.ab_prev)
        v = diff + dt * ((0.5 + beta - gamma) * a_m
                         + (gamma - beta) * a_n)
        # boundary velocity comes straight off the carried strip (the
        # exact parity boundary recurrence)
        v = jnp.where(fs.interior, v, self._strip_plane(state.vb))
        return v.astype(self.dtype).reshape(-1)

    def _consistent_a(self, u_grid, t, ab_strip):
        """M a = F(t) - K u with the CARRIED derived-BC boundary
        acceleration (the parity a satisfies this identity exactly along
        the trajectory, WaveNewmark.cpp:264-278)."""
        fs = self.fs
        rhs = -self._k_diff(u_grid)
        if self._f is not None:
            rhs = rhs + fs.grid_load(self._f.evaluate, t)
        res = self._solve(self._mass_op, rhs,
                          self._strip_plane(ab_strip),
                          jnp.zeros_like(u_grid), self._prec_mass,
                          g_zero=False)
        return res.x.astype(self.dtype)


class Fast2TermThetaSolver(_Fast2TermBase):
    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return "-theta" + clean_double(self.fs.theta)


class Fast2TermNewmarkSolver(_Fast2TermBase):
    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return ("-gamma" + clean_double(self.fs.gamma)
                + "-beta" + clean_double(self.fs.beta))
