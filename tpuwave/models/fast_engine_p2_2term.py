"""Displacement-form (2-term) implicit P2 solvers on the product surface.

The P2 counterpart of models/fast_engine_2term.py (see that module's
docstring for the full derivation): eliminating the auxiliary variables
from the schemes gives the 3-term displacement recurrence

  A u^{n+1} = M (2u^n - u^{n-1}) - dt^2 K [c_u u^n + c_up u^{n-1}]
              + dt^2 F-combo

whose extrapolated warm start x0 = 2u^n - u^{n-1} leaves an
O(dt^2)-small residual — ~1 MG-PCG iteration per step, no mass/velocity
solve. This is the algebra the reference solves with one (Newmark,
WaveNewmark.cpp:177-262) or two (theta, WaveTheta.cpp:251-339) AMG-CG
systems per step; the recurrence coefficients are family-level and
element-degree-agnostic, so they carry to the quadratic element
unchanged. What IS degree-specific is the boundary machinery, handled
here on the canvas layout of models/fast_engine_p2.py:

* the driven boundary lift subtracts A(delta 1_b) with delta =
  g(t^{n+1}) - 2 u^n|b + u^{n-1}|b over the THREE boundary plane
  families (V perimeter, H top/bottom rows, W left/right columns — the
  D plane has no Dirichlet DoFs);
* the Newmark derived-BC recurrence a^{n+1}|b = (g - z)/(beta dt^2)
  (WaveNewmark.cpp:196-210) is advanced on O(perimeter) strips — EIGHT
  strip families (4 V edges + 2 H rows + 2 W columns) instead of P1's
  four — so the exact boundary velocity/acceleration are available for
  reconstruction;
* velocity reconstruction (``state_velocity``, called by the runner at
  diagnostics/IO points only) mirrors the P1 module: an exact mass
  solve for theta, consistent M a^j = F^j - K u^j solves with the
  carried strip BCs for Newmark.

The state stays in the (4, Hc, Wc) canvas layout for the whole step, so
the correction solve's CG matvecs run canvas-native, and the
identical-shape plane stack row-shards over a device mesh
(``--shard rows --solver 2term`` at R=2).

Scope: constant or spatially varying wave speed (the elimination assumes
K static in time) and beta > 0 for Newmark — same scope as the P1 module.
Accuracy class: identical to the parity engine in f64 up to solve
tolerance; the f32 implicit-velocity noise note of
models/fast.py::run_implicit_mg_2term applies.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuwave.models.fast_engine_p2 import _FastP2EngineBase, _P2Op
from tpuwave.solve.cg import pcg

__all__ = ["P22TermState", "FastP22TermThetaSolver",
           "FastP22TermNewmarkSolver"]

#: strip family order: V-bottom, V-top, V-left, V-right,
#: H-bottom, H-top, W-left, W-right
_N_STRIPS = 8


class P22TermState(NamedTuple):
    u: jax.Array        #: (4, Hc, Wc) u^n canvases (boundary = g(t^n))
    u_prev: jax.Array   #: u^{n-1} canvases (zeros before the first step)
    v0: jax.Array       #: initial velocity (consumed by step 1 + t=0 IO)
    a0: jax.Array       #: consistent initial acceleration (Newmark)
    n: jax.Array        #: int32 step counter (0 = no step taken yet)
    #: Newmark boundary strips (8, L): per-family edge values of v^n,
    #: a^n and a^{n-1} on the boundary — advanced by the exact derived-BC
    #: recurrence (module docstring). Zeros for the theta family.
    vb: jax.Array
    ab: jax.Array
    ab_prev: jax.Array


class _FastP22TermBase(_FastP2EngineBase):
    """Shared 2-term machinery on top of the canvas P2 product-engine
    base (operators, boundary/forcing evaluators, elimination, mg
    plumbing all inherited)."""

    def __init__(self, problem, *, precond: str = "mg", **kw):
        kw.pop("solver", None)
        super().__init__(problem, precond=precond, **kw)
        if self._c_mode == "tdep":
            raise ValueError(
                "--solver 2term needs a time-static wave speed (the "
                "displacement elimination assumes K constant in time); "
                "use the 3term engine for `Time Dependent C`")
        if self.method_name == "newmark":
            if self.beta <= 1e-12:
                raise ValueError(
                    "--solver 2term needs Beta > 0 for Newmark (explicit "
                    "beta = 0 is the leapfrog path)")
            self._c_u = self.gamma + 0.5
            self._c_up = 0.5 - self.gamma
            b, g = self.beta, self.gamma
            self._f_w = (b, g + 0.5 - 2.0 * b, 0.5 - g + b)
        else:
            th = self.theta
            self._c_u = 2.0 * th
            self._c_up = 1.0 - 2.0 * th
            self._f_w = (th * th, 2.0 * th * (1.0 - th),
                         (1.0 - th) ** 2)
        # the boundary lift A(delta 1_b) is needed whenever the state's
        # boundary values can differ from the pure extrapolation: driven
        # g, any Newmark run (derived-BC decay), or theta with initial
        # data nonzero on the boundary
        self._needs_lift = (not self._g.is_zero
                            or self.method_name == "newmark")
        if not self._needs_lift:
            u0 = self._cdata(self.disc.params.u0, 0.0)
            self._needs_lift = bool(jnp.any(
                jnp.where(self.boundary, u0, 0.0) != 0.0))
        # noise-anchored f32 stopping scale (run_implicit_mg_2term note):
        # r0's own computation noise is ~ eps * s_abs * |u| elementwise;
        # the Gershgorin bound majorises the K row magnitudes
        k_lam = (self._stiff_lam if self._c_mode == "const"
                 else float(jnp.max(jnp.asarray(
                     self._k_at(0.0).lam_hi))))
        self._s_abs = (abs(self._c_u) + abs(self._c_up)) \
            * self.dt * self.dt * k_lam

    # -- forcing -------------------------------------------------------
    def _f_combo(self, t):
        """dt^2-scaled three-point forcing combination of the recurrence
        (None when the problem has no forcing)."""
        if self._f is None:
            return None
        dt = self.dt
        w1, w0, wm = self._f_w
        out = None
        for w, tt in ((w1, t), (w0, t - dt), (wm, t - 2.0 * dt)):
            if w == 0.0:
                continue
            term = (dt * dt * w) * self.grid_load(tt)
            out = term if out is None else out + term
        return out

    # -- correction solve ----------------------------------------------
    def _solve_corr(self, sys_op: _P2Op, r0, x0_norm):
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
                   max_iter=self._max_iter)

    # -- boundary strips (Newmark driven-v machinery; the strip-family
    # coordinate/extract/scatter helpers live on the canvas base) -------
    def _advance_strips(self, vb, ab, ub, t):
        """One exact step of the parity boundary recurrence
        (WaveNewmark.cpp:177-278 restricted to boundary rows):
        z_b = u_b + dt v_b + dt^2(1/2-b) a_b; a' = (g(t) - z_b)/(b dt^2);
        v' = v_b + dt((1-g) a_b + g a'). ``ub`` = u^n strip values."""
        dt, beta, gamma = self.dt, self.beta, self.gamma
        g_np1 = self._edge_vals(self._g, t)
        z_b = ub + dt * vb + (dt * dt * (0.5 - beta)) * ab
        a_new = (g_np1 - z_b) / (beta * dt * dt)
        v_new = vb + dt * ((1.0 - gamma) * ab + gamma * a_new)
        return v_new, a_new

    # -- stepping ------------------------------------------------------
    def initial_state(self) -> P22TermState:
        p = self.disc.params
        u0 = self._place(self._cdata(p.u0, 0.0))
        v0 = self._place(self._cdata(p.v0, 0.0))
        L = self._strip_len
        zb = jnp.zeros((_N_STRIPS, L), self.dtype)
        if self.method_name == "newmark":
            a0 = self._consistent_a0(u0)
            vb = self._canvas_edges(v0)
            ab = self._canvas_edges(a0)
        else:
            a0 = jnp.zeros_like(u0)
            vb = ab = zb
        return P22TermState(u=u0, u_prev=jnp.zeros_like(u0), v0=v0,
                            a0=a0, n=jnp.asarray(0, jnp.int32),
                            vb=vb, ab=ab, ab_prev=zb)

    def _consistent_a0(self, u0):
        """M a0 = F(0) - K u0 with the second-difference accel BC
        (reference WaveNewmark.cpp:298-390) — same algebra as the 3-array
        engine's initial_state."""
        dt = self.dt
        rhs = -self._rhs_apply(self._k_at(0.0))(u0)
        if self._f is not None:
            rhs = rhs + self.grid_load(0.0)
        g_p = self._bdata(self._g, dt)
        g_0 = self._bdata(self._g, 0.0)
        g_m = self._bdata(self._g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc, jnp.zeros_like(u0),
                          self._prec_mass, g_zero=self._g.is_zero)
        return res.x.astype(self.dtype)

    def _first_step(self, state: P22TermState, t):
        """Step 1 solved directly in u-form (composing u^1 from the
        3-array step injects acceleration noise the undamped recurrence
        amplifies — models/fast.py::implicit_2term_init note):
          theta:   A u^1 = M u^0 - dt^2 t(1-t) K u^0 + dt M v^0
                           + t dt^2 [t F^1 + (1-t) F^0]
          Newmark: A u^1 = M z + b dt^2 F^1,
                   z = u^0 + dt v^0 + dt^2 (1/2 - b) a^0
        with u^1|b = g(t^1) by the standard elimination."""
        dt = self.dt
        u0, v0 = self._shard_c(state.u), self._shard_c(state.v0)
        k_op = self._k_at(0.0)
        sys_op = self._system_of(k_op)
        m_rhs = self._rhs_apply(self._mass_op)
        if self.method_name == "theta":
            th = self.theta
            rhs = m_rhs(u0) \
                - (dt * dt * th * (1.0 - th)) * self._rhs_apply(k_op)(u0) \
                + dt * m_rhs(v0)
            if self._f is not None:
                fa = (th * self.grid_load(t)
                      + (1.0 - th) * self.grid_load(t - dt))
                rhs = rhs + (th * dt * dt) * fa
            x_prev = u0
        else:
            beta = self.beta
            a0 = self._shard_c(state.a0)
            z = u0 + dt * v0 + (dt * dt * (0.5 - beta)) * a0
            rhs = m_rhs(z)
            if self._f is not None:
                rhs = rhs + (beta * dt * dt) * self.grid_load(t)
            x_prev = z
        res = self._solve(sys_op, rhs, self._bdata(self._g, t), x_prev,
                          self._sys_precond(sys_op),
                          g_zero=self._g.is_zero)
        u1 = res.x.astype(self.dtype)
        if self.method_name == "newmark":
            vb1, ab1 = self._advance_strips(state.vb, state.ab,
                                            self._canvas_edges(u0), t)
            strips = (vb1, ab1, state.ab)
        else:
            strips = (state.vb, state.ab, state.ab_prev)
        return self._pack(u1, u0, state, res.iterations, strips)

    def _recur_step(self, state: P22TermState, t):
        dt = self.dt
        c_u, c_up = self._c_u, self._c_up
        u, up = self._shard_c(state.u), self._shard_c(state.u_prev)
        k_op = self._k_at(0.0)
        sys_op = self._system_of(k_op)

        combo = (u if (c_u == 1.0 and c_up == 0.0)
                 else c_u * u + c_up * up)
        # the recurrence stencil reads the true driven boundary values:
        # interior-masked unmasked-input applies (fused kernels when on)
        r0 = -(dt * dt) * self._rhs_apply(k_op)(combo)
        fc = self._f_combo(t)
        if fc is not None:
            r0 = r0 + fc
        g_s = None
        if self._needs_lift:
            # driven lift: x0's boundary is g(t^{n+1}), not the
            # extrapolation 2 u^n|b - u^{n-1}|b — subtract A(delta 1_b).
            # delta comes from the ACTUAL state boundary values (strip
            # extraction, O(perimeter)), so inconsistent initial boundary
            # data is exact too; the delta canvas is scattered from
            # strips instead of full-canvas g evaluation
            g_s = self._edge_vals(self._g, t)
            delta_s = g_s - 2.0 * self._canvas_edges(u) \
                + self._canvas_edges(up)
            r0 = r0 - self._rhs_apply(sys_op)(self._strip_canvas(delta_s))
        interior = self.interior
        r0 = jnp.where(interior, r0, 0.0)
        x0 = jnp.where(interior, 2.0 * u - up, 0.0)
        res = self._solve_corr(sys_op, r0, jnp.linalg.norm(x0))
        if self._g.is_zero:
            u_new = jnp.where(interior, x0 + res.x, 0.0)
        else:
            u_new = jnp.where(interior, x0 + res.x,
                              self._strip_canvas(g_s))
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
        new_state = P22TermState(u=u_new, u_prev=u_old,
                                 v0=state.v0, a0=state.a0,
                                 n=state.n + 1, vb=strips[0],
                                 ab=strips[1], ab_prev=strips[2])
        info = {
            "iterations_1": iters,
            "iterations_2": jnp.asarray(0, jnp.int32),
            "norm_u": jnp.linalg.norm(u_new),
            # backward-difference proxy (P1 module docstring): divergence
            # check + console only; CSVs reconstruct the exact v
            "norm_v": jnp.linalg.norm(u_new - u_old) / self.dt,
        }
        return new_state, info

    def _step_impl(self, state: P22TermState, t):
        return jax.lax.cond(state.n == 0,
                            lambda _: self._first_step(state, t),
                            lambda _: self._recur_step(state, t),
                            None)

    # -- velocity reconstruction (diagnostics/IO cadence only) ---------
    def state_velocity(self, state: P22TermState, t):
        """Exact (u, u_prev) -> v at time ``t`` (canvases). Called by the
        run driver at log/output points; O(1-2) mass solves."""
        return jax.lax.cond(state.n == 0,
                            lambda _: state.v0,
                            lambda _: self._reconstruct_v(state, t),
                            None)

    def _reconstruct_v(self, state, t):
        dt = self.dt
        u, up = state.u, state.u_prev
        diff = (u - up) / dt
        if self.method_name == "theta":
            th = self.theta
            rhs = self._rhs_apply(self._mass_op)(diff)
            if th != 1.0:
                combo = (up if th == 0.0
                         else th * u + (1.0 - th) * up)
                rhs = rhs - (dt * (1.0 - th)) \
                    * self._rhs_apply(self._k_at(0.0))(combo)
                if self._f is not None:
                    fa = (th * self.grid_load(t)
                          + (1.0 - th) * self.grid_load(t - dt))
                    rhs = rhs + (dt * (1.0 - th)) * fa
            res = self._solve(self._mass_op, rhs,
                              self._bdata(self._dgdt, t), diff,
                              self._prec_mass,
                              g_zero=self._dgdt.is_zero)
            return res.x.astype(self.dtype)
        beta, gamma = self.beta, self.gamma
        a_n = self._consistent_a(u, t, state.ab)
        a_m = self._consistent_a(up, t - dt, state.ab_prev)
        v = diff + dt * ((0.5 + beta - gamma) * a_m
                         + (gamma - beta) * a_n)
        # boundary velocity comes straight off the carried strip (the
        # exact parity boundary recurrence); padding stays zero
        v = jnp.where(self.interior, v, self._strip_canvas(state.vb))
        return v.astype(self.dtype)

    def _consistent_a(self, u_c, t, ab_strip):
        """M a = F(t) - K u with the CARRIED derived-BC boundary
        acceleration (the parity a satisfies this identity exactly along
        the trajectory, WaveNewmark.cpp:264-278)."""
        rhs = -self._rhs_apply(self._k_at(0.0))(u_c)
        if self._f is not None:
            rhs = rhs + self.grid_load(t)
        res = self._solve(self._mass_op, rhs,
                          self._strip_canvas(ab_strip),
                          jnp.zeros_like(u_c), self._prec_mass,
                          g_zero=False)
        return res.x.astype(self.dtype)


class FastP22TermThetaSolver(_FastP22TermBase):
    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return "-theta" + clean_double(self.theta)


class FastP22TermNewmarkSolver(_FastP22TermBase):
    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return ("-gamma" + clean_double(self.gamma)
                + "-beta" + clean_double(self.beta))
