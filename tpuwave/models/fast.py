"""Fast (production) solver path: P1 grid-stencil schemes under lax.scan.

This is the performance mode the reference cannot reach: the whole time
loop is ONE compiled XLA program (scan over steps), the operator is a
7-point stencil on the vertex grid (ops/stencil.py), the explicit Newmark
path uses a row-sum lumped mass (no linear solve at all), and the state
shards over a device mesh by rows (parallel/sharding.py).

Scope: P1 elements, constant wave speed, homogeneous Dirichlet data, zero
forcing — exactly the reference's scalability configuration
(scripts/scalability_sweep.py:85-120: standing-mode, IO off). The parity
path (models/theta.py / models/newmark.py) covers the general cases.

Numerics note: parity runs are f64; this path defaults to f32 (half the
bytes per pass), with error/energy still computed via f64 reductions if
requested.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex
from tpuwave.ops.assembly import element_mass_class, element_stiffness_class
from tpuwave.ops.stencil import (GridStencilOperator, boundary_mask_grid,
                                 class_matrices_to_stencil, lumped_mass_grid)
from tpuwave.solve.cg import pcg

__all__ = ["FastWaveSolver", "FastState"]



def cached_scan(holder, key, step_fn, n_steps: int):
    """Memoised jitted scan-over-steps runner (shared by all fast solvers).

    ``holder`` caches compiled runners per (key, n_steps); ``step_fn`` maps
    a state pytree to the next state.
    """
    cache = getattr(holder, "_scan_cache", None)
    if cache is None:
        cache = holder._scan_cache = {}
    full_key = (key, n_steps)
    if full_key not in cache:
        def run(state):
            def body(s, _):
                return step_fn(s), None
            out, _ = jax.lax.scan(body, state, None, length=n_steps)
            return out
        cache[full_key] = jax.jit(run)
    return cache[full_key]


class FastState(NamedTuple):
    u: jax.Array  # (ny+1, nx+1)
    v: jax.Array
    a: jax.Array


def _two_sum(a, b):
    """Knuth TwoSum: s = fl(a + b) and the EXACT rounding error err, so
    a + b == s + err in exact arithmetic. Branch-free (no magnitude
    ordering needed); 6 flops, fuses into the surrounding elementwise
    kernel."""
    s = a + b
    z = s - a
    err = (a - (s - z)) + (b - z)
    return s, err


def _fast_two_sum(a, b):
    """Dekker Fast2Sum: requires |a| >= |b| (true when a is the
    state-scale head and b the eps-scale tail). 3 flops."""
    s = a + b
    err = (a - s) + b
    return s, err


class CompensatedState(NamedTuple):
    """f32 state with exact rounding-error carries (~f48 effective).

    The displacement recurrences (leapfrog, implicit 2-term) carry
    velocity implicitly as (u^n - u^{n-1})/dt, so every eps*|u|-level
    rounding of the state update is an incoherent velocity kick that the
    undamped recurrence amplifies by ~1/(omega dt) per mode (see
    run_implicit_mg_2term). Carrying the update's exact rounding error
    (TwoSum) in a second f32 array removes those kicks: the pair
    (u, u_lo) represents the state to ~2^-45.
    """
    u: jax.Array
    u_lo: jax.Array
    u_prev: jax.Array
    u_prev_lo: jax.Array


class LeapfrogState(NamedTuple):
    """Two-array state for the explicit fast path.

    Newmark beta=0, gamma=1/2 with lumped mass is algebraically identical
    to the leapfrog / central-difference recurrence

        u^{n+1} = 2 u^n - u^{n-1} - dt^2 M_L^{-1} K u^n

    which needs only (u^n, u^{n-1}) — read 2 + write 1 arrays per step
    instead of read 3 + write 3, roughly halving memory traffic (the
    bandwidth-bound cost). v^n is recoverable as
    (u^{n+1} - u^{n-1}) / (2 dt).
    """
    u: jax.Array
    u_prev: jax.Array


class FastWaveSolver:
    """Grid-stencil wave solver (explicit lumped Newmark + implicit CG).

    Parameters
    ----------
    nel, geometry : mesh spec (P1 vertex grid (ny+1, nx+1))
    dt            : time step
    c             : constant wave speed
    scheme        : 'newmark' (beta/gamma) or 'theta' (theta)
    lumped        : explicit beta=0 diagonal-mass path (no CG)
    dtype         : state dtype (f32 default)
    """

    def __init__(self, nel: Tuple[int, int], geometry, dt: float, *,
                 c: float = 1.0, scheme: str = "newmark", beta: float = 0.0,
                 gamma: float = 0.5, theta: float = 0.5, lumped: bool = True,
                 dtype=jnp.float32, sharding=None,
                 cg_reduction: float = 1e-6):
        self.mesh = StructuredTriMesh(tuple(nel), geometry)
        self.space = FeSpace(self.mesh, 1)
        self.shape = (self.mesh.ny + 1, self.mesh.nx + 1)
        self.dt = float(dt)
        self.c = float(c)
        self.scheme = scheme
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.theta = float(theta)
        self.dtype = dtype
        #: CG relative-reduction factor (reference ReductionControl 1e-6;
        #: 1e-9 matches the reference AMG-CG's effective over-convergence
        #: on fine meshes — see RESULTS.md solver-noise note)
        self.cg_reduction = float(cg_reduction)
        self.lumped = bool(lumped) and scheme == "newmark" and beta == 0.0
        self.sharding = sharding

        quad = gauss_simplex(2)
        m_class = element_mass_class(self.space, quad)
        k_class = element_stiffness_class(self.space, quad, c * c)
        self.mass = GridStencilOperator(class_matrices_to_stencil(m_class),
                                        self.shape, dtype)
        self.stiff = GridStencilOperator(class_matrices_to_stencil(k_class),
                                         self.shape, dtype)
        self.inv_lumped = jnp.asarray(1.0 / lumped_mass_grid(self.space),
                                      dtype=dtype)
        bnd = boundary_mask_grid(self.space)
        self.boundary = jnp.asarray(bnd)
        self.interior = jnp.asarray(~bnd)
        #: row counts that divide the mesh keep persistently-sharded
        #: masks/state (device_put); others (e.g. the reference's 641 =
        #: 2^k + 1 rows) get per-step with_sharding_constraint layouts
        #: instead — GSPMD pads the uneven tiling internally, which
        #: jax.device_put rejects
        self._even_shards = True
        if sharding is not None:
            self._even_shards = all(
                name is None
                or self.shape[d] % sharding.mesh.shape[name] == 0
                for d, name in enumerate(tuple(sharding.spec)[:2]))
        if sharding is not None and self._even_shards:
            self.inv_lumped = jax.device_put(self.inv_lumped, sharding)
            self.boundary = jax.device_put(self.boundary, sharding)
            self.interior = jax.device_put(self.interior, sharding)

        if scheme == "newmark":
            self.system = self.mass.axpy(self.beta * self.dt * self.dt, self.stiff)
        else:
            self.system = self.mass.axpy((self.theta * self.dt) ** 2, self.stiff)
        self._inv_diag = 1.0 / self.system.stencil[1][1]

        self._n_dofs = self.shape[0] * self.shape[1]

    # ------------------------------------------------------------------
    def _shard(self, x):
        """Pin the device-mesh layout inside a traced step when the grid
        cannot be device_put-sharded (uneven rows); no-op otherwise."""
        if self.sharding is None or self._even_shards:
            return x
        return jax.lax.with_sharding_constraint(x, self.sharding)

    def grid_coords(self):
        """(ny+1, nx+1) x and y coordinate planes (device, jit-friendly)."""
        (x0, y0) = self.mesh.origin
        ny1, nx1 = self.shape
        xs = x0 + self.mesh.hx * jax.lax.broadcasted_iota(self.dtype, (ny1, nx1), 1)
        ys = y0 + self.mesh.hy * jax.lax.broadcasted_iota(self.dtype, (ny1, nx1), 0)
        return xs, ys

    def _stiff_diff(self, u):
        """K u in zero-row-sum difference form (apply_stencil_diff):
        same algebra as self.stiff(u) with the arithmetic cancellation
        noise removed (~1.4x lower total f32 noise on smooth fields; the
        rest is the input's representation noise through K)."""
        from tpuwave.ops.stencil import apply_stencil_diff
        return apply_stencil_diff(u, self.stiff.stencil)

    def initial_state(self, u0_fn, v0_fn=None) -> FastState:
        """Interpolate initial data; consistent a0 from the lumped mass."""
        xs, ys = self.grid_coords()
        u0 = jnp.asarray(u0_fn(xs, ys), dtype=self.dtype)
        v0 = (jnp.zeros(self.shape, self.dtype) if v0_fn is None
              else jnp.asarray(v0_fn(xs, ys), dtype=self.dtype))
        a0 = jnp.where(self.boundary, 0.0,
                       -self._stiff_diff(u0) * self.inv_lumped)
        st = FastState(u=u0, v=v0, a=a0.astype(self.dtype))
        if self.sharding is not None and self._even_shards:
            st = FastState(*(jax.device_put(x, self.sharding) for x in st))
        return st

    def initial_state_consistent(self, u0_fn, v0_fn=None) -> FastState:
        """Consistent-mass a0: solve M a0 = -K u0 by CG to the parity
        tolerances (reference WaveNewmark.cpp:298-390; homogeneous data so
        a0|boundary = 0) — use for digit-parity runs of the implicit
        schemes instead of the lumped a0 of initial_state."""
        st = self.initial_state(u0_fn, v0_fn)
        a0 = self._consistent_accel(st.u)
        if self.sharding is not None and self._even_shards:
            a0 = jax.device_put(a0, self.sharding)
        return FastState(u=st.u, v=st.v, a=a0)

    # ------------------------------------------------------------------
    def _explicit_step(self, state: FastState) -> FastState:
        """Lumped-mass central difference (Newmark beta=0, gamma=1/2):
        one stencil apply + elementwise updates, zero solves."""
        dt = jnp.asarray(self.dt, self.dtype)
        u, v, a = (self._shard(x) for x in state)
        z = u + dt * v + (0.5 * dt * dt) * a
        a_new = jnp.where(self.boundary, 0.0, -self.stiff(z) * self.inv_lumped)
        a_new = a_new.astype(self.dtype)
        v_new = v + (0.5 * dt) * (a + a_new)
        return FastState(u=z, v=v_new, a=a_new)

    def _solve_abs_tol(self, rhs, x0, op):
        """Absolute residual floor for the fast-path solves.

        The reference's fixed 1e-12 floor is kept in f64 parity mode. In
        f32 production mode a fixed floor is WRONG: the mass-scaled
        systems have entries ~h^2, so at fine meshes/small dt the true
        per-step residual sits below any fixed absolute number and the
        solver would stop at zero iterations, silently freezing the state
        (measured: CN u-error 2.5e-2 instead of 1.4e-5 at 640^2,
        dt=8e-5). Use the backward-error floor
        eta * (lam_max ||x0|| + ||b||), eta = 8 eps — the accuracy a
        correctly-rounded solve can actually attain, scale-free in h, dt.
        lam_max is analytic (stencil symbol).
        """
        if self.dtype == jnp.float64:
            return 1e-12
        from tpuwave.solve.cheby_iter import stencil_symbol_bounds
        lam_max = stencil_symbol_bounds(op.stencil)[1]
        eta = 8 * float(jnp.finfo(self.dtype).eps)
        return eta * (lam_max * jnp.linalg.norm(x0) + jnp.linalg.norm(rhs))

    # NOTE on warm starts for the implicit a-solve: a smooth predictor
    # (a^n - dt M_L^{-1} K(v + dt/2 a), the second-order Taylor step of
    # da/dt = -M^{-1} K v) was measured NOT to reduce the initial CG
    # residual (2.4e-5 vs 2.3e-5 at 256^2, dt=1e-3, f32). Along the
    # discrete trajectory M a^n = -K u^n holds exactly, so a must track
    # the f32 representation noise of u amplified by M^{-1}K
    # (~(2c/h)^2) — high-frequency content no smooth predictor can
    # anticipate; the a-form solve is noise-floor-bound at ~3 V-cycles
    # per step. The fix is the displacement-form path
    # (run_implicit_mg_2term) whose unknown is u itself.
    def _implicit_newmark_step(self, state: FastState,
                               precond=None) -> FastState:
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u, v, a = (self._shard(x) for x in state)
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = jnp.where(self.interior, -self.stiff(z), 0.0)

        x0 = jnp.where(self.interior, a, 0.0)
        res = pcg(self._constrained(self.system), rhs, x0,
                  precond_inv_diag=(self._inv_diag if precond is None
                                    else precond),
                  abs_tol=self._solve_abs_tol(rhs, x0, self.system),
                  max_iter=10000 if self.dtype == jnp.float64 else 2000,
                  reduction=self.cg_reduction)
        a_new = res.x.astype(self.dtype)
        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        return FastState(u=u_new, v=v_new, a=a_new)

    def _constrained(self, op):
        def apply_c(w):
            return jnp.where(self.interior, op(jnp.where(self.interior, w, 0.0)),
                             op.stencil[1][1] * w)
        return apply_c

    def _theta_step(self, state: FastState, precond=None) -> FastState:
        """Stencil theta-method (homogeneous BCs, no forcing): two CG
        solves per step like the reference WaveTheta, on grid stencils.
        ``precond`` overrides the u-system preconditioner (the v-system is
        the bare mass: mesh-independent conditioning, Jacobi suffices)."""
        dt, th = self.dt, self.theta
        u, v, a = (self._shard(x) for x in state)
        mu, ku, mv = self.mass(u), self.stiff(u), self.mass(v)
        max_iter = 10000 if self.dtype == jnp.float64 else 2000

        rhs_u = jnp.where(self.interior,
                          mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv, 0.0)
        # warm start from u^n (a Taylor predictor u + dt v was measured
        # NOT to cut iterations: the u-solve already runs at 1 V-cycle
        # from u^n — its r0 sits at the f32 cancellation floor
        # eps*||rhs||)
        x0_u = jnp.where(self.interior, u, 0.0)
        res_u = pcg(self._constrained(self.system), rhs_u, x0_u,
                    precond_inv_diag=(self._inv_diag if precond is None
                                      else precond),
                    abs_tol=self._solve_abs_tol(rhs_u, x0_u, self.system),
                    max_iter=max_iter, reduction=self.cg_reduction)
        u_new = res_u.x.astype(self.dtype)

        rhs_v = jnp.where(self.interior,
                          mv - (dt * (1.0 - th)) * ku - (dt * th) * self.stiff(u_new),
                          0.0)
        # warm start from v^n (a lumped-mass dv/dt predictor saves only
        # ~1-2 of ~6 cheap mass iterations)
        x0_v = jnp.where(self.interior, v, 0.0)
        res_v = pcg(self._constrained(self.mass), rhs_v, x0_v,
                    precond_inv_diag=1.0 / self.mass.stencil[1][1],
                    abs_tol=self._solve_abs_tol(rhs_v, x0_v, self.mass),
                    max_iter=max_iter, reduction=self.cg_reduction)
        v_new = res_v.x.astype(self.dtype)
        return FastState(u=u_new, v=v_new, a=a)

    def step(self, state: FastState) -> FastState:
        if self.scheme == "theta":
            return self._theta_step(state)
        if self.lumped:
            return self._explicit_step(state)
        return self._implicit_newmark_step(state)

    # ------------------------------------------------------------------
    # leapfrog (two-array) explicit path — same trajectory as the lumped
    # Newmark beta=0 path, minimal HBM traffic
    # ------------------------------------------------------------------
    def initial_leapfrog_state(self, u0_fn, v0_fn=None, f_fn=None,
                               g_fn=None) -> LeapfrogState:
        """(u^1, u^0): the first step is taken via the 3-array scheme so the
        trajectory matches the Newmark path bit-for-bit from step 2 on.

        Optional ``f_fn`` makes the start forcing-aware (consistent load in
        a^0 and the half-step, reference WaveNewmark.cpp:298-343 — without
        it a strong forcing costs one order in an MMS test); optional
        ``g_fn`` pins u^1 boundary data at t = dt.
        """
        if f_fn is None and g_fn is None:
            st = self.initial_state(u0_fn, v0_fn)
            st1 = self._explicit_step(st)
            return LeapfrogState(u=st1.u, u_prev=st.u)
        dt = self.dt
        xs, ys = self.grid_coords()
        u0 = jnp.asarray(u0_fn(xs, ys), dtype=self.dtype)
        v0 = (jnp.zeros(self.shape, self.dtype) if v0_fn is None
              else jnp.asarray(v0_fn(xs, ys), dtype=self.dtype))
        rhs = -self._stiff_diff(u0)
        if f_fn is not None:
            rhs = rhs + self.grid_load(f_fn, 0.0)
        a0 = jnp.where(self.boundary, 0.0, rhs * self.inv_lumped)
        u1 = u0 + dt * v0 + (0.5 * dt * dt) * a0
        if g_fn is None:
            u1 = jnp.where(self.boundary, 0.0, u1)
        else:
            gv = jnp.asarray(g_fn(xs, ys, dt), self.dtype)
            u1 = jnp.where(self.boundary, jnp.broadcast_to(gv, u1.shape), u1)
        return LeapfrogState(u=u1.astype(self.dtype), u_prev=u0)

    def leapfrog_step(self, state: LeapfrogState) -> LeapfrogState:
        dt2 = jnp.asarray(self.dt * self.dt, self.dtype)
        u, u_prev = (self._shard(x) for x in state)
        u_next = 2.0 * u - u_prev - dt2 * (self.stiff(u) * self.inv_lumped)
        u_next = jnp.where(self.boundary, 0.0, u_next).astype(self.dtype)
        return LeapfrogState(u=u_next, u_prev=u)


    # ------------------------------------------------------------------
    # driven (time-dependent Dirichlet) leapfrog: u|boundary = g(x, y, t)
    # pinned directly each step — enables production runs of driven
    # problems like the sine-membrane preset on the fast path
    # ------------------------------------------------------------------
    def leapfrog_step_driven(self, state: LeapfrogState, t, g_fn,
                             f_fn=None) -> LeapfrogState:
        """One leapfrog step with u|dOmega = g_fn(x, y, t) at the NEW time.

        Interior recurrence identical to leapfrog_step; boundary nodes are
        pinned to g (the theta-family convention, exact boundary tracking).
        ``t`` is the time being stepped TO (t^{n+1}). Optional ``f_fn``
        adds the quadrature-consistent forcing load F(t^n) (the semi-
        discrete recurrence reads M a^n = F^n - K u^n, so f acts at the
        FROM time t - dt; :meth:`grid_load`).
        """
        dt2 = jnp.asarray(self.dt * self.dt, self.dtype)
        u, u_prev = state
        accel = -self.stiff(u) * self.inv_lumped
        if f_fn is not None:
            accel = accel + self.grid_load(f_fn, t - self.dt) * self.inv_lumped
        u_next = 2.0 * u - u_prev + dt2 * accel
        xs, ys = self.grid_coords()
        g_vals = jnp.asarray(g_fn(xs, ys, t), self.dtype)
        u_next = jnp.where(self.boundary, g_vals, u_next).astype(self.dtype)
        return LeapfrogState(u=u_next, u_prev=u)

    def run_leapfrog_driven(self, state: LeapfrogState, times, g_fn,
                            f_fn=None) -> LeapfrogState:
        """Scan over explicit time stamps (accumulated like the reference
        loop) with the driven boundary (and optional consistent forcing)."""
        times = jnp.asarray(times, self.dtype)

        def step(carry_t):
            st, idx = carry_t
            st = self.leapfrog_step_driven(st, times[idx], g_fn, f_fn)
            return (st, idx + 1)

        runner = cached_scan(self, ("lf_driven", id(g_fn), id(f_fn),
                                    len(times)), step, len(times))
        out, _ = runner((state, jnp.asarray(0, jnp.int32)))
        return out

    # ------------------------------------------------------------------
    # quadrature-consistent load: L_i = sum_T det w_q phi_i(q) f(x_Tq)
    # by the assembly (r+1) rule — the grid counterpart of the reference's
    # per-step forcing cell loop (WaveTheta.cpp:164-172), replacing the
    # earlier vertex-lumped approximation (a different accuracy class for
    # rough f). Six f evaluations on (ny, nx) planes with iota-generated
    # coordinates + 18 shifted adds, all fused by XLA; jit-traceable in t.
    # ------------------------------------------------------------------
    def _load_data(self):
        try:
            return self.__load_cache
        except AttributeError:
            pass
        from tpuwave.ops.stencil import P1_CLASS_CORNERS
        quad = gauss_simplex(2)
        sh = self.space.shape_at(quad)
        vals = np.asarray(sh.values)                    # (Q, 3)
        ref = np.asarray(quad.points)                   # (Q, 2)
        frac = np.empty((2, len(ref), 2))
        for k in range(2):
            c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
            frac[k] = (c0[None]
                       + ref[:, 0:1] * (c1 - c0)[None]
                       + ref[:, 1:2] * (c2_ - c0)[None])
        self.__load_cache = (vals, frac, np.asarray(quad.weights),
                             float(self.mesh.det_j))
        return self.__load_cache

    def grid_load(self, f_fn, t):
        """Consistent P1 load vector on the (ny+1, nx+1) vertex grid.

        ``f_fn(x, y, t)`` is evaluated at the 2x3 assembly quadrature
        points of every triangle; contributions scatter to the three
        incident vertices by slice-adds (exact everywhere, including
        boundary rows — no roll wrap involved).
        """
        from tpuwave.ops.stencil import P1_CLASS_CORNERS
        vals, frac, w, det = self._load_data()
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 1)
        iy = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 0)
        out = jnp.zeros(self.shape, self.dtype)
        for k in range(2):
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                fv = jnp.broadcast_to(jnp.asarray(
                    f_fn(x0 + (ix + fx) * hx, y0 + (iy + fy) * hy, t),
                    self.dtype), (ny, nx))
                for a in range(3):
                    ox, oy = P1_CLASS_CORNERS[k][a]
                    out = out.at[oy:oy + ny, ox:ox + nx].add(
                        (det * float(w[q]) * float(vals[q, a])) * fv)
        return out

    def leapfrog_velocity(self, state_next: LeapfrogState,
                          state: LeapfrogState):
        """v^n = (u^{n+1} - u^{n-1}) / (2 dt)."""
        return (state_next.u - state.u_prev) / (2.0 * self.dt)

    def run_leapfrog_scan(self, state: LeapfrogState, n_steps: int) -> LeapfrogState:
        return cached_scan(self, "leapfrog", self.leapfrog_step, n_steps)(state)

    # ------------------------------------------------------------------
    # time-dependent wave speed on the fast path: the variable-coefficient
    # 9-plane stencil (shared with the FWI propagators, ops/stencil.py)
    # is reassembled from c(x, y, t) at the assembly quadrature points
    # INSIDE the jitted step — production-speed `Time Dependent C`
    # (the parity engines' counterpart is Discretization.stiffness_at)
    # ------------------------------------------------------------------
    def _tdep_data(self):
        try:
            return self.__tdep_cache
        except AttributeError:
            pass
        quad = gauss_simplex(2)
        sh = self.space.shape_at(quad)
        grads = self.space.physical_grads(sh)          # (2, Q, 3, 2)
        g_class = np.einsum("cqia,cqja->cqij", grads, grads)[:, 0]  # (2,3,3)
        # fractional quadrature-point offsets within the unit grid cell,
        # per (class, q): phys point of cell (iy, ix) =
        # (x0 + (ix + fx) hx, y0 + (iy + fy) hy). Tiny host constants —
        # the coordinates themselves are generated from iota INSIDE the
        # trace (zero HBM traffic; earlier designs streamed an
        # (2, Q, ny, nx, 2) array: 800 MB/step at 4096^2 and an HLO
        # literal of the same size).
        from tpuwave.ops.stencil import P1_CLASS_CORNERS
        ref = np.asarray(quad.points)                  # (Q, 2)
        frac = np.empty((2, len(ref), 2))
        for k in range(2):
            c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
            frac[k] = (c0[None]
                       + ref[:, 0:1] * (c1 - c0)[None]
                       + ref[:, 1:2] * (c2_ - c0)[None])
        self.__tdep_cache = (
            g_class, frac,
            np.asarray(quad.weights, dtype=np.dtype(self.dtype)),  # (Q,)
            float(self.mesh.det_j))
        return self.__tdep_cache

    def _tdep_scales(self, c_fn, t):
        """(ny, nx, 2) per-triangle scales det * sum_q w_q c^2(x_q, t):
        the compact payload from which the varcoef planes are assembled
        (carried across steps by the tdep engines — array form, so it is
        also checkpoint-safe)."""
        _, frac, w, det = self._tdep_data()
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0), _ = self.mesh.geometry
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 1)
        iy = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 0)
        s = None
        for k in range(2):
            acc = None
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                xs = x0 + (ix + fx) * hx
                ys = y0 + (iy + fy) * hy
                c2 = jnp.asarray(c_fn(xs, ys, t), self.dtype) ** 2
                c2 = jnp.broadcast_to(c2, (ny, nx))
                term = float(w[q]) * c2
                acc = term if acc is None else acc + term
            sk = det * acc                              # (ny, nx)
            s = sk[..., None] if s is None else jnp.concatenate(
                [s, sk[..., None]], axis=-1)
        return s

    def _planes_from_scales(self, s):
        from tpuwave.ops.stencil import assemble_varcoef_planes
        g_class = self._tdep_data()[0]
        return assemble_varcoef_planes(s, g_class, self.mesh.ny,
                                       self.mesh.nx, self.dtype)

    def _tdep_planes(self, c_fn, t):
        return self._planes_from_scales(self._tdep_scales(c_fn, t))

    def leapfrog_step_tdep(self, state: LeapfrogState, t, c_fn,
                           g_fn=None, f_fn=None) -> LeapfrogState:
        """One explicit lumped-mass leapfrog step with c = c_fn(x, y, t).

        Semi-discrete equation at t^n: M a^n = F^n - K(t^n) u^n, so the
        stiffness is evaluated at the time being stepped FROM (``t`` =
        t^n; the state lands at t^n + dt). Optional ``g_fn`` pins
        time-dependent Dirichlet data at t^{n+1}; optional ``f_fn`` adds
        the quadrature-consistent forcing load F(t^n) assembled by the
        r+1 rule (:meth:`grid_load` — same accuracy class as the
        reference's per-step forcing cell loop, WaveTheta.cpp:164-172).
        """
        from tpuwave.ops.stencil import apply_varcoef_planes
        dt2 = jnp.asarray(self.dt * self.dt, self.dtype)
        u, u_prev = state
        planes = self._tdep_planes(c_fn, t)
        ku = apply_varcoef_planes(planes, u)
        accel = -ku * self.inv_lumped
        if f_fn is not None:
            accel = accel + self.grid_load(f_fn, t) * self.inv_lumped
        u_next = 2.0 * u - u_prev + dt2 * accel
        if g_fn is None:
            u_next = jnp.where(self.boundary, 0.0, u_next)
        else:
            xs, ys = self.grid_coords()
            gv = jnp.asarray(g_fn(xs, ys, t + self.dt), self.dtype)
            u_next = jnp.where(self.boundary,
                               jnp.broadcast_to(gv, u.shape), u_next)
        return LeapfrogState(u=u_next.astype(self.dtype), u_prev=u)

    def run_leapfrog_tdep(self, state: LeapfrogState, times, c_fn,
                          g_fn=None, f_fn=None) -> LeapfrogState:
        """Scan over explicit FROM-time stamps (t^n values; each step
        lands at t^n + dt) with the time-varying stencil rebuilt in-scan.

        The whole scan is jitted and cached per (n_steps, c_fn, g_fn,
        f_fn): an un-jitted ``lax.scan`` leaves the per-step planes
        unfused.

        Cache hits require STABLE function objects: pass the same
        c_fn/g_fn/f_fn callables across calls (module-level functions or
        closures held by the caller), not fresh lambdas — a new lambda is
        a new key and recompiles. The cache keeps only the most recent
        few entries so fresh-lambda callers cannot grow it without bound.
        """
        times = jnp.asarray(times, self.dtype)
        key = ("tdep", int(times.shape[0]), c_fn, g_fn, f_fn)
        cache = getattr(self, "_tdep_scan_cache", None)
        if cache is None:
            cache = self._tdep_scan_cache = {}
        run = cache.get(key)
        if run is None:
            while len(cache) >= 4:  # evict oldest compiled scans
                cache.pop(next(iter(cache)))
            n = int(times.shape[0])

            @jax.jit
            def run(state, ts):
                def body(st, t):
                    return self.leapfrog_step_tdep(st, t, c_fn, g_fn,
                                                   f_fn), None
                st, _ = jax.lax.scan(body, state, ts, length=n)
                return st

            cache[key] = run
        return run(state, times)

    # ------------------------------------------------------------------
    # error-compensated leapfrog: f32 state + exact rounding-error
    # carries (~f48 effective) — the accuracy mode of the explicit path
    # (see CompensatedState). ~2x the arithmetic of leapfrog_step (one
    # extra stencil apply on the eps-scale tail + TwoSum bookkeeping).
    # ------------------------------------------------------------------
    def initial_compensated_state(self, u0_fn, v0_fn=None) -> CompensatedState:
        lf = self.initial_leapfrog_state(u0_fn, v0_fn)
        zero = jnp.zeros_like(lf.u)
        return CompensatedState(u=lf.u, u_lo=zero, u_prev=lf.u_prev,
                                u_prev_lo=zero)

    def leapfrog_step_compensated(self,
                                  state: CompensatedState) -> CompensatedState:
        """u_next = 2u - u_prev - dt^2 M_L^{-1} K u on the (head, tail)
        pair: K applied to head AND tail (K is linear, the tail apply is
        exact relative to its eps-scale), the head combination tracked
        by TwoSum so its rounding lands in the next tail."""
        dt2 = self.dt * self.dt
        uh, ul, ph, pl = state
        d = -(dt2 * self.inv_lumped) * (self._stiff_diff(uh)
                                        + self._stiff_diff(ul))
        t, r1 = _two_sum(2.0 * uh, -ph)      # 2*uh is exact in binary fp
        small = (2.0 * ul - pl) + (d + r1)
        un, un_lo = _fast_two_sum(t, small)  # |t| ~ |u| >> |small|
        un = jnp.where(self.boundary, 0.0, un).astype(self.dtype)
        un_lo = jnp.where(self.boundary, 0.0, un_lo).astype(self.dtype)
        return CompensatedState(u=un, u_lo=un_lo, u_prev=uh, u_prev_lo=ul)

    def run_leapfrog_compensated(self, state: CompensatedState,
                                 n_steps: int) -> CompensatedState:
        return cached_scan(self, "leapfrog_comp",
                           self.leapfrog_step_compensated, n_steps)(state)

    # ------------------------------------------------------------------
    def run_scan(self, state: FastState, n_steps: int) -> FastState:
        """The whole time loop as one compiled scan — no host round-trips
        (the fast-mode analogue of the reference while-loop,
        WaveTheta.cpp:372-411, with IO off)."""
        return cached_scan(self, "state3", self.step, n_steps)(state)

    # ------------------------------------------------------------------
    # implicit stepping with geometric-multigrid-preconditioned CG: the
    # large-dt production path. Single-level polynomial solvers need
    # O(dt/h) iterations once (theta dt / h)^2 or (beta dt^2 / h^2)
    # dominates; the V-cycle's contraction is h- and dt-independent
    # (solve/multigrid.py), replacing the reference's ML-AMG
    # (WaveTheta.cpp:276-286) with a regular geometric hierarchy.
    # ------------------------------------------------------------------
    def gmg_preconditioner(self, *, pre_degree: int = 1,
                           smooth_range: float = 8.0,
                           coarse_tol: float = 1e-2):
        """V-cycle preconditioner for this solver's implicit system
        (M + beta dt^2 K for Newmark, M + (theta dt)^2 K for theta).

        Default smoother degree 1 (vs the library builder's 2): the
        per-step wall time on the fast paths is smoothing-dominated
        (scripts/scan_mg_degree.py re-measures the choice); CG's stopping
        rule keeps solution accuracy identical, only the iteration split
        changes.
        """
        from tpuwave.solve.multigrid import gmg_for_system
        coef = (self.beta * self.dt * self.dt if self.scheme == "newmark"
                else (self.theta * self.dt) ** 2)
        return gmg_for_system(
            (self.mesh.nx, self.mesh.ny), self.mesh.geometry, self.c, coef,
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)

    def run_implicit_mg(self, state: FastState, n_steps: int, *,
                        pre_degree: int = 1, smooth_range: float = 8.0,
                        coarse_tol: float = 1e-2) -> FastState:
        """Newmark (beta>0) or theta stepping with MG-PCG linear solves
        (same stopping contract as the other implicit paths)."""
        if self.scheme == "newmark" and self.beta <= 1e-12:
            raise ValueError(
                "run_implicit_mg needs beta > 0 (explicit beta=0 is the "
                "leapfrog/lumped path: run_leapfrog_* / run_scan)")
        precond = self.gmg_preconditioner(
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)
        if self.scheme == "newmark":
            def step(st):
                return self._implicit_newmark_step(st, precond)
        elif self.scheme == "theta":
            def step(st):
                return self._theta_step(st, precond)
        else:
            raise ValueError("run_implicit_mg needs scheme newmark/theta")
        runner = cached_scan(self, ("mg", pre_degree, smooth_range,
                                    coarse_tol, self.scheme), step, n_steps)
        return runner(state)

    # ------------------------------------------------------------------
    # displacement-form implicit stepping (two-array state): the
    # implicit twin of the leapfrog path. Eliminating the auxiliary
    # variables (v, a for Newmark using M a^n = -K u^n, exact along the
    # discrete trajectory; v for the theta family from its two update
    # equations) gives 3-term displacement recurrences
    #
    #   Newmark: (M + b dt^2 K) u^{n+1} = M (2u^n - u^{n-1})
    #                             - dt^2 (g + 1/2 - 2b) K u^n
    #                             - dt^2 (1/2 - g + b)  K u^{n-1}
    #   theta:   (M + t^2 dt^2 K) u^{n+1} = M (2u^n - u^{n-1})
    #                             - dt^2 K [2t(1-t) u^n + (1-t)^2 u^{n-1}]
    #
    # (b = beta, g = gamma, t = theta). The payoff: the free
    # extrapolated warm start x0 = 2u^n - u^{n-1} leaves the
    # O(dt^2)-small residual
    #
    #   Newmark: r0 = -dt^2 K [ (g + 1/2) u^n + (1/2 - g) u^{n-1} ]
    #   theta:   r0 = -dt^2 K [ 2t u^n + (1 - 2t) u^{n-1} ]
    #
    # so each step costs ONE fused stencil pass for r0 plus ~1 MG-PCG
    # iteration — no mass/velocity solve, two-array state. The 3-array
    # forms cannot reach this: Newmark's unknown a must track the f32
    # noise of u amplified by M^{-1}K, pinning it at ~3 V-cycles/step
    # (see the note above _implicit_newmark_step), and theta pays a
    # ~6-iteration mass solve for v every step. Replaces the
    # reference's two AMG-CG solves per theta step / one per Newmark
    # step (WaveTheta.cpp:251-339, WaveNewmark.cpp:177-262) with one
    # near-converged solve for either family. Measured: 12.5 vs 88
    # ms/step (NM-AA, 4096^2, dt=1e-3, f32) against the fused a-form.
    #
    # f32 noise characteristics (MEASURED, 4096^2, 100 steps): carrying
    # velocity implicitly as (u^n - u^{n-1})/dt amplifies any incoherent
    # per-step noise by ~1/(omega dt); with the state's own f32
    # representation noise driving r0, the end-state error is ~1e-4
    # relative vs ~3.5e-6 for the 3-array a-form (which keeps u, v, a
    # kinematically consistent so state noise is NOT 1/(omega dt)-
    # amplified). In the large-dt regime this path targets (dt >= ~4e-3
    # at 4096^2) the scheme's own O((omega dt)^2) dispersion error
    # exceeds that noise; at small dt / fine mesh in f32, or whenever
    # noise-floor accuracy matters, use the 3-array paths or f64 (where
    # this path is digit-clean, see test_implicit_2term_matches_3array).
    # ------------------------------------------------------------------
    def implicit_2term_init(self, state: FastState, *, pre_degree: int = 1,
                            smooth_range: float = 8.0,
                            coarse_tol: float = 1e-2) -> LeapfrogState:
        """(u^1, u^0) from one implicit step taken in CORRECTION u-form.

        The first step is solved for u^1 directly (algebraically
        identical to the 3-array step):
          theta:   A u^1 = M u^0 - dt^2 t(1-t) K u^0 + dt M v^0,
                   x0 = u^0,  r0 = dt M v^0 - t dt^2 K u^0
          Newmark: A u^1 = M z,  z = u^0 + dt v^0 + dt^2(1/2-b) a^0,
                   x0 = z,   r0 = -b dt^2 K z
        with K applied in difference form. The form matters at fine
        meshes in f32: composing u^1 = z + b dt^2 a^1 from the 3-array
        step injects the acceleration's amplified white noise into the
        (u^1, u^0) pair, and the undamped 3-term recurrence turns any
        incoherent u^1 - u^0 mismatch into a persistent velocity error
        amplified by ~1/(omega dt) per mode (measured at 4096^2 f32,
        100 steps: 1.0e-3 rel error with the composed init vs 2.4e-4
        with this one; the residual ~1e-4 floor is the per-step
        representation noise through the same amplification — see the
        class block comment). For Newmark, start from
        ``initial_state_consistent`` for exact agreement with the
        3-array trajectory (the recurrence derivation uses
        M a^0 = -K u^0)."""
        precond = self.gmg_preconditioner(
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)
        dt = self.dt
        u, v, a = state
        if self.scheme == "theta":
            th = self.theta
            x0 = jnp.where(self.interior, u, 0.0)
            r0 = jnp.where(self.interior,
                           dt * self.mass(v)
                           - (th * dt * dt) * self._stiff_diff(u), 0.0)
            s_init = th * dt * dt
        else:
            beta = self.beta
            z = u + dt * v + (dt * dt * (0.5 - beta)) * a
            x0 = jnp.where(self.interior, z, 0.0)
            r0 = jnp.where(self.interior,
                           (-beta * dt * dt) * self._stiff_diff(z), 0.0)
            s_init = beta * dt * dt
        if self.dtype == jnp.float64:
            abs_tol = 1e-12
        else:
            eps = float(jnp.finfo(self.dtype).eps)
            s_abs = s_init * sum(abs(cc) for row in self.stiff.stencil
                                 for cc in row)
            abs_tol = jnp.minimum(eps * s_abs * jnp.linalg.norm(x0),
                                  0.5 * jnp.linalg.norm(r0))
        res = pcg(self._constrained(self.system), r0, jnp.zeros_like(r0),
                  r0=r0, precond_inv_diag=precond, abs_tol=abs_tol,
                  max_iter=10000 if self.dtype == jnp.float64 else 2000,
                  reduction=self.cg_reduction)
        u1 = (x0 + res.x).astype(self.dtype)
        return LeapfrogState(u=u1, u_prev=state.u)

    def _consistent_accel(self, u):
        """a = -M^{-1} K u by Jacobi-CG to the fast-path tolerances (K in
        difference form: the rhs must not be cancellation-noise-bound)."""
        rhs = jnp.where(self.interior, -self._stiff_diff(u), 0.0)
        x0 = jnp.zeros_like(rhs)
        res = pcg(self._constrained(self.mass), rhs, x0,
                  precond_inv_diag=1.0 / self.mass.stencil[1][1],
                  abs_tol=self._solve_abs_tol(rhs, x0, self.mass),
                  max_iter=10000 if self.dtype == jnp.float64 else 2000,
                  reduction=self.cg_reduction)
        return res.x.astype(self.dtype)

    def implicit_2term_finish(self, state: LeapfrogState) -> FastState:
        """Exact (u, u_prev) -> (u, v, a) conversion (one-time mass
        solves, no approximation on top of the CG tolerances).

        Newmark:  v^N = (u^N - u^{N-1})/dt
                        + dt [ (1/2 + b - g) a^{N-1} + (g - b) a^N ]
                  with consistent M a = -K u at both times.
        theta:    v^N = (u^N - u^{N-1})/dt
                        - dt (1-t) M^{-1} K [ t u^N + (1-t) u^{N-1} ]
                  (exactly (u^N - u^{N-1})/dt for BE, t=1); a is not a
                  theta state variable and is returned as the consistent
                  acceleration of u^N for convenience."""
        dt = self.dt
        if self.scheme == "theta":
            th = self.theta
            a = self._consistent_accel(state.u)
            if th == 1.0:
                corr = 0.0
            else:
                combo = (th * state.u + (1.0 - th) * state.u_prev
                         if th != 0.0 else state.u_prev)
                # M^{-1} K combo = -consistent_accel(combo)
                corr = dt * (1.0 - th) * self._consistent_accel(combo)
            v = (state.u - state.u_prev) / dt + corr
        else:
            beta, gamma = self.beta, self.gamma
            a_prev = self._consistent_accel(state.u_prev)
            a = self._consistent_accel(state.u)
            v = ((state.u - state.u_prev) / dt
                 + dt * ((0.5 + beta - gamma) * a_prev
                         + (gamma - beta) * a))
        v = jnp.where(self.interior, v, 0.0).astype(self.dtype)
        return FastState(u=state.u, v=v, a=a)

    def run_implicit_mg_2term(self, state: LeapfrogState, n_steps: int, *,
                              pre_degree: int = 1, smooth_range: float = 8.0,
                              coarse_tol: float = 1e-2) -> LeapfrogState:
        """Displacement-form implicit stepping for both scheme families
        (see block comment above)."""
        if self.scheme == "newmark":
            if self.beta <= 1e-12:
                raise ValueError(
                    "run_implicit_mg_2term needs beta > 0 for Newmark "
                    "(explicit beta=0 is the leapfrog path)")
            c_u, c_up = self.gamma + 0.5, 0.5 - self.gamma
        elif self.scheme == "theta":
            c_u, c_up = 2.0 * self.theta, 1.0 - 2.0 * self.theta
        else:
            raise ValueError("run_implicit_mg_2term needs newmark/theta")
        dt = self.dt
        precond = self.gmg_preconditioner(
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)
        max_iter = 10000 if self.dtype == jnp.float64 else 2000
        eta = (None if self.dtype == jnp.float64
               else float(jnp.finfo(self.dtype).eps))
        # noise-anchored stopping for the correction solve: r0 is the
        # dt^2-scaled stencil pass -dt^2 K(combo), whose own f32
        # computation noise is ~ eps * dt^2 * sum|K coeffs| * |u|
        # elementwise (at fine meshes K u cancels down to h^2-scale
        # values, so r0 can sit only a few x above this floor). Stop at
        # that floor when the signal is strong, and ALWAYS demand at
        # least a 2x reduction (min with 0.5 ||r0||): a lam_max-based
        # backward-error floor can exceed ||r0|| here, and 0-iteration
        # steps silently degenerate the recurrence to pure extrapolation
        # (measured: 3.6e-3 trajectory drift over 20 steps at 4096^2).
        s_abs = (abs(c_u) + abs(c_up)) * dt * dt * sum(
            abs(cc) for row in self.stiff.stencil for cc in row)

        apply_sys = self._constrained(self.system)
        interior = self.interior

        def step(c):
            cu, cup = c
            combo = (cu if (c_u == 1.0 and c_up == 0.0)
                     else c_u * cu + c_up * cup)
            r0 = jnp.where(interior,
                           (-dt * dt) * self._stiff_diff(combo), 0.0)
            x0 = jnp.where(interior, 2.0 * cu - cup, 0.0)
            rn2, xn2 = jnp.vdot(r0, r0), jnp.vdot(x0, x0)
            abs_tol = (1e-12 if eta is None
                       else jnp.minimum(
                           eta * s_abs * jnp.sqrt(xn2),
                           0.5 * jnp.sqrt(rn2)).astype(self.dtype))
            res = pcg(apply_sys, r0, jnp.zeros_like(r0), r0=r0,
                      norm0_sq=rn2, precond_inv_diag=precond,
                      abs_tol=abs_tol, max_iter=max_iter,
                      reduction=self.cg_reduction)
            return ((x0 + res.x).astype(self.dtype), cu)

        runner = cached_scan(self, ("mg2", pre_degree, smooth_range,
                                    coarse_tol), step, n_steps)
        u_fin, up_fin = runner((state.u, state.u_prev))
        return LeapfrogState(u=u_fin, u_prev=up_fin)

    # ------------------------------------------------------------------
    # error-compensated displacement-form stepping: the accuracy mode of
    # run_implicit_mg_2term. Same recurrence on a (head, tail) f32 pair
    # (CompensatedState): K applied to head AND tail in the r0 pass and
    # the extrapolation 2u - u_prev tracked by TwoSum, so the per-step
    # eps*|u| rounding kicks that the undamped recurrence amplifies by
    # ~1/(omega dt) land in the tail instead of the trajectory.
    # ------------------------------------------------------------------
    def implicit_2term_init_comp(self, state: FastState, *,
                                 pre_degree: int = 1,
                                 smooth_range: float = 8.0,
                                 coarse_tol: float = 1e-2) -> CompensatedState:
        lf = self.implicit_2term_init(state, pre_degree=pre_degree,
                                      smooth_range=smooth_range,
                                      coarse_tol=coarse_tol)
        zero = jnp.zeros_like(lf.u)
        return CompensatedState(u=lf.u, u_lo=zero, u_prev=lf.u_prev,
                                u_prev_lo=zero)

    def implicit_2term_finish_comp(self, state: CompensatedState) -> FastState:
        return self.implicit_2term_finish(
            LeapfrogState(u=state.u, u_prev=state.u_prev))

    def run_implicit_mg_2term_comp(self, state: CompensatedState,
                                   n_steps: int, *, pre_degree: int = 1,
                                   smooth_range: float = 8.0,
                                   coarse_tol: float = 1e-2,
                                   tol_factor: float = 1.0
                                   ) -> CompensatedState:
        """Compensated variant of ``run_implicit_mg_2term`` (f32 only —
        in f64 use the plain path). Costs one extra stencil pass (K on
        the tail) + TwoSum bookkeeping per step; ``tol_factor`` scales
        the noise-anchored stopping floor (smaller = more CG iterations
        = lower solve-leftover noise)."""
        if self.dtype == jnp.float64:
            raise ValueError("compensated stepping is the f32 accuracy "
                             "mode; run the plain 2-term path in f64")
        if self.scheme == "newmark":
            if self.beta <= 1e-12:
                raise ValueError("needs beta > 0 for Newmark")
            c_u, c_up = self.gamma + 0.5, 0.5 - self.gamma
        elif self.scheme == "theta":
            c_u, c_up = 2.0 * self.theta, 1.0 - 2.0 * self.theta
        else:
            raise ValueError("needs scheme newmark/theta")
        dt = self.dt
        precond = self.gmg_preconditioner(
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)
        max_iter = 2000
        eta = float(jnp.finfo(self.dtype).eps) * float(tol_factor)
        s_abs = (abs(c_u) + abs(c_up)) * dt * dt * sum(
            abs(cc) for row in self.stiff.stencil for cc in row)

        apply_sys = self._constrained(self.system)
        interior = self.interior

        def step(c):
            uh, ul, ph, pl = c
            if c_u == 1.0 and c_up == 0.0:
                combo_h, combo_l = uh, ul
            else:
                combo_h = c_u * uh + c_up * ph
                combo_l = c_u * ul + c_up * pl
            # K on head AND tail: the pair represents the state to ~2^-45,
            # so r0 carries no eps*|u| input-representation noise
            r0 = jnp.where(interior,
                           (-dt * dt) * (self._stiff_diff(combo_h)
                                         + self._stiff_diff(combo_l)),
                           0.0)
            rn2 = jnp.vdot(r0, r0)
            xnorm = jnp.linalg.norm(jnp.where(interior, 2.0 * uh - ph, 0.0))
            abs_tol = jnp.minimum(eta * s_abs * xnorm,
                                  0.5 * jnp.sqrt(rn2)).astype(self.dtype)
            res = pcg(apply_sys, r0, jnp.zeros_like(r0), r0=r0,
                      norm0_sq=rn2, precond_inv_diag=precond,
                      abs_tol=abs_tol, max_iter=max_iter,
                      reduction=self.cg_reduction)
            t, r1 = _two_sum(2.0 * uh, -ph)
            small = (2.0 * ul - pl) + (res.x + r1)
            un, un_lo = _fast_two_sum(t, small)
            un = jnp.where(interior, un, 0.0).astype(self.dtype)
            un_lo = jnp.where(interior, un_lo, 0.0).astype(self.dtype)
            return CompensatedState(u=un, u_lo=un_lo, u_prev=uh,
                                    u_prev_lo=ul)

        runner = cached_scan(self, ("mg2c", pre_degree, smooth_range,
                                    coarse_tol, tol_factor), step, n_steps)
        return runner(state)

    def run_implicit_mg_2term_comp_driven(
            self, state: CompensatedState, times, g_fn, *,
            pre_degree: int = 1, smooth_range: float = 8.0,
            coarse_tol: float = 1e-2,
            tol_factor: float = 1.0) -> CompensatedState:
        """DRIVEN-boundary compensated displacement stepping: the TwoSum
        recurrence of :meth:`run_implicit_mg_2term_comp` with the product
        engine's boundary machinery (models/fast_engine_2term.py) —
        r0 gets the driven lift ``-A(delta 1_b)`` with
        ``delta = g(t^{n+1}) - 2 u^n|b + u^{n-1}|b`` (head values only:
        the boundary carries no compensation, ``u|b = g`` exactly in f32
        like the plain engine), and the updated state's boundary is
        pinned to ``g(t^{n+1})``. The recurrence stencil reads the TRUE
        boundary values (the combo is applied unmasked, as in the plain
        method). Round-5 verdict ask 7: the precision table's
        compensated row measured on the same driven configuration as
        its f32 row."""
        if self.dtype == jnp.float64:
            raise ValueError("compensated stepping is the f32 accuracy "
                             "mode; run the plain 2-term path in f64")
        if self.scheme == "newmark":
            if self.beta <= 1e-12:
                raise ValueError("needs beta > 0 for Newmark")
            c_u, c_up = self.gamma + 0.5, 0.5 - self.gamma
        elif self.scheme == "theta":
            c_u, c_up = 2.0 * self.theta, 1.0 - 2.0 * self.theta
        else:
            raise ValueError("needs scheme newmark/theta")
        dt = self.dt
        precond = self.gmg_preconditioner(
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)
        max_iter = 2000
        eta = float(jnp.finfo(self.dtype).eps) * float(tol_factor)
        s_abs = (abs(c_u) + abs(c_up)) * dt * dt * sum(
            abs(cc) for row in self.stiff.stencil for cc in row)

        apply_sys = self._constrained(self.system)
        interior = self.interior
        boundary = ~interior

        times = jnp.asarray(times, self.dtype)
        xs, ys = self.grid_coords()

        def g_bnd(t):
            """g(x, y, t) on the TRUE boundary nodes, zero elsewhere
            (incl. pads) — the driven fill / delta operand."""
            gv = jnp.asarray(g_fn(xs, ys, t), self.dtype)
            return jnp.where(boundary, gv, 0.0)

        def step(carry):
            (uh, ul, ph, pl), idx = carry
            t = times[idx]
            if c_u == 1.0 and c_up == 0.0:
                combo_h, combo_l = uh, ul
            else:
                combo_h = c_u * uh + c_up * ph
                combo_l = c_u * ul + c_up * pl
            # unmasked combo: the stencil sees the true driven boundary
            r0 = jnp.where(interior,
                           (-dt * dt) * (self._stiff_diff(combo_h)
                                         + self._stiff_diff(combo_l)),
                           0.0)
            g_new = g_bnd(t)
            delta = g_new - jnp.where(boundary, 2.0 * uh - ph, 0.0)
            r0 = r0 - jnp.where(interior, self.system(delta), 0.0)
            rn2 = jnp.vdot(r0, r0)
            xnorm = jnp.linalg.norm(jnp.where(interior, 2.0 * uh - ph,
                                              0.0))
            abs_tol = jnp.minimum(eta * s_abs * xnorm,
                                  0.5 * jnp.sqrt(rn2)).astype(self.dtype)
            res = pcg(apply_sys, r0, jnp.zeros_like(r0), r0=r0,
                      norm0_sq=rn2, precond_inv_diag=precond,
                      abs_tol=abs_tol, max_iter=max_iter,
                      reduction=self.cg_reduction)
            t2, r1 = _two_sum(2.0 * uh, -ph)
            small = (2.0 * ul - pl) + (res.x + r1)
            un, un_lo = _fast_two_sum(t2, small)
            un = jnp.where(interior, un, g_new).astype(self.dtype)
            un_lo = jnp.where(interior, un_lo, 0.0).astype(self.dtype)
            return (CompensatedState(u=un, u_lo=un_lo, u_prev=uh,
                                     u_prev_lo=ul), idx + 1)

        runner = cached_scan(self, ("mg2cd", id(g_fn), len(times),
                                    pre_degree, smooth_range, coarse_tol,
                                    tol_factor), step, len(times))
        out, _ = runner((state, jnp.asarray(0, jnp.int32)))
        return out

    def energy(self, state: FastState):
        """E = 1/2 (v M v + u K u), f64 reductions, interior-exact.

        Uses the flat element path for the boundary-correct quadratic forms
        (operators built once and cached).
        """
        ops = getattr(self, "_energy_ops", None)
        if ops is None:
            from tpuwave.ops.operators import MatrixFreeOperator
            quad = gauss_simplex(2)
            mass = MatrixFreeOperator(self.space.cell_dofs, self.space.n_dofs,
                                      a_class=element_mass_class(self.space, quad),
                                      dtype=jnp.float64)
            stiff = MatrixFreeOperator(
                self.space.cell_dofs, self.space.n_dofs,
                a_class=element_stiffness_class(self.space, quad,
                                                self.c * self.c),
                dtype=jnp.float64)
            ops = self._energy_ops = (mass, stiff)
        mass, stiff = ops
        u = state.u.reshape(-1).astype(jnp.float64)
        v = state.v.reshape(-1).astype(jnp.float64)
        return 0.5 * (jnp.vdot(v, mass(v)) + jnp.vdot(u, stiff(u)))

    @property
    def n_dofs(self) -> int:
        return self._n_dofs
