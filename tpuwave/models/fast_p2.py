"""P2 production solver on the plane-stencil operators.

Companion of models/fast.py for quadratic elements: state is the flat P2
DoF vector (vertices + h/v/d edge planes, pure reshapes), operators are
constant block-stencils (ops/stencil_p2.py), steps are implicit
consistent-mass CG (P2 row-sum lumping is singular — vertex rows integrate
to zero — so there is no meaningful explicit-lumped P2 path). Everything
(masks, coordinates) is built from iota on device: no O(n_dofs) host
arrays, which is what lets 4096^2 P2 (67M DoF) fit on one chip where the
gather/segment_sum path needs 19 GB at 3072^2.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex
from tpuwave.ops.assembly import element_mass_class, element_stiffness_class
from tpuwave.ops.stencil_p2 import (P2PlaneStencil, canvas_shape,
                                    canvases_to_planes, p2_plane_shapes,
                                    planes_to_canvases, planes_to_flat)
from tpuwave.solve.cg import pcg

__all__ = ["P2FastSolver", "P2State", "P2CanvasSolver", "P2CanvasState"]


class P2State(NamedTuple):
    u: jax.Array  # flat (n_dofs,)
    v: jax.Array
    a: jax.Array


class P2FastSolver:
    """Implicit Newmark / theta stepping with P2 plane-stencil operators."""

    def __init__(self, nel: Tuple[int, int], geometry, dt: float, *,
                 c: float = 1.0, scheme: str = "newmark", beta: float = 0.25,
                 gamma: float = 0.5, theta: float = 0.5, dtype=jnp.float32,
                 cg_reduction: float = 1e-6, precond: str = "jacobi",
                 mg_pre_degree: int = 1, mg_smooth_range: float = 8.0):
        self.mesh = StructuredTriMesh(tuple(nel), geometry)
        self.space = FeSpace(self.mesh, 2)
        self.nx, self.ny = self.mesh.nx, self.mesh.ny
        if scheme not in ("newmark", "theta"):
            raise ValueError(f"unknown scheme {scheme!r}")
        self.dt = float(dt)
        self.c = float(c)
        self.scheme = scheme
        self.beta, self.gamma, self.theta = float(beta), float(gamma), float(theta)
        self.dtype = dtype
        #: CG relative-reduction stopping factor (reference
        #: ReductionControl 1e-6). The reference's ML-AMG V-cycles
        #: over-converge past the nominal tolerance; pass 1e-9 to match
        #: its effective solve accuracy on fine meshes (see RESULTS.md).
        self.cg_reduction = float(cg_reduction)
        self.n_dofs = self.space.n_dofs

        quad = gauss_simplex(3)
        m_class = element_mass_class(self.space, quad)
        k_class = element_stiffness_class(self.space, quad, c * c)
        self.mass = P2PlaneStencil(self.space, m_class, dtype)
        self.stiff = P2PlaneStencil(self.space, k_class, dtype)
        # matrix_a = M + beta dt^2 K | matrix_u = M + (theta dt)^2 K
        sys_coef = (self.beta * self.dt * self.dt if scheme == "newmark"
                    else (self.theta * self.dt) ** 2)
        self.system = self.mass.axpy(sys_coef, self.stiff)
        self._interior = self.interior_mask()
        self._sys_prec = 1.0 / self.system.diagonal()
        self._mass_prec = 1.0 / self.mass.diagonal()
        if precond == "auto":
            from tpuwave.solve.multigrid import AUTO_MG_THRESHOLD
            q = sys_coef * c * c / (self.mesh.hx * self.mesh.hy)
            precond = "mg" if q >= AUTO_MG_THRESHOLD else "jacobi"
        self.precond = precond
        if precond == "mg":
            # (p+h)-multigrid for the system solves: dt-independent CG
            # iteration counts at CFL-breaking dt (solve/multigrid.py).
            # The mass v-solve keeps Jacobi (mesh-independent cond).
            from tpuwave.solve.multigrid import p2_gmg_for_system
            self._sys_prec = p2_gmg_for_system(
                tuple(nel), geometry, c, sys_coef, dtype=dtype,
                pre_degree=mg_pre_degree, smooth_range=mg_smooth_range)
        elif precond != "jacobi":
            raise ValueError(f"Unknown preconditioner {precond!r}")

    # ------------------------------------------------------------------
    # device-built geometry (no host O(n) arrays)
    # ------------------------------------------------------------------
    def _plane_coords(self):
        """Per-plane (x, y) coordinate arrays from iota."""
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        out = {}
        offs = {"V": (0.0, 0.0), "H": (0.5, 0.0), "W": (0.0, 0.5),
                "D": (0.5, 0.5)}
        for p, (r, ccols) in p2_plane_shapes(self.nx, self.ny).items():
            ox, oy = offs[p]
            xs = x0 + hx * (jax.lax.broadcasted_iota(self.dtype, (r, ccols), 1) + ox)
            ys = y0 + hy * (jax.lax.broadcasted_iota(self.dtype, (r, ccols), 0) + oy)
            out[p] = (xs, ys)
        return out

    def interior_mask(self):
        """Flat interior (non-Dirichlet) mask built from iota."""
        parts = []
        for p, (r, ccols) in p2_plane_shapes(self.nx, self.ny).items():
            ri = jax.lax.broadcasted_iota(jnp.int32, (r, ccols), 0)
            ci = jax.lax.broadcasted_iota(jnp.int32, (r, ccols), 1)
            if p == "V":
                bnd = (ri == 0) | (ri == r - 1) | (ci == 0) | (ci == ccols - 1)
            elif p == "H":
                bnd = (ri == 0) | (ri == r - 1)
            elif p == "W":
                bnd = (ci == 0) | (ci == ccols - 1)
            else:
                bnd = jnp.zeros((r, ccols), bool)
            parts.append(jnp.logical_not(bnd).reshape(-1))
        return jnp.concatenate(parts)

    def initial_state(self, u0_fn, v0_fn=None) -> P2State:
        coords = self._plane_coords()
        u_planes = {p: jnp.asarray(u0_fn(xs, ys), self.dtype)
                    for p, (xs, ys) in coords.items()}
        u0 = planes_to_flat(u_planes)
        if v0_fn is None:
            v0 = jnp.zeros_like(u0)
        else:
            v0 = planes_to_flat({p: jnp.asarray(v0_fn(xs, ys), self.dtype)
                                 for p, (xs, ys) in coords.items()})
        if self.scheme == "theta":
            # first-order system: no acceleration state
            return P2State(u=u0, v=v0, a=jnp.zeros_like(u0))
        # consistent a0: M a0 = -K u0 (homogeneous data), interior-masked CG
        interior = self._interior
        rhs = jnp.where(interior, -self.stiff(u0), 0.0)
        res = pcg(self._constrained(self.mass, interior), rhs,
                  jnp.zeros_like(u0),
                  precond_inv_diag=self._mass_prec,
                  abs_tol=1e-6 if self.dtype == jnp.float32 else 1e-12,
                  max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        return P2State(u=u0, v=v0, a=res.x.astype(self.dtype))

    # ------------------------------------------------------------------
    def _constrained(self, op, interior):
        diag = op.diagonal()

        def apply_c(w):
            return jnp.where(interior, op(jnp.where(interior, w, 0.0)),
                             diag * w)
        return apply_c

    @property
    def _max_iter(self):
        return 10000 if self.dtype == jnp.float64 else 2000

    @property
    def _abs_tol(self):
        return 1e-6 if self.dtype == jnp.float32 else 1e-12

    def step(self, state: P2State) -> P2State:
        if self.scheme == "theta":
            return self._theta_step(state)
        return self._newmark_step(state)

    def _newmark_step(self, state: P2State) -> P2State:
        """Implicit Newmark-beta step (homogeneous BCs, zero forcing)."""
        dt, beta, gamma = self.dt, self.beta, self.gamma
        interior = self._interior
        u, v, a = state
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = jnp.where(interior, -self.stiff(z), 0.0)
        res = pcg(self._constrained(self.system, interior), rhs,
                  jnp.where(interior, a, 0.0),
                  precond_inv_diag=self._sys_prec,
                  abs_tol=self._abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        a_new = res.x.astype(self.dtype)
        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        return P2State(u=u_new, v=v_new, a=a_new)

    def _theta_step(self, state: P2State) -> P2State:
        """theta-method step on the P2 plane stencils (homogeneous BCs,
        zero forcing): two consistent-mass CG solves per step, exactly the
        reference WaveTheta algebra (src/WaveTheta.cpp:119-339)."""
        dt, th = self.dt, self.theta
        interior = self._interior
        u, v, a = state
        mu, ku, mv = self.mass(u), self.stiff(u), self.mass(v)
        rhs_u = jnp.where(interior,
                          mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv,
                          0.0)
        res_u = pcg(self._constrained(self.system, interior), rhs_u,
                    jnp.where(interior, u, 0.0),
                    precond_inv_diag=self._sys_prec,
                    abs_tol=self._abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        u_new = res_u.x.astype(self.dtype)
        rhs_v = jnp.where(interior,
                          mv - (dt * (1.0 - th)) * ku
                          - (dt * th) * self.stiff(u_new), 0.0)
        res_v = pcg(self._constrained(self.mass, interior), rhs_v,
                    jnp.where(interior, v, 0.0),
                    precond_inv_diag=self._mass_prec,
                    abs_tol=self._abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        return P2State(u=u_new, v=res_v.x.astype(self.dtype), a=a)

    def run_scan(self, state: P2State, n_steps: int) -> P2State:
        from tpuwave.models.fast import cached_scan
        return cached_scan(self, "p2flat", self.step, n_steps)(state)

    # ------------------------------------------------------------------
    # time-dependent wave speed: K(t) as the variable-coefficient P2
    # block-stencil (ops/stencil_p2.py::P2VarcoefStencil) rebuilt from
    # c(x, y, t) INSIDE the jitted step — the P2 counterpart of
    # FastWaveSolver's tdep paths (`Time Dependent C` at fast-P2 speed;
    # parity counterpart: Discretization.stiffness_at with R=2)
    # ------------------------------------------------------------------
    def _tdep_p2_data(self):
        try:
            return self.__tdep_cache
        except AttributeError:
            pass
        from tpuwave.ops.stencil_p2 import p2_varcoef_data
        self.__tdep_cache = p2_varcoef_data(self.space, gauss_simplex(3))
        return self.__tdep_cache

    def _tdep_scales(self, c_fn, t):
        """(2, Q, ny, nx) planes det * w_q * c^2(x_ekq, t) (traceable)."""
        G, frac, w, det = self._tdep_p2_data()
        ny, nx = self.ny, self.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 1)
        iy = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 0)
        rows = []
        for k in range(2):
            qrows = []
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                xs = x0 + (ix + fx) * hx
                ys = y0 + (iy + fy) * hy
                c2 = jnp.asarray(c_fn(xs, ys, t), self.dtype) ** 2
                c2 = jnp.broadcast_to(c2, (ny, nx))
                qrows.append((det * float(w[q])) * c2)
            rows.append(jnp.stack(qrows))
        return jnp.stack(rows)

    def _stiff_from_scales(self, s):
        from tpuwave.ops.stencil_p2 import P2VarcoefStencil
        G = self._tdep_p2_data()[0]
        return P2VarcoefStencil(self.space, s, G, self.dtype)

    def _stiff_at(self, c_fn, t):
        return self._stiff_from_scales(self._tdep_scales(c_fn, t))

    def step_tdep(self, state: P2State, t, c_fn, k_n_scales=None,
                  k_np1_scales=None) -> P2State:
        """One step with K = K(t) (homogeneous BCs, zero forcing — the
        P2-fast scope). The elastic force acts at t^{n+1} for Newmark and
        is theta-weighted K^n/K^{n+1} for the theta family, matching the
        parity tdep semantics (models/newmark.py, models/theta.py).
        ``k_n_scales``/``k_np1_scales`` let the scan carry the already-
        built scale planes (run_scan_tdep) — one varcoef build per step
        instead of two for the theta family."""
        dt = self.dt
        interior = self._interior
        sys_coef = (self.beta * dt * dt if self.scheme == "newmark"
                    else (self.theta * dt) ** 2)
        k_np1 = (self._stiff_from_scales(k_np1_scales)
                 if k_np1_scales is not None else self._stiff_at(c_fn, t))
        system = self.mass.axpy_varcoef(sys_coef, k_np1)
        sys_prec = 1.0 / system.diagonal()
        if self.scheme == "newmark":
            beta, gamma = self.beta, self.gamma
            u, v, a = state
            z = u + dt * v + (dt * dt * (0.5 - beta)) * a
            rhs = jnp.where(interior, -k_np1(z), 0.0)
            res = pcg(self._constrained(system, interior), rhs,
                      jnp.where(interior, a, 0.0),
                      precond_inv_diag=sys_prec, abs_tol=self._abs_tol,
                      max_iter=self._max_iter, reduction=self.cg_reduction)
            a_new = res.x.astype(self.dtype)
            u_new = z + (beta * dt * dt) * a_new
            v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
            return P2State(u=u_new, v=v_new, a=a_new)
        th = self.theta
        k_n = (self._stiff_from_scales(k_n_scales)
               if k_n_scales is not None else self._stiff_at(c_fn, t - dt))
        u, v, a = state
        mu, ku, mv = self.mass(u), k_n(u), self.mass(v)
        rhs_u = jnp.where(interior,
                          mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv,
                          0.0)
        res_u = pcg(self._constrained(system, interior), rhs_u,
                    jnp.where(interior, u, 0.0),
                    precond_inv_diag=sys_prec, abs_tol=self._abs_tol,
                    max_iter=self._max_iter, reduction=self.cg_reduction)
        u_new = res_u.x.astype(self.dtype)
        rhs_v = jnp.where(interior,
                          mv - (dt * (1.0 - th)) * ku
                          - (dt * th) * k_np1(u_new), 0.0)
        res_v = pcg(self._constrained(self.mass, interior), rhs_v,
                    jnp.where(interior, v, 0.0),
                    precond_inv_diag=self._mass_prec,
                    abs_tol=self._abs_tol, max_iter=self._max_iter,
                    reduction=self.cg_reduction)
        return P2State(u=u_new, v=res_v.x.astype(self.dtype), a=a)

    def initial_state_tdep(self, u0_fn, c_fn, v0_fn=None) -> P2State:
        """u0/v0 interpolation with the consistent a0 solved against K(0)
        (no wasted static-K a0 solve — interpolation inlined)."""
        coords = self._plane_coords()
        u0 = planes_to_flat({p: jnp.asarray(u0_fn(xs, ys), self.dtype)
                             for p, (xs, ys) in coords.items()})
        if v0_fn is None:
            v0 = jnp.zeros_like(u0)
        else:
            v0 = planes_to_flat({p: jnp.asarray(v0_fn(xs, ys), self.dtype)
                                 for p, (xs, ys) in coords.items()})
        if self.scheme == "theta":
            return P2State(u=u0, v=v0, a=jnp.zeros_like(u0))
        interior = self._interior
        rhs = jnp.where(interior, -self._stiff_at(c_fn, 0.0)(u0), 0.0)
        res = pcg(self._constrained(self.mass, interior), rhs,
                  jnp.zeros_like(u0), precond_inv_diag=self._mass_prec,
                  abs_tol=self._abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        return P2State(u=u0, v=v0, a=res.x.astype(self.dtype))

    def run_scan_tdep(self, state: P2State, times, c_fn) -> P2State:
        """Whole-loop jitted scan over FROM... the reference accumulation
        time stamps (each entry is the t^{n+1} being stepped TO), with
        K(t) rebuilt in-scan. Cached per (n_steps, c_fn) — pass stable
        function objects (see FastWaveSolver.run_leapfrog_tdep)."""
        times = jnp.asarray(times, self.dtype)
        key = ("p2tdep", int(times.shape[0]), c_fn, self.scheme)
        cache = getattr(self, "_tdep_scan_cache", None)
        if cache is None:
            cache = self._tdep_scan_cache = {}
        run = cache.get(key)
        if run is None:
            while len(cache) >= 4:
                cache.pop(next(iter(cache)))
            n = int(times.shape[0])

            @jax.jit
            def run(state, ts):
                # the theta family's K^n is last step's K^{n+1}: carry
                # the scale planes so each step builds ONE operator
                def body(carry, t):
                    st, s_n = carry
                    s_np1 = self._tdep_scales(c_fn, t)
                    st = self.step_tdep(st, t, c_fn, k_n_scales=s_n,
                                        k_np1_scales=s_np1)
                    return (st, s_np1), None
                s0 = self._tdep_scales(c_fn, ts[0] - self.dt)
                (st, _), _ = jax.lax.scan(body, (state, s0), ts, length=n)
                return st

            cache[key] = run
        return run(state, times)


class P2CanvasState(NamedTuple):
    u: jax.Array  # (4, Hc, Wc) canvas stacks, plane order V,H,W,D
    v: jax.Array
    a: jax.Array


class P2CanvasPair(NamedTuple):
    """Two-array displacement state for the canvas 2-term implicit path
    (the P2 twin of models/fast.py::LeapfrogState)."""
    u: jax.Array       # (4, Hc, Wc)
    u_prev: jax.Array


class P2CanvasSolver:
    """Shardable P2 solver: state lives as four equal zero-padded canvases.

    The canvas layout makes every plane the same shape, so the whole state
    stack (4, Hc, Wc) row-shards over a jax.sharding mesh and the
    block-stencil rolls lower to nearest-neighbour collective-permutes —
    the multi-chip P2 path (SURVEY.md hard part 5, 'halo exchange for P2
    DoFs'). Semantics match P2FastSolver (implicit Newmark, homogeneous
    BCs, zero forcing).
    """

    def __init__(self, nel: Tuple[int, int], geometry, dt: float, *,
                 c: float = 1.0, beta: float = 0.25, gamma: float = 0.5,
                 scheme: str = "newmark", theta: float = 0.5,
                 dtype=jnp.float32, sharding=None, row_multiple: int = 1,
                 cg_reduction: float = 1e-6,
                 precond: str = "jacobi", mg_pre_degree: int = 1,
                 mg_smooth_range: float = 8.0):
        if scheme not in ("newmark", "theta"):
            raise ValueError(f"unknown scheme {scheme!r}")
        self.mesh = StructuredTriMesh(tuple(nel), geometry)
        self.space = FeSpace(self.mesh, 2)
        self.nx, self.ny = self.mesh.nx, self.mesh.ny
        self.dt = float(dt)
        self.scheme = scheme
        self.theta = float(theta)
        self.beta, self.gamma = float(beta), float(gamma)
        self.dtype = dtype
        self.cg_reduction = float(cg_reduction)
        self.sharding = sharding
        self.cshape = canvas_shape(self.nx, self.ny, row_multiple)
        self.n_dofs = self.space.n_dofs

        quad = gauss_simplex(3)
        self.mass = P2PlaneStencil(self.space,
                                   element_mass_class(self.space, quad), dtype)
        self.stiff = P2PlaneStencil(
            self.space, element_stiffness_class(self.space, quad, c * c), dtype)
        sys_coef = (self.beta * self.dt * self.dt if scheme == "newmark"
                    else (self.theta * self.dt) ** 2)
        self.system = self.mass.axpy(sys_coef, self.stiff)

        self.interior = self._interior_canvas_mask()
        from tpuwave.ops.stencil_p2 import _PLANES
        diag = jnp.asarray([self.system.plane_diag[p] for p in _PLANES],
                           dtype=dtype).reshape(4, 1, 1)
        self._diag = diag
        self._mass_diag = jnp.asarray(
            [self.mass.plane_diag[p] for p in _PLANES],
            dtype=dtype).reshape(4, 1, 1)
        if sharding is not None:
            self.interior = jax.device_put(self.interior, sharding)
        self._sys_prec = 1.0 / self._diag
        if precond == "auto":
            from tpuwave.solve.multigrid import AUTO_MG_THRESHOLD
            q = sys_coef * c * c / (self.mesh.hx * self.mesh.hy)
            precond = "mg" if q >= AUTO_MG_THRESHOLD else "jacobi"
        self.precond = precond
        if precond == "mg":
            # (p+h)-multigrid for the system solves on the canvas layout:
            # dt-independent CG iteration counts at CFL-breaking dt, with
            # the smoothing applies running through the constrained
            # canvas apply. The mass v-solve
            # keeps Jacobi (mesh-independent conditioning).
            from tpuwave.solve.multigrid import (P2CanvasGmgPreconditioner,
                                                 p2_gmg_for_system)
            flat_pre = p2_gmg_for_system(tuple(nel), geometry, c, sys_coef,
                                         dtype=dtype,
                                         pre_degree=mg_pre_degree,
                                         smooth_range=mg_smooth_range)
            self._sys_prec = P2CanvasGmgPreconditioner(
                self._constrained(self.system), self.interior,
                1.0 / self._diag, flat_pre.sm_theta, flat_pre.sm_coeffs,
                flat_pre.p1_cycle, self.nx, self.ny, self.cshape)
        elif precond != "jacobi":
            raise ValueError(f"Unknown preconditioner {precond!r}")

    def _interior_canvas_mask(self):
        """(4, Hc, Wc) True at interior (free) DoFs, False at Dirichlet +
        padding (both pinned to zero)."""
        shapes = p2_plane_shapes(self.nx, self.ny)
        hc, wc = self.cshape
        ri = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0)
        ci = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1)
        masks = []
        from tpuwave.ops.stencil_p2 import _PLANES
        for p in _PLANES:
            r, ccols = shapes[p]
            lj = ri - 1  # plane-local row
            li = ci - 1  # plane-local col
            support = (lj >= 0) & (lj < r) & (li >= 0) & (li < ccols)
            if p == "V":
                bnd = (lj == 0) | (lj == r - 1) | (li == 0) | (li == ccols - 1)
            elif p == "H":
                bnd = (lj == 0) | (lj == r - 1)
            elif p == "W":
                bnd = (li == 0) | (li == ccols - 1)
            else:
                bnd = jnp.zeros((hc, wc), bool)
            masks.append(support & ~bnd)
        return jnp.stack(masks)

    def _plane_coords_canvas(self):
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        hc, wc = self.cshape
        ri = jax.lax.broadcasted_iota(self.dtype, (hc, wc), 0) - 1.0
        ci = jax.lax.broadcasted_iota(self.dtype, (hc, wc), 1) - 1.0
        offs = {"V": (0.0, 0.0), "H": (0.5, 0.0), "W": (0.0, 0.5),
                "D": (0.5, 0.5)}
        from tpuwave.ops.stencil_p2 import _PLANES
        return [(x0 + hx * (ci + offs[p][0]), y0 + hy * (ri + offs[p][1]))
                for p in _PLANES]

    def initial_state(self, u0_fn, v0_fn=None) -> P2CanvasState:
        coords = self._plane_coords_canvas()
        u0 = jnp.stack([jnp.asarray(u0_fn(xs, ys), self.dtype)
                        for xs, ys in coords])
        u0 = jnp.where(self.interior, u0, 0.0)
        if v0_fn is None:
            v0 = jnp.zeros_like(u0)
        else:
            v0 = jnp.stack([jnp.asarray(v0_fn(xs, ys), self.dtype)
                            for xs, ys in coords])
            v0 = jnp.where(self.interior, v0, 0.0)
        if self.sharding is not None:
            u0 = jax.device_put(u0, self.sharding)
            v0 = jax.device_put(v0, self.sharding)
        if self.scheme == "theta":
            return P2CanvasState(u=u0, v=v0, a=jnp.zeros_like(u0))
        rhs = self._rhs_stiff(u0)
        res = pcg(self._constrained(self.mass), rhs, jnp.zeros_like(u0),
                  precond_inv_diag=1.0 / self._mass_diag,
                  abs_tol=self._abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        return P2CanvasState(u=u0, v=v0, a=res.x.astype(self.dtype))

    def _rhs_stiff(self, z):
        """interior-masked -K z (homogeneous data)."""
        return jnp.where(self.interior, -self.stiff.apply_canvases(z), 0.0)

    @property
    def _max_iter(self):
        return 10000 if self.dtype == jnp.float64 else 2000

    @property
    def _abs_tol(self):
        return 1e-6 if self.dtype == jnp.float32 else 1e-12

    def _constrained(self, op):
        from tpuwave.ops.stencil_p2 import _PLANES
        diag = jnp.asarray([op.plane_diag[p] for p in _PLANES],
                           dtype=self.dtype).reshape(4, 1, 1)

        def apply_c(w):
            return jnp.where(
                self.interior,
                op.apply_canvases(jnp.where(self.interior, w, 0.0)),
                diag * w)
        return apply_c

    def step(self, state: P2CanvasState) -> P2CanvasState:
        if self.scheme == "theta":
            return self._theta_step(state)
        return self._newmark_step(state)

    def _newmark_step(self, state: P2CanvasState) -> P2CanvasState:
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u, v, a = state
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = self._rhs_stiff(z)
        res = pcg(self._constrained(self.system), rhs,
                  jnp.where(self.interior, a, 0.0),
                  precond_inv_diag=self._sys_prec,
                  abs_tol=self._abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        a_new = res.x.astype(self.dtype)
        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        return P2CanvasState(u=u_new, v=v_new, a=a_new)

    def _theta_step(self, state: P2CanvasState) -> P2CanvasState:
        """theta-method step on the shardable canvas layout (homogeneous
        BCs, zero forcing) — the multi-chip P2 theta path; reference
        WaveTheta algebra (src/WaveTheta.cpp:119-339)."""
        dt, th = self.dt, self.theta
        interior = self.interior
        abs_tol = 1e-6 if self.dtype == jnp.float32 else 1e-12
        u, v, a = state
        um = jnp.where(interior, u, 0.0)
        vm = jnp.where(interior, v, 0.0)
        mu = self.mass.apply_canvases(um)
        ku = self.stiff.apply_canvases(um)
        mv = self.mass.apply_canvases(vm)
        rhs_u = jnp.where(interior,
                          mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv,
                          0.0)
        res_u = pcg(self._constrained(self.system), rhs_u, um,
                    precond_inv_diag=self._sys_prec,
                    abs_tol=abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        u_new = res_u.x.astype(self.dtype)
        kun = self.stiff.apply_canvases(jnp.where(interior, u_new, 0.0))
        rhs_v = jnp.where(interior,
                          mv - (dt * (1.0 - th)) * ku - (dt * th) * kun, 0.0)
        res_v = pcg(self._constrained(self.mass), rhs_v, vm,
                    precond_inv_diag=1.0 / self._mass_diag,
                    abs_tol=abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        return P2CanvasState(u=u_new, v=res_v.x.astype(self.dtype), a=a)

    def run_scan(self, state: P2CanvasState, n_steps: int) -> P2CanvasState:
        from tpuwave.models.fast import cached_scan
        return cached_scan(self, "p2canvas", self.step, n_steps)(state)

    # ------------------------------------------------------------------
    # displacement-form (two-array) implicit stepping on the canvas
    # layout — the P2 port of FastWaveSolver.run_implicit_mg_2term (see
    # the block comment there for the derivation, the warm-start /
    # stopping-rule findings and the f32 noise trade). One
    # O(dt^2)-residual system solve per step, no mass/velocity solve.
    # ------------------------------------------------------------------
    def _consistent_accel_canvas(self, u):
        """a = -M^{-1} K u by Jacobi-CG on the canvases."""
        rhs = self._rhs_stiff(jnp.where(self.interior, u, 0.0))
        res = pcg(self._constrained(self.mass), rhs, jnp.zeros_like(u),
                  precond_inv_diag=1.0 / self._mass_diag,
                  abs_tol=self._abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        return res.x.astype(self.dtype)

    def implicit_2term_init(self, state: P2CanvasState) -> P2CanvasPair:
        """(u^1, u^0) via the first step solved in correction u-form
        (any composed u^1 injects an incoherent (u^1, u^0) mismatch the
        undamped recurrence amplifies by ~1/(omega dt) — see
        FastWaveSolver.implicit_2term_init)."""
        dt = self.dt
        u, v, a = state
        if self.scheme == "theta":
            th = self.theta
            x0 = jnp.where(self.interior, u, 0.0)
            vm = jnp.where(self.interior, v, 0.0)
            r0 = (jnp.where(self.interior,
                            dt * self.mass.apply_canvases(vm), 0.0)
                  + (th * dt * dt) * self._rhs_stiff(x0))
        else:
            beta = self.beta
            z = u + dt * v + (dt * dt * (0.5 - beta)) * a
            x0 = jnp.where(self.interior, z, 0.0)
            r0 = (beta * dt * dt) * self._rhs_stiff(x0)
        rn2 = jnp.vdot(r0, r0)
        abs_tol = jnp.minimum(
            jnp.asarray(self._abs_tol, self.dtype),
            0.5 * jnp.sqrt(rn2).astype(self.dtype))
        res = pcg(self._constrained(self.system), r0, jnp.zeros_like(r0),
                  r0=r0, norm0_sq=rn2, precond_inv_diag=self._sys_prec,
                  abs_tol=abs_tol, max_iter=self._max_iter,
                  reduction=self.cg_reduction)
        return P2CanvasPair(u=(x0 + res.x).astype(self.dtype),
                            u_prev=jnp.where(self.interior, u, 0.0))

    def run_implicit_2term(self, pair: P2CanvasPair,
                           n_steps: int) -> P2CanvasPair:
        """3-term displacement recurrence: each step is one fused
        -dt^2 K(combo) pass + ~1 MG/Jacobi-PCG iteration on the system
        (extrapolated warm start 2u^n - u^{n-1}). The stopping rule
        forces >= 1 CG iteration (min with 0.5 ||r0||): a floor above
        ||r0|| silently degenerates the recurrence to extrapolation."""
        if self.scheme == "newmark":
            if self.beta <= 1e-12:
                raise ValueError("run_implicit_2term needs beta > 0 for "
                                 "Newmark")
            c_u, c_up = self.gamma + 0.5, 0.5 - self.gamma
        else:
            c_u, c_up = 2.0 * self.theta, 1.0 - 2.0 * self.theta
        dt = self.dt
        apply_sys = self._constrained(self.system)
        tol_cap = jnp.asarray(self._abs_tol, self.dtype)

        def step(c):
            cu, cup = c
            combo = (cu if (c_u == 1.0 and c_up == 0.0)
                     else c_u * cu + c_up * cup)
            r0 = (dt * dt) * self._rhs_stiff(combo)
            x0 = jnp.where(self.interior, 2.0 * cu - cup, 0.0)
            rn2 = jnp.vdot(r0, r0)
            abs_tol = jnp.minimum(tol_cap,
                                  0.5 * jnp.sqrt(rn2).astype(self.dtype))
            res = pcg(apply_sys, r0, jnp.zeros_like(r0), r0=r0,
                      norm0_sq=rn2, precond_inv_diag=self._sys_prec,
                      abs_tol=abs_tol, max_iter=self._max_iter,
                      reduction=self.cg_reduction)
            return ((x0 + res.x).astype(self.dtype), cu)

        from tpuwave.models.fast import cached_scan
        runner = cached_scan(self, "p2c-2term", step, n_steps)
        u_f, up_f = runner((pair.u, pair.u_prev))
        return P2CanvasPair(u=u_f, u_prev=up_f)

    def implicit_2term_finish(self, pair: P2CanvasPair) -> P2CanvasState:
        """Exact (u, u_prev) -> (u, v, a) conversion (one-time mass
        solves; same identities as FastWaveSolver.implicit_2term_finish)."""
        dt = self.dt
        a = self._consistent_accel_canvas(pair.u)
        if self.scheme == "theta":
            th = self.theta
            if th == 1.0:
                corr = 0.0
            else:
                combo = (th * pair.u + (1.0 - th) * pair.u_prev
                         if th != 0.0 else pair.u_prev)
                corr = dt * (1.0 - th) * self._consistent_accel_canvas(combo)
            v = (pair.u - pair.u_prev) / dt + corr
        else:
            beta, gamma = self.beta, self.gamma
            a_prev = self._consistent_accel_canvas(pair.u_prev)
            v = ((pair.u - pair.u_prev) / dt
                 + dt * ((0.5 + beta - gamma) * a_prev
                         + (gamma - beta) * a))
        v = jnp.where(self.interior, v, 0.0).astype(self.dtype)
        return P2CanvasState(u=pair.u, v=v, a=a)

    def to_flat(self, xc) -> jax.Array:
        return planes_to_flat(canvases_to_planes(xc, self.nx, self.ny))
