"""P2 (R = 2) product-surface fast engine — canvas-native and shardable.

The reference's one engine is degree-generic AND partition-generic —
``FE_SimplexP<dim>(r)`` at /root/reference/src/WaveEquationBase.cpp:74-84
serves r in {1, 2} identically, and ``GridTools::partition_triangulation``
at :65-69 decomposes the mesh across MPI ranks for every degree, including
driven Dirichlet data, forcing, and the derived acceleration boundary
formulas (WaveNewmark.cpp:116-262, WaveTheta.cpp:119-339).

:class:`FastP2ThetaSolver` and :class:`FastP2NewmarkSolver` implement the
EXACT parity step algebra of models/theta.py / models/newmark.py on the
four P2 DoF planes (ops/stencil_p2.py) — symmetric Dirichlet elimination
with time-dependent g on vertex AND edge-midpoint boundary planes, the
three derived acceleration boundary formulas, the quadrature-consistent
P2 load (r+1 rule = gauss_simplex(3)), the consistent a0 solve, and the
same ReductionControl stopping contract — with the full wave-speed class
(constant, spatially varying via :class:`P2VarcoefStencil`, and
`Time Dependent C` with the K(t) scale planes rebuilt inside the jitted
step, the theta family carrying K(t^n) across steps).

Round-5 layout: the state lives as four equal zero-padded CANVASES
(4, Hc, Wc) for the WHOLE step — boundary interpolation, the load vector,
the rhs algebra, the Dirichlet lift and every CG matvec are canvas-native,
so no solve pays flat <-> canvas conversions, and the identical-shape plane
stack row-shards over a ``jax.sharding`` device mesh exactly like the P1 engine
(``--shard rows`` at R = 2): GSPMD lowers the block-stencil shifts to
nearest-neighbour collective-permutes and the CG / diagnostics reductions
to psum. Flat vectors appear only at the diagnostics/IO boundary
(log-cadence), through the :class:`_CanvasDiag` adapter around the
parity ``Discretization`` / O(grid) :class:`P2GridDiagnostics`.

NB every O(n_dofs) array this engine needs (interior/boundary masks,
assembled diagonals, varcoef scale planes, coordinates) is built INSIDE
the trace from iota / jnp.full — a concrete array closed over by the
jitted step lowers to an HLO literal, and at 4096^2 (67.1M DoF) those
literals would add ~1.2 GB to every compiled program.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex
from tpuwave.models._scan import ScanMixin
from tpuwave.models.fast_engine import FastGridState
from tpuwave.models.p2_diag import P2GridDiagnostics
from tpuwave.ops.assembly import element_mass_class, element_stiffness_class
from tpuwave.ops.stencil_p2 import (_P2_POSITIONS, _PLANES, P2PlaneStencil,
                                    P2VarcoefStencil, canvas_shape,
                                    canvases_to_planes, p2_plane_shapes,
                                    p2_varcoef_data, planes_to_flat)
from tpuwave.solve.cg import pcg
from tpuwave.utils.params import Params

__all__ = ["FastP2ThetaSolver", "FastP2NewmarkSolver", "P2_PLANE_OFFS"]

#: per-plane support-point offsets within the unit grid cell
P2_PLANE_OFFS = {"V": (0.0, 0.0), "H": (0.5, 0.0), "W": (0.0, 0.5),
                 "D": (0.5, 0.5)}


class _P2Op(NamedTuple):
    """Canvas P2 operator triple: unconstrained apply on (4, Hc, Wc)
    stacks, assembled diagonal ((4, 1, 1) plane constants or full
    (4, Hc, Wc) canvases with 1.0 padding), and an upper eigenvalue
    bound (f32 backward-error floor / Chebyshev)."""
    apply: object
    diag: object
    lam_hi: object


def _gershgorin_plane_stencil(op: P2PlaneStencil) -> float:
    """max over output planes of sum |coeff| — a Gershgorin row-sum bound
    on the constant P2 block-stencil (host float)."""
    sums = {p: 0.0 for p in _PLANES}
    for (pa, _pb, _ox, _oy), c in op.coeffs.items():
        sums[pa] += abs(c)
    return max(sums.values())


class _CanvasDiag:
    """Runner-facing diagnostics adapter: accepts the engine's canvas
    state arrays and forwards flat vectors to the wrapped parity
    ``Discretization`` / O(grid) ``P2GridDiagnostics`` surface (their
    semantics — reference WaveEquationBase.cpp:148-222 energy/probe,
    :367-423 errors — are already pinned by tests). Conversions are pure
    reshapes/crops and run only at the log/IO cadence."""

    def __init__(self, inner, nx: int, ny: int):
        self._inner = inner
        self._nx, self._ny = int(nx), int(ny)
        self.energy = jax.jit(self._energy_c)
        if inner.params.has_exact_solution:
            self.errors = jax.jit(self._errors_c)

    def to_flat(self, x):
        if x.ndim == 1:
            return x
        return planes_to_flat(canvases_to_planes(x, self._nx, self._ny))

    def _energy_c(self, u, v):
        return self._inner.energy(self.to_flat(u), self.to_flat(v))

    def _errors_c(self, u, t):
        return self._inner.errors(self.to_flat(u), t)

    def probe(self, u):
        return self._inner.probe(self.to_flat(u))

    def vertex_values(self, u):
        return self._inner.vertex_values(self.to_flat(u))

    def interpolate(self, expr, t=0.0):
        return self._inner.interpolate(expr, t)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _FastP2EngineBase(ScanMixin):
    """Shared plumbing: canvas plane operators, boundary/forcing data,
    symmetric Dirichlet elimination on the canvas P2 state."""

    def __init__(self, problem, *, precond: str = "jacobi",
                 cheby_degree: int = 3, sharding=None,
                 solver: str = "3term", cheby_solver_degree: int = 8,
                 mg_pre_degree: int = 2, mg_smooth_range: float = 8.0):
        # mg_pre_degree=2: the parity V-cycle's smoothing degree
        # (solve/multigrid.py::p2_gmg_for_system), so both engines run
        # the same preconditioner
        if isinstance(problem, Params):
            disc = P2GridDiagnostics(problem)
        else:
            disc = problem
        p = disc.params
        if p.r != 2:
            raise ValueError("FastP2*Solver needs R = 2")
        self.mesh = StructuredTriMesh(p.nel, p.geometry)
        self.space = FeSpace(self.mesh, 2)
        self.nx, self.ny = self.mesh.nx, self.mesh.ny
        self.disc = _CanvasDiag(disc, self.nx, self.ny)
        self.dtype = disc.dtype
        self.dt = p.dt
        self.theta, self.beta, self.gamma = p.theta, p.beta, p.gamma
        self.n_dofs = self.space.n_dofs
        self._max_iter = 10000 if self.dtype == jnp.float64 else 2000

        c_const = p.c.constant_value
        self.time_dep_c = p.time_dependent_c and p.c.time_dependent
        if self.time_dep_c:
            self._c_mode = "tdep"
        elif c_const is None:
            self._c_mode = "varcoef"
        else:
            self._c_mode = "const"
        self._c_eval = p.c.evaluate
        self._g = p.g
        self._dgdt = p.dgdt
        self._f = p.f if not p.f.is_zero else None

        if solver not in ("3term", "cheby"):
            raise ValueError(f"unknown solver {solver!r} for this engine "
                             "(3term | cheby; 2term is the displacement-"
                             "form classes in models/fast_engine_p2_2term)")
        self._solver = solver
        self._cheby_solver_degree = int(cheby_solver_degree)
        if solver == "cheby" and self._c_mode != "const":
            raise ValueError(
                "--solver cheby needs a constant wave speed (block-symbol "
                "eigenvalue bounds); use 3term for varcoef or "
                "time-dependent C")

        quad = gauss_simplex(3)                       # assembly rule r + 1
        self.mass = P2PlaneStencil(
            self.space, element_mass_class(self.space, quad), self.dtype)
        self._mass_lam = _gershgorin_plane_stencil(self.mass)
        #: bound canvas applies, captured ONCE so `is` identity checks
        #: (cheby routing) work — a fresh bound method per access
        #: would never compare equal
        self._mass_apply = self.mass.apply_canvases

        #: system coefficient: M + coef * K
        self.coef = (p.beta * p.dt * p.dt if self.method_name == "newmark"
                     else (p.theta * p.dt) ** 2)

        self._k_unit_lam = _gershgorin_plane_stencil(P2PlaneStencil(
            self.space, element_stiffness_class(self.space, quad, 1.0),
            self.dtype))
        if self._c_mode == "const":
            self._stiff = P2PlaneStencil(
                self.space,
                element_stiffness_class(self.space, quad,
                                        float(c_const) ** 2), self.dtype)
            self._stiff_lam = _gershgorin_plane_stencil(self._stiff)
            self._sys_stencil = self.mass.axpy(self.coef, self._stiff) \
                if self.coef != 0.0 else self.mass
            self._sys_lam = _gershgorin_plane_stencil(self._sys_stencil)
            self._stiff_apply = self._stiff.apply_canvases
            self._sys_apply = self._sys_stencil.apply_canvases
        else:
            # varcoef/tdep: the operator is rebuilt from iota-generated
            # scale planes INSIDE each step trace (for varcoef the c(x,y)
            # evaluation repeats per step — the price of keeping the HLO
            # free of O(n_dofs) literals; see the module docstring note)
            self._stiff = None
            self._sys_stencil = None
            self._sys_lam = None
            self._stiff_apply = self._sys_apply = None

        # -- device-mesh layout (--shard rows / blocks at R = 2) --------
        #: ``sharding``: a grid NamedSharding as produced by
        #: parallel/sharding.py::grid_sharding — the same object the P1
        #: engine takes. The canvas stack (4, Hc, Wc) shards its
        #: row (and, for 2-D meshes, column) axes; the leading plane
        #: axis stays replicated. Canvas rows/cols are padded to the
        #: shard counts so device_put always tiles evenly.
        self.sharding = sharding
        self._canvas_sharding = None
        y_shards = x_shards = 1
        if sharding is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            spec = tuple(sharding.spec)
            y_name = spec[0] if len(spec) > 0 else None
            x_name = spec[1] if len(spec) > 1 else None
            if y_name is not None:
                y_shards = sharding.mesh.shape[y_name]
            if x_name is not None:
                x_shards = sharding.mesh.shape[x_name]
            self._canvas_sharding = NamedSharding(
                sharding.mesh, PartitionSpec(None, y_name, x_name))

        self._cshape = canvas_shape(self.nx, self.ny, row_multiple=y_shards,
                                    col_multiple=x_shards)

        # preconditioner for the implicit system (the theta v-system is
        # the bare mass — mesh-independent conditioning, Jacobi always)
        if self._solver == "cheby":
            precond = "jacobi"   # cheby IS the solver; skip mg setup
        elif precond == "auto":
            from tpuwave.solve.multigrid import auto_precond
            precond = auto_precond(disc, self.coef)
        self.precond = precond
        self.cheby_degree = int(cheby_degree)
        if precond == "mg":
            # canvas-native (p+h)-multigrid V-cycle (solve/multigrid.py):
            # the smoothing applies run through the constrained canvas
            # apply. Non-constant / time-dependent c freezes the
            # hierarchy at the rms wave speed (a FIXED SPD V-cycle stays a
            # valid CG preconditioner for a varying SPD system —
            # models/theta.py note).
            from tpuwave.solve.multigrid import (P2CanvasGmgPreconditioner,
                                                 p2_gmg_for_system)
            c_ref = (float(c_const) if c_const is not None
                     else self._frozen_c_ref())
            flat_pre = p2_gmg_for_system(
                (self.nx, self.ny), p.geometry, c_ref, self.coef,
                dtype=self.dtype, pre_degree=int(mg_pre_degree),
                smooth_range=float(mg_smooth_range))
            mg_st = (self._sys_stencil if self._sys_stencil is not None
                     else flat_pre.system)
            inv_diag = 1.0 / jnp.asarray(
                [mg_st.plane_diag[q] for q in _PLANES],
                self.dtype).reshape(4, 1, 1)
            self._prec_sys = P2CanvasGmgPreconditioner(
                self._constrained_stencil_apply(mg_st), None, inv_diag,
                flat_pre.sm_theta, flat_pre.sm_coeffs, flat_pre.p1_cycle,
                self.nx, self.ny, self._cshape)
        elif precond in ("jacobi", "chebyshev"):
            self._prec_sys = None   # derived from the (per-step) system op
        else:
            raise ValueError(f"Unknown preconditioner {precond!r}")

        if self._solver == "cheby":
            from tpuwave.solve.cheby_iter import chebyshev_coefficients
            lo, hi = self._p2_symbol_bounds(self._sys_stencil)
            self._cheby_bounds = (lo, hi)
            th, cf = chebyshev_coefficients(lo, hi,
                                            self._cheby_solver_degree)
            self._cheby_sched = (th, tuple(cf))

        self._step = jax.jit(self._step_impl)

    # -- spectrum bounds for the cheby solver ---------------------------
    @staticmethod
    def _p2_symbol_bounds(st: P2PlaneStencil, n: int = 128,
                          pad_rel: float = 0.02):
        """Spectrum bounds of the constant P2 block-stencil from its 4x4
        Hermitian symbol S(theta)[pa, pb] = sum C e^{i theta . off} —
        the block generalisation of solve/cheby_iter.py::
        stencil_symbol_bounds (Dirichlet principal submatrix spectrum
        inside the symbol range by interlacing; pinned rows contribute
        the plane diagonals, folded into the range below). The outward
        pad only loosens the Chebyshev interval (safe)."""
        order = {p: i for i, p in enumerate(_PLANES)}
        th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
        tx = th[None, :]
        ty = th[:, None]
        S = np.zeros((n, n, 4, 4), dtype=np.complex128)
        for (pa, pb, ox, oy), c in st.coeffs.items():
            S[..., order[pa], order[pb]] += c * np.exp(
                1j * (ox * tx + oy * ty))
        lam = np.linalg.eigvalsh(S)
        lo, hi = float(lam.min()), float(lam.max())
        for q in _PLANES:
            d = float(st.plane_diag[q])
            lo, hi = min(lo, d), max(hi, d)
        pad = pad_rel * (hi - lo)
        lo = max(lo - pad, 1e-12 * hi)
        return lo, hi + pad

    # -- wave-speed machinery -------------------------------------------
    def _frozen_c_ref(self) -> float:
        """rms of c(x, y, 0) over the DoF support points, computed from
        iota plane coordinates (no O(n_dofs) host arrays)."""
        from tpuwave.models.p2_diag import p2_plane_coords
        tot = cnt = 0.0
        for pl, (xs, ys) in p2_plane_coords(self.mesh, jnp.float64).items():
            cv = jnp.broadcast_to(jnp.asarray(
                self._c_eval(xs, ys, 0.0), jnp.float64), xs.shape)
            tot += float(jnp.sum(cv ** 2))
            cnt += cv.size
        return float(np.sqrt(tot / cnt))

    def _tdep_data(self):
        try:
            return self.__tdep_cache
        except AttributeError:
            pass
        self.__tdep_cache = p2_varcoef_data(self.space, gauss_simplex(3))
        return self.__tdep_cache

    def _tdep_scales(self, t):
        """(2, Q, ny, nx) planes det * w_q * c^2(x_ekq, t) (traceable;
        same algebra as models/fast_p2.py::P2FastSolver._tdep_scales)."""
        G, frac, w, det = self._tdep_data()
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
                c2 = jnp.asarray(self._c_eval(
                    x0 + (ix + fx) * hx, y0 + (iy + fy) * hy, t),
                    self.dtype) ** 2
                c2 = jnp.broadcast_to(c2, (ny, nx))
                qrows.append((det * float(w[q])) * c2)
            rows.append(jnp.stack(qrows))
        return jnp.stack(rows)

    def _k_from_scales(self, s) -> _P2Op:
        """Varcoef K operator; lam_hi by the SPD majorant
        K(c) <= max(c^2) K(1), so lam(K(c)) <= max(c^2) * lam(K(1))."""
        G, frac, w, det = self._tdep_data()
        op = P2VarcoefStencil(self.space, s, G, self.dtype)
        wdet = jnp.asarray(det * np.asarray(w), self.dtype)   # (Q,)
        c2max = jnp.max(s / wdet[None, :, None, None])
        return _P2Op(op.apply_canvases, self._pad_diag(op),
                     c2max * self._k_unit_lam)

    def _pad_diag(self, op: P2VarcoefStencil):
        """Assembled diagonal canvases with padding pinned to 1.0 (a zero
        pad diagonal would NaN the Jacobi scaling: inf * 0 residual)."""
        return jnp.where(self.support, op.diagonal_canvases(self._cshape),
                         1.0)

    # -- lazily-built canvas masks (iota, see module docstring) ---------
    @property
    def support(self):
        """(4, Hc, Wc) True on each plane's support window."""
        shapes = p2_plane_shapes(self.nx, self.ny)
        hc, wc = self._cshape
        ri = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0)
        ci = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1)
        masks = []
        for p in _PLANES:
            r, c = shapes[p]
            masks.append((ri >= 1) & (ri < 1 + r) & (ci >= 1) & (ci < 1 + c))
        return jnp.stack(masks)

    @property
    def interior(self):
        """(4, Hc, Wc) True at interior (free) DoFs."""
        from tpuwave.solve.multigrid import _p2_canvas_interior
        return _p2_canvas_interior(self.nx, self.ny, self._cshape)

    @property
    def boundary(self):
        """(4, Hc, Wc) True at Dirichlet DoFs (support minus interior)."""
        return jnp.logical_and(self.support,
                               jnp.logical_not(self.interior))

    # -- canvas layout helpers ------------------------------------------
    def to_flat(self, xc) -> jax.Array:
        """(4, Hc, Wc) canvas stack -> flat (n_dofs,) core.mesh vector."""
        if xc.ndim == 1:
            return xc
        return planes_to_flat(canvases_to_planes(xc, self.nx, self.ny))

    def to_canvas(self, x) -> jax.Array:
        """flat (n_dofs,) -> (4, Hc, Wc) canvas stack."""
        from tpuwave.ops.stencil_p2 import flat_to_planes, planes_to_canvases
        return planes_to_canvases(flat_to_planes(x, self.nx, self.ny),
                                  self._cshape)

    def _shard_c(self, x):
        """Pin the device-mesh canvas layout inside the jitted step
        (no-op when unsharded)."""
        if self._canvas_sharding is None:
            return x
        return jax.lax.with_sharding_constraint(x, self._canvas_sharding)

    def _place(self, x):
        if self._canvas_sharding is None:
            return x
        return jax.device_put(x, self._canvas_sharding)

    def _canvas_coords(self):
        """Per-plane (x, y) canvas coordinate arrays from iota."""
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        hc, wc = self._cshape
        ri = jax.lax.broadcasted_iota(self.dtype, (hc, wc), 0) - 1.0
        ci = jax.lax.broadcasted_iota(self.dtype, (hc, wc), 1) - 1.0
        return [(x0 + hx * (ci + P2_PLANE_OFFS[p][0]),
                 y0 + hy * (ri + P2_PLANE_OFFS[p][1])) for p in _PLANES]

    def _cdata(self, expr, t):
        """expr(x, y, t) at ALL canvas support points (zero padding) —
        used for u0/v0 interpolation, where every support value is
        consumed."""
        hc, wc = self._cshape
        if expr.is_zero:
            return jnp.zeros((4, hc, wc), self.dtype)
        vals = jnp.stack([jnp.broadcast_to(jnp.asarray(
            expr.evaluate(xs, ys, t), self.dtype), (hc, wc))
            for xs, ys in self._canvas_coords()])
        return jnp.where(self.support, vals, 0.0)

    def _bdata(self, expr, t):
        """expr(x, y, t) on the BOUNDARY DoFs only (zeros elsewhere),
        evaluated on the eight O(perimeter) strip families and scattered
        into a canvas — every consumer of g/dgdt/accel-BC data masks
        with ``self.boundary``, so this replaces full-canvas expression
        evaluation (4 x (Hc, Wc) elementwise passes per use at bench
        scale) with O(perimeter) work + one canvas materialisation."""
        hc, wc = self._cshape
        if expr.is_zero:
            return jnp.zeros((4, hc, wc), self.dtype)
        return self._strip_canvas(self._edge_vals(expr, t))

    # -- boundary strip families (V perimeter, H rows, W columns) -------
    @property
    def _strip_len(self):
        return max(self.nx + 1, self.ny + 1)

    def _strip_coords(self):
        """(xs, ys) per strip family: V-bottom/top/left/right,
        H-bottom/top, W-left/right."""
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        nx, ny = self.nx, self.ny
        xs_v = x0 + hx * jnp.arange(nx + 1, dtype=self.dtype)
        ys_v = y0 + hy * jnp.arange(ny + 1, dtype=self.dtype)
        xs_h = x0 + hx * (jnp.arange(nx, dtype=self.dtype) + 0.5)
        ys_w = y0 + hy * (jnp.arange(ny, dtype=self.dtype) + 0.5)
        x1 = jnp.asarray(x0 + hx * nx, self.dtype)
        y1 = jnp.asarray(y0 + hy * ny, self.dtype)
        x0 = jnp.asarray(x0, self.dtype)
        y0 = jnp.asarray(y0, self.dtype)
        return [(xs_v, jnp.full_like(xs_v, y0)),       # V-bottom
                (xs_v, jnp.full_like(xs_v, y1)),       # V-top
                (jnp.full_like(ys_v, x0), ys_v),       # V-left
                (jnp.full_like(ys_v, x1), ys_v),       # V-right
                (xs_h, jnp.full_like(xs_h, y0)),       # H-bottom
                (xs_h, jnp.full_like(xs_h, y1)),       # H-top
                (jnp.full_like(ys_w, x0), ys_w),       # W-left
                (jnp.full_like(ys_w, x1), ys_w)]       # W-right

    def _edge_vals(self, expr, t):
        """(8, L) strip-family values of expr(x, y, t), zero-padded."""
        L = self._strip_len
        if expr.is_zero:
            return jnp.zeros((8, L), self.dtype)
        rows = []
        for xs, ys in self._strip_coords():
            v = jnp.broadcast_to(jnp.asarray(expr.evaluate(xs, ys, t),
                                             self.dtype), xs.shape)
            rows.append(jnp.zeros(L, self.dtype).at[:v.shape[0]].set(v))
        return jnp.stack(rows)

    def _canvas_edges(self, xc):
        """(8, L) boundary-strip extraction of a canvas stack."""
        nx, ny = self.nx, self.ny
        L = self._strip_len
        z = jnp.zeros(L, self.dtype)
        return jnp.stack([
            z.at[:nx + 1].set(xc[0, 1, 1:nx + 2]),          # V-bottom
            z.at[:nx + 1].set(xc[0, 1 + ny, 1:nx + 2]),     # V-top
            z.at[:ny + 1].set(xc[0, 1:ny + 2, 1]),          # V-left
            z.at[:ny + 1].set(xc[0, 1:ny + 2, 1 + nx]),     # V-right
            z.at[:nx].set(xc[1, 1, 1:nx + 1]),              # H-bottom
            z.at[:nx].set(xc[1, 1 + ny, 1:nx + 1]),         # H-top
            z.at[:ny].set(xc[2, 1:ny + 1, 1]),              # W-left
            z.at[:ny].set(xc[2, 1:ny + 1, 1 + nx]),         # W-right
        ])

    def _strip_canvas(self, strips):
        """(8, L) strips -> (4, Hc, Wc) canvas stack with the values on
        the boundary DoFs (zeros elsewhere; V corners consistent — the
        four V families agree there). Built as select chains over 1-D
        scatters + broadcasts: chained full-canvas `.at[].set` scatters
        cost a canvas copy EACH (measured 24 ms at 4096^2); the selects
        fuse into ~one pass."""
        nx, ny = self.nx, self.ny
        hc, wc = self._cshape
        ri = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0)
        ci = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1)
        z = jnp.zeros((hc, wc), self.dtype)

        def row_b(s, n):
            v = jnp.zeros(wc, self.dtype).at[1:1 + n].set(s[:n])
            return jnp.broadcast_to(v[None, :], (hc, wc))

        def col_b(s, n):
            v = jnp.zeros(hc, self.dtype).at[1:1 + n].set(s[:n])
            return jnp.broadcast_to(v[:, None], (hc, wc))

        v_pl = jnp.where(
            ci == 1, col_b(strips[2], ny + 1),
            jnp.where(ci == 1 + nx, col_b(strips[3], ny + 1),
                      jnp.where(ri == 1, row_b(strips[0], nx + 1),
                                jnp.where(ri == 1 + ny,
                                          row_b(strips[1], nx + 1), z))))
        h_pl = jnp.where(ri == 1, row_b(strips[4], nx),
                         jnp.where(ri == 1 + ny, row_b(strips[5], nx), z))
        w_pl = jnp.where(ci == 1, col_b(strips[6], ny),
                         jnp.where(ci == 1 + nx, col_b(strips[7], ny), z))
        return jnp.stack([v_pl, h_pl, w_pl, z])

    # -- operators -------------------------------------------------------
    @property
    def _mass_op(self) -> _P2Op:
        return _P2Op(self._mass_apply, self._plane_diag(self.mass),
                     self._mass_lam)

    def _plane_diag(self, st: P2PlaneStencil):
        return jnp.asarray([st.plane_diag[q] for q in _PLANES],
                           self.dtype).reshape(4, 1, 1)

    @property
    def _prec_mass(self):
        return 1.0 / self._plane_diag(self.mass)

    def _k_at(self, t) -> _P2Op:
        if self._c_mode == "const":
            return _P2Op(self._stiff_apply,
                         self._plane_diag(self._stiff), self._stiff_lam)
        if self._c_mode == "varcoef":
            return self._k_from_scales(self._tdep_scales(0.0))
        return self._k_from_scales(self._tdep_scales(t))

    def _system_of(self, k_op: _P2Op) -> _P2Op:
        """M + coef * K as a single canvas operator (merged constant
        stencil when K is constant-coefficient)."""
        coef = self.coef
        if coef == 0.0:   # theta = 0 / beta = 0: the system is bare mass
            return self._mass_op
        if self._sys_stencil is not None:
            return _P2Op(self._sys_apply,
                         self._plane_diag(self._sys_stencil), self._sys_lam)
        m_apply = self._mass_apply

        def apply(xc):
            return m_apply(xc) + coef * k_op.apply(xc)
        diag = jnp.where(self.support,
                         self._plane_diag(self.mass) + coef * k_op.diag,
                         1.0)
        return _P2Op(apply, diag, self._mass_lam + coef * k_op.lam_hi)

    def _sys_precond(self, sys_op: _P2Op):
        """Resolve the preconditioner for (this step's) system operator."""
        if self.precond == "mg":
            return self._prec_sys
        inv_diag = 1.0 / sys_op.diag
        if self.precond == "jacobi":
            return inv_diag
        # chebyshev on the CONSTRAINED apply; the Gershgorin bound of the
        # unconstrained operator majorises it (pinned rows pure diagonal)
        from tpuwave.solve.chebyshev import chebyshev_apply
        apply_c = self._constrained_apply(sys_op)
        dmin = jnp.min(jnp.where(self.support, sys_op.diag, jnp.inf))
        lmax = sys_op.lam_hi / dmin
        deg = self.cheby_degree

        def prec(r):
            return chebyshev_apply(apply_c, inv_diag, r, lambda_max=lmax,
                                   degree=deg)
        return prec

    # -- problem data ----------------------------------------------------
    def _load_data(self):
        try:
            return self.__load_cache
        except AttributeError:
            pass
        from tpuwave.ops.stencil import P1_CLASS_CORNERS
        quad = gauss_simplex(3)
        sh = self.space.shape_at(quad)
        vals = np.asarray(sh.values)                    # (Q, 6)
        ref = np.asarray(quad.points)
        frac = np.empty((2, len(ref), 2))
        for k in range(2):
            c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
            frac[k] = (c0[None]
                       + ref[:, 0:1] * (c1 - c0)[None]
                       + ref[:, 1:2] * (c2_ - c0)[None])
        self.__load_cache = (vals, frac, np.asarray(quad.weights),
                             float(self.mesh.det_j))
        return self.__load_cache

    def grid_load(self, t):
        """Quadrature-consistent P2 load vector on the canvases, by the
        assembly r+1 rule — the plane counterpart of the reference's
        per-step forcing cell loop (WaveTheta.cpp:164-172):
        L_i = sum_T det w_q phi_i(q) f(x_Tq), scattered to the six
        incident plane positions by slice-adds at the (1, 1) embedding."""
        vals, frac, w, det = self._load_data()
        ny, nx = self.ny, self.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 1)
        iy = jax.lax.broadcasted_iota(self.dtype, (ny, nx), 0)
        idx = {p: i for i, p in enumerate(_PLANES)}
        out = [jnp.zeros(self._cshape, self.dtype) for _ in _PLANES]
        f_eval = self._f.evaluate
        for k in range(2):
            pos = _P2_POSITIONS[k]
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                fv = jnp.broadcast_to(jnp.asarray(
                    f_eval(x0 + (ix + fx) * hx, y0 + (iy + fy) * hy, t),
                    self.dtype), (ny, nx))
                for a in range(6):
                    pa, (ox, oy) = pos[a]
                    out[idx[pa]] = out[idx[pa]].at[
                        1 + oy:1 + oy + ny, 1 + ox:1 + ox + nx].add(
                        (det * float(w[q]) * float(vals[q, a])) * fv)
        return jnp.stack(out)

    # -- Dirichlet elimination ------------------------------------------
    def _constrained_stencil_apply(self, st: P2PlaneStencil):
        """Constrained canvas apply of a CONSTANT block-stencil (the mg
        smoother)."""
        diag = self._plane_diag(st)

        def apply_c(w):
            return jnp.where(self.interior,
                             st.apply_canvases(jnp.where(self.interior,
                                                         w, 0.0)),
                             diag * w)
        return apply_c

    def _rhs_apply(self, op: _P2Op):
        """Interior-masked, unmasked-input apply for rhs assembly (the
        operands carry true boundary values; every consumer is
        interior-masked downstream by the elimination)."""
        interior = self.interior

        def apply_i(xc):
            return jnp.where(interior, op.apply(xc), 0.0)
        return apply_i

    def _constrained_apply(self, op: _P2Op):
        interior = self.interior

        def apply_c(w):
            return jnp.where(interior,
                             op.apply(jnp.where(interior, w, 0.0)),
                             op.diag * w)
        return apply_c

    def _constrain(self, op: _P2Op, rhs, g_cv, x_prev, *, g_zero: bool):
        """Canvas form of ops.operators.constrain_system (deal.II
        apply_boundary_values with eliminate_columns=true). ``g_zero``
        statically skips the lift apply for homogeneous data."""
        interior = self.interior
        apply_c = self._constrained_apply(op)
        if g_zero:
            rhs_c = jnp.where(interior, rhs, 0.0)
            x0 = jnp.where(interior, x_prev, 0.0)
            return apply_c, rhs_c, x0
        g_ext = jnp.where(self.boundary, g_cv, 0.0)
        # the boundary lift A(g 1_b) runs through the interior-masked
        # unmasked-input apply — algebraically identical to
        # where(interior, rhs - A g, diag g)
        rhs_c = jnp.where(interior, rhs, op.diag * g_ext) \
            - self._rhs_apply(op)(g_ext)
        x0 = jnp.where(self.boundary, g_ext,
                       jnp.where(interior, x_prev, 0.0))
        return apply_c, rhs_c, x0

    def _abs_tol(self, rhs, x0, op: _P2Op):
        """Reference 1e-12 floor in f64; backward-error floor in f32
        (models/fast.py::_solve_abs_tol rationale)."""
        if self.dtype == jnp.float64:
            return 1e-12
        eta = 8 * float(jnp.finfo(self.dtype).eps)
        return eta * (op.lam_hi * jnp.linalg.norm(x0)
                      + jnp.linalg.norm(rhs))

    def _solve(self, op: _P2Op, rhs, g_cv, x_prev, precond, *,
               g_zero: bool):
        apply_c, rhs_c, x0 = self._constrain(op, rhs, g_cv, x_prev,
                                             g_zero=g_zero)
        if self._solver == "cheby":
            return self._solve_cheby(op, apply_c, rhs_c, x0)
        return pcg(apply_c, rhs_c, x0, precond_inv_diag=precond,
                   abs_tol=self._abs_tol(rhs_c, x0, op),
                   max_iter=self._max_iter)

    def _solve_cheby(self, op: _P2Op, apply_c, rhs_c, x0):
        """Restarted Chebyshev iteration on the constrained canvas system
        (--solver cheby at R = 2): data-independent coefficient schedules
        from the 4x4 block-symbol bounds (no dot products inside a
        block), blocks of ``cheby_solver_degree`` iterations between
        residual checks — the P2 counterpart of models/fast_engine.py::
        _solve_cheby with the same ReductionControl stopping contract.
        The mass v-solve keeps the parity CG (its conditioning needs ~
        the same iterations either way)."""
        from tpuwave.solve.cheby_iter import chebyshev_solve
        if op.apply is not self._sys_apply:
            # non-system solves (bare mass) stay on the CG contract
            return pcg(apply_c, rhs_c, x0,
                       precond_inv_diag=1.0 / op.diag,
                       abs_tol=self._abs_tol(rhs_c, x0, op),
                       max_iter=self._max_iter)
        lo, hi = self._cheby_bounds
        return chebyshev_solve(apply_c, rhs_c, x0, lam_min=lo, lam_max=hi,
                               degree=self._cheby_solver_degree,
                               abs_tol=self._abs_tol(rhs_c, x0, op),
                               max_iter=self._max_iter)

    def step(self, state: FastGridState, t):
        return self._step(state, t)


class FastP2ThetaSolver(_FastP2EngineBase):
    """theta-method on the P2 canvases — parity algebra of models/theta.py
    (reference WaveTheta.cpp:119-339) at plane-stencil speed, including
    time-dependent Dirichlet g on vertex AND edge-midpoint planes,
    theta-weighted forcing, and variable / time-dependent wave speed."""

    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return "-theta" + clean_double(self.theta)

    def initial_state(self) -> FastGridState:
        p = self.disc.params
        u0 = self._place(self._cdata(p.u0, 0.0))
        v0 = self._place(self._cdata(p.v0, 0.0))
        pay = self._tdep_scales(0.0) if self._c_mode == "tdep" else None
        return FastGridState(u=u0, v=v0, a=jnp.zeros_like(u0),
                             k_payload=pay)

    def _step_impl(self, state: FastGridState, t):
        dt, th = self.dt, self.theta
        u, v = self._shard_c(state.u), self._shard_c(state.v)

        pay_np1 = None
        if self._c_mode == "tdep":
            # K^n from the carried payload (built as K^{n+1} last step);
            # K^{n+1} rebuilt from c(x, y, t) — one build per step
            k_n = (self._k_from_scales(state.k_payload)
                   if state.k_payload is not None
                   else self._k_at(t - dt))
            pay_np1 = self._tdep_scales(t)
            k_np1 = self._k_from_scales(pay_np1)
        else:
            k_n = k_np1 = self._k_at(t)
        sys_op = self._system_of(k_np1)
        prec_sys = self._sys_precond(sys_op)

        m_rhs = self._rhs_apply(self._mass_op)
        mu, ku = m_rhs(u), self._rhs_apply(k_n)(u)
        mv = m_rhs(v)

        if self._f is not None:
            f_avg = (th * self.grid_load(t)
                     + (1.0 - th) * self.grid_load(t - dt))
        else:
            f_avg = None

        # u system (WaveTheta.cpp:119-186, 251-294)
        rhs_u = mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv
        if f_avg is not None:
            rhs_u = rhs_u + (th * dt * dt) * f_avg
        res_u = self._solve(sys_op, rhs_u, self._bdata(self._g, t), u,
                            prec_sys, g_zero=self._g.is_zero)
        u_new = self._shard_c(res_u.x.astype(self.dtype))

        # v system (WaveTheta.cpp:188-249, 296-339)
        rhs_v = mv - (dt * (1.0 - th)) * ku \
            - (dt * th) * self._rhs_apply(k_np1)(u_new)
        if f_avg is not None:
            rhs_v = rhs_v + dt * f_avg
        res_v = self._solve(self._mass_op, rhs_v,
                            self._bdata(self._dgdt, t), v,
                            self._prec_mass, g_zero=self._dgdt.is_zero)
        v_new = self._shard_c(res_v.x.astype(self.dtype))

        new_state = FastGridState(u=u_new, v=v_new, a=state.a,
                                  k_payload=pay_np1)
        info = {
            "iterations_1": res_u.iterations,
            "iterations_2": res_v.iterations,
            "norm_u": jnp.linalg.norm(u_new),
            "norm_v": jnp.linalg.norm(v_new),
        }
        return new_state, info


class FastP2NewmarkSolver(_FastP2EngineBase):
    """Newmark-beta on the P2 canvases — parity algebra of
    models/newmark.py (reference WaveNewmark.cpp:116-390): consistent-mass
    a-solve (also at beta = 0), the derived acceleration boundary
    formulas, consistent a0, per-step forcing, variable / time-dependent
    wave speed."""

    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave.utils.naming import clean_double
        return ("-gamma" + clean_double(self.gamma)
                + "-beta" + clean_double(self.beta))

    # -- acceleration boundary data (WaveNewmark.cpp:177-262) ----------
    def _accel_bc(self, t, z):
        dt = self.dt
        if self.beta > 1e-12:
            return (self._bdata(self._g, t) - z) / (self.beta * dt * dt)
        g_p = self._bdata(self._g, t)
        g_0 = self._bdata(self._g, t - dt)
        g_m = self._bdata(self._g, t - 2.0 * dt)
        return (g_p - 2.0 * g_0 + g_m) / (dt * dt)

    def initial_state(self) -> FastGridState:
        """u0, v0 interpolation + consistent M a0 = F(0) - K(0) u0 with
        a0|b = (g(dt) - 2 g(0) + g(-dt)) / dt^2 (reference :298-390)."""
        p, dt = self.disc.params, self.dt
        u0 = self._place(self._cdata(p.u0, 0.0))
        v0 = self._place(self._cdata(p.v0, 0.0))
        rhs = -self._rhs_apply(self._k_at(0.0))(u0)
        if self._f is not None:
            rhs = rhs + self.grid_load(0.0)
        g_p = self._bdata(self._g, dt)
        g_0 = self._bdata(self._g, 0.0)
        g_m = self._bdata(self._g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc, jnp.zeros_like(u0),
                          self._prec_mass, g_zero=self._g.is_zero)
        self.initial_iterations = int(res.iterations)
        return FastGridState(u=u0, v=v0,
                             a=self._place(res.x.astype(self.dtype)))

    def _step_impl(self, state: FastGridState, t):
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u, v = self._shard_c(state.u), self._shard_c(state.v)
        a = self._shard_c(state.a)

        # the elastic force acts at t^{n+1} (models/newmark.py tdep note)
        k_np1 = self._k_at(t)
        sys_op = self._system_of(k_np1)
        prec_sys = self._sys_precond(sys_op)

        # z = u + dt v + dt^2 (1/2 - beta) a  (WaveNewmark.cpp:123-126)
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = -self._rhs_apply(k_np1)(z)
        if self._f is not None:
            rhs = rhs + self.grid_load(t)

        a_bc = self._accel_bc(t, z)
        # NB for beta > 0 the derived BC (g - z)/(beta dt^2) is nonzero
        # even for g == 0 whenever the state is nonzero on the boundary
        # (inconsistent initial data decays to g, reference
        # WaveNewmark.cpp:196-210) — the homogeneous shortcut applies
        # only to the beta = 0 second-difference formula
        res = self._solve(sys_op, rhs, a_bc, a, prec_sys,
                          g_zero=self._g.is_zero and beta <= 1e-12)
        a_new = self._shard_c(res.x.astype(self.dtype))

        u_new = (z + (beta * dt * dt) * a_new).astype(self.dtype)
        v_new = (v + dt * ((1.0 - gamma) * a + gamma * a_new)).astype(
            self.dtype)
        new_state = FastGridState(u=u_new, v=v_new, a=a_new)
        info = {
            "iterations_1": res.iterations,
            "iterations_2": jnp.asarray(0, jnp.int32),
            "norm_u": jnp.linalg.norm(u_new),
            "norm_v": jnp.linalg.norm(v_new),
        }
        return new_state, info
