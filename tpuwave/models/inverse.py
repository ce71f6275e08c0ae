"""Differentiable wave propagation + full-waveform inversion (FWI).

A capability the C++/MPI reference cannot offer: the whole forward model
(P1 FEM, lumped-mass leapfrog, reference scheme of WaveNewmark.cpp:24-37 at
beta=0 with row-sum lumping) is a pure JAX function of the per-cell squared
wave speed ``c2_cell``, so ``jax.grad`` differentiates the data misfit
through the entire time loop — the adjoint-state method for free, compiled
by XLA. Memory for reverse mode is kept linear-in-steps-but-small via
``jax.checkpoint`` on the scan body (recompute-in-backward), the standard
remat trade.

Forward model
-------------
    M_L u''  +  K(c2) u = w(t) e_src,     u|dOmega = 0,   u(0)=u0, u'(0)=0

with K(c2) the P1 stiffness assembled matrix-free per element
(gather -> scaled class matvec -> segment_sum, ops/operators.py): for P1 the
element stiffness factorises as ``K_e = s_e * G_class`` with
``s_e = detJ * w_sum * c2_e`` (ops/assembly.py::element_stiffness_scaled),
so c2 enters the compiled graph only through the per-element scale — the
gradient wrt c2 costs one extra gather/scatter in the backward pass.

Leapfrog recurrence (the framework's production explicit scheme,
models/fast.py::leapfrog_step, equivalent to reference central differences):

    u^{n+1} = 2 u^n - u^{n-1} + dt^2 M_L^{-1} (w_n e_src - K u^n)

with homogeneous Dirichlet rows pinned each step. Receiver traces are the
per-step solution samples at chosen vertices; the misfit is the usual
0.5 * sum (d_sim - d_obs)^2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuwave.config import default_float
from tpuwave.core.mesh import FeSpace, StructuredTriMesh
from tpuwave.core.quadrature import gauss_simplex

__all__ = ["FwiProblem", "ricker_wavelet", "lowpass_time"]


def ricker_wavelet(times, peak_freq: float, delay: Optional[float] = None):
    """Ricker (Mexican-hat) source wavelet w(t), the standard FWI source."""
    times = np.asarray(times, dtype=np.float64)
    t0 = delay if delay is not None else 1.2 / peak_freq
    arg = (np.pi * peak_freq * (times - t0)) ** 2
    return (1.0 - 2.0 * arg) * np.exp(-arg)


def lowpass_time(x, dt: float, cutoff: float, axis: int = 0,
                 rolloff: float = 0.2):
    """Zero-phase low-pass along a time axis (host-side preprocessing).

    Real-FFT filter with a raised-cosine rolloff: |H(f)| = 1 for
    f <= (1-rolloff)*cutoff, cosine-tapers to 0 at cutoff (the taper
    avoids the brick-wall's Gibbs ringing). Used by multiscale FWI to
    build the per-stage data/wavelet bands.
    """
    x = np.asarray(x)
    n = x.shape[axis]
    freqs = np.fft.rfftfreq(n, d=dt)
    f0 = (1.0 - rolloff) * cutoff
    h = np.ones_like(freqs)
    band = (freqs > f0) & (freqs < cutoff)
    h[band] = 0.5 * (1.0 + np.cos(np.pi * (freqs[band] - f0)
                                  / max(cutoff - f0, 1e-300)))
    h[freqs >= cutoff] = 0.0
    shape = [1] * x.ndim
    shape[axis] = len(freqs)
    return np.fft.irfft(np.fft.rfft(x, axis=axis) * h.reshape(shape),
                        n=n, axis=axis)


def envelope_time(x, axis: int = -2, eps: float = 1e-30):
    """Instantaneous-amplitude envelope |x + i H(x)| along a time axis
    (H = Hilbert transform, computed by the FFT analytic-signal trick).
    Differentiable (jnp.fft), so it composes with jax.grad; ``eps``
    regularises the |·| kink at exact zeros."""
    x = jnp.asarray(x)
    n = x.shape[axis]
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    shape = [1] * x.ndim
    shape[axis] = n
    a = jnp.fft.ifft(jnp.fft.fft(x, axis=axis) * h.reshape(shape),
                     axis=axis)
    return jnp.sqrt(jnp.real(a) ** 2 + jnp.imag(a) ** 2 + eps)


def trace_misfit(sim, obs, kind: str = "l2", *, huber_delta: float = 1.0,
                 time_axis: int = -2):
    """Data-misfit functionals over receiver gathers (last two axes =
    (n_steps, n_rec); a leading shot axis is fine).

    - ``"l2"``: 0.5‖r‖² — the classic least-squares objective.
    - ``"huber"``: quadratic for |r| ≤ huber_delta, linear beyond — the
      outlier-robust objective for noise-bursty field data (Guitton &
      Symes 2003).
    - ``"envelope"``: 0.5‖env(sim) − env(obs)‖² on the instantaneous
      amplitudes — insensitive to phase/traveltime error of up to a
      full cycle, the classic cycle-skipping mitigation (Bozdağ et al.
      2011); pairs well as the first stage before an L2 polish.
    """
    r = jnp.asarray(sim) - jnp.asarray(obs)
    if kind == "l2":
        return 0.5 * jnp.sum(r * r)
    if kind == "huber":
        d = jnp.asarray(huber_delta, r.dtype)
        q = jnp.abs(r)
        return jnp.sum(jnp.where(q <= d, 0.5 * q * q, d * (q - 0.5 * d)))
    if kind == "envelope":
        e = (envelope_time(sim, axis=time_axis)
             - envelope_time(obs, axis=time_axis))
        return 0.5 * jnp.sum(e * e)
    raise ValueError(f"unknown misfit kind {kind!r}")


class FwiResult(NamedTuple):
    c2: jax.Array            # recovered per-cell squared wave speed
    misfits: np.ndarray      # misfit value per iteration (n_iter,)
    wavelet: Optional[jax.Array] = None  # co-estimated source (if requested)


class FwiProblem:
    """Differentiable forward model + adjoint gradients + inversion loop.

    Parameters
    ----------
    nel : (nx, ny) structured-rectangle resolution (2 triangles per cell,
        reference GridGenerator::subdivided_hyper_rectangle_with_simplices,
        WaveEquationBase.cpp:42-46).
    geometry : ((x0, y0), (x1, y1)) bounding box.
    dt, n_steps : time grid (t_n = n dt, n = 1..n_steps recorded).
    source : (x, y) source location, snapped to the nearest vertex.
    receivers : sequence of (x, y) receiver locations, snapped likewise —
        or sampled at the exact locations by P1 barycentric interpolation
        with ``interp_receivers=True`` (differentiable; both adjoints).
    wavelet : (n_steps,) nodal force time series at the source (default: a
        Ricker wavelet auto-scaled to the time grid).
    remat : checkpoint the scan body (recompute forward states in the
        backward pass instead of storing every intermediate).
    sponge_width : width (in physical units) of an absorbing sponge layer
        along the boundary; 0 disables it (hard reflecting Dirichlet wall).
        Inside the layer a damping sigma(x) = sponge_strength * q(x)^2 is
        applied (q ramps 0 -> 1 toward the wall), turning the recurrence
        into the damped leapfrog
        (1 + s) u^{n+1} = 2 u^n - (1 - s) u^{n-1} + dt^2 M_L^{-1} (...),
        s = sigma dt / 2 — the standard sponge/Cerjan absorbing boundary
        for truncating open domains (seismic-imaging practice).
    engine : "scatter" (gather -> scaled class matvec -> segment_sum, the
        reference-parity form), "grid" (scatter-free slab multiply-adds
        on (ny, nx) coefficient planes), or "stencil" (assembled
        variable-coefficient 9-point stencil: coefficient planes built
        once per trajectory, 9 multiply-roll-adds per step). All are
        equally differentiable in c2.
    adjoint : "remat" (default; jax autodiff through the checkpointed
        scan — stores two fields per step) or "reversal" (hand-written
        adjoint-state method via jax.custom_vjp: the backward pass
        RECONSTRUCTS forward states by running the time-reversible
        leapfrog backwards from the final pair, so memory is O(1) in the
        step count — the production seismic-imaging technique. Requires
        engine="stencil" and the default zero initial condition. With a
        sponge the damped strip is not reversible, so the forward pass
        saves part of the wavefield each step and the
        reconstruction overwrites it from storage ("boundary saving") —
        far below remat's O(n_vertices * n_steps) memory. See
        ``boundary_save`` for the two storage flavours.
    boundary_save : what the reversal+sponge forward pass saves:
        "strip" (default — every sigma > 0 vertex, gradients exact
        everywhere) or "ring" (only the sponge's innermost layer — 2
        grid rows + 2 grid cols hugging the sigma == 0 rectangle — with
        the deeper sponge zeroed during reconstruction: memory
        O(perimeter * n_steps), gradients exact on
        ``sponge_interior_cell_mask`` i.e. the whole physical region,
        approximate inside the sponge — the classic seismic recipe).
    """

    def __init__(self, nel: Tuple[int, int], geometry, dt: float,
                 n_steps: int, *, source: Tuple[float, float],
                 receivers: Sequence[Tuple[float, float]],
                 wavelet: Optional[np.ndarray] = None,
                 dtype=None, remat: bool = True,
                 sponge_width: float = 0.0,
                 sponge_strength: float = 30.0,
                 engine: str = "scatter",
                 adjoint: str = "remat",
                 boundary_save: str = "strip",
                 interp_receivers: bool = False):
        if engine not in ("scatter", "grid", "stencil"):
            raise ValueError(f"unknown engine {engine!r}")
        if adjoint not in ("remat", "reversal"):
            raise ValueError(f"unknown adjoint {adjoint!r}")
        if boundary_save not in ("strip", "ring"):
            raise ValueError(f"unknown boundary_save {boundary_save!r}")
        if adjoint == "reversal" and engine != "stencil":
            raise ValueError("adjoint='reversal' needs engine='stencil' "
                             "(the reconstruction runs on the assembled "
                             "stencil planes)")
        self.engine = engine
        self.adjoint = adjoint
        self.dtype = dtype or default_float()
        self.mesh = StructuredTriMesh(tuple(nel), geometry)
        self.space = FeSpace(self.mesh, 1)
        self.dt = float(dt)
        self.n_steps = int(n_steps)
        self.remat = bool(remat)

        quad = gauss_simplex(2)  # assembly rule for r=1 (reference :82)
        sh = self.space.shape_at(quad)
        grads = self.space.physical_grads(sh)        # (2, Q, 3, 2)
        # P1: q-independent physical gradients -> K_e = s_e * G_class
        g = np.einsum("cqia,cqja->cqij", grads, grads)[:, 0]  # (2, 3, 3)
        self._g_class_np = g
        self._g_class = jnp.asarray(g, dtype=self.dtype)
        self._w_sum = float(np.sum(quad.weights))    # reference-triangle area
        self._det_j = float(self.mesh.det_j)

        cells = np.asarray(self.mesh.cells, dtype=np.int32)  # (E, 3)
        self._cells = jnp.asarray(cells)
        self.n_cells = cells.shape[0]
        self.n_vertices = self.mesh.n_vertices

        # row-sum lumped mass (c-independent): each triangle puts detJ/6 on
        # each of its vertices (ops/stencil.py::lumped_mass_grid, exact
        # including boundary rows)
        lumped = np.zeros(self.n_vertices)
        np.add.at(lumped, cells.ravel(),
                  np.full(cells.size, self._det_j / 6.0))
        self._inv_lumped = jnp.asarray(1.0 / lumped, dtype=self.dtype)

        self._interior = jnp.asarray(
            ~self.mesh.boundary_vertex_mask, dtype=self.dtype)

        # sponge/Cerjan damping profile sigma(x) per vertex (0 outside the
        # layer); quadratic ramp toward the wall
        coords_all = self.mesh.vertex_coords
        (x0, y0), (x1, y1) = (self.mesh.origin,
                              (self.mesh.origin[0] + self.mesh.extent[0],
                               self.mesh.origin[1] + self.mesh.extent[1]))
        if sponge_width > 0.0:
            d_wall = np.minimum.reduce([coords_all[:, 0] - x0,
                                        x1 - coords_all[:, 0],
                                        coords_all[:, 1] - y0,
                                        y1 - coords_all[:, 1]])
            q = np.clip(1.0 - d_wall / float(sponge_width), 0.0, 1.0)
            sigma = float(sponge_strength) * q * q
        else:
            sigma = np.zeros(self.n_vertices)
        s_half = 0.5 * self.dt * sigma
        self._damp_num = jnp.asarray(1.0 - s_half, dtype=self.dtype)
        self._damp_den = jnp.asarray(1.0 / (1.0 + s_half), dtype=self.dtype)
        # boundary saving for the time-reversal adjoint with a sponge: the
        # damped strip (sigma > 0) is NOT reversible, so the forward pass
        # stores part of the wavefield each step and the reconstruction
        # overwrites it from storage — the production seismic-imaging
        # technique. Two flavours:
        #   "strip": save every sigma > 0 vertex — gradients exact
        #       everywhere incl. inside the sponge; O(|strip| * n_steps).
        #   "ring": save only the interface ring (the sponge's innermost
        #       layer: 2 full rows + 2 full cols hugging the sigma == 0
        #       rectangle) and ZERO the deeper sponge during
        #       reconstruction — O(perimeter * n_steps) memory; gradients
        #       exact at every cell whose 3 vertices have sigma == 0
        #       (sponge_interior_cell_mask), approximate in the sponge.
        # Saved values live in rectangular grid blocks so the per-step
        # save/restore is static slices + dynamic_update_slices, NOT a
        # flat gather/scatter (an index gather over ~19% of the grid per
        # step costs more than the whole remat adjoint; slices are
        # ~free).
        self.boundary_save = boundary_save
        self._sigma_np = sigma
        self._sponge_keep = None
        self._sponge_rects = None
        if sponge_width > 0.0 and adjoint == "reversal":
            nxv, nyv = self.mesh.nx + 1, self.mesh.ny + 1
            sig_g = sigma.reshape(nyv, nxv)
            zr = np.where((sig_g == 0.0).any(axis=1))[0]
            zc = np.where((sig_g == 0.0).any(axis=0))[0]
            if zr.size == 0 or zc.size == 0:
                raise ValueError("sponge_width covers the whole domain; "
                                 "the reversal adjoint needs a "
                                 "sigma == 0 interior")
            r0, r1, c0, c1 = (int(zr[0]), int(zr[-1]),
                              int(zc[0]), int(zc[-1]))
            self._sponge_rect = (r0, r1, c0, c1)
            if boundary_save == "ring":
                # the {sigma == 0} set is a rectangle (sigma is a
                # min-of-wall-distances profile); save its 1-ring — 2
                # full-width rows + 2 full-height cols (full extents so
                # the diagonal (1,1)/(-1,-1) stencil corners are covered
                # and the fused kernels' whole-row/col restores match
                # this reference algorithm exactly)
                rects = [(r0 - 1, r0, 0, nxv), (r1 + 1, r1 + 2, 0, nxv),
                         (0, nyv, c0 - 1, c0), (0, nyv, c1 + 1, c1 + 2)]
                keep = np.ones((nyv, nxv))
                keep[sig_g > 0.0] = 0.0
                for (a, b, c, d) in rects:
                    keep[a:b, c:d] = 1.0
                self._sponge_keep = jnp.asarray(keep.reshape(-1),
                                                self.dtype)
            else:
                # every sigma > 0 vertex = the 4 bands around the
                # sigma == 0 rectangle
                rects = [(0, r0, 0, nxv), (r1 + 1, nyv, 0, nxv),
                         (r0, r1 + 1, 0, c0), (r0, r1 + 1, c1 + 1, nxv)]
            self._sponge_rects = [(a, b, c, d) for (a, b, c, d) in rects
                                  if (b - a) > 0 and (d - c) > 0]
            self._sponge_saved_size = sum(
                (b - a) * (d - c) for (a, b, c, d) in self._sponge_rects)
            if boundary_save == "ring":
                src_v = int(np.argmin(np.sum(
                    (self.mesh.vertex_coords - np.asarray(source)) ** 2,
                    axis=1)))
                if sigma[src_v] > 0.0:
                    raise ValueError(
                        "boundary_save='ring' needs the source outside "
                        "the sponge (the undamped reconstruction formula "
                        "re-applies the source term at sigma == 0 points "
                        "only)")

        coords = self.mesh.vertex_coords
        self.source_vertex = int(np.argmin(
            np.sum((coords - np.asarray(source)) ** 2, axis=1)))
        self.receiver_vertices = jnp.asarray(
            [int(np.argmin(np.sum((coords - np.asarray(r)) ** 2, axis=1)))
             for r in receivers], dtype=jnp.int32)
        self.interp_receivers = bool(interp_receivers)
        if interp_receivers:
            # P1 barycentric sampling at the exact receiver locations:
            # y_r = sum_j w_rj u[v_rj] over the containing triangle
            # (reference point_value semantics, WaveEquationBase.cpp:170-222)
            vr, wr = [], []
            for r in receivers:
                cell, (xi, eta) = self.mesh.locate_point(r)
                vr.append(cells[cell])
                wr.append((1.0 - xi - eta, xi, eta))
            self._rec_tri_verts = jnp.asarray(np.asarray(vr, np.int32))
            self._rec_tri_w = jnp.asarray(np.asarray(wr), self.dtype)

        if wavelet is None:
            times = self.dt * np.arange(1, self.n_steps + 1)
            wavelet = ricker_wavelet(times, peak_freq=1.0 / (20 * self.dt))
        self.wavelet = jnp.asarray(
            np.broadcast_to(np.asarray(wavelet), (self.n_steps,)),
            dtype=self.dtype)

    # -- boundary saving (reversal + sponge) ---------------------------------

    def _sponge_save(self, u_flat):
        """Concatenate the saved-rectangle values of a flat field (S,)."""
        nxv, nyv = self.mesh.nx + 1, self.mesh.ny + 1
        u_g = u_flat.reshape(nyv, nxv)
        return jnp.concatenate(
            [u_g[a:b, c:d].reshape(-1) for (a, b, c, d)
             in self._sponge_rects])

    def _sponge_restore(self, u_flat, saved):
        """Overwrite the saved rectangles of a flat field from storage."""
        nxv, nyv = self.mesh.nx + 1, self.mesh.ny + 1
        u_g = u_flat.reshape(nyv, nxv)
        off = 0
        for (a, b, c, d) in self._sponge_rects:
            n = (b - a) * (d - c)
            u_g = u_g.at[a:b, c:d].set(
                saved[off:off + n].reshape(b - a, d - c))
            off += n
        return u_g.reshape(-1)

    # -- receiver sampling ---------------------------------------------------

    def _sample(self, u):
        """Receiver traces from a field: nearest-vertex (default) or P1
        barycentric interpolation at the exact locations."""
        if self.interp_receivers:
            return jnp.sum(u[self._rec_tri_verts] * self._rec_tri_w,
                           axis=-1)
        return u[self.receiver_vertices]

    def _inject(self, vec, ybar_row):
        """Adjoint of :meth:`_sample`: scatter receiver cotangents back
        into the field (u_bar[v_rj] += w_rj * ybar_r)."""
        if self.interp_receivers:
            return vec.at[self._rec_tri_verts].add(
                self._rec_tri_w * ybar_row[:, None])
        return vec.at[self.receiver_vertices].add(ybar_row)

    # -- model regularisation -------------------------------------------------

    @property
    def _cell_adjacency(self):
        """(2, n_pairs) int32 indices of edge-sharing triangle pairs.

        On the structured mesh each grid cell's lower triangle
        (v00,v10,v11) shares its diagonal with the cell's upper triangle,
        its bottom edge with the upper triangle of the cell below, and
        each upper triangle shares its left edge with the lower triangle
        of the cell to the left. Cached; built once host-side.
        """
        adj = self.__dict__.get("_cell_adjacency_cached")
        if adj is not None:
            return adj
        nx, ny = self.mesh.nx, self.mesh.ny
        gi = 2 * (np.arange(ny)[:, None] * nx + np.arange(nx))  # lower ids
        pairs = [np.stack([gi.ravel(), gi.ravel() + 1])]        # diagonal
        if ny > 1:
            lo = gi[1:, :].ravel()           # lower(i, j), j >= 1
            up = gi[:-1, :].ravel() + 1      # upper(i, j-1)
            pairs.append(np.stack([lo, up]))
        if nx > 1:
            up = gi[:, 1:].ravel() + 1       # upper(i, j), i >= 1
            lo = gi[:, :-1].ravel()          # lower(i-1, j)
            pairs.append(np.stack([up, lo]))
        # host numpy on purpose: a jnp constant materialised during a jit
        # trace would cache an escaped tracer
        adj = np.concatenate(pairs, axis=1).astype(np.int32)
        self.__dict__["_cell_adjacency_cached"] = adj
        return adj

    @property
    def sponge_interior_cell_mask(self) -> np.ndarray:
        """Bool (n_cells,): cells whose 3 vertices all have sigma == 0.

        With ``boundary_save="ring"`` the c2 gradient is exact on exactly
        these cells (the physical region); sponge cells see an
        approximate gradient (the deep-sponge wavefield is zeroed during
        reconstruction). All-True without a sponge.
        """
        sig_v = self._sigma_np[np.asarray(self.mesh.cells)]  # (E, 3)
        return (sig_v == 0.0).all(axis=1)

    def roughness(self, c2_cell):
        """Sum of squared c2 jumps across all edge-sharing triangle pairs —
        the graph-Laplacian Tikhonov functional used by ``reg_lambda``."""
        ia, ib = self._cell_adjacency
        d = jnp.asarray(c2_cell, self.dtype)
        diff = d[ia] - d[ib]
        return jnp.sum(diff * diff)

    # -- forward model ------------------------------------------------------

    def stiffness_apply(self, c2_cell, u):
        """K(c2) u, matrix-free and traceable in ``c2_cell`` (n_cells,).

        For raw (single) applies the ``stencil`` engine uses the grid form
        — exact on boundary rows too; its roll-based plane apply is used
        inside trajectories where boundary rows are masked anyway.
        """
        if self.engine in ("grid", "stencil"):
            return self._stiffness_apply_grid(c2_cell, u)
        scale = (self._det_j * self._w_sum) * jnp.asarray(c2_cell, self.dtype)
        ve = u[self._cells].reshape(-1, 2, 3)          # gather, class pairs
        we = jnp.einsum("kij,ekj->eki", self._g_class, ve, precision="highest")
        we = we * scale.reshape(-1, 2, 1)
        return jax.ops.segment_sum(we.reshape(-1), self._cells.reshape(-1),
                                   num_segments=self.n_vertices)

    # corner offsets (x, y) of the two triangle classes per structured grid
    # cell (core/mesh.py::cells: lower (v00, v10, v11), upper (v00, v11, v01))
    _CORNERS = (((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1)))

    def _assemble_stencil_planes(self, c2_cell):
        """Assembled variable-coefficient 9-point stencil: per neighbour
        offset d, the (ny+1, nx+1) coefficient plane w_d with
        y[I] = sum_d w_d[I] * u[I + d]. Linear (hence differentiable) in
        c2; built ONCE per misfit/trajectory evaluation, so each time step
        costs 9 aligned multiply-roll-adds instead of the grid engine's 19
        slab ops. Interior-exact; boundary rows are masked by the stepper.
        """
        from tpuwave.ops.stencil import assemble_varcoef_planes
        ny, nx = self.mesh.ny, self.mesh.nx
        s = ((self._det_j * self._w_sum)
             * jnp.asarray(c2_cell, self.dtype).reshape(ny, nx, 2))
        return assemble_varcoef_planes(s, self._g_class_np, ny, nx,
                                       self.dtype)

    def _apply_stencil_planes(self, planes, u):
        """y = sum_d w_d * roll(u, -d) on the vertex grid (wrap garbage on
        boundary rows/cols only — masked by the stepper, the same caveat
        as ops/stencil.py::apply_stencil)."""
        from tpuwave.ops.stencil import apply_varcoef_planes
        ny, nx = self.mesh.ny, self.mesh.nx
        return apply_varcoef_planes(planes,
                                    u.reshape(ny + 1, nx + 1)).reshape(-1)

    def _stiffness_apply_grid(self, c2_cell, u):
        """Grid-slicing form of K(c2) u: scatter-free variable-coefficient
        stencil — 2 classes x nonzero (i, j) pairs of slab multiply-adds on
        (ny, nx) planes instead of gather/segment_sum. Same algebra as the
        scatter engine (contributions grouped per (class, i, j) instead of
        per cell), gather-free, and equally traceable in c2.
        """
        ny, nx = self.mesh.ny, self.mesh.nx
        s = ((self._det_j * self._w_sum)
             * jnp.asarray(c2_cell, self.dtype).reshape(ny, nx, 2))
        ug = u.reshape(ny + 1, nx + 1)
        acc = jnp.zeros_like(ug)
        for k in range(2):
            sk = s[..., k]
            for i in range(3):
                oix, oiy = self._CORNERS[k][i]
                for j in range(3):
                    g = self._g_class_np[k, i, j]
                    if g == 0.0:
                        continue
                    ojx, ojy = self._CORNERS[k][j]
                    acc = acc.at[oiy:oiy + ny, oix:oix + nx].add(
                        g * sk * ug[ojy:ojy + ny, ojx:ojx + nx])
        return acc.reshape(-1)

    def _propagate(self, c2_cell, src, wavelet,
                   u0: Optional[jax.Array] = None,
                   return_final: bool = False):
        """Core leapfrog scan, traceable in (c2_cell, src, wavelet, u0)."""
        c2_cell = jnp.asarray(c2_cell, self.dtype)
        dt2 = jnp.asarray(self.dt * self.dt, self.dtype)

        if self.engine == "stencil":
            planes = self._assemble_stencil_planes(c2_cell)

            def k_apply(u):
                return self._apply_stencil_planes(planes, u)
        else:
            def k_apply(u):
                return self.stiffness_apply(c2_cell, u)

        def forced_accel(u, w_n):
            f = -k_apply(u)
            f = f.at[src].add(w_n)
            return f * self._inv_lumped

        if u0 is None:
            u0 = jnp.zeros(self.n_vertices, self.dtype)
        else:
            u0 = jnp.asarray(u0, self.dtype)
        u1 = u0 + 0.5 * dt2 * forced_accel(u0, wavelet[0])
        u1 = u1 * self._interior

        # boundary saving (reversal + sponge): stream the damped-strip
        # values out of the scan so the backward pass can reconstruct
        save = (self._sponge_rects is not None) and return_final

        def body(carry, w_n):
            u, u_prev = carry
            u_next = (2.0 * u - self._damp_num * u_prev
                      + dt2 * forced_accel(u, w_n)) * self._damp_den
            u_next = u_next * self._interior
            out = self._sample(u_next)
            if save:
                out = (out, self._sponge_save(u_next))
            return (u_next, u), out

        if self.remat:
            body = jax.checkpoint(body)
        first = self._sample(u1)
        (u_last, u_prevlast), rest = jax.lax.scan(body, (u1, u0), wavelet[1:])
        if save:
            rest, strip_rest = rest
            strips = jnp.concatenate([self._sponge_save(u1)[None],
                                      strip_rest], axis=0)
            traces = jnp.concatenate([first[None], rest], axis=0)
            return traces, (u_last, u_prevlast, strips)
        traces = jnp.concatenate([first[None], rest], axis=0)
        if return_final:
            return traces, (u_last, u_prevlast)
        return traces

    # -- O(1)-memory adjoint: time-reversed state reconstruction ------------

    def _adjoint_backward(self, c2_cell, src, wavelet, u_last, u_prevlast,
                          ybar, strips=None):
        """Hand-written reverse pass of :meth:`_propagate` (stencil engine,
        zero start): a reverse-time scan that simultaneously
        (a) RECONSTRUCTS the forward states u_{k-1} from (u_{k+1}, u_k) —
        the undamped leapfrog is time-reversible, so no forward state is
        stored; (b) propagates the adjoint field lambda driven by the
        receiver cotangents; (c) accumulates the 9 stencil-plane
        correlations W_d = -sum_k mu_{k+1} * shift(u_k, d), which chain
        through the (linear) plane assembly to dJ/dc2. Memory is O(1) in
        n_steps with hard walls. With a sponge, the damped strip is not
        reversible: ``strips`` carries the forward pass's saved strip
        values (n_steps, |strip|) and the reconstruction overwrites the
        strip from storage each step (boundary saving — memory
        O(|strip| * n_steps)); the lambda recursion applies the exact
        damped-leapfrog transpose so gradients stay exact everywhere.
        Returns (c2_bar, wavelet_bar).
        """
        c2_cell = jnp.asarray(c2_cell, self.dtype)
        dt2 = jnp.asarray(self.dt * self.dt, self.dtype)
        planes, assemble_vjp = jax.vjp(self._assemble_stencil_planes, c2_cell)
        interior = self._interior
        inv_m = self._inv_lumped
        ny, nx = self.mesh.ny, self.mesh.nx
        keep = self._sponge_keep
        has_sponge = strips is not None and self._sponge_rects is not None
        if has_sponge:
            # interior ⊙ Dden folded into one mask; Dnum applied to the
            # u_prev-cotangent leg (exact transpose of the damped step)
            bden = interior * self._damp_den
            dnum = self._damp_num
        else:
            bden = interior

        def K(u):
            return self._apply_stencil_planes(planes, u)

        n = self.n_steps
        lam_n = self._inject(jnp.zeros(self.n_vertices, self.dtype),
                             ybar[-1])
        wbar0 = {d: jnp.zeros((ny + 1, nx + 1), self.dtype) for d in planes}
        carry0 = (u_last, u_prevlast, lam_n,
                  jnp.zeros(self.n_vertices, self.dtype), wbar0)
        # reverse over k = n-1 .. 1: xs rows are (ybar_k, w_k) with
        # y_k = traces[k-1] (traces[0] is u_1) and w_k = wavelet[k];
        # with boundary saving also the strip of u_{k-1} (row 0 is the
        # zero initial condition, rows 1.. are the forward saves)
        xs = (ybar[:-1], wavelet[1:])
        if has_sponge:
            zero_row = jnp.zeros((1,) + strips.shape[1:], strips.dtype)
            strip_xs = jnp.concatenate([zero_row, strips[:-2]],
                                       axis=0)[:n - 1]
            xs = xs + (strip_xs,)

        def body(carry, x):
            if has_sponge:
                ybar_k, w_k, strip_km1 = x
            else:
                ybar_k, w_k = x
            u_next, u_cur, lam_next, lam_partial, wbar = carry
            blam = bden * lam_next
            mu = dt2 * inv_m * blam
            # (dF/du_k)^T lam_{k+1} = 2 B lam - dt^2 K M^-1 B lam
            lam_cur = lam_partial + 2.0 * blam - K(mu)
            lam_cur = self._inject(lam_cur, ybar_k)
            lam_prev_partial = -(dnum * blam) if has_sponge else -blam
            # time-reversed reconstruction of u_{k-1} (undamped formula —
            # exact off the strip; strip values come from storage)
            f = (-K(u_cur)).at[src].add(w_k)
            u_prev = interior * (2.0 * u_cur - u_next + dt2 * inv_m * f)
            if has_sponge:
                if keep is not None:   # ring mode: zero the deep sponge
                    u_prev = u_prev * keep
                u_prev = self._sponge_restore(u_prev, strip_km1)
            mu_g = mu.reshape(ny + 1, nx + 1)
            u_g = u_cur.reshape(ny + 1, nx + 1)
            wbar = {d: wbar[d] - mu_g * jnp.roll(u_g, (-d[1], -d[0]), (0, 1))
                    for d in wbar}
            return ((u_cur, u_prev, lam_cur, lam_prev_partial, wbar),
                    mu[src])

        (_, _, lam_1, _, wbar), wav_bar_rest = jax.lax.scan(
            body, carry0, xs, reverse=True)
        # start u_1 = B(dt^2/2 M^-1 w_0 e_src): only the wavelet depends
        wav_bar_0 = 0.5 * dt2 * (inv_m * (interior * lam_1))[src]
        wavelet_bar = jnp.concatenate([wav_bar_0[None], wav_bar_rest])
        return assemble_vjp(wbar)[0], wavelet_bar

    @property
    def _reversal_sim(self):
        """custom_vjp-wrapped forward (c2, src, wavelet) -> traces with the
        reconstruction-based backward pass. Cached per problem."""
        sim = self.__dict__.get("_reversal_sim_cached")
        if sim is not None:
            return sim

        @jax.custom_vjp
        def sim(c2, src, wavelet):
            return self._propagate(c2, src, wavelet)

        def fwd(c2, src, wavelet):
            traces, final = self._propagate(
                c2, src, wavelet, return_final=True)
            # final is (u_last, u_prevlast) or, with boundary saving,
            # (u_last, u_prevlast, strips)
            return traces, (c2, src, wavelet) + tuple(final)

        def bwd(res, ybar):
            c2, src, wavelet, u_last, u_prevlast, *rest = res
            c2_bar, wav_bar = self._adjoint_backward(
                c2, src, wavelet, u_last, u_prevlast, ybar, *rest)
            src_bar = np.zeros(np.shape(src), jax.dtypes.float0)  # int arg
            return c2_bar, src_bar, wav_bar

        sim.defvjp(fwd, bwd)
        self.__dict__["_reversal_sim_cached"] = sim
        return sim

    def simulate(self, c2_cell, u0: Optional[jax.Array] = None,
                 wavelet: Optional[jax.Array] = None):
        """Forward-propagate and return receiver traces (n_steps, n_rec).

        Pure in (c2_cell, u0, wavelet): safe under jit/grad/vmap — both
        adjoint modes produce wavelet cotangents, so the source time
        series is an invertible parameter too (see ``invert``'s
        ``estimate_wavelet``). u'(0) = 0; the first step is the standard
        second-order Taylor start
        u^1 = u^0 + dt^2/2 M_L^{-1} (w_0 e_src - K u^0).
        """
        w = self.wavelet if wavelet is None else jnp.asarray(
            wavelet, self.dtype)
        if self.adjoint == "reversal" and u0 is None:
            return self._reversal_sim(
                jnp.asarray(c2_cell, self.dtype),
                jnp.asarray(self.source_vertex, jnp.int32), w)
        return self._propagate(c2_cell, self.source_vertex, w, u0)

    # -- multi-shot (survey-style acquisition) ------------------------------

    def snap_vertices(self, points) -> jax.Array:
        """Nearest-vertex ids for a list of (x, y) points (int32)."""
        coords = self.mesh.vertex_coords
        return jnp.asarray(
            [int(np.argmin(np.sum((coords - np.asarray(p)) ** 2, axis=1)))
             for p in points], dtype=jnp.int32)

    def simulate_shots(self, c2_cell, sources, wavelets=None):
        """Batch of independent shots via ``jax.vmap`` -> (S, n_steps, n_rec).

        ``sources``: (S,) vertex ids (see :meth:`snap_vertices`);
        ``wavelets``: (S, n_steps) per-shot source time series (default:
        this problem's wavelet for every shot). The shot axis is
        embarrassingly parallel — under jit with a sharded ``sources``
        batch, GSPMD partitions it across the device mesh (shot/data
        parallelism, the standard production-FWI scaling axis).
        """
        sources = jnp.asarray(sources, jnp.int32)
        if wavelets is None:
            wavelets = jnp.broadcast_to(self.wavelet,
                                        (sources.shape[0], self.n_steps))
        else:
            wavelets = jnp.asarray(wavelets, self.dtype)
        if self.adjoint == "reversal":
            def one(s, w):
                return self._reversal_sim(
                    jnp.asarray(c2_cell, self.dtype), s, w)
        else:
            def one(s, w):
                return self._propagate(c2_cell, s, w)
        return jax.vmap(one)(sources, wavelets)

    def misfit_shots(self, c2_cell, sources, observed, wavelets=None,
                     kind: str = "l2", huber_delta: float = 1.0):
        """Data misfit over the multi-shot gather (default 0.5‖r‖²; see
        :func:`trace_misfit` for the robust "huber"/"envelope" kinds)."""
        return trace_misfit(self.simulate_shots(c2_cell, sources, wavelets),
                            jnp.asarray(observed, self.dtype),
                            kind, huber_delta=huber_delta)

    # -- source encoding (simultaneous-source / supershot FWI) ---------------

    def simulate_supershot(self, c2_cell, sources, codes, wavelets=None):
        """One propagation with ALL sources firing simultaneously, each
        scaled by its encoding weight -> (n_steps, n_rec).

        The leapfrog injection is linear in the force, so an S-source
        supershot costs exactly one single-shot simulation regardless of
        S — the encoded-source trick of production FWI (Krebs et al.
        2009, "Fast full-wavefield seismic inversion using encoded
        sources"): with random ±1 ``codes`` redrawn per iteration, the
        expected encoded misfit equals the sum of the per-shot misfits
        (cross-talk terms vanish in expectation), cutting the per-
        iteration cost by S×.

        ``sources``: (S,) vertex ids; ``codes``: (S,) weights (±1
        Rademacher for the classic scheme, but any floats work — e.g.
        plane-wave/linear phase encodings built into ``wavelets``);
        ``wavelets``: optional (S, n_steps) per-source time series
        (default: this problem's wavelet for every source).

        Differentiable in (c2_cell, codes, wavelets) on every engine;
        adjoint="reversal" runs the same O(1)-memory
        time-reversed backward pass — the multi-source injection and its
        wavelet cotangents fall out of the same ``at[src].add`` algebra.
        """
        sources = jnp.asarray(sources, jnp.int32)
        codes = jnp.asarray(codes, self.dtype)
        if wavelets is None:
            wavelets = jnp.broadcast_to(self.wavelet,
                                        (sources.shape[0], self.n_steps))
        else:
            wavelets = jnp.asarray(wavelets, self.dtype)
        wmat = wavelets.T * codes[None, :]           # (n_steps, S)
        if self.adjoint == "reversal":
            return self._reversal_sim(jnp.asarray(c2_cell, self.dtype),
                                      sources, wmat)
        return self._propagate(c2_cell, sources, wmat)

    def misfit_encoded(self, c2_cell, sources, codes, observed,
                       wavelets=None):
        """0.5 * ||supershot(c2; codes) - sum_s codes_s * observed_s||^2 —
        the encoded objective whose Rademacher expectation is
        ``misfit_shots`` (plus a model-independent cross-talk constant).
        ``observed``: the (S, n_steps, n_rec) per-shot gather; the same
        codes encode synthetics (by superposed injection) and data (by
        weighted trace sum)."""
        codes = jnp.asarray(codes, self.dtype)
        d_enc = jnp.einsum("s,snr->nr", codes,
                           jnp.asarray(observed, self.dtype),
                           precision="highest")
        r = self.simulate_supershot(c2_cell, sources, codes, wavelets) - d_enc
        return 0.5 * jnp.sum(r * r)

    def invert_encoded(self, observed, c2_init, *, sources, key,
                       n_iter: int = 50, learning_rate: float = 0.1,
                       bounds: Optional[Tuple[float, float]] = None,
                       wavelets=None, reg_lambda: float = 0.0,
                       redraw_every: int = 1,
                       verbose: bool = False) -> FwiResult:
        """Stochastic encoded-source descent: each Adam iteration draws
        fresh ±1 Rademacher ``codes`` (every ``redraw_every`` iterations)
        and steps on the S×-cheaper :meth:`misfit_encoded`; redrawing
        decorrelates the cross-talk noise across iterations so it
        averages out of the model update (Krebs et al. 2009). The
        recorded per-iteration misfits are the encoded values (a noisy
        S-scaled proxy of the full objective — evaluate
        :meth:`misfit_shots` for a clean final number)."""
        import optax

        observed = jnp.asarray(observed, self.dtype)
        sources = jnp.asarray(sources, jnp.int32)
        n_src = int(sources.shape[0])

        def loss(c2, codes):
            val = self.misfit_encoded(c2, sources, codes, observed,
                                      wavelets)
            if reg_lambda > 0.0:
                val = val + reg_lambda * self.roughness(c2)
            return val

        opt = optax.adam(learning_rate)
        vg = jax.value_and_grad(loss)

        @jax.jit
        def step(c2, opt_state, codes):
            val, g = vg(c2, codes)
            updates, opt_state = opt.update(g, opt_state)
            c2 = optax.apply_updates(c2, updates)
            if bounds is not None:
                c2 = jnp.clip(c2, bounds[0], bounds[1])
            return c2, opt_state, val

        c2 = jnp.asarray(c2_init, self.dtype)
        opt_state = opt.init(c2)
        misfits = np.empty(n_iter)
        codes = None
        for i in range(n_iter):
            if codes is None or i % max(1, redraw_every) == 0:
                key, sub = jax.random.split(key)
                codes = jax.random.rademacher(sub, (n_src,),
                                              dtype=self.dtype)
            c2, opt_state, val = step(c2, opt_state, codes)
            misfits[i] = float(val)
            if verbose:
                print(f"iter {i:3d}  encoded misfit {misfits[i]:.6e}")
        return FwiResult(c2=c2, misfits=misfits, wavelet=None)

    # -- Born modeling / RTM / least-squares migration -----------------------

    def _data_map(self, sources=None, wavelets=None):
        """The (differentiable) model->data map m = c2_cell -> traces,
        single-shot (n_steps, n_rec) or multi-shot (S, n_steps, n_rec)."""
        if sources is None:
            return lambda m: self.simulate(m)
        sources = jnp.asarray(sources, jnp.int32)
        return lambda m: self.simulate_shots(m, sources, wavelets)

    def born(self, c2_cell, dc2_cell, sources=None, wavelets=None):
        """Linearized (Born/demigration) forward modeling: the directional
        derivative L[dm] = d(traces)/d(c2) · dc2_cell of the wave-equation
        data map at background ``c2_cell`` — single-scattering synthetics
        from a reflectivity perturbation, computed by one forward-mode
        sweep (jax.jvp) through the leapfrog scan. Forward mode cannot
        traverse the reversal custom_vjp, so this path always runs the
        plain scan (engines scatter/grid/stencil)."""
        c2 = jnp.asarray(c2_cell, self.dtype)
        dm = jnp.asarray(dc2_cell, self.dtype)
        if sources is None:
            f = lambda m: self._propagate(m, self.source_vertex,
                                          self.wavelet)
        else:
            srcs = jnp.asarray(sources, jnp.int32)
            ws = (jnp.broadcast_to(self.wavelet,
                                   (srcs.shape[0], self.n_steps))
                  if wavelets is None
                  else jnp.asarray(wavelets, self.dtype))
            f = lambda m: jax.vmap(
                lambda s, w: self._propagate(m, s, w))(srcs, ws)
        return jax.jvp(f, (c2,), (dm,))[1]

    def migrate(self, c2_cell, data, sources=None, wavelets=None):
        """Adjoint of :meth:`born`: the RTM operator Lᵀd — back-propagate
        ``data`` as adjoint sources and zero-lag-correlate with the
        forward source wavefield (the cross-correlation imaging
        condition IS the adjoint of Born modeling). Runs through
        whichever adjoint this problem is configured with — including
        the O(1)-memory time reversal — so production-size migrations
        need no stored wavefields. Returns a per-cell image."""
        c2 = jnp.asarray(c2_cell, self.dtype)
        f = self._data_map(sources, wavelets)
        _, vjp = jax.vjp(f, c2)
        return vjp(jnp.asarray(data, self.dtype))[0]

    def rtm_image(self, c2_cell, observed, sources=None, wavelets=None,
                  normalize: Optional[str] = "illumination",
                  precond_eps: float = 1e-3):
        """Reverse-time-migration image of recorded ``observed`` data over
        the smooth background ``c2_cell`` (classic seismic imaging:
        Baysal et al. 1983). ``normalize="illumination"`` divides by the
        source-illumination diagonal (:meth:`illumination`), the
        standard amplitude correction for geometric spreading; ``None``
        returns the raw adjoint Lᵀd."""
        img = self.migrate(c2_cell, observed, sources, wavelets)
        if normalize is None:
            return img
        if normalize != "illumination":
            raise ValueError(f"unknown normalize {normalize!r}")
        illum = self.illumination(jnp.asarray(c2_cell, self.dtype),
                                  sources=sources, wavelets=wavelets)
        return img / (illum + precond_eps * jnp.max(illum))

    def lsrtm(self, c2_cell, observed, *, n_iter: int = 10,
              sources=None, wavelets=None, verbose: bool = False):
        """Least-squares RTM: solve min_m ½‖L m − d‖² for the reflectivity
        ``m`` by CGLS (conjugate gradients on the normal equations),
        each iteration one Born modeling (jvp) + one migration (vjp) —
        the linearized-inversion upgrade of plain RTM that deconvolves
        the source wavelet and acquisition footprint from the image.
        Returns (m, residual_norms) with residual_norms[k] = ‖d − L m_k‖
        (residual_norms[0] = ‖d‖, the zero-image residual)."""
        c2 = jnp.asarray(c2_cell, self.dtype)
        d = jnp.asarray(observed, self.dtype)
        f = self._data_map(sources, wavelets)

        @jax.jit
        def L(m):
            return self.born(c2, m, sources, wavelets)

        @jax.jit
        def Lt(r):
            _, vjp = jax.vjp(f, c2)
            return vjp(r)[0]

        m = jnp.zeros(self.n_cells, self.dtype)
        r = d                       # d - L·0
        s = Lt(r)
        p = s
        gamma = jnp.sum(s * s)
        norms = [float(jnp.sqrt(jnp.sum(r * r)))]
        for k in range(n_iter):
            q = L(p)
            alpha = gamma / jnp.sum(q * q)
            m = m + alpha * p
            r = r - alpha * q
            norms.append(float(jnp.sqrt(jnp.sum(r * r))))
            if verbose:
                print(f"lsrtm iter {k:3d}  ||r|| {norms[-1]:.6e}")
            s = Lt(r)
            gamma_new = jnp.sum(s * s)
            p = s + (gamma_new / gamma) * p
            gamma = gamma_new
        return m, np.asarray(norms)

    def gauss_newton_hvp(self, c2_cell, v, sources=None, wavelets=None,
                         damping: float = 0.0):
        """Matrix-free Gauss–Newton Hessian-vector product
        (JᵀJ + damping·I) v at background ``c2_cell``, J = ∂(traces)/∂c2:
        one Born modeling (jvp) + one migration (vjp). Symmetric PSD by
        construction — the operator behind truncated-Gauss-Newton /
        Levenberg–Marquardt FWI (:meth:`invert_gauss_newton`)."""
        v = jnp.asarray(v, self.dtype)
        hv = self.migrate(c2_cell, self.born(c2_cell, v, sources, wavelets),
                          sources, wavelets)
        if damping:
            hv = hv + jnp.asarray(damping, self.dtype) * v
        return hv

    def invert_gauss_newton(self, observed, c2_init, *, n_outer: int = 5,
                            n_cg: int = 5, damping: float = 0.0,
                            step: float = 1.0,
                            bounds: Optional[Tuple[float, float]] = None,
                            sources=None, wavelets=None,
                            verbose: bool = False) -> FwiResult:
        """Truncated Gauss–Newton FWI (Levenberg–Marquardt for
        ``damping`` > 0; Pratt et al. 1998): each outer iteration
        linearizes the data map at the current model, solves
        (JᵀJ + λI) p = −g by ``n_cg`` CG iterations with matrix-free
        :meth:`gauss_newton_hvp` products (2 propagation pairs each),
        and updates c2 ← Π_bounds(c2 + step·p). Far fewer outer
        iterations than first-order descent on smooth problems because
        the JᵀJ solve deconvolves the acquisition footprint from the
        update — the second-order production-FWI workhorse.

        Cost per outer iteration ≈ (1 + 2·n_cg) propagation pairs.
        Returns FwiResult with the per-outer-iteration misfits."""
        d = jnp.asarray(observed, self.dtype)
        f = self._data_map(sources, wavelets)

        @jax.jit
        def value_and_gradient(m):
            sim, vjp = jax.vjp(f, m)
            r = sim - d
            return 0.5 * jnp.sum(r * r), vjp(r)[0]

        @jax.jit
        def hvp(m, v):
            return self.gauss_newton_hvp(m, v, sources, wavelets,
                                         damping=damping)

        c2 = jnp.asarray(c2_init, self.dtype)
        misfits = np.empty(n_outer)
        for k in range(n_outer):
            val, g = value_and_gradient(c2)
            misfits[k] = float(val)
            if verbose:
                print(f"gn outer {k:3d}  misfit {misfits[k]:.6e}")
            # CG on the (damped) normal equations from p = 0
            p = jnp.zeros_like(c2)
            r = -g
            q = r
            rho = jnp.sum(r * r)
            for _ in range(n_cg):
                hq = hvp(c2, q)
                alpha = rho / jnp.sum(q * hq)
                p = p + alpha * q
                r = r - alpha * hq
                rho_new = jnp.sum(r * r)
                q = r + (rho_new / rho) * q
                rho = rho_new
            c2 = c2 + jnp.asarray(step, self.dtype) * p
            if bounds is not None:
                c2 = jnp.clip(c2, bounds[0], bounds[1])
        return FwiResult(c2=c2, misfits=misfits, wavelet=None)

    # -- illumination / gradient preconditioning -----------------------------

    def illumination(self, c2_cell, sources=None, wavelets=None):
        """Per-cell source-illumination field I_e = sum_k mean_v u_k[v]^2
        (v over the cell's 3 vertices; summed over shots when ``sources``
        is given) — the diagonal pseudo-Hessian proxy of classic FWI.
        Deep/poorly-lit cells have tiny I, so dividing the gradient by
        (I + eps*max I) compensates geometric spreading (``invert``'s
        precondition="illumination"). Engine-independent: always runs
        the XLA stencil-plane forward (a one-off diagnostic scan, not
        the production gradient path).
        """
        c2_cell = jnp.asarray(c2_cell, self.dtype)
        dt2 = jnp.asarray(self.dt * self.dt, self.dtype)
        planes = self._assemble_stencil_planes(c2_cell)

        def one(src, w):
            def accel(u, w_n):
                f = -self._apply_stencil_planes(planes, u)
                f = f.at[src].add(w_n)
                return f * self._inv_lumped

            u0 = jnp.zeros(self.n_vertices, self.dtype)
            u1 = (u0 + 0.5 * dt2 * accel(u0, w[0])) * self._interior

            def body(carry, w_n):
                u, u_prev, acc = carry
                u_next = (2.0 * u - self._damp_num * u_prev
                          + dt2 * accel(u, w_n)) * self._damp_den
                u_next = u_next * self._interior
                return (u_next, u, acc + u_next * u_next), None

            (_, _, acc), _ = jax.lax.scan(
                body, (u1, u0, u1 * u1), w[1:])
            return acc

        if sources is None:
            acc = one(self.source_vertex, self.wavelet)
        else:
            sources = jnp.asarray(sources, jnp.int32)
            if wavelets is None:
                wavelets = jnp.broadcast_to(
                    self.wavelet, (sources.shape[0], self.n_steps))
            acc = jnp.sum(jax.vmap(one)(sources,
                                        jnp.asarray(wavelets, self.dtype)),
                          axis=0)
        return jnp.mean(acc[self._cells], axis=1)

    # -- inversion ----------------------------------------------------------

    def misfit(self, c2_cell, observed, wavelet: Optional[jax.Array] = None,
               kind: str = "l2", huber_delta: float = 1.0):
        """Single-shot data misfit (default 0.5‖r‖², the classic FWI
        objective; ``kind`` selects the robust functionals of
        :func:`trace_misfit`)."""
        return trace_misfit(self.simulate(c2_cell, wavelet=wavelet),
                            jnp.asarray(observed, self.dtype),
                            kind, huber_delta=huber_delta)

    def misfit_and_grad(self, c2_cell, observed):
        """(misfit, dmisfit/dc2_cell) via reverse-mode through the scan."""
        return jax.value_and_grad(self.misfit)(
            jnp.asarray(c2_cell, self.dtype), observed)

    def invert(self, observed, c2_init, *, n_iter: int = 50,
               learning_rate: float = 0.1,
               bounds: Optional[Tuple[float, float]] = None,
               sources=None, wavelet=None, wavelets=None,
               estimate_wavelet: bool = False,
               wavelet_init: Optional[jax.Array] = None,
               optimizer: str = "adam",
               reg_lambda: float = 0.0,
               precondition: Optional[str] = None,
               precond_eps: float = 1e-3,
               misfit_kind: str = "l2",
               huber_delta: float = 1.0,
               checkpoint: Optional[str] = None,
               checkpoint_every: int = 10,
               verbose: bool = False) -> FwiResult:
        """Iterative descent on the misfit, with optional box projection.

        ``precondition="illumination"`` divides the c2 gradient by the
        source-illumination field evaluated at ``c2_init``
        (I + precond_eps * max I; see :meth:`illumination`) — the
        classic diagonal pseudo-Hessian scaling that compensates
        geometric spreading so deep, poorly-lit cells update at a
        useful rate. Adam only (a fixed diagonal metric; with L-BFGS it
        would make the line-search gradients inconsistent).

        ``checkpoint``: path of a single .npz snapshot (model, optimizer
        state, misfit history) written every ``checkpoint_every``
        iterations and at the end; if the file already exists the
        descent RESUMES from it (``n_iter`` counts total iterations, so
        a resumed run does only the remainder). Big inversions are
        hours-long; this is the crash/preemption insurance the
        production workflow needs.

        ``misfit_kind`` selects the data functional ("l2" default,
        "huber" with ``huber_delta``, or "envelope" — see
        :func:`trace_misfit`); gradients flow through all of them.

        ``reg_lambda`` > 0 adds Tikhonov smoothing
        ``reg_lambda * roughness(c2)`` (squared c2 jumps across
        edge-sharing triangles) to the objective — the standard damping
        of high-wavenumber artifacts in under-determined acquisitions.

        ``optimizer``: "adam" (default; robust first-order, uses
        ``learning_rate``) or "lbfgs" (optax L-BFGS with zoom
        linesearch — the classic quasi-Newton FWI workhorse, usually
        far fewer iterations on smooth problems; ``learning_rate`` is
        ignored). With box ``bounds`` the update is projected after
        each step (projected quasi-Newton).

        With ``sources`` given, ``observed`` is the (S, n_steps, n_rec)
        multi-shot gather and the shot axis parallelises under GSPMD.
        ``wavelet`` fixes a non-default single-shot source time series
        (``wavelets``, (S, n_steps), is its multi-shot counterpart).

        ``estimate_wavelet=True`` co-estimates the source time series
        (the production-FWI source-estimation problem: the true w(t) is
        rarely known): the descent runs jointly over (c2, w), starting
        the wavelet at ``wavelet_init`` (default: this problem's
        wavelet), with the box projection applied to c2 only. In
        multi-shot mode the single estimated wavelet is shared across
        shots (fixed ``wavelet``/``wavelets`` cannot be combined with
        it).
        """
        import optax

        observed = jnp.asarray(observed, self.dtype)
        if estimate_wavelet and (wavelets is not None
                                 or wavelet is not None):
            raise ValueError("estimate_wavelet=True estimates one shared "
                             "wavelet; drop the fixed `wavelet(s)` "
                             "argument")
        if sources is not None:
            sources = jnp.asarray(sources, jnp.int32)

        def loss(params, obs):
            c2, w = params
            if sources is None:
                val = self.misfit(c2, obs,
                                  wavelet=wavelet if w is None else w,
                                  kind=misfit_kind, huber_delta=huber_delta)
            else:
                ws = wavelets
                if ws is None:
                    base = w if w is not None else (
                        self.wavelet if wavelet is None else wavelet)
                    ws = jnp.broadcast_to(base,
                                          (sources.shape[0], self.n_steps))
                val = self.misfit_shots(c2, sources, obs, ws,
                                        kind=misfit_kind,
                                        huber_delta=huber_delta)
            if reg_lambda > 0.0:
                val = val + reg_lambda * self.roughness(c2)
            return val

        c2 = jnp.asarray(c2_init, self.dtype)
        if estimate_wavelet:
            w0 = (self.wavelet if wavelet_init is None
                  else jnp.asarray(wavelet_init, self.dtype))
            params = (c2, w0)
        else:
            params = (c2, None)

        if precondition not in (None, "illumination"):
            raise ValueError(f"unknown precondition {precondition!r}")
        if precondition == "illumination":
            if optimizer != "adam":
                raise ValueError("precondition='illumination' needs "
                                 "optimizer='adam' (a scaled gradient "
                                 "breaks the L-BFGS line search)")
            illum = self.illumination(c2, sources=sources,
                                      wavelets=wavelets)
            g_scale = 1.0 / (illum + precond_eps * jnp.max(illum))
        else:
            g_scale = None

        if optimizer == "adam":
            opt = optax.adam(learning_rate)
            vg = jax.jit(jax.value_and_grad(loss))

            @jax.jit
            def step(params, opt_state):
                val, g = vg(params, observed)
                if g_scale is not None:
                    g = (g[0] * g_scale, g[1])
                updates, opt_state = opt.update(g, opt_state)
                params = optax.apply_updates(params, updates)
                if bounds is not None:
                    c2, w = params
                    params = (jnp.clip(c2, bounds[0], bounds[1]), w)
                return params, opt_state, val

        elif optimizer == "lbfgs":
            opt = optax.lbfgs()

            def obj(prms):
                return loss(prms, observed)

            vg_state = optax.value_and_grad_from_state(obj)

            @jax.jit
            def step(params, opt_state):
                val, g = vg_state(params, state=opt_state)
                updates, opt_state = opt.update(
                    g, opt_state, params, value=val, grad=g, value_fn=obj)
                params = optax.apply_updates(params, updates)
                if bounds is not None:
                    c2, w = params
                    params = (jnp.clip(c2, bounds[0], bounds[1]), w)
                return params, opt_state, val
        else:
            raise ValueError(f"unknown optimizer {optimizer!r}")

        opt_state = opt.init(params)
        start = 0
        misfits = np.empty(n_iter)
        if checkpoint is not None:
            from ..utils.checkpoint import load_inversion, save_inversion
            ck = load_inversion(checkpoint)
            if ck is not None:
                n_done, hist, p_leaves, o_leaves = ck
                flat_p, tree_p = jax.tree_util.tree_flatten(params)
                flat_o, tree_o = jax.tree_util.tree_flatten(opt_state)
                if (len(p_leaves) != len(flat_p)
                        or len(o_leaves) != len(flat_o)):
                    raise ValueError(
                        f"checkpoint {checkpoint} does not match this "
                        "inversion configuration (different optimizer or "
                        "estimate_wavelet setting)")
                params = jax.tree_util.tree_unflatten(
                    tree_p, [jnp.asarray(a) for a in p_leaves])
                opt_state = jax.tree_util.tree_unflatten(
                    tree_o, [jnp.asarray(a) for a in o_leaves])
                start = min(n_done, n_iter)
                misfits[:start] = hist[:start]
                if verbose:
                    print(f"resumed from {checkpoint} at iteration {start}")
        for i in range(start, n_iter):
            params, opt_state, val = step(params, opt_state)
            misfits[i] = float(val)
            if verbose:
                print(f"iter {i:3d}  misfit {misfits[i]:.6e}")
            if checkpoint is not None and ((i + 1) % checkpoint_every == 0
                                           or i + 1 == n_iter):
                save_inversion(
                    checkpoint, i + 1, misfits[:i + 1],
                    jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(opt_state))
        c2, w = params
        return FwiResult(c2=c2, misfits=misfits,
                         wavelet=w if estimate_wavelet else None)

    def invert_multiscale(self, observed, c2_init, *, cutoffs,
                          n_iter: int = 50, learning_rate: float = 0.1,
                          bounds: Optional[Tuple[float, float]] = None,
                          sources=None, optimizer: str = "adam",
                          reg_lambda: float = 0.0,
                          precondition: Optional[str] = None,
                          misfit_kind: str = "l2",
                          huber_delta: float = 1.0,
                          verbose: bool = False) -> FwiResult:
        """Frequency-continuation FWI (Bunks et al. 1995, the production
        cure for cycle skipping): run :meth:`invert` over a sequence of
        low-pass ``cutoffs`` (Hz, ascending; None = unfiltered final
        stage), filtering the observed data AND the source wavelet to
        the same band each stage — the forward map is linear in w, so
        filtering the source filters the synthetics consistently — and
        warm-starting c2 from the previous stage. Long-wavelength model
        components converge first, keeping the misfit within half a
        cycle as the band widens.

        ``n_iter`` may be a sequence (one count per stage — typically
        fewer low-band iterations, more at full band).

        Returns the final stage's model with all stages' misfit
        histories concatenated.
        """
        observed = np.asarray(observed)
        c2 = jnp.asarray(c2_init, self.dtype)
        if isinstance(n_iter, (list, tuple)):
            if len(n_iter) != len(cutoffs):
                raise ValueError("need one n_iter per cutoff stage")
            iters = list(n_iter)
        else:
            iters = [n_iter] * len(cutoffs)
        histories = []
        for k, fc in enumerate(cutoffs):
            if fc is None:
                d_k, w_k = observed, None
            else:
                d_k = lowpass_time(observed, self.dt, fc, axis=-2)
                w_k = jnp.asarray(
                    lowpass_time(np.asarray(self.wavelet), self.dt, fc),
                    self.dtype)
            if verbose:
                print(f"stage {k}: cutoff "
                      f"{'full band' if fc is None else f'{fc:g} Hz'}")
            res = self.invert(d_k, c2, n_iter=iters[k],
                              learning_rate=learning_rate, bounds=bounds,
                              sources=sources, wavelet=w_k,
                              wavelets=None, optimizer=optimizer,
                              reg_lambda=reg_lambda,
                              precondition=precondition,
                              misfit_kind=misfit_kind,
                              huber_delta=huber_delta, verbose=verbose)
            c2 = res.c2
            histories.append(res.misfits)
        return FwiResult(c2=c2, misfits=np.concatenate(histories))
