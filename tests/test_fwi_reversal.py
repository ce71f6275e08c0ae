"""The production FWI path — engine="stencil" (assembled variable-
coefficient stencil planes) with the hand-written time-reversal adjoint —
against the reference path: engine="scatter" (gather -> element matvec ->
segment_sum) differentiated by jax autodiff through the remat scan. Forward
traces, misfit gradients, wavelet cotangents, sponges and shots, in f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuwave.models.inverse import FwiProblem

GEOM = ((0.0, 0.0), (1.0, 1.0))
DT = 8e-3
RECEIVERS = [(0.25, 0.3), (0.7, 0.65)]


def _pair(nel=(12, 10), steps=12, **kw):
    """(reference, production) problems on the same mesh and data."""
    common = dict(source=(0.45, 0.55), receivers=RECEIVERS,
                  dtype=jnp.float64, **kw)
    ref = FwiProblem(nel, GEOM, DT, steps, engine="scatter",
                     adjoint="remat", **common)
    rev = FwiProblem(nel, GEOM, DT, steps, engine="stencil",
                     adjoint="reversal", **common)
    return ref, rev


def _c2(prob, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(1.0 + 0.3 * rng.random(prob.n_cells))


@pytest.mark.parametrize("nel,steps,interp", [
    ((12, 10), 12, False), ((12, 10), 12, True),
    ((12, 26), 20, False), ((12, 26), 20, True),
])
def test_reversal_forward_matches_scatter(nel, steps, interp):
    ref, rev = _pair(nel, steps, interp_receivers=interp)
    c2 = _c2(ref, seed=3)
    np.testing.assert_allclose(np.asarray(rev.simulate(c2)),
                               np.asarray(ref.simulate(c2)),
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("nel,steps,interp", [
    ((12, 10), 12, False), ((12, 26), 20, False),
    ((12, 26), 20, True), ((12, 26), 17, False),
])
def test_reversal_gradient_matches_autodiff(nel, steps, interp):
    """c2 gradient of the misfit: time-reversed reconstruction vs jax.grad
    through the remat scan of the reference engine (steps=17 puts the
    reconstruction's first and last step next to each other in the
    odd-length reverse scan)."""
    ref, rev = _pair(nel, steps, interp_receivers=interp)
    obs = ref.simulate(_c2(ref, seed=1))
    c2_init = jnp.ones(ref.n_cells)
    v_ref, g_ref = jax.value_and_grad(ref.misfit)(c2_init, obs)
    v_rev, g_rev = jax.value_and_grad(rev.misfit)(c2_init, obs)
    np.testing.assert_allclose(float(v_rev), float(v_ref), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(g_rev), np.asarray(g_ref),
                               rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("nel,steps", [((12, 10), 12), ((12, 26), 20)])
def test_reversal_wavelet_cotangent_matches_autodiff(nel, steps):
    ref, rev = _pair(nel, steps)
    c2 = _c2(ref, seed=2)
    obs = ref.simulate(1.1 * c2)

    def wav_grad(p):
        return jax.grad(lambda w: p.misfit(c2, obs, wavelet=w))(p.wavelet)

    np.testing.assert_allclose(np.asarray(wav_grad(rev)),
                               np.asarray(wav_grad(ref)),
                               rtol=1e-8, atol=1e-14)


def test_reversal_engine_guards():
    with pytest.raises(ValueError, match="reversal"):
        FwiProblem((12, 10), GEOM, DT, 12, source=(0.5, 0.5),
                   receivers=[(0.25, 0.25)], engine="grid",
                   adjoint="reversal")
    with pytest.raises(ValueError, match="boundary_save"):
        FwiProblem((12, 10), GEOM, DT, 12, source=(0.5, 0.5),
                   receivers=[(0.25, 0.25)], engine="stencil",
                   adjoint="reversal", sponge_width=0.2,
                   boundary_save="edges")


def test_sponge_forward_matches_scatter():
    """The damped (sponge) leapfrog on the stencil planes equals the
    reference engine's damped scan."""
    kw = dict(sponge_width=0.2, sponge_strength=12.0)
    ref, rev = _pair((16, 12), 12, **kw)
    c2 = _c2(ref, seed=7)
    np.testing.assert_allclose(np.asarray(rev.simulate(c2)),
                               np.asarray(ref.simulate(c2)),
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("save,steps", [("ring", 12), ("strip", 20)])
def test_sponge_reversal_matches_autodiff(save, steps):
    """Boundary-saving reversal with a sponge: traces, misfit and wavelet
    cotangents exact; the c2 gradient exact everywhere in strip mode and
    on the physical (sigma == 0) cells in ring mode."""
    kw = dict(sponge_width=0.22, sponge_strength=25.0, boundary_save=save)
    ref, rev = _pair((12, 10), steps, **kw)
    obs = ref.simulate(_c2(ref, seed=5))
    np.testing.assert_allclose(np.asarray(rev.simulate(_c2(ref, seed=5))),
                               np.asarray(obs), rtol=1e-11, atol=1e-13)
    c2_init = jnp.ones(ref.n_cells)
    v_ref, g_ref = jax.value_and_grad(ref.misfit)(c2_init, obs)
    v_rev, g_rev = jax.value_and_grad(rev.misfit)(c2_init, obs)
    np.testing.assert_allclose(float(v_rev), float(v_ref), rtol=1e-11)
    mask = (rev.sponge_interior_cell_mask if save == "ring"
            else np.ones(ref.n_cells, bool))
    np.testing.assert_allclose(np.asarray(g_rev)[mask],
                               np.asarray(g_ref)[mask],
                               rtol=1e-8, atol=1e-14)

    def wgrad(p):
        return jax.grad(lambda w: p.misfit(c2_init, obs, wavelet=w))(
            p.wavelet)

    np.testing.assert_allclose(np.asarray(wgrad(rev)),
                               np.asarray(wgrad(ref)),
                               rtol=1e-8, atol=1e-14)


def test_ring_requires_source_outside_sponge():
    with pytest.raises(ValueError, match="ring"):
        FwiProblem((12, 10), GEOM, DT, 12, source=(0.02, 0.5),
                   receivers=RECEIVERS, engine="stencil",
                   adjoint="reversal", sponge_width=0.2,
                   boundary_save="ring")


def test_sponge_covering_domain_rejected():
    with pytest.raises(ValueError, match="sigma == 0"):
        FwiProblem((12, 10), GEOM, DT, 12, source=(0.5, 0.5),
                   receivers=RECEIVERS, engine="stencil",
                   adjoint="reversal", sponge_width=0.9)


def test_grid_engine_forward_matches_scatter():
    """The third engine (scatter-free slab multiply-adds) on the wider
    grid, against the same reference."""
    ref, _ = _pair((12, 26), 20)
    grid = FwiProblem((12, 26), GEOM, DT, 20, source=(0.45, 0.55),
                      receivers=RECEIVERS, dtype=jnp.float64, engine="grid")
    c2 = _c2(ref, seed=6)
    np.testing.assert_allclose(np.asarray(grid.simulate(c2)),
                               np.asarray(ref.simulate(c2)),
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("sponge", [False, True])
def test_multishot_reversal_matches_autodiff(sponge):
    """vmapped shots through the reversal custom_vjp (per-shot strip
    saves under vmap with a sponge) against the reference engine."""
    kw = (dict(sponge_width=0.2, sponge_strength=20.0) if sponge else {})
    ref, rev = _pair((12, 26), 20, **kw)
    srcs = rev.snap_vertices([(0.3, 0.5), (0.7, 0.45)])
    c2 = _c2(ref, seed=11)
    obs = ref.simulate_shots(1.1 * c2, srcs)
    np.testing.assert_allclose(np.asarray(rev.simulate_shots(1.1 * c2,
                                                             srcs)),
                               np.asarray(obs), rtol=1e-11, atol=1e-13)
    g_ref = jax.grad(lambda c: ref.misfit_shots(c, srcs, obs))(c2)
    g_rev = jax.grad(lambda c: rev.misfit_shots(c, srcs, obs))(c2)
    np.testing.assert_allclose(np.asarray(g_rev), np.asarray(g_ref),
                               rtol=1e-8, atol=1e-14)
