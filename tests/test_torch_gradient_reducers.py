"""Port parity of the pose gradient and the gradient refine at every reducer,
one map or M (``kernels.overlap_score_grad``, ``kernels.gradient_refine``,
``matchers.gradient_match``).

The fixture is tests/test_torch_refine.py's: a 160^2 map of the cecum
world's lower corridor from two scans of 128 beams, a scan from a third
pose. Tolerances, as in test_torch_gradient.py and test_torch_refine.py:

- the twin's gradient (autograd over ``overlap_score_ref`` with the
  reducer) against ``jax.grad`` of the reference's ``score_single`` with
  the same ``ScoringConfig`` within 1e-5 x max(1, |g|), the score within
  2e-6, on the beams clear of the reducer's kinks (``clear_of_kinks``: a
  beam within 1e-4 cell of one gets weight 0 on both sides). The general
  overlap's kinks lie where an edge of the endpoint's square (the position
  +- extent / 2) meets a cell edge, and on the integers;
- the obstacle, max and mean reducers and the overlap reducer at window 0
  are piecewise constant: the port's derivative is exactly 0. The
  reference's ``jax.grad`` is exactly 0 for the first three and rounding
  noise for the window-0 overlap (trap r), which the 1e-5 bound covers;
- ``gradient_match`` against the reference's (jitted; ``vmap`` over maps
  for M), pose within 1e-5, prob and trace within 2e-6;
- on the CPU the yardstick loop (``gradient_refine_rounds``) and the
  wrapper equal the twin bit for bit, for every reducer and for M maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

TOL, POSE_TOL, GRAD_TOL, KINK_MARGIN = 2e-6, 1e-5, 1e-5, 1e-4
N_BEAMS = 128

#: (reducer, window, extent): every kind, the general overlap at three
#: extents and radii, and the bilinear one (overlap, extent 1, window 1)
REDUCERS = [("obstacle", 1, 1.0), ("max", 1, 1.0), ("mean", 1, 1.0), ("overlap", 0, 1.0),
            ("overlap", 1, 0.5), ("overlap", 1, 1.6), ("overlap", 2, 2.5), ("overlap", 1, 1.0)]


def _id(r):
    return f"{r[0]}-w{r[1]}-e{r[2]}"


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(N_BEAMS)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, scale)
    cfg = jray.BeamConfig(wall_blur=True, free_impl="dda")
    insert = jax.jit(jray.insert_scan, static_argnums=(1, 4))
    for p in ([-1.0, -1.5, 0.0], [0.0, -1.6, 0.1]):
        s = jray.cast_rays(occ, origin, scale, jnp.asarray(p), bearings)
        gm = insert(gm, model, jnp.asarray(p), s, cfg)
    true = jnp.asarray([0.5, -1.55, 0.05])
    s = jray.cast_rays(occ, origin, scale, true, bearings)
    jview = jscore.MapView.of(gm, model)
    tview = tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)), known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)), scale=jview.scale)
    ts = tscan.LaserScan(torch.from_numpy(np.array(s.ranges)),
                         torch.from_numpy(np.array(s.bearings)),
                         torch.from_numpy(np.array(s.valid)))
    return jview, s, tview, ts, np.array(true)


def configs(reducer, window, extent, stride=1):
    kw = dict(reducer=reducer, window=window, overlap_extent=extent, stride=stride)
    return jscore.ScoringConfig(**kw), tscore.ScoringConfig(**kw)


def poses_near(true, n, seed):
    rng = np.random.default_rng(seed)
    return (true + rng.normal(0, [0.06, 0.06, 0.04], (n, 3))).astype(np.float32)


def m_maps(jview, true):
    """Three maps (the corridor, flipped, shifted) with an origin and a
    start pose each (tests/test_torch_refine.py's)."""
    offs = np.array([[0.12, -0.06, 0.04], [-0.1, 0.05, -0.05], [0.05, 0.1, 0.0]], np.float32)
    occ = np.stack([np.array(jview.occ), np.array(jview.occ)[::-1], np.array(jview.occ)])
    known = np.stack([np.array(jview.known), np.array(jview.known)[::-1],
                      np.array(jview.known)])
    origin = np.array(jview.origin) + np.array([[0, 0], [0.1, 0], [0, -0.1]], np.float32)
    return occ, known, origin, (true + offs).astype(np.float32)


def assert_bits(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x.reshape(-1).view(torch.int32),
                                                  y.reshape(-1).view(torch.int32))


# --- the pose gradient ---------------------------------------------------------------


@pytest.mark.parametrize("red", REDUCERS, ids=[_id(r) for r in REDUCERS])
def test_pose_gradient_matches_jax_grad(setup, red):
    jview, js, tview, ts, true = setup
    jsc, tsc = configs(*red)
    reducer = tscore.reducer_of(tsc)
    prep = tscore.prepare(tview, ts, tsc)
    poses = poses_near(true, 5, seed=len(red[0]) + 10 * red[1])
    grad = jax.jit(jax.value_and_grad(lambda p, w: jscore.score_single(jview, js, p, jsc, w)))
    checked = 0
    for p in poses:
        clear = kernels.clear_of_kinks(torch.from_numpy(p)[None], prep.pts, prep.origin,
                                       prep.scale, KINK_MARGIN, reducer)
        w = clear.to(torch.float32)
        got_s, got_g = kernels.overlap_score_grad(
            prep.plane, torch.from_numpy(p)[None], prep.pts, (prep.beam_w * w).contiguous(),
            prep.origin, prep.scale, prep.unknown, reducer)
        want_s, want_g = grad(jnp.asarray(p), jnp.asarray(w.numpy()))
        want_g = np.asarray(want_g)
        assert abs(float(got_s[0]) - float(want_s)) <= TOL
        tol = GRAD_TOL * max(1.0, float(np.linalg.norm(want_g)))
        np.testing.assert_allclose(got_g[0].numpy(), want_g, atol=tol, rtol=0)
        if reducer.flat:
            assert torch.equal(got_g, torch.zeros_like(got_g))  # exactly, not noise
        else:
            assert np.linalg.norm(want_g) > 0.1  # a real slope
        checked += int(clear.sum())
    assert checked >= 5 * N_BEAMS // 2  # most beams are clear of the kinks


@pytest.mark.parametrize("red", REDUCERS[4:], ids=[_id(r) for r in REDUCERS[4:]])
def test_pose_gradient_over_m_maps_is_each_maps(setup, red):
    """With a leading map dimension every map differentiates its own poses
    with its own scan: each map's rows equal a single-map call (sums of the
    same terms, compared at 1e-7)."""
    jview, _, tview, ts, true = setup
    occ, known, origin, inits = m_maps(jview, true)
    _, tsc = configs(*red)
    maps = tscore.MapView(torch.from_numpy(occ.copy()), torch.from_numpy(known.copy()),
                          torch.from_numpy(origin), tview.scale)
    scans = tscan.LaserScan(*(a.expand(3, -1) for a in (ts.ranges, ts.bearings, ts.valid)))
    prep = tscore.prepare(maps, scans, tsc)
    poses = torch.from_numpy(np.stack([poses_near(i, 4, seed=m) for m, i in enumerate(inits)]))
    score, grad = kernels.overlap_score_grad(prep.plane, poses, prep.pts, prep.beam_w,
                                             prep.origin, prep.scale, prep.unknown, prep.reducer)
    assert score.shape == (3, 4) and grad.shape == (3, 4, 3)
    for m in range(3):
        s1, g1 = kernels.overlap_score_grad(prep.plane[m], poses[m], prep.pts[m], prep.beam_w[m],
                                            prep.origin[m], prep.scale, prep.unknown,
                                            prep.reducer)
        torch.testing.assert_close(score[m], s1, atol=1e-7, rtol=0)
        torch.testing.assert_close(grad[m], g1, atol=1e-6, rtol=0)
    assert float(grad.abs().max()) > 0.1


def test_kinks_of_the_general_overlap():
    """A coordinate at an edge of the square on a cell edge (x + extent / 2
    an integer) is a kink of the general overlap, not of the bilinear taps;
    at a cell's centre it is the other way round."""
    red = kernels.Reducer("overlap", radius=1, extent=1.6)
    origin = torch.zeros(2)
    pose = torch.zeros(1, 3)

    def clear(x, reducer):
        pts = torch.tensor([[x * 0.1, 0.437 * 0.1]])
        return bool(kernels.clear_of_kinks(pose, pts, origin, 0.1, KINK_MARGIN, reducer)[0])

    assert not clear(7.2, red) and clear(7.2, kernels.BILINEAR)  # 7.2 + 0.8 = 8
    assert not clear(7.8, red)  # 7.8 - 0.8 = 7
    assert clear(7.5, red) and not clear(7.5, kernels.BILINEAR)
    assert not clear(7.0, red) and not clear(7.0, kernels.Reducer("obstacle"))
    assert clear(7.3, kernels.Reducer("max", radius=2))


# --- the gradient refine ---------------------------------------------------------------


@pytest.mark.parametrize("red", REDUCERS, ids=[_id(r) for r in REDUCERS])
def test_gradient_match_matches_reference(setup, red):
    jview, js, tview, ts, true = setup
    jsc, tsc = configs(*red)
    init = (true + np.float32([0.05, -0.04, 0.03])).astype(np.float32)
    kw = dict(iterations=10, step_xy=0.04, step_theta=0.02)
    want = jax.jit(lambda p: jmatch.gradient_match(
        jview, js, p, None, jmatch.GradientConfig(scoring=jsc, **kw)))(jnp.asarray(init))
    got = tmatch.gradient_match(tview, ts, torch.from_numpy(init), None,
                                tmatch.GradientConfig(scoring=tsc, **kw))
    assert got.pose.shape == (3,) and got.trace.shape == (10,)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=POSE_TOL, rtol=0)
    assert abs(float(got.prob) - float(want.prob)) <= TOL
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), atol=TOL, rtol=0)
    if tscore.reducer_of(tsc).flat:
        assert torch.equal(got.pose, torch.from_numpy(init))
    else:
        assert float(got.prob) > float(got.trace[0]) - 1e-12 and not torch.equal(
            got.pose, torch.from_numpy(init))


@pytest.mark.parametrize("red", [("obstacle", 1, 1.0), ("overlap", 2, 2.5), ("overlap", 1, 1.0)],
                         ids=_id)
def test_gradient_match_over_m_maps_matches_reference(setup, red):
    """M maps in one call against the reference's ``vmap`` of its
    ``gradient_match`` over the maps (the RBPF's and the loop closer's
    form), every second beam."""
    jview, js, tview, ts, true = setup
    occ, known, origin, inits = m_maps(jview, true)
    jsc, tsc = configs(*red, stride=2)
    kw = dict(iterations=8, step_xy=0.04, step_theta=0.02)
    jmaps = jscore.MapView(occ=jnp.asarray(occ), known=jnp.asarray(known),
                           origin=jnp.asarray(origin), scale=jview.scale)
    jcfg = jmatch.GradientConfig(scoring=jsc, **kw)
    want = jax.jit(jax.vmap(lambda v, p: jmatch.gradient_match(v, js, p, None, jcfg)))(
        jmaps, jnp.asarray(inits))
    tmaps = tscore.MapView(torch.from_numpy(occ.copy()), torch.from_numpy(known.copy()),
                           torch.from_numpy(origin), tview.scale)
    scans = tscan.LaserScan(*(a.expand(3, -1) for a in (ts.ranges, ts.bearings, ts.valid)))
    got = tmatch.gradient_match(tmaps, scans, torch.from_numpy(inits), None,
                                tmatch.GradientConfig(scoring=tsc, **kw))
    assert got.pose.shape == (3, 3) and got.prob.shape == (3,) and got.trace.shape == (3, 8)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(got.prob.numpy(), np.asarray(want.prob), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), atol=TOL, rtol=0)


@pytest.mark.parametrize("red", [("obstacle", 1, 1.0), ("mean", 2, 1.0), ("overlap", 0, 1.0),
                                 ("overlap", 2, 2.5), ("overlap", 1, 1.0)], ids=_id)
@pytest.mark.parametrize("n_maps", [0, 3])
def test_refine_twin_equals_the_launch_loop_on_cpu(setup, red, n_maps):
    """One map (``n_maps`` 0) or M, every reducer: the yardstick loop and the
    wrapper equal the twin bit for bit on the CPU; a piecewise-constant
    score keeps the start pose and fills the trace with its score."""
    jview, _, tview, ts, true = setup
    _, tsc = configs(*red)
    if n_maps == 0:
        prep = tscore.prepare(tview, ts, tsc)
        pose = torch.from_numpy(true + np.float32([0.05, -0.03, 0.02]))
    else:
        occ, known, origin, inits = m_maps(jview, true)
        maps = tscore.MapView(torch.from_numpy(occ.copy()), torch.from_numpy(known.copy()),
                              torch.from_numpy(origin), tview.scale)
        scans = tscan.LaserScan(*(a.expand(3, -1) for a in (ts.ranges, ts.bearings, ts.valid)))
        prep = tscore.prepare(maps, scans, tsc)
        pose = torch.from_numpy(inits)
    args = (prep.plane, prep.pts, prep.beam_w, prep.origin, pose, prep.scale, prep.unknown,
            0.04, 0.02, 9, 0.5, prep.reducer)
    ref = kernels.gradient_refine_ref(*args)
    assert_bits(kernels.gradient_refine_rounds(*args), ref)
    assert_bits(kernels.gradient_refine(*args), ref)
    lead = pose.shape[:-1]
    assert ref[0].shape == pose.shape and ref[1].shape == lead and ref[2].shape == (*lead, 9)
    if prep.reducer.flat:
        assert torch.equal(ref[0], pose)
        assert torch.equal(ref[2], ref[1][..., None].expand(*lead, 9))
        score = kernels.overlap_score_ref(prep.plane, pose[..., None, :], prep.pts, prep.beam_w,
                                          prep.origin, prep.scale, prep.unknown, prep.reducer)
        assert torch.equal(ref[1], score[..., 0])


@pytest.mark.parametrize("offset,reference_moves", [
    ([0.18, -0.14, 0.06], True), ([0.05, -0.04, 0.03], False), ([-0.1, 0.07, -0.02], True)])
def test_window_zero_overlap_takes_the_exact_zero(setup, offset, reference_moves):
    """Trap r. At window 0 the overlap score ``(v w) / max(w, 1e-9)`` is the
    cell's value, constant in the pose inside a cell. The reference's
    autodiff leaves rounding noise in its gradient (~1e-8 here), which
    ``g / (|g| + 1e-12)`` turns into a full unit step in a direction set by
    rounding, kept whenever it happens to score better. The port takes the
    exact 0: it keeps the start pose and its score. Measured on this
    fixture (24 iterations): from two of these three starts the reference's
    refine moves (by at most 2.2e-3 m, its score up by 1.3e-3 and 5.2e-3),
    from the third it stays."""
    jview, js, tview, ts, true = setup
    jsc, tsc = configs("overlap", 0, 1.0)
    init = (true + np.float32(offset)).astype(np.float32)
    g = np.asarray(jax.jit(jax.grad(lambda p: jscore.score_single(jview, js, p, jsc)))(
        jnp.asarray(init)))
    assert 0 < np.linalg.norm(g) < 1e-6  # noise
    prep = tscore.prepare(tview, ts, tsc)
    start, got_g = kernels.overlap_score_grad(
        prep.plane, torch.from_numpy(init)[None], prep.pts, prep.beam_w, prep.origin, prep.scale,
        prep.unknown, prep.reducer)
    assert torch.equal(got_g, torch.zeros_like(got_g))
    want = jax.jit(lambda p: jmatch.gradient_match(jview, js, p, None,
                                                   jmatch.GradientConfig(scoring=jsc)))(
        jnp.asarray(init))
    got = tmatch.gradient_match(tview, ts, torch.from_numpy(init), None,
                                tmatch.GradientConfig(scoring=tsc))
    assert torch.equal(got.pose, torch.from_numpy(init)) and torch.equal(got.prob, start[0])
    moved = np.abs(np.asarray(want.pose) - init).max()
    assert (moved > 0) == reference_moves and moved < 2.5e-3
    if reference_moves:
        assert float(want.prob) > float(got.prob) + 1e-3
    else:
        assert abs(float(got.prob) - float(want.prob)) <= TOL
