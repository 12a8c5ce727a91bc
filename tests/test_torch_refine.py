"""Port parity of the two refines that run in one launch on the card:
``kernels.gradient_refine`` (the gradient matcher's ascent) and
``kernels.hill_climb`` (the hill-climbing matcher, one map or M), through
their plain twins ``gradient_refine_ref`` and ``hill_climb_ref``.

The twins are held to the reference's ``gradient_match`` and
``hill_climbing_match`` (jitted, on the CPU) at the tolerances of
test_torch_gradient.py and test_torch_matchers.py: pose 1e-5, prob and
trace 2e-6 (the scores' sums run in another order, so a step can only be
decided otherwise where two scores lie within that much). On the CPU the
multi-launch loops (``gradient_refine_rounds``, ``hill_climb_rounds``, the
card's bitwise yardsticks) score through the same twins, so they equal the
twins bit for bit; the matchers route CPU tensors to the twins and launch
nothing; bad shapes raise before anything runs.
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

TOL = 2e-6
POSE_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """A 160^2 map of the lower corridor from two scans of 128 beams, and a
    scan from a third pose."""
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(128)
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


def weights(n, seed):
    return np.random.default_rng(seed).uniform(0.2, 1.0, n).astype(np.float32)


def prepared(tview, ts, stride=1, w=None):
    sc = tscore.ScoringConfig(reducer="overlap", window=1, stride=stride)
    return tscore.prepare(tview, ts, sc, None if w is None else torch.from_numpy(w))


def refine_args(prep, pose, cfg):
    return (prep.plane, prep.pts, prep.beam_w, prep.origin, pose, prep.scale, prep.unknown,
            cfg.step_xy, cfg.step_theta, cfg.iterations, cfg.shrink)


def assert_bits(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x.reshape(-1).view(torch.int32),
                                                  y.reshape(-1).view(torch.int32))


# --- the gradient refine --------------------------------------------------------


@pytest.mark.parametrize("offset,iterations,stride,weighted", [
    ([0.04, -0.03, 0.02], 12, 1, False),
    ([-0.06, 0.05, -0.03], 12, 1, True),
    ([0.03, 0.02, -0.02], 8, 2, False),
    ([0.0, 0.0, 0.0], 0, 1, False),
])
def test_gradient_refine_ref_matches_reference(setup, offset, iterations, stride, weighted):
    jview, js, tview, ts, true = setup
    init = (true + np.asarray(offset, np.float32)).astype(np.float32)
    w = weights(128, 3) if weighted else None
    jcfg = jmatch.GradientConfig(
        iterations=iterations, step_xy=0.03, step_theta=0.015,
        scoring=jscore.ScoringConfig(reducer="overlap", window=1, stride=stride))
    tcfg = tmatch.GradientConfig(iterations=iterations, step_xy=0.03, step_theta=0.015)
    want = jax.jit(lambda p, pw: jmatch.gradient_match(jview, js, p, None, jcfg, pw))(
        jnp.asarray(init), None if w is None else jnp.asarray(w))
    prep = prepared(tview, ts, stride, w)
    pose, prob, trace = kernels.gradient_refine_ref(*refine_args(prep, torch.from_numpy(init),
                                                                 tcfg))
    assert pose.shape == (3,) and prob.shape == () and trace.shape == (iterations,)
    np.testing.assert_allclose(pose.numpy(), np.asarray(want.pose), atol=POSE_TOL, rtol=0)
    assert abs(float(prob) - float(want.prob)) <= TOL
    np.testing.assert_allclose(trace.numpy(), np.asarray(want.trace), atol=TOL, rtol=0)


@pytest.mark.parametrize("iterations", [0, 1, 12])
def test_gradient_twin_equals_the_launch_loop_on_cpu(setup, iterations):
    """On the CPU the yardstick loop scores through ``overlap_score_grad``'s
    twin: the same bits as ``gradient_refine_ref``, and the wrapper takes
    the twin."""
    _, _, tview, ts, true = setup
    prep = prepared(tview, ts, 1, weights(128, 4))
    cfg = tmatch.GradientConfig(iterations=iterations, step_xy=0.03, step_theta=0.015)
    args = refine_args(prep, torch.from_numpy(true + np.float32([0.05, 0.03, -0.02])), cfg)
    ref = kernels.gradient_refine_ref(*args)
    assert_bits(kernels.gradient_refine_rounds(*args), ref)
    assert_bits(kernels.gradient_refine(*args), ref)


def test_gradient_norm_is_written_out(setup):
    """The loop's |g| is sqrt((gx^2 + gy^2) + gth^2), the kernel's order:
    a step along a gradient handed in lands where that expression puts it."""
    _, _, tview, ts, true = setup
    prep = prepared(tview, ts)
    g = torch.tensor([3.0, -4.0, 12.0])
    seen = []

    def score_grad(v, poses, *args):
        seen.append(poses[0].clone())
        return torch.zeros(1), g[None] if len(seen) == 1 else torch.zeros(1, 3)

    start = torch.tensor([0.5, -1.55, 0.05])
    kernels.gradient_refine_loop(score_grad, prep.plane, prep.pts, prep.beam_w, prep.origin,
                                 start, prep.scale, prep.unknown, 0.03, 0.015, 1, 0.5)
    sq = g * g
    gn = g / (torch.sqrt((sq[0] + sq[1]) + sq[2]) + 1e-12)
    want = start + torch.tensor([0.03, 0.03, 0.015]) * gn
    assert torch.equal(seen[1][:2], want[:2])
    assert abs(float(seen[1][2] - want[2])) < 1e-6  # wrapped


# --- the hill climb ---------------------------------------------------------------


@pytest.mark.parametrize("offset,step_xy,step_theta,iterations,stride,weighted", [
    ([0.12, -0.06, 0.04], 0.1, 0.05, 8, 2, False),
    ([-0.05, 0.03, -0.02], 0.05, 0.0125, 12, 1, True),
    ([0.08, 0.05, 0.03], 0.025, 0.01, 10, 1, False),
    ([0.0, 0.0, 0.0], 0.1, 0.05, 0, 2, False),
])
def test_hill_climb_ref_matches_reference(setup, offset, step_xy, step_theta, iterations, stride,
                                          weighted):
    jview, js, tview, ts, true = setup
    init = (true + np.asarray(offset, np.float32)).astype(np.float32)
    w = weights(128, 5) if weighted else None
    jcfg = jmatch.HillClimbingConfig(
        step_xy=step_xy, step_theta=step_theta, iterations=iterations,
        scoring=jscore.ScoringConfig(reducer="overlap", window=1, stride=stride))
    tcfg = tmatch.HillClimbingConfig(step_xy=step_xy, step_theta=step_theta,
                                     iterations=iterations)
    want = jax.jit(lambda p, pw: jmatch.hill_climbing_match(jview, js, p, None, jcfg, pw))(
        jnp.asarray(init), None if w is None else jnp.asarray(w))
    prep = prepared(tview, ts, stride, w)
    pose, prob, trace = kernels.hill_climb_ref(*refine_args(prep, torch.from_numpy(init), tcfg))
    assert pose.shape == (3,) and prob.shape == () and trace.shape == (iterations,)
    np.testing.assert_allclose(pose.numpy(), np.asarray(want.pose), atol=POSE_TOL, rtol=0)
    assert abs(float(prob) - float(want.prob)) <= TOL
    np.testing.assert_allclose(trace.numpy(), np.asarray(want.trace), atol=TOL, rtol=0)


def m_maps(jview, true):
    """Three maps (the corridor, flipped, shifted) with an origin and a
    start pose each."""
    offs = np.array([[0.12, -0.06, 0.04], [-0.1, 0.05, -0.05], [0.05, 0.1, 0.0]], np.float32)
    occ = np.stack([np.array(jview.occ), np.array(jview.occ)[::-1], np.array(jview.occ)])
    known = np.stack([np.array(jview.known), np.array(jview.known)[::-1],
                      np.array(jview.known)])
    origin = np.array(jview.origin) + np.array([[0, 0], [0.1, 0], [0, -0.1]], np.float32)
    return occ, known, origin, (true + offs).astype(np.float32)


@pytest.mark.parametrize("iterations", [6, 0])
def test_hill_climb_ref_over_m_maps_matches_reference(setup, iterations):
    jview, js, tview, ts, true = setup
    occ, known, origin, inits = m_maps(jview, true)
    jcfg = jmatch.HillClimbingConfig(
        iterations=iterations, scoring=jscore.ScoringConfig(reducer="overlap", stride=2))
    jmaps = jscore.MapView(occ=jnp.asarray(occ), known=jnp.asarray(known),
                           origin=jnp.asarray(origin), scale=jview.scale)
    want = jax.jit(jax.vmap(lambda v, p: jmatch.hill_climbing_match(v, js, p, None, jcfg)))(
        jmaps, jnp.asarray(inits))
    tmaps = tscore.MapView(occ=torch.from_numpy(occ.copy()), known=torch.from_numpy(known.copy()),
                           origin=torch.from_numpy(origin), scale=tview.scale)
    scans = tscan.LaserScan(*(a.expand(3, -1) for a in (ts.ranges, ts.bearings, ts.valid)))
    prep = tscore.prepare(tmaps, scans, tscore.ScoringConfig(reducer="overlap", stride=2))
    tcfg = tmatch.HillClimbingConfig(iterations=iterations)
    pose, prob, trace = kernels.hill_climb_ref(*refine_args(prep, torch.from_numpy(inits), tcfg))
    assert pose.shape == (3, 3) and prob.shape == (3,) and trace.shape == (3, iterations)
    np.testing.assert_allclose(pose.numpy(), np.asarray(want.pose), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want.prob), atol=TOL, rtol=0)
    np.testing.assert_allclose(trace.numpy(), np.asarray(want.trace), atol=TOL, rtol=0)


@pytest.mark.parametrize("n_maps", [0, 1, 3])
def test_hill_climb_twin_equals_the_launch_loop_on_cpu(setup, n_maps):
    """One map (``n_maps`` 0) or M: the yardstick loop (one score call a
    round) and the wrapper equal the twin bit for bit on the CPU."""
    jview, _, tview, ts, true = setup
    cfg = tmatch.HillClimbingConfig(iterations=7)
    if n_maps == 0:
        args = refine_args(prepared(tview, ts), torch.from_numpy(true + np.float32(
            [0.1, -0.05, 0.03])), cfg)
    else:
        occ, known, origin, inits = m_maps(jview, true)
        maps = tscore.MapView(torch.from_numpy(occ[:n_maps].copy()),
                              torch.from_numpy(known[:n_maps].copy()),
                              torch.from_numpy(origin[:n_maps]), tview.scale)
        scans = tscan.LaserScan(*(a.expand(n_maps, -1) for a in (ts.ranges, ts.bearings,
                                                                  ts.valid)))
        prep = tscore.prepare(maps, scans, tscore.ScoringConfig(reducer="overlap"))
        args = refine_args(prep, torch.from_numpy(inits[:n_maps]), cfg)
    ref = kernels.hill_climb_ref(*args)
    assert_bits(kernels.hill_climb_rounds(*args), ref)
    assert_bits(kernels.hill_climb(*args), ref)


# --- routing and checks ------------------------------------------------------------


@pytest.mark.parametrize("matcher,twin", [("gradient", "gradient_refine_ref"),
                                          ("hill_climbing", "hill_climb_ref")])
def test_matchers_route_cpu_tensors_to_the_twins(setup, monkeypatch, matcher, twin):
    _, _, tview, ts, true = setup
    calls = []
    plain = getattr(kernels, twin)
    monkeypatch.setattr(kernels, twin, lambda *a: calls.append(a[0].device) or plain(*a))
    kernels.reset_launch_counts()
    cfg_cls, match = tmatch.MATCHERS[matcher]
    res = match(tview, ts, torch.from_numpy(true + np.float32([0.05, -0.03, 0.02])), None,
                cfg_cls(iterations=4, scoring=tscore.ScoringConfig(reducer="overlap")))
    assert calls == [torch.device("cpu")]
    assert not any(kernels.launch_counts().values())
    assert res.pose.shape == (3,) and res.trace.shape == (4,)
    assert float(res.prob) >= float(res.trace[0])


def bad_cases(prep, pose):
    """(what, args) of a single-map refine with one input of a wrong shape."""
    a = [prep.plane, prep.pts, prep.beam_w, prep.origin, pose]
    cases = []
    for i, (what, bad) in enumerate((
            ("plane without its rows", prep.plane[0]),
            ("points of 3 coordinates", torch.zeros(prep.pts.shape[0], 3)),
            ("a weight short", prep.beam_w[:-1]),
            ("origin of 3", torch.zeros(3)),
            ("pose of 2", pose[:2]),
            ("poses of 2 maps", pose.expand(2, 3)))):
        b = list(a)
        b[i if i < 5 else 4] = bad
        cases.append((what, b))
    return cases


@pytest.mark.parametrize("refine", ["gradient_refine", "hill_climb"])
def test_refines_reject_bad_shapes(setup, refine):
    _, _, tview, ts, true = setup
    prep = prepared(tview, ts)
    fn = getattr(kernels, refine)
    pose = torch.from_numpy(true)
    tail = (prep.scale, prep.unknown, 0.03, 0.015)
    for what, a in bad_cases(prep, pose):
        with pytest.raises(ValueError):
            fn(*a, *tail, 4, 0.5)
    with pytest.raises(ValueError):  # a negative count of iterations
        fn(prep.plane, prep.pts, prep.beam_w, prep.origin, pose, *tail, -1, 0.5)
    m = (prep.plane.expand(2, -1, -1), prep.pts.expand(2, -1, -1), prep.beam_w.expand(2, -1),
         prep.origin.expand(2, -1))
    if refine == "gradient_refine":  # one map only
        with pytest.raises(ValueError):
            fn(*m, pose.expand(2, 3), *tail, 4, 0.5)
    else:  # M maps with the poses of another M
        with pytest.raises(ValueError):
            fn(*m, pose.expand(3, 3), *tail, 4, 0.5)
