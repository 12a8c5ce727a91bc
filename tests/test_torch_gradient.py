"""Port parity of the gradient refine: ``kernels.overlap_score_grad_ref``
(the plain twin of the pose-gradient kernel: autograd over the score's
twin) and ``matchers.gradient_match`` against
``jax.grad(scoring.score_single)`` and the reference's ``gradient_match``,
and the engine with a refine stage against the reference's engine.

The overlap score is piecewise bilinear in an endpoint's cell position:
its derivative jumps where a coordinate crosses a cell's centre (a tap
changes) or edge (the reference's window changes), and at such a tie JAX
splits the gradient: on a cell's centre the reference's derivative is the
mean of its two sides', and so is the twin's (one test puts endpoints
there). The other test poses keep every endpoint at least 1e-4 cell from
both. There the twin's gradient agrees with the reference's within
1e-5 x max(1, |g|) (the sums run in another order, and the reference's
derivative of its window's total weight, 0 exactly, is not 0 in f32); the
score within 2e-6. A refine steps along g / |g|, so a gradient apart by
1e-6 moves a candidate by ~1e-7 m, and keep-if-better can fall the other
way where two scores lie that close (trap i): single refines are held to
1e-5 m and 2e-6 in probability, the engine runs to 1e-4 m, as the tinySLAM
engine test holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatchers
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscoring
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import matchers as tmatchers
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscoring
from slam_constructor_tpu_torch.ops.scan import LaserScan as TScan
from slam_constructor_tpu_torch.ops.scan import scan_points
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)

MAP, N_BEAMS, SCALE = 160, 96, 0.1
KINK_MARGIN = 1e-4  # cells


@pytest.fixture(scope="module")
def scene():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.1)[:10] + torch.tensor([0.013, 0.021, 0.0])
    scans, odom, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS), rng=7,
        odom_noise_xy=0.02, odom_noise_theta=0.01)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, MAP, MAP, SCALE)
    insert = jax.jit(jray.insert_scan, static_argnums=(1, 4))
    for i in range(0, 10, 2):
        gm = insert(gm, model, jnp.asarray(gt[i].numpy()), jscan(scans, i),
                    jray.BeamConfig(free_impl="dda", wall_blur=True))
    view = jscoring.MapView.of(gm, model)
    tview = tscoring.MapView(
        occ=torch.from_numpy(np.array(view.occ)), known=torch.from_numpy(np.array(view.known)),
        origin=torch.from_numpy(np.array(view.origin)), scale=view.scale)
    return dict(scans=scans, odom=odom, gt=gt, view=view, tview=tview)


def jscan(scans, i):
    return JScan(jnp.asarray(scans.ranges[i].numpy()), jnp.asarray(scans.bearings[i].numpy()),
                 jnp.asarray(scans.valid[i].numpy()))


def clear_of_kinks(pose, scan, origin, stride):
    """Every valid endpoint (of the kept beams) at least KINK_MARGIN cell
    from a cell's centre and edge on both axes."""
    clear = kernels.clear_of_kinks(torch.from_numpy(pose)[None], scan_points(scan)[::stride],
                                   torch.from_numpy(origin), SCALE, KINK_MARGIN)
    return bool((clear | ~scan.valid[::stride]).all())


def random_poses(scene, scan, stride, n, seed):
    rng = np.random.default_rng(seed)
    origin = scene["tview"].origin.numpy()
    out = []
    while len(out) < n:
        p = (scene["gt"][5].numpy() + rng.normal(0, [0.06, 0.06, 0.04])).astype(np.float32)
        if clear_of_kinks(p, scan, origin, stride):
            out.append(p)
    return out


@pytest.mark.parametrize("stride,weighted", [(1, False), (2, False), (1, True), (3, True)])
def test_twin_gradient_matches_jax_grad(scene, stride, weighted):
    scan = scene["scans"][5]
    js = jscan(scene["scans"], 5)
    w = np.random.default_rng(1).uniform(0.2, 1.0, N_BEAMS).astype(np.float32) if weighted else None
    jsc = jscoring.ScoringConfig(reducer="overlap", window=1, stride=stride)
    tsc = tscoring.ScoringConfig(reducer="overlap", window=1, stride=stride)
    jw = None if w is None else jnp.asarray(w)
    grad = jax.jit(jax.value_and_grad(
        lambda p: jscoring.score_single(scene["view"], js, p, jsc, jw)))
    prep = tscoring.prepare(scene["tview"], scan, tsc, None if w is None else torch.from_numpy(w))
    poses = random_poses(scene, scan, stride, 6, seed=stride + 10 * weighted)
    got_s, got_g = kernels.overlap_score_grad_ref(
        prep.plane, torch.from_numpy(np.stack(poses)), prep.pts, prep.beam_w, prep.origin,
        prep.scale, prep.unknown)
    for i, p in enumerate(poses):
        want_s, want_g = grad(jnp.asarray(p))
        want_g = np.asarray(want_g)
        assert abs(float(got_s[i]) - float(want_s)) <= 2e-6
        tol = 1e-5 * max(1.0, float(np.linalg.norm(want_g)))
        np.testing.assert_allclose(got_g[i].numpy(), want_g, atol=tol, rtol=0)
        assert np.linalg.norm(want_g) > 0.1  # a real slope, not a flat patch


@pytest.mark.parametrize("py,r0", [(2.3, 2.25), (2.25, 2.3), (2.25, 2.25)])
def test_twin_gradient_on_a_cell_centre_matches_jax_grad(py, r0):
    """An endpoint exactly on a cell's centre, along x (r0 = 2.25), y
    (py = 2.25) or both: there JAX's ``max`` and ``min`` split the tie, so
    the reference's derivative is the mean of the two sides'. The twin
    takes the same mean. Cells of 0.5 m and a pose at heading 0 put the
    endpoints of the beams at bearing 0 on the same bits on both sides;
    every beam weighs in."""
    rng = np.random.default_rng(4)
    occ = rng.uniform(0.05, 0.95, (16, 16)).astype(np.float32)
    known = rng.uniform(size=(16, 16)) < 0.9
    bearings = np.concatenate([np.zeros(3), rng.uniform(-np.pi, np.pi, 13)]).astype(np.float32)
    ranges = np.concatenate([[r0, r0 + 1.0, r0 + 2.0], rng.uniform(1.0, 3.5, 13)])
    ranges = ranges.astype(np.float32)
    pose = np.float32([1.0, py, 0.0])
    cfg = dict(reducer="overlap", window=1)
    view = jscoring.MapView(jnp.asarray(occ), jnp.asarray(known), jnp.zeros(2, jnp.float32), 0.5)
    js = JScan(jnp.asarray(ranges), jnp.asarray(bearings), jnp.ones(16, bool))
    want_s, want_g = jax.jit(jax.value_and_grad(
        lambda p: jscoring.score_single(view, js, p, jscoring.ScoringConfig(**cfg))))(
        jnp.asarray(pose))
    tview = tscoring.MapView(torch.from_numpy(occ), torch.from_numpy(known), torch.zeros(2), 0.5)
    tscan = TScan(torch.from_numpy(ranges), torch.from_numpy(bearings),
                  torch.ones(16, dtype=torch.bool))
    prep = tscoring.prepare(tview, tscan, tscoring.ScoringConfig(**cfg))
    on_centre = ~kernels.clear_of_kinks(torch.from_numpy(pose)[None], prep.pts, prep.origin,
                                        0.5, KINK_MARGIN)
    assert bool(on_centre[:3].all())
    got_s, got_g = kernels.overlap_score_grad_ref(
        prep.plane, torch.from_numpy(pose)[None], prep.pts, prep.beam_w, prep.origin, prep.scale,
        prep.unknown)
    want_g = np.asarray(want_g)
    assert abs(float(got_s[0]) - float(want_s)) <= 2e-6
    tol = 1e-5 * max(1.0, float(np.linalg.norm(want_g)))
    np.testing.assert_allclose(got_g[0].numpy(), want_g, atol=tol, rtol=0)
    assert np.linalg.norm(want_g) > 0.1


def test_score_of_the_gradient_is_overlap_score(scene):
    """The twin's score is ``overlap_score``'s bits (the refine keeps a
    candidate by it), and each pose's gradient is its own: a batch of K
    poses gives the rows of K single calls."""
    scan = scene["scans"][5]
    prep = tscoring.prepare(scene["tview"], scan, tscoring.ScoringConfig(reducer="overlap"))
    poses = torch.from_numpy(np.stack(random_poses(scene, scan, 1, 3, seed=5)))
    args = (prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    score, dscore = kernels.overlap_score_grad(prep.plane, poses, *args)
    assert torch.equal(score, kernels.overlap_score(prep.plane, poses, *args))
    for i in range(poses.shape[0]):
        one_s, one_g = kernels.overlap_score_grad(prep.plane, poses[i:i + 1], *args)
        torch.testing.assert_close(one_s, score[i:i + 1], atol=0, rtol=0)
        torch.testing.assert_close(one_g, dscore[i:i + 1], atol=1e-7, rtol=0)


@pytest.mark.parametrize("offset,weighted", [
    ((0.04, -0.03, 0.02), False), ((-0.06, 0.05, -0.03), True), ((0.0, 0.0, 0.0), False)])
def test_gradient_match_matches_reference(scene, offset, weighted):
    scan, js = scene["scans"][5], jscan(scene["scans"], 5)
    init = (scene["gt"][5].numpy() + np.array(offset, np.float32)).astype(np.float32)
    w = np.random.default_rng(2).uniform(0.2, 1.0, N_BEAMS).astype(np.float32) if weighted else None
    jcfg = jmatchers.GradientConfig(
        iterations=12, step_xy=0.03, step_theta=0.015,
        scoring=jscoring.ScoringConfig(reducer="overlap", window=1))
    tcfg = tmatchers.GradientConfig(
        iterations=12, step_xy=0.03, step_theta=0.015,
        scoring=tscoring.ScoringConfig(reducer="overlap", window=1))
    ref = jax.jit(lambda p, pw: jmatchers.gradient_match(scene["view"], js, p, None, jcfg, pw))(
        jnp.asarray(init), None if w is None else jnp.asarray(w))
    got = tmatchers.gradient_match(scene["tview"], scan, torch.from_numpy(init), None, tcfg,
                                   None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-5, rtol=0)
    assert abs(float(got.prob) - float(ref.prob)) <= 2e-6
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace), atol=2e-6, rtol=0)
    assert float(got.prob) >= float(got.trace[0]) and got.trace.shape == (12,)
    # deterministic, and registered for the config system
    again = tmatchers.MATCHERS["gradient"][1](scene["tview"], scan, torch.from_numpy(init),
                                              None, tcfg,
                                              None if w is None else torch.from_numpy(w))
    assert torch.equal(again.pose, got.pose)


@pytest.mark.parametrize("refine", ["gradient", "hill_climbing", "brute_force"])
def test_engine_with_refine_matches_reference(scene, refine):
    """8 scans through both engines, a Monte-Carlo match then the refine,
    with the reference's matcher normals injected: poses within 1e-4."""
    scans, odom, gt = scene["scans"], scene["odom"], scene["gt"]
    n, batch, rounds = 8, 16, 4
    sc = dict(reducer="overlap", window=1)
    refine_kw = {"gradient": dict(iterations=6, step_xy=0.03, step_theta=0.015),
                 "hill_climbing": dict(iterations=5, step_xy=0.025, step_theta=0.01),
                 "brute_force": dict(half_x=0.05, half_y=0.05, half_theta=0.02, n_x=5, n_y=5,
                                     n_theta=5)}[refine]
    mc = dict(sigma_xy=0.08, sigma_theta=0.05, batch=batch, rounds=rounds)
    base = dict(map_height=MAP, map_width=MAP, map_scale=SCALE, refine_matcher=refine)
    jrc = jmatchers.MATCHERS[refine][0](scoring=jscoring.ScoringConfig(**sc), **refine_kw)
    trc = tmatchers.MATCHERS[refine][0](scoring=tscoring.ScoringConfig(**sc), **refine_kw)
    jcfg = jeng.EngineConfig(
        matcher_cfg=jmatchers.MonteCarloConfig(scoring=jscoring.ScoringConfig(**sc), **mc),
        beam=jray.BeamConfig(free_impl="dda", wall_blur=True), refine_cfg=jrc, **base)
    tcfg = teng.EngineConfig(
        matcher_cfg=tmatchers.MonteCarloConfig(scoring=tscoring.ScoringConfig(**sc), **mc),
        beam=tray.BeamConfig(wall_blur=True), refine_cfg=trc, **base)
    js = JScan(jnp.asarray(scans.ranges[:n].numpy()), jnp.asarray(scans.bearings[:n].numpy()),
               jnp.asarray(scans.valid[:n].numpy()))
    state = jeng.init_state(jcfg).replace(pose=jnp.asarray(gt[0].numpy()))
    _, jtraj, jprobs = jeng.run_sequence(jcfg, state, js, jnp.asarray(odom[:n].numpy()))
    key, noise = jax.random.PRNGKey(0), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        noise.append(np.stack([np.asarray(jax.random.normal(k, (batch, 3)))
                               for k in jax.random.split(sub, rounds)]))
    e = teng.Engine(tcfg, device="cpu")
    e.state = dataclasses.replace(e.state, pose=gt[0].clone())
    traj, probs = e.run(scans[:n], odom[:n], noise=torch.from_numpy(np.stack(noise)))
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-4, rtol=0)
