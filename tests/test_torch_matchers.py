"""Port parity: the Monte-Carlo matcher with the reference's noise injected.

The reference draws ``jax.random.normal(keys[r], (batch, 3))`` per round
with ``keys = jax.random.split(key, rounds)``; the test draws the same
numbers and hands them to the port. Scores agree to 2e-6 (see
test_torch_scoring.py), so every round keeps the same candidate: the pose
agrees within 1e-5 (a few ulps of sin/cos/atan2 in the candidate draw),
prob and the per-round trace within 2e-6.

The match itself is ``kernels.mc_match``: on a CPU tensor its plain twin
``mc_match_ref``, which is held here against the reference's gather path
over batch sizes, round counts (0 and 1 included), an anneal that fires,
beam weights and stride 2; and whose tie, NaN and no-launch behaviour the
CUDA kernel has to share.
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
from slam_constructor_tpu_torch.ops import geometry as tgeo
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import prng as tprng
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

BATCH, ROUNDS = 16, 4


def reference_noise(key, rounds, batch):
    """The standard normals the reference matcher draws from ``key``."""
    keys = jax.random.split(key, rounds)
    return np.stack([np.asarray(jax.random.normal(k, (batch, 3))) for k in keys])


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(128)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, scale)
    cfg = jray.BeamConfig(wall_blur=True, free_impl="dda")
    # a map from two scans along the lower corridor
    for p in ([-1.0, -1.5, 0.0], [0.0, -1.6, 0.1]):
        s = jray.cast_rays(occ, origin, scale, jnp.asarray(p), bearings)
        gm = jray.insert_scan(gm, model, jnp.asarray(p), s, cfg)
    true = jnp.asarray([0.5, -1.55, 0.05])
    s = jray.cast_rays(occ, origin, scale, true, bearings)
    jview = jscore.MapView.of(gm, model)
    tview = tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)), known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)), scale=jview.scale,
    )
    ts = tscan.LaserScan(
        torch.from_numpy(np.array(s.ranges)), torch.from_numpy(np.array(s.bearings)),
        torch.from_numpy(np.array(s.valid)),
    )
    return jview, s, tview, ts, np.asarray(true)


@pytest.mark.parametrize("seed,offset", [(0, [0.12, -0.06, 0.04]), (1, [-0.1, 0.05, -0.05]),
                                         (2, [0.0, 0.0, 0.0])])
def test_monte_carlo_match_matches_reference(setup, seed, offset):
    jview, js, tview, ts, true = setup
    init = (true + np.asarray(offset, np.float32)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    sc = dict(reducer="overlap", window=1)
    jcfg = jmatch.MonteCarloConfig(sigma_xy=0.08, sigma_theta=0.05, batch=BATCH, rounds=ROUNDS,
                                   scoring=jscore.ScoringConfig(**sc))
    tcfg = tmatch.MonteCarloConfig(sigma_xy=0.08, sigma_theta=0.05, batch=BATCH, rounds=ROUNDS,
                                   scoring=tscore.ScoringConfig(**sc))
    want = jmatch.monte_carlo_match(jview, js, jnp.asarray(init), key, jcfg)
    got = tmatch.monte_carlo_match(
        tview, ts, torch.from_numpy(init), None, tcfg,
        noise=torch.from_numpy(reference_noise(key, ROUNDS, BATCH)),
    )
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.prob), float(want.prob), atol=2e-6)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), atol=2e-6)
    assert float(got.prob) >= float(tscore.score_single(tview, ts, torch.from_numpy(init),
                                                         tcfg.scoring))


def test_generator_draws_are_reproducible(setup):
    _, _, tview, ts, true = setup
    cfg = tmatch.MonteCarloConfig(batch=BATCH, rounds=ROUNDS,
                                  scoring=tscore.ScoringConfig(reducer="overlap"))
    init = torch.from_numpy((true + 0.05).astype(np.float32))
    # the draws from a key are the reference's: split(key, rounds), then
    # normal(key_r, (batch, 3)) a round, which its jitted code multiplies by
    # sigma as erf_inv(u) * (sqrt(2) * sigma); the match equals the one
    # handed those erf_inv values, and they times sqrt(2) are the normals
    key = tprng.key(3)
    res = [tmatch.monte_carlo_match(tview, ts, init, key, cfg) for _ in range(2)]
    keys = jax.random.split(jax.random.PRNGKey(3), ROUNDS)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want = np.array(jax.jit(jax.vmap(lambda k: jax.lax.erf_inv(
        jax.random.uniform(k, (BATCH, 3), minval=lo, maxval=1.0))))(keys))
    normals = np.array(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (BATCH, 3))))(keys))
    np.testing.assert_array_equal(normals, want * np.float32(np.sqrt(2.0)))
    given = tmatch.monte_carlo_match(tview, ts, init, None, cfg,
                                     noise=tmatch.ErfInvDraws(torch.from_numpy(want)))
    assert torch.equal(res[0].pose, res[1].pose) and res[0].trace.shape == (ROUNDS,)
    assert torch.equal(res[0].pose, given.pose) and torch.equal(res[0].trace, given.trace)


@pytest.mark.parametrize("stride,weighted,draws", [(1, False, "step key"), (2, True, "step key"),
                                                    (2, True, "normals"), (1, False, "erf_inv")])
def test_match_from_pose_and_odometry_equals_the_handed_prior(setup, stride, weighted, draws):
    """``monte_carlo_match(..., odom=)`` (``kernels.mc_match_scan``: the
    prior's compose and the scan's points in the match's launch on the card)
    against the match handed ``compose(pose, odom)`` and the scan, bit for
    bit, with a step's key, standard normals and erf_inv draws."""
    _, _, tview, ts, true = setup
    cfg = tmatch.MonteCarloConfig(batch=BATCH, rounds=ROUNDS, scoring=tscore.ScoringConfig(
        reducer="overlap", stride=stride))
    pose = torch.from_numpy((true - np.float32([0.1, -0.04, 0.03])).astype(np.float32))
    odom = torch.tensor([0.11, -0.05, 0.02])
    pw = torch.rand(ts.ranges.shape, generator=torch.Generator().manual_seed(4)) if weighted \
        else None
    kw = {}
    if draws == "step key":
        kw["step_key"] = tprng.key(5)
    else:
        noise = torch.randn((ROUNDS, BATCH, 3), generator=torch.Generator().manual_seed(6))
        kw["noise"] = tmatch.ErfInvDraws(noise) if draws == "erf_inv" else noise
    got = tmatch.monte_carlo_match(tview, ts, pose, None, cfg, pw, odom=odom, **kw)
    want = tmatch.monte_carlo_match(tview, ts, tgeo.compose(pose, odom), None, cfg, pw, **kw)
    for a, b in ((got.pose, want.pose), (got.prob, want.prob), (got.trace, want.trace)):
        assert torch.equal(a, b)
    assert (got.next_key is None) == (draws != "step key")
    if got.next_key is not None:
        assert torch.equal(got.next_key, want.next_key)


@pytest.mark.parametrize("view", ["two maps", "window"])
def test_odometry_on_more_than_one_map_raises(setup, view):
    """``odom`` is taken on one map's view and one scan only (the match's
    launch composes the prior there); a view of P maps or of windows
    raises rather than composing the priors elsewhere."""
    _, _, tview, ts, true = setup
    cfg = tmatch.MonteCarloConfig(batch=BATCH, rounds=ROUNDS)
    maps = tscore.MapView(occ=tview.occ.expand(2, *tview.occ.shape),
                          known=tview.known.expand(2, *tview.known.shape),
                          origin=tview.origin.expand(2, 2), scale=tview.scale)
    if view == "window":
        maps = tscore.window_of(maps, torch.zeros((2, 2)), 32)
    scans = tscan.LaserScan(*(t.expand(2, -1) for t in (ts.ranges, ts.bearings, ts.valid)))
    pose = torch.from_numpy(np.tile(np.asarray(true, np.float32), (2, 1)))
    with pytest.raises(ValueError, match="odom"):
        tmatch.monte_carlo_match(maps, scans, pose, None, cfg, odom=torch.zeros(3),
                                 noise=torch.zeros((2, ROUNDS, BATCH, 3)))


@pytest.mark.parametrize("shape", [(ROUNDS + 1, BATCH, 3), (ROUNDS, BATCH // 2, 3)])
def test_noise_of_another_shape_than_the_config_raises(setup, shape):
    _, _, tview, ts, true = setup
    cfg = tmatch.MonteCarloConfig(batch=BATCH, rounds=ROUNDS,
                                  scoring=tscore.ScoringConfig(reducer="overlap"))
    with pytest.raises(ValueError, match="noise"):
        tmatch.monte_carlo_match(tview, ts, torch.from_numpy(true.copy()), None, cfg,
                                 noise=torch.zeros(shape))


@pytest.mark.parametrize("batch,rounds,bad_rounds,stride,weighted", [
    (8, 0, 1, 1, False),
    (8, 1, 1, 1, False),
    (20, 6, 1, 1, False),
    (8, 6, 1, 2, True),
    (20, 1, 2, 2, True),
])
def test_mc_match_ref_matches_reference(setup, batch, rounds, bad_rounds, stride, weighted):
    """The twin of the fused kernel against the reference's gather path.
    Tolerances: pose 1e-6 (candidates differ by a few ulps of sin/cos/atan2
    at |values| < 2), prob and trace 2e-6 (the bound on a score)."""
    jview, js, tview, ts, true = setup
    init = (true + np.asarray([0.1, -0.05, 0.04], np.float32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    pw = np.random.default_rng(1).uniform(0.2, 1.0, 128).astype(np.float32) if weighted else None
    jsc = jscore.ScoringConfig(reducer="overlap", window=1, stride=stride, impl="gather")
    tsc = tscore.ScoringConfig(reducer="overlap", window=1, stride=stride)
    jcfg = jmatch.MonteCarloConfig(sigma_xy=0.08, sigma_theta=0.05, batch=batch, rounds=rounds,
                                   bad_rounds_before_anneal=bad_rounds, scoring=jsc)
    want = jmatch.monte_carlo_match(jview, js, jnp.asarray(init), key, jcfg,
                                    None if pw is None else jnp.asarray(pw))
    prep = tscore.prepare(tview, ts, tsc, None if pw is None else torch.from_numpy(pw))
    noise = reference_noise(key, rounds, batch) if rounds else np.zeros((0, batch, 3), np.float32)
    pose, prob, trace = kernels.mc_match_ref(
        prep.plane, prep.pts, prep.beam_w, prep.origin, torch.from_numpy(init),
        torch.from_numpy(noise), prep.scale, prep.unknown, 0.08, 0.05, bad_rounds,
    )
    assert trace.shape == (rounds,) and prep.pts.shape[0] == 128 // stride
    np.testing.assert_allclose(pose.numpy(), np.asarray(want.pose), atol=1e-6)
    np.testing.assert_allclose(float(prob), float(want.prob), atol=2e-6)
    np.testing.assert_allclose(trace.numpy(), np.asarray(want.trace), atol=2e-6)
    if rounds == 6:
        # the anneal fired: no six rounds in a row improve on 8-20 draws
        assert (trace.numpy() <= float(prob)).any()


def _scripted_match(probs_by_round, noise, bad_rounds=2):
    """The match loop over scripted scores: the first call scores the start
    pose (0.1), call 1 + r returns ``probs_by_round[r]``."""
    calls = []

    def score(plane, poses, *rest):
        calls.append(poses.clone())
        return torch.tensor([0.1]) if len(calls) == 1 else probs_by_round[len(calls) - 2]

    z = torch.zeros(1)
    out = kernels.mc_match_loop(score, z, z, z, z, torch.tensor([1.0, 2.0, 0.5]), noise,
                                 0.1, 0.5, 0.2, 0.1, bad_rounds)
    return out, calls


def test_argmax_tie_takes_the_first_index():
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 3)).astype(np.float32))
    probs = torch.tensor([0.2, 0.3, 0.2, 0.9, 0.4, 0.9, 0.1, 0.9])
    (pose, prob, trace), calls = _scripted_match([probs], noise)
    assert torch.equal(pose, calls[1][3]) and not torch.equal(pose, calls[1][5])
    assert float(prob) == float(trace[0]) == float(probs[3])


def test_equal_or_nan_score_is_never_better_and_anneals():
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 4, 3)).astype(np.float32))
    rounds = [torch.tensor([0.1, 0.05, 0.0, 0.1]),  # equal to the start: not better
              torch.tensor([0.0, float("nan"), 0.05, 0.0]),  # NaN is the argmax, never better
              torch.tensor([0.0, 0.0, 0.3, 0.0])]
    (pose, prob, trace), calls = _scripted_match(rounds, noise, bad_rounds=2)
    start = torch.tensor([1.0, 2.0, 0.5])
    # two bad rounds halve sigma before round 2 draws around the unchanged start
    sigma = torch.tensor([0.2, 0.2, 0.1]) * 0.5
    want = start + noise[2, 2] * sigma
    assert torch.equal(pose[:2], want[:2]) and torch.equal(prob, rounds[2][2])
    assert torch.isnan(trace[1]) and torch.equal(trace[0], rounds[0][0])
    assert torch.equal(calls[2][:, :2], start[:2] + noise[1, :, :2] * torch.tensor([0.2, 0.2]))


def test_cpu_match_launches_no_kernel(setup):
    _, _, tview, ts, true = setup
    cfg = tmatch.MonteCarloConfig(batch=8, rounds=2, scoring=tscore.ScoringConfig(reducer="overlap"))
    before = (kernels.launch_counts()["mc_match"], kernels.launch_counts()["overlap_score"])
    res = tmatch.monte_carlo_match(tview, ts, torch.tensor(true), tprng.key(0), cfg)
    assert (kernels.launch_counts()["mc_match"], kernels.launch_counts()["overlap_score"]) == before
    assert res.pose.device.type == "cpu" and bool(torch.isfinite(res.trace).all())


def test_mc_match_rounds_equals_twin_on_cpu(setup):
    """On a CPU tensor both loops run the same twin: equal bit for bit."""
    _, _, tview, ts, true = setup
    prep = tscore.prepare(tview, ts, tscore.ScoringConfig(reducer="overlap", stride=2))
    noise = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 12, 3)).astype(np.float32))
    args = (prep.plane, prep.pts, prep.beam_w, prep.origin, torch.tensor(true), noise,
            prep.scale, prep.unknown, 0.1, 0.05, 1)
    for a, b in zip(kernels.mc_match_rounds(*args), kernels.mc_match(*args)):
        assert torch.equal(a, b)


# --- hill climbing (M3RSM's refine) -------------------------------------------


@pytest.mark.parametrize("offset,step_xy,step_theta,iterations,stride", [
    ([0.12, -0.06, 0.04], 0.1, 0.05, 8, 2),
    ([-0.05, 0.03, -0.02], 0.05, 0.0125, 12, 1),
    ([0.0, 0.0, 0.0], 0.1, 0.05, 0, 2),
])
def test_hill_climbing_matches_reference(setup, offset, step_xy, step_theta, iterations, stride):
    """One map: the same steps taken round by round (pose 1e-5, prob and
    trace 2e-6: the scores' sum order), 0 rounds included."""
    jview, js, tview, ts, true = setup
    init = (true + np.asarray(offset, np.float32)).astype(np.float32)
    sc = dict(reducer="overlap", window=1, stride=stride)
    jcfg = jmatch.HillClimbingConfig(step_xy=step_xy, step_theta=step_theta,
                                     iterations=iterations, scoring=jscore.ScoringConfig(**sc))
    tcfg = tmatch.HillClimbingConfig(step_xy=step_xy, step_theta=step_theta,
                                     iterations=iterations, scoring=tscore.ScoringConfig(**sc))
    want = jax.jit(lambda v, s, p: jmatch.hill_climbing_match(v, s, p, None, jcfg))(
        jview, js, jnp.asarray(init))
    got = tmatch.hill_climbing_match(tview, ts, torch.from_numpy(init), None, tcfg)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.prob), float(want.prob), atol=2e-6)
    assert got.trace.shape == (iterations,)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), atol=2e-6)
    assert tmatch.MATCHERS["hill_climbing"] == (tmatch.HillClimbingConfig,
                                                tmatch.hill_climbing_match)


def test_hill_climbing_over_m_maps(setup):
    """Three maps with a prior each (the loop closer's form): each equals a
    single climb on its own map bit for bit, and the reference ``vmap``ped
    within the single-map tolerances."""
    jview, js, tview, ts, true = setup
    sc = dict(reducer="overlap", window=1, stride=2)
    jcfg = jmatch.HillClimbingConfig(scoring=jscore.ScoringConfig(**sc), iterations=6)
    tcfg = tmatch.HillClimbingConfig(scoring=tscore.ScoringConfig(**sc), iterations=6)
    offs = np.array([[0.12, -0.06, 0.04], [-0.1, 0.05, -0.05], [0.05, 0.1, 0.0]], np.float32)
    inits = (true + offs).astype(np.float32)
    occ = np.stack([np.array(jview.occ), np.array(jview.occ)[::-1], np.array(jview.occ)])
    known = np.stack([np.array(jview.known), np.array(jview.known)[::-1],
                      np.array(jview.known)])
    origin = np.array(jview.origin) + np.array([[0, 0], [0.1, 0], [0, -0.1]], np.float32)
    jmaps = jscore.MapView(occ=jnp.asarray(occ), known=jnp.asarray(known),
                           origin=jnp.asarray(origin), scale=jview.scale)
    want = jax.jit(jax.vmap(lambda v, p: jmatch.hill_climbing_match(v, js, p, None, jcfg)))(
        jmaps, jnp.asarray(inits))
    tmaps = tscore.MapView(occ=torch.from_numpy(occ.copy()), known=torch.from_numpy(known.copy()),
                           origin=torch.from_numpy(origin), scale=tview.scale)
    scans = tscan.LaserScan(*(a.expand(3, -1) for a in (ts.ranges, ts.bearings, ts.valid)))
    got = tmatch.hill_climbing_match(tmaps, scans, torch.from_numpy(inits), None, tcfg)
    assert got.pose.shape == (3, 3) and got.prob.shape == (3,) and got.trace.shape == (3, 6)
    for m in range(3):
        one = tmatch.hill_climbing_match(
            tscore.MapView(tmaps.occ[m], tmaps.known[m], tmaps.origin[m], tview.scale), ts,
            torch.from_numpy(inits[m]), None, tcfg)
        assert torch.equal(got.pose[m], one.pose) and torch.equal(got.trace[m], one.trace)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_allclose(got.prob.numpy(), np.asarray(want.prob), atol=2e-6)
