"""Port parity: the scoring reducers other than the bilinear overlap.

The port's ``score_poses`` (on the CPU: the kernels' plain twin
``overlap_score_ref`` with a ``kernels.Reducer``) against the reference's
gather path (``slam_constructor_tpu/ops/scoring.py:336-376``), called
eagerly: the obstacle reducer (one cell a beam, the reference's default),
the max and the mean over the (2 window + 1)^2 cells, and the overlap
reducer at extents other than 1 and at window 0. Tolerance atol 2e-6, the
bound the reference holds its Pallas path to: a beam's value is a cell's
value, a max, or a sum of at most 25 products, and a score is a mean over
beams summed in another order.

A beam's cell is ``floor((world - origin) / scale)``. The port divides, as
the reference does when it runs eagerly; under ``jit`` the reference
multiplies by ``1 / scale`` instead (trap m), which moves a position that
lies within an ulp of a cell's edge into the next cell. The tests count
those flips between the two forms and hold the port to the eager form.
The matchers (brute force, Monte-Carlo with the reference's noise, hill
climbing, M3RSM at ``M3RSMConfig()``) run inside the reference's
``lax.scan`` / ``lax.map`` and so see the jitted form; their tests count
the flips over every pose the reference scored.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import m3rsm as jm3
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scan as jscan
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.geometry import apply_pose
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import m3rsm as tm3
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

ATOL = 2e-6
N_BEAMS = 120

#: every reducer of the reference other than the bilinear overlap: (reducer,
#: window, overlap_extent)
REDUCERS = [("obstacle", 1, 1.0)]
REDUCERS += [(r, w, 1.0) for r in ("max", "mean") for w in (0, 1, 2)]
REDUCERS += [("overlap", w, e) for e in (0.5, 1.6, 2.5) for w in (0, 1, 2)]


# the fixtures' maps and scans, made by the reference (jitted: eagerly its
# insert takes seconds)
_cast = jax.jit(jray.cast_rays, static_argnums=2)
_insert = jax.jit(jray.insert_scan, static_argnums=(1, 4))


def _ids(cases):
    return [f"{r}-w{w}-e{e}" for r, w, e in cases]


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = jdata.box_world(8.0, 0.1, obstacles=5, seed=3)
    bearings = jdata.default_bearings(N_BEAMS)
    tp = jnp.array([0.3, -0.2, 0.15])
    s = _cast(occ, origin, scale, tp, bearings)
    # a few invalid beams, so the weighted mean skips them
    s = s.replace(valid=s.valid & (jnp.arange(N_BEAMS) % 9 != 4))
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 96, 96, 0.1)  # holds the 8 m world
    gm = _insert(gm, model, tp, s, jray.BeamConfig(wall_blur=True, free_impl="dda"))
    jview = jscore.MapView.of(gm, model)
    # candidates spread wide so many endpoints fall off the map
    rng = np.random.default_rng(0)
    cand = (np.asarray(tp)[None] + rng.normal(size=(24, 3)) * [1.5, 1.5, 0.4]).astype(np.float32)
    pw = rng.uniform(0.2, 1.0, N_BEAMS).astype(np.float32)
    return jview, s, _tview(jview), _tscan(s), cand, pw


def _tview(jview):
    return tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)), known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)), scale=float(jview.scale))


def _tscan(js):
    return tscan.LaserScan(torch.from_numpy(np.array(js.ranges)),
                           torch.from_numpy(np.array(js.bearings)),
                           torch.from_numpy(np.array(js.valid)))


def _configs(reducer, window, extent, stride=1):
    kw = dict(reducer=reducer, window=window, overlap_extent=extent, stride=stride)
    return jscore.ScoringConfig(impl="gather", **kw), tscore.ScoringConfig(**kw)


def _reference_cells(jview, js, poses, stride, jitted):
    """floor((world - origin) / scale) of every kept beam's endpoint from
    every pose f32[K, 3], as the reference computes it eagerly (a
    division) or under ``jit`` (trap m) -> i32[K, R', 2] (x, y)."""
    def cells(poses):
        pts = jscan.scan_points(jscore._strided_scan(js, stride))
        world = apply_pose(poses[:, None, :], pts[None, :, :])
        return jnp.floor((world - jview.origin) / jview.scale).astype(jnp.int32)

    fn = jax.jit(cells) if jitted else cells
    return np.asarray(fn(jnp.asarray(poses)))


def _port_cells(tview, ts, poses, stride):
    """The cells the port's kernels and twin read: the same transform,
    divided by the scale as a tensor (an IEEE division)."""
    pts = tscan.scan_points(ts)[::stride]
    p = torch.from_numpy(np.asarray(poses, np.float32))
    c, s = torch.cos(p[:, 2:3]), torch.sin(p[:, 2:3])
    wx = p[:, 0:1] + c * pts[:, 0] - s * pts[:, 1]
    wy = p[:, 1:2] + s * pts[:, 0] + c * pts[:, 1]
    x = tgrid.div_scale(wx - tview.origin[0], tview.scale)
    y = tgrid.div_scale(wy - tview.origin[1], tview.scale)
    return torch.stack([torch.floor(x), torch.floor(y)], -1).to(torch.int32).numpy()


def flips(jview, js, poses, stride=1):
    """The endpoints whose cell the reference's jitted form puts elsewhere
    than its eager division."""
    eager = _reference_cells(jview, js, poses, stride, jitted=False)
    return int((eager != _reference_cells(jview, js, poses, stride, jitted=True)).any(-1).sum())


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("reducer,window,extent", REDUCERS, ids=_ids(REDUCERS))
def test_score_poses_matches_reference(setup, reducer, window, extent, stride, weighted):
    jview, js, tview, ts, cand, pw = setup
    jcfg, tcfg = _configs(reducer, window, extent, stride)
    want = jscore.score_poses(jview, js, jnp.asarray(cand), jcfg,
                              jnp.asarray(pw) if weighted else None)
    got = tscore.score_poses(tview, ts, torch.from_numpy(cand), tcfg,
                             torch.from_numpy(pw) if weighted else None)
    assert got.shape == (len(cand),) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_endpoint_cells_match_the_eager_reference(setup):
    """Every endpoint's cell, for the wide candidates and for 2,000 poses
    near the true one, is the eager reference's; the flips between the
    reference's eager and jitted forms are counted (none on these inputs
    is hidden: a flip, where there is one, must show as a cell that only
    the jitted form moves)."""
    jview, js, tview, ts, cand, _ = setup
    rng = np.random.default_rng(5)
    near = (cand[:1] + rng.normal(size=(2000, 3)) * [0.05, 0.05, 0.02]).astype(np.float32)
    total = 0
    for poses in (cand, near):
        for stride in (1, 3):
            eager = _reference_cells(jview, js, poses, stride, jitted=False)
            np.testing.assert_array_equal(_port_cells(tview, ts, poses, stride), eager)
            total += flips(jview, js, poses, stride)
    # 2,024 poses x 120 + 40 beams: the forms part on a few endpoints at most
    assert total <= 8, total


@pytest.mark.parametrize("reducer,window,extent", REDUCERS, ids=_ids(REDUCERS))
def test_point_values_match_reference(setup, reducer, window, extent):
    """Per point: with origin 0, scale 1 and one sensor point (0, 0) at
    weight 1, candidate k's score is the reducer's value at (x_k, y_k);
    positions over and around the 96^2 map, on cell edges and centres too."""
    jview, _, _, _, _, _ = setup
    rng = np.random.default_rng(1)
    rel = rng.uniform(-4.0, 100.0, (2000, 2)).astype(np.float32)
    rel[:200] = np.round(rel[:200] * 2.0) / 2.0  # edges and centres
    poses = np.concatenate([rel, np.zeros((len(rel), 1), np.float32)], -1)
    one = jscan.LaserScan(ranges=jnp.zeros(1), bearings=jnp.zeros(1), valid=jnp.ones(1, bool))
    view1 = jscore.MapView(occ=jview.occ, known=jview.known, origin=jnp.zeros(2), scale=1.0)
    jcfg, tcfg = _configs(reducer, window, extent)
    want = jscore.score_poses(view1, one, jnp.asarray(poses), jcfg)
    got = tscore.score_poses(
        tscore.MapView(occ=torch.from_numpy(np.array(jview.occ)),
                       known=torch.from_numpy(np.array(jview.known)), origin=torch.zeros(2),
                       scale=1.0),
        _tscan(one), torch.from_numpy(poses), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_jitted_reference_parts_only_on_flipped_cells(setup):
    """The reference under ``jit`` scores the obstacle reducer on cells
    reached by a multiplication; every candidate whose score then differs
    from the port's by more than the tolerance holds a flipped endpoint."""
    jview, js, tview, ts, _, _ = setup
    rng = np.random.default_rng(9)
    cand = (np.asarray([0.3, -0.2, 0.15])[None] + rng.normal(size=(512, 3))
            * [0.3, 0.3, 0.1]).astype(np.float32)
    jcfg, tcfg = _configs("obstacle", 1, 1.0)
    jitted = np.asarray(jax.jit(lambda p: jscore.score_poses(jview, js, p, jcfg))(
        jnp.asarray(cand)))
    got = tscore.score_poses(tview, ts, torch.from_numpy(cand), tcfg).numpy()
    eager = _reference_cells(jview, js, cand, 1, jitted=False)
    moved = (eager != _reference_cells(jview, js, cand, 1, jitted=True)).any(-1).any(-1)
    parted = np.abs(got - jitted) > ATOL
    assert not (parted & ~moved).any()


# --- the matchers at the reference's default, the obstacle reducer ----------


@pytest.fixture(scope="module")
def corridor():
    """tests/test_torch_matchers.py's fixture: two scans of the cecum
    world's lower corridor in a 160^2 map, a third from the true pose."""
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(N_BEAMS)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, scale)
    cfg = jray.BeamConfig(wall_blur=True, free_impl="dda")
    for p in ([-1.0, -1.5, 0.0], [0.0, -1.6, 0.1]):
        s = _cast(occ, origin, scale, jnp.asarray(p), bearings)
        gm = _insert(gm, model, jnp.asarray(p), s, cfg)
    true = jnp.asarray([0.5, -1.55, 0.05])
    s = _cast(occ, origin, scale, true, bearings)
    jview = jscore.MapView.of(gm, model)
    return jview, s, _tview(jview), _tscan(s), np.asarray(true)


def reference_noise(key, rounds, batch):
    """The standard normals the reference's Monte-Carlo matcher draws."""
    keys = jax.random.split(key, rounds)
    return np.stack([np.asarray(jax.random.normal(k, (batch, 3))) for k in keys])


@pytest.mark.parametrize("stride,weighted", [(1, False), (3, True)])
def test_brute_force_match_obstacle_matches_reference(corridor, stride, weighted):
    jview, js, tview, ts, true = corridor
    init = (true + np.asarray([0.07, -0.04, 0.03], np.float32)).astype(np.float32)
    pw = np.random.default_rng(2).uniform(0.2, 1.0, N_BEAMS).astype(np.float32)
    jsc, tsc = _configs("obstacle", 1, 1.0, stride)
    kw = dict(half_x=0.2, half_y=0.2, half_theta=0.1, n_x=5, n_y=5, n_theta=5)
    want = jmatch.brute_force_match(jview, js, jnp.asarray(init), None,
                                    jmatch.BruteForceConfig(scoring=jsc, **kw),
                                    jnp.asarray(pw) if weighted else None)
    got = tmatch.brute_force_match(tview, ts, torch.from_numpy(init), None,
                                   tmatch.BruteForceConfig(scoring=tsc, **kw),
                                   torch.from_numpy(pw) if weighted else None)
    if not (np.allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-6)
            and abs(float(got.prob) - float(want.prob)) <= ATOL):
        # only a flipped endpoint may part them: the jitted form's cells
        grid = (np.asarray(init)[None] + tmatch.brute_force_offsets(
            tmatch.BruteForceConfig(**kw), "cpu").numpy()).astype(np.float32)
        assert flips(jview, js, grid, stride) > 0, (got, want)


def flipped_rounds(jview, js, rounds):
    """bool a round: whether any endpoint of the round's poses f32[K, 3]
    lies in another cell under the reference's jitted form."""
    return [flips(jview, js, poses) > 0 for poses in rounds]


def assert_matches_or_flipped(got, want, rounds, moved, pose_tol):
    """The port's (pose, prob, trace) against the reference's: equal within
    the tolerances, or else parted first in a round at or after one whose
    poses hold a flipped endpoint (``rounds`` the poses scored first, then
    a round at a time; ``moved`` their flip flags)."""
    trace_diff = np.abs(got.trace.numpy() - np.asarray(want.trace)) > ATOL
    same = (np.allclose(got.pose.numpy(), np.asarray(want.pose), atol=pose_tol)
            and abs(float(got.prob) - float(want.prob)) <= ATOL and not trace_diff.any())
    if same:
        return
    first = int(np.argmax(trace_diff)) + 1 if trace_diff.any() else len(rounds) - 1
    assert any(moved[: first + 1]), (
        f"parted in round {first} with no flipped endpoint before it: pose {got.pose} against "
        f"{want.pose}, trace {got.trace} against {want.trace}")


@pytest.mark.parametrize("seed,offset", [(0, [0.12, -0.06, 0.04]), (1, [-0.1, 0.05, -0.05]),
                                         (2, [0.0, 0.0, 0.0])])
def test_monte_carlo_match_obstacle_matches_reference(corridor, seed, offset):
    """The reference's draws injected. The poses it scored (the first, then
    a round's candidates; rebuilt from the port's run) are checked for
    flips: the results agree, or part only from a round whose candidates
    hold a flipped endpoint."""
    jview, js, tview, ts, true = corridor
    init = (true + np.asarray(offset, np.float32)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jsc, tsc = _configs("obstacle", 1, 1.0)
    kw = dict(sigma_xy=0.08, sigma_theta=0.04, batch=16, rounds=6)
    want = jmatch.monte_carlo_match(jview, js, jnp.asarray(init), key,
                                    jmatch.MonteCarloConfig(scoring=jsc, **kw))
    noise = torch.from_numpy(reference_noise(key, 6, 16))
    seen = []

    def recording(plane, poses, *rest):
        seen.append(poses.reshape(-1, 3).numpy().copy())
        return kernels.overlap_score_ref(plane, poses, *rest)

    prep = tscore.prepare(tview, ts, tsc)
    kernels.mc_match_loop(recording, prep.plane, prep.pts, prep.beam_w, prep.origin,
                          torch.from_numpy(init), noise, prep.scale, prep.unknown, 0.08, 0.04, 2,
                          prep.reducer)
    got = tmatch.monte_carlo_match(tview, ts, torch.from_numpy(init), None,
                                   tmatch.MonteCarloConfig(scoring=tsc, **kw), noise=noise)
    assert_matches_or_flipped(got, want, seen, flipped_rounds(jview, js, seen), 1e-5)


@pytest.mark.parametrize("reducer,window,extent", [("obstacle", 1, 1.0), ("max", 1, 1.0),
                                                   ("overlap", 0, 1.6)],
                         ids=_ids([("obstacle", 1, 1.0), ("max", 1, 1.0), ("overlap", 0, 1.6)]))
def test_hill_climbing_match_matches_reference(corridor, reducer, window, extent):
    jview, js, tview, ts, true = corridor
    init = (true + np.asarray([0.11, -0.07, 0.04], np.float32)).astype(np.float32)
    jsc, tsc = _configs(reducer, window, extent)
    want = jmatch.hill_climbing_match(jview, js, jnp.asarray(init), None,
                                      jmatch.HillClimbingConfig(scoring=jsc))
    seen = []

    def recording(plane, poses, *rest):
        seen.append(poses.reshape(-1, 3).numpy().copy())
        return kernels.overlap_score_ref(plane, poses, *rest)

    prep = tscore.prepare(tview, ts, tsc)
    cfg = tmatch.HillClimbingConfig(scoring=tsc)
    kernels.hill_climb_loop(recording, prep.plane, prep.pts, prep.beam_w, prep.origin,
                            torch.from_numpy(init), prep.scale, prep.unknown, cfg.step_xy,
                            cfg.step_theta, cfg.iterations, cfg.shrink, prep.reducer)
    got = tmatch.hill_climbing_match(tview, ts, torch.from_numpy(init), None, cfg)
    assert_matches_or_flipped(got, want, seen, flipped_rounds(jview, js, seen), 1e-5)


def test_m3rsm_default_config_matches_reference(corridor):
    """``M3RSMConfig()`` (5 levels, 17 thetas, the whole map, a hill climb
    of 8 rounds on the obstacle score) against the reference's jitted
    match, the branch and bound's winner and the climb."""
    jview, js, tview, ts, true = corridor
    init = (true + np.asarray([0.15, -0.1, 0.06], np.float32)).astype(np.float32)
    jcfg = jm3.M3RSMConfig()
    want = jax.jit(lambda v, s, p: jm3.m3rsm_match(v, s, p, None, jcfg))(
        jview, js, jnp.asarray(init))
    tcfg = tm3.M3RSMConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                              if f.name != "scoring"})
    assert tcfg.scoring == tscore.ScoringConfig() and tcfg.scoring.reducer == "obstacle"
    got = tm3.m3rsm_match(tview, ts, torch.from_numpy(init), None, tcfg)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.prob), float(want.prob), atol=ATOL)


@pytest.mark.parametrize("reducer,window,extent",
                         [("obstacle", 1, 1.0), ("mean", 1, 1.0), ("overlap", 1, 1.6),
                          ("overlap", 0, 1.0)],
                         ids=_ids([("obstacle", 1, 1.0), ("mean", 1, 1.0), ("overlap", 1, 1.6),
                                   ("overlap", 0, 1.0)]))
def test_gradient_match_refuses_reducers_it_cannot_differentiate(corridor, reducer, window,
                                                                 extent):
    """Since the gradient of every reducer is ported, nothing is refused:
    the piecewise-constant reducers (obstacle, mean, the overlap at window
    0) keep the start pose, its score and a trace of it, as the reference's
    refine does; the general overlap moves as the reference's does."""
    jview, js, tview, ts, true = corridor
    init = (true + np.float32([0.06, -0.04, 0.03])).astype(np.float32)
    cfg = tmatch.GradientConfig(scoring=tscore.ScoringConfig(
        reducer=reducer, window=window, overlap_extent=extent))
    got = tmatch.gradient_match(tview, ts, torch.from_numpy(init), None, cfg)
    jcfg = jmatch.GradientConfig(scoring=jscore.ScoringConfig(
        reducer=reducer, window=window, overlap_extent=extent))
    want = jax.jit(lambda p: jmatch.gradient_match(jview, js, p, None, jcfg))(jnp.asarray(init))
    if tscore.reducer_of(cfg.scoring).flat:
        assert torch.equal(got.pose, torch.from_numpy(init))
        assert torch.equal(got.trace, got.prob.expand(cfg.iterations))
    else:
        assert np.abs(got.pose.numpy() - init).max() > 0.01
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5, rtol=0)
    assert abs(float(got.prob) - float(want.prob)) <= 2e-6


def test_unknown_reducer_raises(setup):
    _, _, tview, ts, cand, _ = setup
    with pytest.raises(ValueError, match="unknown reducer"):
        tscore.score_poses(tview, ts, torch.from_numpy(cand),
                           tscore.ScoringConfig(reducer="median"))


def test_reducer_launch_counts_by_variant(setup):
    """CPU tensors launch nothing; the counts by reducer start at 0 and
    name every scoring wrapper and reducer."""
    _, _, tview, ts, cand, _ = setup
    kernels.reset_launch_counts()
    tscore.score_poses(tview, ts, torch.from_numpy(cand), tscore.ScoringConfig())
    counts = kernels.reducer_launch_counts()
    assert set(counts) >= {f"{n}/{k}" for n in ("mc_match_batched", "hill_climb", "m3rsm_search")
                           for k in kernels.REDUCER_KINDS}
    assert not any(counts.values())
