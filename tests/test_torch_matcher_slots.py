"""Port parity of every matcher in every slot: the RBPF's primary match and
its refine (hill climbing, gradient ascent, M3RSM; on the dense maps and on
the copy-on-write pool), the loop closer's hill-climbing and gradient
matchers (with and without the sub-cell refine), ``joint_refine`` with the
hill climb, the gradient ascent and M3RSM, and the CLI's configs that name
them.

The RBPF: 4 particles, 96^2 maps at 0.2 m, 64^2 windows (``fast_config``
with a 2.5 m usable range; on the pool 4 x 4 tiles of 16), 120 beams, 3
steps, each from the reference's state (crossed by ``convert``) with its
draws (its key chain as in test_torch_gmapping.py; a Monte-Carlo matcher's
normals only where one runs). Poses within 1e-5 (a refine's keep-if-better
on scores summed in another order, as test_torch_refine.py holds it),
log-weights within 1e-4 (gamma = 8 times the log of such a score),
ancestors exact.

The loop closer and ``joint_refine``: test_torch_posegraph.py's drifting
loop (24 keyframes, 64 beams, 64^2 submaps): the same loops accepted, the
graph's structure exact, deltas within 1e-5 (1e-3 with the sub-cell refine,
whose parabola moves with the scores' last digits), infos rtol 5e-2; the
joint refine's poses within 1e-5.

The reference's Monte-Carlo matcher cannot be its loop matcher or its
joint-refine matcher: it hands the matcher ``key=None`` there, and
``jax.random.split(None, n)`` raises ``TypeError``. The port refuses both
(trap s).
"""

import dataclasses
import functools
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import gmapping as jgm
from slam_constructor_tpu.models import posegraph as jpg
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import m3rsm as jm3
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.ops import prng as tprng
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import m3rsm as tm3
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.ops.geometry import between, compose
from slam_constructor_tpu_torch.ops.scan import LaserScan as TScan
from slam_constructor_tpu_torch.utils import config as tconfig
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

POSE_TOL, LOGW_TOL = 1e-5, 1e-4

# --- the RBPF's slots --------------------------------------------------------------

P, MAP, SCALE, N_BEAMS, STEPS = 4, 96, 0.2, 120, 3
FAST = dict(n_particles=P, map_size=MAP, map_scale=SCALE, usable_range=2.5)
COW = dict(map_storage="cow", tile_block=16, window_tiles=4, tile_capacity=256)

#: (primary matcher, refine matcher)
SLOTS = [("hill_climbing", None), ("gradient", None), ("m3rsm", None),
         ("monte_carlo", "hill_climbing"), ("monte_carlo", "gradient"), ("monte_carlo", "m3rsm")]


def matcher_cfg(side, kind, fast):
    """The slot's config on side ``side`` (the reference's modules or the
    port's): the fast preset's scoring (overlap, window 1, every second
    beam), the gradient ascent on the general overlap (extent 2, window 2)."""
    match, score, m3 = (jmatch, jscore, jm3) if side == "j" else (tmatch, tscore, tm3)
    sc = score.ScoringConfig(reducer="overlap", window=1, stride=2)
    if kind == "monte_carlo":
        return fast.matcher_cfg
    if kind == "hill_climbing":
        return match.HillClimbingConfig(step_xy=0.05, step_theta=0.025, iterations=6, scoring=sc)
    if kind == "gradient":
        return match.GradientConfig(iterations=8, step_xy=0.04, step_theta=0.02,
                                    scoring=score.ScoringConfig(reducer="overlap", window=2,
                                                                overlap_extent=2.0, stride=2))
    return m3.M3RSMConfig(levels=3, half_x=0.3, half_y=0.3, half_theta=0.1, n_theta=5,
                          beam_width=16, refine_iterations=4, scoring=sc)


def slot_configs(matcher, refine, storage):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j, t = jgm.fast_config(**FAST), tgm.fast_config(**FAST)
    out = []
    for side, cfg in (("j", j), ("t", t)):
        cfg = dataclasses.replace(
            cfg, matcher=matcher, matcher_cfg=matcher_cfg(side, matcher, cfg),
            refine_matcher=refine,
            refine_cfg=None if refine is None else matcher_cfg(side, refine, cfg),
            **(COW if storage == "cow" else {}))
        out.append(cfg)
    return out


@functools.cache
def _draws_fn(cfg):
    def draws(key):
        key, k_noise, k_match, k_res = jax.random.split(key, 4)
        keys = jax.random.split(k_match, cfg.n_particles)
        mc = cfg.matcher_cfg
        out = dict(proposal=jax.random.normal(k_noise, (cfg.n_particles, 3)),
                   u0=jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / cfg.n_particles))
        if cfg.matcher == "monte_carlo":
            out["match"] = jax.vmap(lambda k: jax.vmap(
                lambda kr: jax.random.normal(kr, (mc.batch, 3)))(jax.random.split(k, mc.rounds)))(
                keys)
        return out

    return jax.jit(draws)


def reference_draws(key, cfg):
    """The reference step's random numbers from its key (``split(key, 4)``:
    proposal, match keys, resampling), as the port's Draws; the match's
    normals only for a Monte-Carlo primary (a Monte-Carlo refine there
    takes the same key, so the same normals)."""
    return tgm.Draws(**{k: torch.from_numpy(np.array(v, np.float32))
                        for k, v in _draws_fn(cfg)(key).items()})


def state_tree(st, storage):
    maps = ({"pool": np.asarray(st.gm.pool), "tables": np.asarray(st.gm.tables),
             "refcnt": np.asarray(st.gm.refcnt), "origin": np.asarray(st.gm.origin),
             "scale": st.gm.scale, "block": st.gm.block, "overflow": bool(st.gm.overflow)}
            if storage == "cow" else
            {"cells": np.asarray(st.gm.cells), "origin": np.asarray(st.gm.origin),
             "scale": st.gm.scale})
    return {**maps, "poses": np.asarray(st.poses), "log_weights": np.asarray(st.log_weights),
            "step": int(st.step)}


@pytest.fixture(scope="module")
def seq():
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.12)[:STEPS]
    return tdata.synth_sequence(occ, origin, scale, poses, tdata.default_bearings(N_BEAMS),
                                rng=3, odom_noise_xy=0.02, odom_noise_theta=0.01)


def jscan(scans, i):
    return JScan(ranges=jnp.asarray(scans.ranges[i].numpy()),
                 bearings=jnp.asarray(scans.bearings[i].numpy()),
                 valid=jnp.asarray(scans.valid[i].numpy()))


def pose_diff(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[..., 2] = np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2]))
    return np.abs(d).max()


@pytest.mark.parametrize("storage", ["dense", "cow"])
@pytest.mark.parametrize("matcher,refine", SLOTS, ids=[f"{m}+{r}" for m, r in SLOTS])
def test_rbpf_slot_matches_reference(seq, matcher, refine, storage):
    scans, odom, gt = seq
    jcfg, tcfg = slot_configs(matcher, refine, storage)
    step = jax.jit(partial(jgm.gmapping_step, jcfg))
    st = jgm.init_state(jcfg, jax.random.PRNGKey(0))
    st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (P, 3)))
    moved = 0.0
    for i in range(STEPS):
        draws = reference_draws(st.key, jcfg)
        assert (draws.match is None) == (matcher != "monte_carlo")
        port = convert.gmapping_state_from_numpy(state_tree(st, storage), device="cpu")
        port, anc = tgm.gmapping_step(tcfg, port, scans[i], odom[i], draws)
        prior = st.poses
        st, janc = step(st, jscan(scans, i), jnp.asarray(odom[i].numpy()))
        np.testing.assert_array_equal(anc.numpy(), np.asarray(janc))
        assert pose_diff(port.poses.numpy(), st.poses) <= POSE_TOL, i
        np.testing.assert_allclose(port.log_weights.numpy(), np.asarray(st.log_weights),
                                   atol=LOGW_TOL, rtol=0)
        moved = max(moved, pose_diff(st.poses, prior))
    assert moved > 0.01  # the particles moved


def test_rbpf_draws_refine_normals_only_for_a_monte_carlo_refine():
    """The step's draws hold the particles' match keys only where a slot is
    Monte-Carlo (which draws its own numbers from them in K5's prologue),
    and no match or refine normals."""
    key = tprng.key(0)
    for matcher, refine in SLOTS:
        _, cfg = slot_configs(matcher, refine, "dense")
        _, d = tgm.draw(cfg, key)
        mc = "monte_carlo" in (matcher, refine)
        assert (d.match_key is None) != mc
        assert d.match is None and d.refine is None
    _, cfg = slot_configs("hill_climbing", "monte_carlo", "dense")
    _, d = tgm.draw(cfg, key)
    assert d.match is None and d.refine is None and d.match_key.shape == (P, 2)


# --- the loop closer and the joint refine ----------------------------------------

R, KW = 64, dict(max_keyframes=32, max_edges=64, min_index_gap=6, loop_radius=2.0,
                 min_prob=0.5, max_candidates=3, local_map_size=64, gn_iterations=6,
                 loop_info_cap=100.0)


def loop_configs(kind, **kw):
    kw = {**KW, **kw, "loop_matcher_kind": kind}
    out = []
    for match, score, pg in ((jmatch, jscore, jpg), (tmatch, tscore, tpg)):
        if kind == "hill_climbing":
            lm = match.HillClimbingConfig(step_xy=0.1, step_theta=0.05, iterations=8,
                                          scoring=score.ScoringConfig(reducer="overlap",
                                                                      stride=2))
        else:  # the gradient ascent on the general overlap
            lm = match.GradientConfig(iterations=12, scoring=score.ScoringConfig(
                reducer="overlap", window=1, overlap_extent=1.5, stride=2))
        out.append(pg.PoseGraphConfig(**kw, loop_matcher=lm))
    return out


def to_jax(tree):
    return jpg.PoseGraphState(
        kf_poses=jnp.asarray(tree["kf_poses"]),
        kf_scans=JScan(ranges=jnp.asarray(tree["kf_ranges"]),
                       bearings=jnp.asarray(tree["kf_bearings"]),
                       valid=jnp.asarray(tree["kf_valid"])),
        n_kf=jnp.int32(tree["n_kf"]), edge_i=jnp.asarray(tree["edge_i"]),
        edge_j=jnp.asarray(tree["edge_j"]), edge_delta=jnp.asarray(tree["edge_delta"]),
        edge_info=jnp.asarray(tree["edge_info"]), edge_is_loop=jnp.asarray(tree["edge_is_loop"]),
        n_edges=jnp.int32(tree["n_edges"]), last_kf=jnp.int32(tree["last_kf"]),
        kf_overflow=jnp.asarray(tree["kf_overflow"]),
        edge_overflow=jnp.asarray(tree["edge_overflow"]))


def from_jax(st):
    return dict(
        kf_poses=np.asarray(st.kf_poses), kf_ranges=np.asarray(st.kf_scans.ranges),
        kf_bearings=np.asarray(st.kf_scans.bearings), kf_valid=np.asarray(st.kf_scans.valid),
        n_kf=np.asarray(st.n_kf), edge_i=np.asarray(st.edge_i), edge_j=np.asarray(st.edge_j),
        edge_delta=np.asarray(st.edge_delta), edge_info=np.asarray(st.edge_info),
        edge_is_loop=np.asarray(st.edge_is_loop), n_edges=np.asarray(st.n_edges),
        last_kf=np.asarray(st.last_kf), kf_overflow=np.asarray(st.kf_overflow),
        edge_overflow=np.asarray(st.edge_overflow))


def assert_same_graph(tree, want, delta_atol=1e-5, info_rtol=5e-2):
    for k in ("n_kf", "n_edges", "last_kf", "kf_overflow", "edge_overflow", "edge_i", "edge_j",
              "edge_is_loop", "kf_valid"):
        np.testing.assert_array_equal(tree[k], want[k], err_msg=k)
    np.testing.assert_allclose(tree["edge_delta"], want["edge_delta"], atol=delta_atol, rtol=0)
    np.testing.assert_allclose(tree["edge_info"], want["edge_info"], rtol=info_rtol)


def tscans(s, sl):
    return TScan(torch.from_numpy(s["ranges"][sl]), torch.from_numpy(s["bearings"][sl]),
                 torch.from_numpy(s["valid"][sl]))


@pytest.fixture(scope="module")
def loop():
    """test_torch_posegraph.py's loop: 24 keyframes, a lap of 18 and 6 more
    that revisit its start, with drifting estimates."""
    occ, origin, scale = tdata.cecum_world()
    lap = tdata.rectangle_trajectory(step=1.4)
    scans, _, gt = tdata.synth_sequence(occ, origin, scale, torch.cat([lap, lap[:6]]),
                                        tdata.default_bearings(R))
    rng = np.random.default_rng(0)
    est = [gt[0]]
    for i in range(1, len(gt)):
        d = between(gt[i - 1], gt[i]) + torch.from_numpy(
            rng.normal(0, [0.02, 0.02, 0.006]).astype(np.float32))
        est.append(compose(est[-1], d))
    return dict(ranges=scans.ranges.numpy(), bearings=scans.bearings.numpy(),
                valid=scans.valid.numpy(), est=torch.stack(est).numpy(), n=len(gt))


def chain_only(loop, tcfg, n=None):
    st = tpg.init_state(tcfg, R, "cpu")
    for i in range(loop["n"] if n is None else n):
        st = tpg.add_keyframe(tcfg, st, torch.from_numpy(loop["est"][i]), tscans(loop, i))
    return st


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("kind", ["hill_climbing", "gradient"])
def test_loop_matcher_matches_reference(loop, kind, refine):
    """``densify_loops`` from the bare chain (M submaps, one launch of the
    matcher a pass), then ``detect_loops`` for the newest keyframe."""
    jm, tm = jcells.BayesAvgCell(), tcells.BayesAvgCell()
    jcfg, tcfg = loop_configs(kind, loop_subcell_refine=refine)
    tst = chain_only(loop, tcfg)
    jst = to_jax(convert.graph_to_numpy(tst))
    atol = 1e-3 if refine else 1e-5
    jst, jn = jax.jit(lambda st: jpg.densify_loops(jcfg, jm, st))(jst)
    tst, tn = tpg.densify_loops(tcfg, tm, tst)
    assert int(tn) == int(jn) >= 1
    assert_same_graph(convert.graph_to_numpy(tst), from_jax(jst), delta_atol=atol)
    pose, i = loop["est"][-1], loop["n"] - 1
    jst, jn = jax.jit(lambda st, s, p: jpg.detect_loops(jcfg, jm, st, s, p))(
        jst, JScan(*(jnp.asarray(loop[k][i]) for k in ("ranges", "bearings", "valid"))),
        jnp.asarray(pose))
    tst, tn = tpg.detect_loops(tcfg, tm, tst, tscans(loop, i), torch.from_numpy(pose))
    assert int(tn) == int(jn)
    assert_same_graph(convert.graph_to_numpy(tst), from_jax(jst), delta_atol=atol)


@pytest.mark.parametrize("matcher", ["hill_climbing", "gradient", "m3rsm"])
def test_joint_refine_matches_reference(loop, matcher):
    """Two rounds over the K leave-one-out maps with the reference's default
    config of the matcher (``cfg_cls()``: the hill climb on the obstacle
    score, the gradient on the overlap, M3RSM at its defaults), on a 160^2
    map that holds the world (off a smaller map the reference wraps samples
    into its last cell, and the maps part)."""
    jm, tm = jcells.BayesAvgCell(), tcells.BayesAvgCell()
    kw = {**KW, "max_keyframes": 8}
    jcfg, tcfg = jpg.PoseGraphConfig(**kw), tpg.PoseGraphConfig(**kw)
    tst = chain_only(loop, tcfg, n=7)
    jst = to_jax(convert.graph_to_numpy(tst))
    beam = dict(occupancy_estimator="const", hole_width=0.3, wall_blur=True)
    want = np.asarray(jax.jit(lambda st, gm: jpg.joint_refine(
        jcfg, jm, st, gm, jray.BeamConfig(**beam), rounds=2, matcher=matcher))(
        jst, jgrid.make_grid_map(jm, 160, 160, 0.1)).kf_poses)
    got = tpg.joint_refine(tcfg, tm, tst, tgrid.make_grid_map(tm, 160, 160, 0.1),
                           tray.BeamConfig(**beam), rounds=2, matcher=matcher).kf_poses.numpy()
    assert pose_diff(got, want) <= POSE_TOL
    before = tst.kf_poses.numpy()
    np.testing.assert_array_equal(got[0], before[0])  # the gauge anchor
    np.testing.assert_array_equal(got[7], before[7])  # the unused slot


def test_monte_carlo_loop_and_joint_matchers_raise_in_both(loop):
    """Trap s: the reference hands its loop matcher and its joint-refine
    matcher ``key=None``; its Monte-Carlo matcher raises ``TypeError`` on
    it. The port refuses both with a ``NotImplementedError`` that says so."""
    jm, tm = jcells.BayesAvgCell(), tcells.BayesAvgCell()
    jcfg = jpg.PoseGraphConfig(**KW, loop_matcher_kind="monte_carlo",
                               loop_matcher=jmatch.MonteCarloConfig())
    view = jscore.MapView.of(jgrid.make_grid_map(jm, 64, 64, 0.1), jm)
    scan = JScan(*(jnp.asarray(loop[k][0]) for k in ("ranges", "bearings", "valid")))
    with pytest.raises(TypeError, match="PRNG key"):
        jpg._match_loop(jcfg, view, scan, jnp.zeros(3))
    with pytest.raises(NotImplementedError, match="key=None"):
        tpg.PoseGraphConfig(**KW, loop_matcher_kind="monte_carlo",
                            loop_matcher=tmatch.MonteCarloConfig())
    tcfg = tpg.PoseGraphConfig(**{**KW, "max_keyframes": 8})
    tst = chain_only(loop, tcfg, n=3)
    jst = to_jax(convert.graph_to_numpy(tst))
    beam = dict(occupancy_estimator="const", hole_width=0.3, wall_blur=True)
    with pytest.raises(TypeError, match="PRNG key"):
        jpg.joint_refine(jpg.PoseGraphConfig(**{**KW, "max_keyframes": 8}), jm, jst,
                         jgrid.make_grid_map(jm, 64, 64, 0.1), jray.BeamConfig(**beam),
                         rounds=1, matcher="monte_carlo")
    with pytest.raises(NotImplementedError, match="key=None"):
        tpg.joint_refine(tcfg, tm, tst, tgrid.make_grid_map(tm, 64, 64, 0.1),
                         tray.BeamConfig(**beam), rounds=1, matcher="monte_carlo")
    with pytest.raises(ValueError):
        tpg.PoseGraphConfig(loop_matcher_kind="nope")


# --- the CLI's configs --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["monte_carlo", "hill_climbing", "gradient", "brute_force",
                                  "m3rsm"])
def test_gmapping_properties_reach_every_matcher(kind):
    props = {"pf.particles": "4", "matcher.type": kind, "map.height": "64", "map.width": "64",
             "scoring.reducer": "overlap"}
    cfg = tconfig.gmapping_config_from(props)
    assert cfg.matcher == kind
    assert isinstance(cfg.matcher_cfg, tmatch.MATCHERS[kind][0])
    e = tgm.GMappingEngine(cfg, device="cpu", seed=2)
    assert e.cfg.matcher == kind


def test_engine_gradient_refine_at_the_default_reducer(seq):
    """``refine.type = gradient`` without ``scoring.reducer``: the reference's
    default obstacle reducer, piecewise constant, so the refine keeps every
    match's pose: the run equals the run without the refine bit for bit."""
    scans, odom, gt = seq
    props = {"matcher.type": "monte_carlo", "matcher.batch": "8", "matcher.rounds": "3",
             "map.height": "96", "map.width": "96", "map.scale": "0.2"}
    with_refine = tconfig.engine_config_from({**props, "refine.type": "gradient"})
    assert with_refine.refine_matcher == "gradient"
    assert with_refine.refine_cfg.scoring.reducer == "obstacle"
    trajs = []
    for cfg in (with_refine, tconfig.engine_config_from(props)):
        e = teng.Engine(cfg, device="cpu", seed=4)
        e.state = dataclasses.replace(e.state, pose=gt[0].clone())
        trajs.append(e.run(scans, odom)[0])
    assert torch.equal(trajs[0], trajs[1])
