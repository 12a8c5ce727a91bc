"""Port parity: the keyframe pose graph (store, loop detection, densify,
Gauss-Newton, map regeneration).

One synthetic drifting loop (a lap and a third of the cecum rectangle, 64
beams, keyframes 1.4 m apart, estimates that accumulate odometric drift) is
made with numpy and the port's datagen and fed to both sides as arrays; the
graph crosses as the numpy dict of ``utils.convert``. Tolerances:

- the structure of the graph (keyframe and edge indices, counts, order,
  loop flags, overflow flags) is exact;
- edge deltas atol 1e-5 (a loop delta is a grid pose, the same index on
  both sides, through ``between``);
- edge infos rtol 5e-2: a second difference of scores that agree to ~1e-7,
  divided by eps^2 (see test_torch_bruteforce.py), then clipped;
- submaps: every cell but (H-1, W-1) within 1e-5. The reference on a CPU
  wraps each free sample that falls off the submap into that last cell
  (its scatter turns them to index -1); the port drops them;
- ``optimize``: poses within 1e-5 of the reference (Cholesky against
  Cholesky, normal equations summed in another order) and 1e-3 of a float64
  Gauss-Newton on the same graph; ``graph_error`` rtol 1e-4;
- ``schur_solve``: atol 1e-4 against the reference and against a float64
  solve;
- ``regenerate_map``: batched against the serial chain of inserts, cells
  within 1e-5 (sums in another order), and against the reference;
- ``joint_refine``: the same winning grid index for every keyframe in every
  round, so poses within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import posegraph as jpg
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import m3rsm as jm3
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import m3rsm as tm3
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.ops.geometry import between, compose
from slam_constructor_tpu_torch.ops.scan import LaserScan as TScan
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

R, BATCH = 64, 4
KW = dict(max_keyframes=32, max_edges=64, min_index_gap=6, loop_radius=2.0, min_prob=0.5,
          max_candidates=3, local_map_size=64, gn_iterations=6, loop_info_cap=100.0)
BF = dict(half_x=0.5, half_y=0.5, half_theta=0.2, n_x=5, n_y=5, n_theta=5)
MODELS = {
    "bayes_avg": (jcells.BayesAvgCell(), tcells.BayesAvgCell()),
    "tbm": (jcells.TBMCell(), tcells.TBMCell()),
}


def configs(**kw):
    kw = {**KW, **kw}
    j = jpg.PoseGraphConfig(**kw, loop_matcher=jmatch.BruteForceConfig(
        **BF, scoring=jscore.ScoringConfig(reducer="overlap", stride=2)))
    t = tpg.PoseGraphConfig(**kw, loop_matcher=tmatch.BruteForceConfig(
        **BF, scoring=tscore.ScoringConfig(reducer="overlap", stride=2)))
    return j, t


def m3_configs(**kw):
    """The M3RSM loop matcher of the reference's own test
    (``tests/test_posegraph.py:451-455``)."""
    kw = {**KW, **kw, "loop_matcher_kind": "m3rsm"}
    m3 = dict(levels=3, half_x=0.6, half_y=0.6, half_theta=0.3, n_theta=7)
    j = jpg.PoseGraphConfig(**kw, loop_matcher=jm3.M3RSMConfig(
        **m3, scoring=jscore.ScoringConfig(reducer="overlap", stride=2)))
    t = tpg.PoseGraphConfig(**kw, loop_matcher=tm3.M3RSMConfig(
        **m3, scoring=tscore.ScoringConfig(reducer="overlap", stride=2)))
    return j, t


def to_jax(tree):
    """The numpy dict of ``convert`` as the reference's PoseGraphState."""
    return jpg.PoseGraphState(
        kf_poses=jnp.asarray(tree["kf_poses"]),
        kf_scans=JScan(ranges=jnp.asarray(tree["kf_ranges"]), bearings=jnp.asarray(tree["kf_bearings"]),
                       valid=jnp.asarray(tree["kf_valid"])),
        n_kf=jnp.int32(tree["n_kf"]), edge_i=jnp.asarray(tree["edge_i"]),
        edge_j=jnp.asarray(tree["edge_j"]), edge_delta=jnp.asarray(tree["edge_delta"]),
        edge_info=jnp.asarray(tree["edge_info"]), edge_is_loop=jnp.asarray(tree["edge_is_loop"]),
        n_edges=jnp.int32(tree["n_edges"]), last_kf=jnp.int32(tree["last_kf"]),
        kf_overflow=jnp.asarray(tree["kf_overflow"]), edge_overflow=jnp.asarray(tree["edge_overflow"]),
    )


def from_jax(st):
    return dict(
        kf_poses=np.asarray(st.kf_poses), kf_ranges=np.asarray(st.kf_scans.ranges),
        kf_bearings=np.asarray(st.kf_scans.bearings), kf_valid=np.asarray(st.kf_scans.valid),
        n_kf=np.asarray(st.n_kf), edge_i=np.asarray(st.edge_i), edge_j=np.asarray(st.edge_j),
        edge_delta=np.asarray(st.edge_delta), edge_info=np.asarray(st.edge_info),
        edge_is_loop=np.asarray(st.edge_is_loop), n_edges=np.asarray(st.n_edges),
        last_kf=np.asarray(st.last_kf), kf_overflow=np.asarray(st.kf_overflow),
        edge_overflow=np.asarray(st.edge_overflow),
    )


def assert_same_graph(tree, want, delta_atol=1e-5, info_rtol=5e-2):
    for k in ("n_kf", "n_edges", "last_kf", "kf_overflow", "edge_overflow", "edge_i", "edge_j",
              "edge_is_loop", "kf_valid"):
        np.testing.assert_array_equal(tree[k], want[k], err_msg=k)
    np.testing.assert_allclose(tree["edge_delta"], want["edge_delta"], atol=delta_atol, rtol=0)
    np.testing.assert_allclose(tree["edge_info"], want["edge_info"], rtol=info_rtol)
    for k in ("kf_poses", "kf_ranges", "kf_bearings"):
        np.testing.assert_allclose(tree[k], want[k], atol=1e-6, rtol=0, err_msg=k)


def jscans(s, sl):
    return JScan(ranges=jnp.asarray(s["ranges"][sl]), bearings=jnp.asarray(s["bearings"][sl]),
                 valid=jnp.asarray(s["valid"][sl]))


def tscans(s, sl):
    return TScan(torch.from_numpy(s["ranges"][sl]), torch.from_numpy(s["bearings"][sl]),
                 torch.from_numpy(s["valid"][sl]))


@pytest.fixture(scope="module")
def loop():
    """24 keyframes: a lap of 18 and 6 more that revisit its start, with
    drifting estimates."""
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
    """The loop's keyframes with their odometric chain and no loop edge."""
    st = tpg.init_state(tcfg, R, "cpu")
    for i in range(loop["n"] if n is None else n):
        st = tpg.add_keyframe(tcfg, st, torch.from_numpy(loop["est"][i]), tscans(loop, i))
    return st


@pytest.fixture(scope="module")
def processed(loop):
    """The loop through ``process_keyframes`` in batches of 4 on both sides
    (the last batch is padded and masked)."""
    jcfg, tcfg = configs()
    jm, tm = MODELS["bayes_avg"]
    jst, tst = jpg.init_state(jcfg, R), tpg.init_state(tcfg, R, "cpu")
    jproc = jax.jit(lambda st, s, p, v: jpg.process_keyframes(jcfg, jm, st, s, p, v))
    counts = []
    n = loop["n"] - 2  # 22 keyframes: the last batch holds 2 and 2 of padding
    for b0 in range(0, n, BATCH):
        idx = np.minimum(np.arange(b0, b0 + BATCH), n - 1)
        valid = np.arange(b0, b0 + BATCH) < n
        jst, jn = jproc(jst, jscans(loop, idx), jnp.asarray(loop["est"][idx]), jnp.asarray(valid))
        tst, tn = tpg.process_keyframes(tcfg, tm, tst, tscans(loop, idx),
                                        torch.from_numpy(loop["est"][idx]), torch.from_numpy(valid))
        counts.append((int(jn), int(tn)))
    return jcfg, tcfg, jst, tst, counts


def test_keyframe_store_matches_reference(loop):
    """init_state, should_add_keyframe, add_keyframe, _append_edge."""
    jcfg, tcfg = configs()
    jst, tst = jpg.init_state(jcfg, R), tpg.init_state(tcfg, R, "cpu")
    assert_same_graph(convert.graph_to_numpy(tst), from_jax(jst))
    assert bool(tpg.should_add_keyframe(tcfg, tst, torch.zeros(3)))  # the first always
    for i in range(5):
        pose = loop["est"][i]
        jst = jpg.add_keyframe(jcfg, jst, jnp.asarray(pose), jscans(loop, i))
        tst = tpg.add_keyframe(tcfg, tst, torch.from_numpy(pose), tscans(loop, i))
        for probe in (pose + np.float32([0.3, 0.0, 0.1]), pose + np.float32([0.4, 0.3, 0.0]),
                      pose + np.float32([0.0, 0.0, 0.51])):
            assert bool(tpg.should_add_keyframe(tcfg, tst, torch.from_numpy(probe))) == bool(
                jpg.should_add_keyframe(jcfg, jst, jnp.asarray(probe)))
    delta = np.float32([0.5, -0.25, 0.125])
    jst = jpg._append_edge(jst, 4, 0, jnp.asarray(delta), jcfg.loop_info, is_loop=True)
    tst = tpg._append_edge(tst, 4, 0, torch.from_numpy(delta), tcfg.loop_info, is_loop=True)
    tree = convert.graph_to_numpy(tst)
    assert tree["n_kf"] == 5 and tree["n_edges"] == 5 and tree["last_kf"] == 4
    assert_same_graph(tree, from_jax(jst), delta_atol=1e-6, info_rtol=0)
    # the dict crosses back unchanged
    back = convert.graph_to_numpy(convert.graph_from_numpy(tree, "cpu"))
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v)


def test_overflow_flags_and_grow_match_reference(loop):
    """Writes at capacity are dropped and latch the flags; grow pads the
    store and clears them."""
    jcfg, tcfg = configs(max_keyframes=4, max_edges=2)
    jst, tst = jpg.init_state(jcfg, R), tpg.init_state(tcfg, R, "cpu")
    for i in range(6):
        jst = jpg.add_keyframe(jcfg, jst, jnp.asarray(loop["est"][i]), jscans(loop, i))
        tst = tpg.add_keyframe(tcfg, tst, torch.from_numpy(loop["est"][i]), tscans(loop, i))
        assert_same_graph(convert.graph_to_numpy(tst), from_jax(jst), info_rtol=0)
    tree = convert.graph_to_numpy(tst)
    assert tree["n_kf"] == 4 and tree["n_edges"] == 2 and tree["last_kf"] == 3
    assert tree["kf_overflow"] and tree["edge_overflow"]
    jcfg2, jst2 = jpg.grow(jcfg, jst)
    tcfg2, tst2 = tpg.grow(tcfg, tst)
    assert (tcfg2.max_keyframes, tcfg2.max_edges) == (jcfg2.max_keyframes, jcfg2.max_edges) == (8, 4)
    jst2 = jpg.add_keyframe(jcfg2, jst2, jnp.asarray(loop["est"][4]), jscans(loop, 4))
    tst2 = tpg.add_keyframe(tcfg2, tst2, torch.from_numpy(loop["est"][4]), tscans(loop, 4))
    tree = convert.graph_to_numpy(tst2)
    assert tree["kf_poses"].shape == (8, 3) and tree["edge_i"].shape == (4,)
    assert not tree["kf_overflow"] and not tree["edge_overflow"] and tree["n_kf"] == 5
    assert_same_graph(tree, from_jax(jst2), info_rtol=0)
    _, tst3 = tpg.grow(tcfg2, tst2, max_keyframes=9, max_edges=4)
    assert tst3.kf_scans.valid.shape == (9, R) and tst3.edge_delta.shape == (4, 3)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_render_local_map_matches_reference_but_the_wrap_cell(loop, model):
    jm, tm = MODELS[model]
    jcfg, tcfg = configs()
    tst = chain_only(loop, tcfg, n=8)
    jst = to_jax(convert.graph_to_numpy(tst))
    n = tcfg.local_map_size
    jrender = jax.jit(lambda st, ci: jpg._render_local_map(jcfg, jm, st, ci))
    for ci in (0, 3, 7):  # the first has no older neighbour, the last no newer
        want = jrender(jst, jnp.int32(ci))
        got = tpg._render_local_map(tcfg, tm, tst, ci)
        assert got.cells.shape == (n, n, tm.n_channels + 1)
        np.testing.assert_allclose(got.origin.numpy(), np.asarray(want.origin), atol=1e-6)
        diff = np.abs(got.cells.numpy() - np.asarray(want.cells)).max(-1)
        diff[n - 1, n - 1] = 0.0  # the reference's wrap cell
        assert diff.max() <= 1e-5
        assert int((got.cells[..., -1] > 0).sum()) > 300
    # the batch renders each submap as it renders it alone
    batch = tpg._render_local_maps(tcfg, tm, tst, torch.tensor([0, 3, 7]))
    one = tpg._render_local_map(tcfg, tm, tst, 3)
    torch.testing.assert_close(batch.cells[1], one.cells, atol=1e-6, rtol=0)


def test_process_keyframes_matches_reference(processed):
    jcfg, tcfg, jst, tst, counts = processed
    assert all(j == t for j, t in counts), counts
    assert sum(t for _, t in counts) >= 4, "the loop closed no loop"
    tree = convert.graph_to_numpy(tst)
    assert tree["n_kf"] == 22 and tree["edge_is_loop"].sum() == sum(t for _, t in counts)
    assert_same_graph(tree, from_jax(jst))
    loops = tree["edge_info"][: tree["n_edges"]][tree["edge_is_loop"][: tree["n_edges"]]]
    assert len(np.unique(loops)) > 4  # the estimates are not all on the clip's bounds


def test_process_keyframes_keyframe_by_keyframe_gives_the_same_graph(loop, processed):
    """A batch wider than the index gap goes keyframe by keyframe."""
    _, tcfg, _, tst, counts = processed
    tm = MODELS["bayes_avg"][1]
    seq = tpg.init_state(tcfg, R, "cpu")
    idx = np.arange(22)
    assert len(idx) > tcfg.min_index_gap
    seq, n = tpg.process_keyframes(
        tcfg, tm, seq, tscans(loop, idx), torch.from_numpy(loop["est"][idx]),
        torch.ones(22, dtype=torch.bool))
    assert int(n) == sum(t for _, t in counts)
    assert_same_graph(convert.graph_to_numpy(seq), convert.graph_to_numpy(tst), delta_atol=1e-6,
                      info_rtol=1e-4)


def test_detect_loops_matches_reference(loop):
    jm, tm = MODELS["bayes_avg"]
    jcfg, tcfg = configs()
    tst = chain_only(loop, tcfg)
    jst = to_jax(convert.graph_to_numpy(tst))
    pose, i = loop["est"][-1], loop["n"] - 1
    jout, jn = jax.jit(lambda st, s, p: jpg.detect_loops(jcfg, jm, st, s, p))(
        jst, jscans(loop, i), jnp.asarray(pose))
    tout, tn = tpg.detect_loops(tcfg, tm, tst, tscans(loop, i), torch.from_numpy(pose))
    assert int(tn) == int(jn) >= 1
    assert_same_graph(convert.graph_to_numpy(tout), from_jax(jout))


def test_detect_loops_with_m3rsm_matches_reference(loop):
    """The newest keyframe against its candidates' submaps through M3RSM
    (a pyramid a submap, built in one launch on the card): the same loops
    accepted, deltas within 1e-5 (the same winning cell, the refine's
    scores in another sum order)."""
    jm, tm = MODELS["bayes_avg"]
    jcfg, tcfg = m3_configs()
    tst = chain_only(loop, tcfg)
    jst = to_jax(convert.graph_to_numpy(tst))
    pose, i = loop["est"][-1], loop["n"] - 1
    jout, jn = jax.jit(lambda st, s, p: jpg.detect_loops(jcfg, jm, st, s, p))(
        jst, jscans(loop, i), jnp.asarray(pose))
    tout, tn = tpg.detect_loops(tcfg, tm, tst, tscans(loop, i), torch.from_numpy(pose))
    assert int(tn) == int(jn) >= 1
    assert_same_graph(convert.graph_to_numpy(tout), from_jax(jout))


def test_process_keyframes_and_densify_with_m3rsm_match_reference(loop):
    """The loop's keyframes through ``process_keyframes`` in batches of 4
    and a ``densify_loops`` pass, with the M3RSM loop matcher on both
    sides: the same graph."""
    jcfg, tcfg = m3_configs()
    jm, tm = MODELS["bayes_avg"]
    jst, tst = jpg.init_state(jcfg, R), tpg.init_state(tcfg, R, "cpu")
    jproc = jax.jit(lambda st, s, p, v: jpg.process_keyframes(jcfg, jm, st, s, p, v))
    n, total = loop["n"] - 2, 0
    for b0 in range(0, n, BATCH):
        idx = np.minimum(np.arange(b0, b0 + BATCH), n - 1)
        valid = np.arange(b0, b0 + BATCH) < n
        jst, jn = jproc(jst, jscans(loop, idx), jnp.asarray(loop["est"][idx]), jnp.asarray(valid))
        tst, tn = tpg.process_keyframes(tcfg, tm, tst, tscans(loop, idx),
                                        torch.from_numpy(loop["est"][idx]), torch.from_numpy(valid))
        assert int(tn) == int(jn)
        total += int(tn)
    assert total >= 2, "the loop closed no loop"
    assert_same_graph(convert.graph_to_numpy(tst), from_jax(jst))
    jst, jn = jax.jit(lambda st: jpg.densify_loops(jcfg, jm, st))(jst)
    tst, tn = tpg.densify_loops(tcfg, tm, tst)
    assert int(tn) == int(jn)
    assert_same_graph(convert.graph_to_numpy(tst), from_jax(jst))


@pytest.mark.parametrize("refine", [False, True])
def test_densify_loops_matches_reference(loop, refine):
    """From the bare chain densify proposes the closest index-distant pairs;
    a second pass leaves out the pairs the first constrained."""
    jm, tm = MODELS["bayes_avg"]
    jcfg, tcfg = configs(loop_subcell_refine=refine)
    tst = chain_only(loop, tcfg)
    jst = to_jax(convert.graph_to_numpy(tst))
    jdens = jax.jit(lambda st: jpg.densify_loops(jcfg, jm, st))
    total = 0
    for _ in range(2):
        jst, jn = jdens(jst)
        tst, tn = tpg.densify_loops(tcfg, tm, tst)
        assert int(tn) == int(jn)
        total += int(tn)
        # a refined delta moves with the score's last digits: 1e-3 of a 0.25 m step
        assert_same_graph(convert.graph_to_numpy(tst), from_jax(jst),
                          delta_atol=1e-3 if refine else 1e-5)
    assert total >= 3
    tree = convert.graph_to_numpy(tst)
    loops = tree["edge_is_loop"][: tree["n_edges"]]
    pairs = list(zip(tree["edge_i"][: tree["n_edges"]][loops], tree["edge_j"][: tree["n_edges"]][loops]))
    assert len(set(pairs)) == len(pairs) and all(j - i >= tcfg.min_index_gap for i, j in pairs)


def _gauss_newton_f64(tree, cfg):
    """The same Gauss-Newton in float64 numpy, edge by edge."""
    poses = tree["kf_poses"].astype(np.float64)
    k, n_e = poses.shape[0], int(tree["n_edges"])
    used = np.repeat((np.arange(k) < tree["n_kf"]) & (np.arange(k) > 0), 3)
    for _ in range(cfg.gn_iterations):
        h, b = np.zeros((3 * k, 3 * k)), np.zeros(3 * k)
        for e in range(n_e):
            i, j = int(tree["edge_i"][e]), int(tree["edge_j"][e])
            z, pi, pj = tree["edge_delta"][e].astype(np.float64), poses[i], poses[j]
            c, s = np.cos(pi[2]), np.sin(pi[2])
            rt, dt = np.array([[c, s], [-s, c]]), pj[:2] - pi[:2]
            th = pj[2] - pi[2] - z[2]
            r = np.concatenate([rt @ dt - z[:2], [np.arctan2(np.sin(th), np.cos(th))]])
            ji, jj = np.zeros((3, 3)), np.zeros((3, 3))
            ji[:2, :2], ji[:2, 2], ji[2, 2] = -rt, np.array([[-s, c], [-c, -s]]) @ dt, -1.0
            jj[:2, :2], jj[2, 2] = rt, 1.0
            w = tree["edge_info"][e].astype(np.float64)
            if cfg.huber_delta > 0 and tree["edge_is_loop"][e]:
                w = w * min(1.0, cfg.huber_delta / np.sqrt(max((w * r * r).sum(), 1e-12)))
            a = np.zeros((3, 3 * k))
            a[:, 3 * i:3 * i + 3] += ji
            a[:, 3 * j:3 * j + 3] += jj
            h += a.T @ (w[:, None] * a)
            b += a.T @ (w * r)
        h = np.where(used[:, None] & used[None, :], h, 0.0) + np.diag(np.where(used, cfg.gn_damping, 1.0))
        dx = np.linalg.solve(h, -np.where(used, b, 0.0)).reshape(k, 3)
        poses = poses + dx
        poses[:, 2] = np.arctan2(np.sin(poses[:, 2]), np.cos(poses[:, 2]))
    return poses


@pytest.mark.parametrize("huber", [0.3, 0.0])
def test_optimize_and_graph_error_match_reference_and_float64(processed, huber):
    jcfg, tcfg, jst, tst, _ = processed
    jcfg, tcfg = (dataclasses.replace(c, huber_delta=huber) for c in (jcfg, tcfg))
    e0 = float(tpg.graph_error(tst))
    np.testing.assert_allclose(e0, float(jpg.graph_error(jst)), rtol=1e-4)
    jopt = jax.jit(lambda st: jpg.optimize(jcfg, st))(jst)
    topt = tpg.optimize(tcfg, tst)
    assert torch.equal(tpg.optimize(tcfg, tst).kf_poses, topt.kf_poses)  # a fixed order of sums
    got = topt.kf_poses.numpy()
    np.testing.assert_allclose(got, np.asarray(jopt.kf_poses), atol=1e-5, rtol=0)
    want64 = _gauss_newton_f64(convert.graph_to_numpy(tst), tcfg)
    d = got - want64
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    assert np.abs(d).max() <= 1e-3
    e1 = float(tpg.graph_error(topt))
    np.testing.assert_allclose(e1, float(jpg.graph_error(jopt)), rtol=1e-4)
    assert e1 < 0.7 * e0
    # the gauge anchor and the unused rows stay
    np.testing.assert_array_equal(got[0], tst.kf_poses.numpy()[0])
    np.testing.assert_array_equal(got[22:], 0.0)
    assert np.abs(got - tst.kf_poses.numpy())[:22, :2].max() > 0.02  # it moved something


def test_optimize_checked_reports_a_failed_factorisation(processed):
    """The solver's status is 0 on a sound graph and the Cholesky's on one
    whose normal equations are not positive definite (negative weights)."""
    _, tcfg, _, tst, _ = processed
    topt, info = tpg.optimize_checked(tcfg, tst)
    assert info.dtype == torch.int32 and info.shape == () and int(info) == 0
    assert torch.equal(topt.kf_poses, tpg.optimize(tcfg, tst).kf_poses)
    bad = dataclasses.replace(tst, edge_info=-tst.edge_info)
    _, info = tpg.optimize_checked(tcfg, bad)
    assert int(info) > 0


def test_edge_residual_jacobians():
    pi, pj = torch.tensor([1.0, 2.0, 0.5]), torch.tensor([2.0, 2.5, 1.0])
    z = between(pi, pj)
    e, ji, jj = tpg._edge_residual_jac(pi, pj, z)
    torch.testing.assert_close(e, torch.zeros(3), atol=1e-6, rtol=0)
    want = jpg._edge_residual_jac(jnp.asarray(pi.numpy()), jnp.asarray(pj.numpy()), jnp.asarray(z.numpy()))
    np.testing.assert_allclose(ji.numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(jj.numpy(), np.asarray(want[2]), atol=1e-6)


def test_schur_solve_matches_reference_and_float64():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(10, 10))
    h = (a @ a.T + 10 * np.eye(10)).astype(np.float32)
    b = rng.normal(size=10).astype(np.float32)
    got = tpg.schur_solve(torch.from_numpy(h), torch.from_numpy(b), split=4).numpy()
    want = np.asarray(jpg.schur_solve(jnp.asarray(h), jnp.asarray(b), split=4))
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, np.linalg.solve(h.astype(np.float64), b.astype(np.float64)), atol=1e-4)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_regenerate_map_batched_equals_serial_and_reference(loop, model):
    jm, tm = MODELS[model]
    jcfg, tcfg = configs()
    tst = chain_only(loop, tcfg, n=9)
    jst = to_jax(convert.graph_to_numpy(tst))
    beam = dict(occupancy_estimator="const", hole_width=0.3, wall_blur=True)
    tbeam, jbeam = tray.BeamConfig(**beam), jray.BeamConfig(**beam)
    # 160^2 at 0.1 m holds the whole world: nothing falls off, no wrap cell
    got = tpg.regenerate_map(tcfg, tm, tst, tgrid.make_grid_map(tm, 160, 160, 0.1), tbeam, group=4)
    serial = tgrid.make_grid_map(tm, 160, 160, 0.1)
    for i in range(9):
        serial = tray.insert_scan(serial, tm, tst.kf_poses[i], tst.kf_scans[i], tbeam)
    torch.testing.assert_close(got.cells, serial.cells, atol=1e-5, rtol=0)
    assert int((got.cells[..., -1] > 0).sum()) > 2000
    want = jpg.regenerate_map(jcfg, jm, jst, jgrid.make_grid_map(jm, 160, 160, 0.1), jbeam)
    np.testing.assert_allclose(got.cells.numpy(), np.asarray(want.cells), atol=1e-5, rtol=0)
    # the host's count of keyframes only spares the empty slots
    hinted = tpg.regenerate_map(tcfg, tm, tst, tgrid.make_grid_map(tm, 160, 160, 0.1), tbeam,
                                group=4, n_used=9)
    torch.testing.assert_close(hinted.cells, got.cells, atol=1e-6, rtol=0)


def test_joint_refine_matches_reference(loop):
    jm, tm = MODELS["bayes_avg"]
    jcfg, tcfg = configs(max_keyframes=8)
    tst = chain_only(loop, tcfg, n=7)  # one slot stays unused
    jst = to_jax(convert.graph_to_numpy(tst))
    beam = dict(occupancy_estimator="const", hole_width=0.3, wall_blur=True)
    grid = dict(half_x=0.2, half_y=0.2, half_theta=0.05, n_x=5, n_y=5, n_theta=3)
    jref = jax.jit(lambda st, gm: jpg.joint_refine(
        jcfg, jm, st, gm, jray.BeamConfig(**beam), rounds=2,
        matcher_cfg=jmatch.BruteForceConfig(**grid, scoring=jscore.ScoringConfig(reducer="overlap"))))
    want = np.asarray(jref(jst, jgrid.make_grid_map(jm, 160, 160, 0.1)).kf_poses)
    got = tpg.joint_refine(
        tcfg, tm, tst, tgrid.make_grid_map(tm, 160, 160, 0.1), tray.BeamConfig(**beam), rounds=2,
        matcher_cfg=tmatch.BruteForceConfig(**grid, scoring=tscore.ScoringConfig(reducer="overlap")),
    ).kf_poses.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    before = tst.kf_poses.numpy()
    np.testing.assert_array_equal(got[0], before[0])  # the gauge anchor
    np.testing.assert_array_equal(got[7], before[7])  # the unused slot
    assert np.abs(got[1:7] - before[1:7]).max() > 0.01  # damped half way to a grid point
    with pytest.raises(NotImplementedError, match="key=None"):  # the reference raises too
        tpg.joint_refine(tcfg, tm, tst, tgrid.make_grid_map(tm, 160, 160, 0.1),
                         tray.BeamConfig(**beam), matcher="monte_carlo")


def test_unported_loop_matcher_raises():
    """The M3RSM loop matcher is ported, its sub-cell refine is not: the
    reference's grid-pitch fallback for a matcher without a grid is a known
    fault (trap e)."""
    with pytest.raises(NotImplementedError):
        tpg.PoseGraphConfig(loop_matcher_kind="m3rsm", loop_subcell_refine=True)
