"""Port parity: the shared-plane rasteriser (``kernels.scan_planes``, K3
without the fold) and its callers in the loop closer.

On the CPU the wrapper runs its plain twin ``kernels.scan_planes_ref``
(the free trace counted with ``scatter_add_`` or the polar fill, the
occupied evidence added with ``index_put_`` on flat indices, scan-major);
``raycast.scan_observation_planes_batched`` is one call of it. These tests
hold, bit for bit, the wrapper to the twin and the twin to
``kernels.scan_planes_ordered`` (each plane's samples summed with
``np.add.at`` in scan-major sample order: what the card's kernel sums in),
for every ``plane_of`` form: none (a plane a scan), one shared plane,
sorted, and unsorted. The loop closer's three callers (the submaps, the
regenerated map, joint refine) and the TBM submap chain (one
``raycast.insert_scan_windows`` call a step, K3's fold of P maps) reach the
wrappers, and match the JAX reference within the tolerances of
``test_torch_posegraph.py``: every submap cell but the reference's wrap
cell (H-1, W-1) within 1e-5, the regenerated map within 1e-5, joint refine's
poses within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import posegraph as jpg
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.ops.geometry import between, compose
from slam_constructor_tpu_torch.ops.scan import LaserScan as TScan
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

R, N_KF, SIDE, SCALE = 64, 8, 96, 0.2  # 19.2 m at 0.2 m holds the 14.4 x 5.2 m world
KW = dict(max_keyframes=8, max_edges=16, min_index_gap=6, loop_radius=2.0, min_prob=0.5,
          max_candidates=3, local_map_size=48, gn_iterations=4, submap_radius=1)
GRID = dict(half_x=0.2, half_y=0.2, half_theta=0.05, n_x=5, n_y=5, n_theta=3)
BEAM = dict(occupancy_estimator="const", hole_width=0.3, wall_blur=True)
#: every plane_of form: (plane of each of the 8 keyframes, planes)
PLANE_OF = {"none": (None, N_KF), "shared": ([0] * N_KF, 1),
            "sorted": ([0, 0, 0, 1, 1, 2, 2, 2], 3), "unsorted": ([2, 0, 1, 0, 2, 1, 1, 0], 3)}


@pytest.fixture(scope="module")
def loop():
    """8 keyframes 1.4 m apart along the cecum rectangle with drifting
    estimates, 64 beams, every 5th beam invalid."""
    occ, origin, scale = tdata.cecum_world()
    gt = tdata.rectangle_trajectory(step=1.4)[:N_KF]
    scans, _, gt = tdata.synth_sequence(occ, origin, scale, gt, tdata.default_bearings(R))
    rng = np.random.default_rng(0)
    est = [gt[0]]
    for i in range(1, N_KF):
        d = between(gt[i - 1], gt[i]) + torch.from_numpy(
            rng.normal(0, [0.02, 0.02, 0.006]).astype(np.float32))
        est.append(compose(est[-1], d))
    valid = scans.valid & (torch.arange(R) % 5 != 2)
    return torch.stack(est), TScan(scans.ranges, scans.bearings, valid)


def _planes_args(loop, form, free_impl):
    poses, scans = loop
    plane_of, n_planes = PLANE_OF[form]
    plane_of = None if plane_of is None else torch.tensor(plane_of)
    origins = torch.full((2,), -SIDE * SCALE / 2)
    cfg = tray.BeamConfig(**{**BEAM, "free_impl": free_impl,
                             "occupancy_estimator": "area" if free_impl == "polar" else "const"})
    return origins, SIDE, SIDE, SCALE, poses, scans, cfg, plane_of, n_planes


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("free_impl", ["dda", "polar"])
@pytest.mark.parametrize("form", sorted(PLANE_OF))
def test_scan_planes_is_its_twin_and_the_ordered_sums(loop, form, free_impl):
    """On the CPU the wrapper (and ``scan_observation_planes_batched``) is
    its twin, and the twin's planes are the ordered sums, bit for bit."""
    args = _planes_args(loop, form, free_impl)
    before = kernels.launch_counts()["scan_planes"]
    w, s = kernels.scan_planes(*args)
    w_ref, s_ref = kernels.scan_planes_ref(*args)
    w_ray, s_ray = tray.scan_observation_planes_batched(*args)
    w_ord, s_ord = kernels.scan_planes_ordered(*args)
    assert kernels.launch_counts()["scan_planes"] == before
    assert w.shape == s.shape == (args[-1], SIDE, SIDE) and w.dtype == torch.float32
    for got_w, got_s in ((w, s), (w_ray, s_ray), (w_ord, s_ord)):
        assert _same(got_w, w_ref) and _same(got_s, s_ref)
    # the evidence landed, and sums of several scans are fractional
    assert int((s > 0).sum()) > 30 * args[-1] and int((w > 0).sum()) > 100 * args[-1]
    if form != "none" and free_impl == "dda":
        assert bool(((s * 9) % 1 != 0).any())


@pytest.mark.parametrize("form", ["none", "unsorted"])
def test_scan_planes_runs_count_the_twins_occupied_samples(loop, form):
    """``kernels.scan_planes_runs``: every occupied sample of the twin's
    ``index_put_`` list lands in one cell of one plane (the invalid and
    off-plane ones in plane 0's cell 0), and every cell with occupied
    evidence has a run."""
    args = _planes_args(loop, form, "dda")
    _, s = kernels.scan_planes_ref(*args)
    runs = kernels.scan_planes_runs(*args)
    assert runs.shape == s.shape and runs.dtype == torch.int64
    assert int(runs.sum()) == N_KF * R * (1 + args[6].blur_samples)
    assert bool((runs[s > 0] > 0).all()) and int(runs[0, 0, 0]) >= R


def _configs():
    j = jpg.PoseGraphConfig(**KW, loop_matcher=jmatch.BruteForceConfig(
        **GRID, scoring=jscore.ScoringConfig(reducer="overlap", stride=2)))
    t = tpg.PoseGraphConfig(**KW, loop_matcher=tmatch.BruteForceConfig(
        **GRID, scoring=tscore.ScoringConfig(reducer="overlap", stride=2)))
    return j, t


def _graph(loop, tcfg):
    """The keyframes with their odometric chain (slot 7 unused), on both sides."""
    poses, scans = loop
    st = tpg.init_state(tcfg, R, "cpu")
    for i in range(N_KF - 1):
        st = tpg.add_keyframe(tcfg, st, poses[i], scans[i])
    tree = convert.graph_to_numpy(st)
    jst = jpg.PoseGraphState(
        kf_poses=jnp.asarray(tree["kf_poses"]),
        kf_scans=JScan(ranges=jnp.asarray(tree["kf_ranges"]),
                       bearings=jnp.asarray(tree["kf_bearings"]),
                       valid=jnp.asarray(tree["kf_valid"])),
        n_kf=jnp.int32(tree["n_kf"]), edge_i=jnp.asarray(tree["edge_i"]),
        edge_j=jnp.asarray(tree["edge_j"]), edge_delta=jnp.asarray(tree["edge_delta"]),
        edge_info=jnp.asarray(tree["edge_info"]),
        edge_is_loop=jnp.asarray(tree["edge_is_loop"]), n_edges=jnp.int32(tree["n_edges"]),
        last_kf=jnp.int32(tree["last_kf"]), kf_overflow=jnp.asarray(tree["kf_overflow"]),
        edge_overflow=jnp.asarray(tree["edge_overflow"]))
    return st, jst


class _Spy:
    """Counts the calls of ``kernels.scan_planes`` and ``kernels.scan_insert``
    (with their ``plane_of`` and cells' rank), passing them on."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("scan_planes", "scan_insert"):
            real = getattr(kernels, name)

            def spy(*args, _name=name, _real=real, **kw):
                self.calls.append((_name, args, kw))
                return _real(*args, **kw)

            monkeypatch.setattr(kernels, name, spy)

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def test_callers_reach_the_wrappers_and_match_the_reference(loop, monkeypatch):
    """The submaps (BayesAvg: one ``scan_planes`` call with ``plane_of``;
    TBM: one ``scan_insert`` call on the M submaps a step of the chain),
    the regenerated map (one ``scan_planes`` call a group into one plane)
    and joint refine (one ``scan_planes`` call a round, a plane a
    keyframe), each against the JAX reference."""
    jcfg, tcfg = _configs()
    st, jst = _graph(loop, tcfg)
    spy = _Spy(monkeypatch)
    n = tcfg.local_map_size
    ci = torch.tensor([0, 3, 6])
    for model in ("bayes_avg", "tbm"):
        jm, tm = ((jcells.BayesAvgCell(), tcells.BayesAvgCell()) if model == "bayes_avg" else
                  (jcells.TBMCell(), tcells.TBMCell()))
        got = tpg._render_local_maps(tcfg, tm, st, ci)
        calls = spy.take()
        if model == "bayes_avg":
            assert [c[0] for c in calls] == ["scan_planes"]
            assert calls[0][1][7].tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2] and calls[0][1][8] == 3
        else:  # the chain: a step over the 3 submaps at once, as the loop's body
            span = 2 * tcfg.submap_radius + 1
            assert [c[0] for c in calls] == ["scan_insert"] * span
            assert all(c[1][0].cells.shape == (3, n, n, 5) and c[2]["window"] == 0 for c in calls)
        jrender = jax.jit(jax.vmap(lambda c: jpg._render_local_map(jcfg, jm, jst, c)))
        want = jrender(jnp.asarray(ci.numpy(), jnp.int32))
        diff = np.abs(got.cells.numpy() - np.asarray(want.cells)).max(-1)
        diff[:, n - 1, n - 1] = 0.0  # the reference's wrap cell
        assert diff.max() <= 1e-5 and int((got.cells[..., -1] > 0).sum()) > 300

    jm, tm = jcells.BayesAvgCell(), tcells.BayesAvgCell()
    tbeam, jbeam = tray.BeamConfig(**BEAM), jray.BeamConfig(**BEAM)
    got = tpg.regenerate_map(tcfg, tm, st, tgrid.make_grid_map(tm, SIDE, SIDE, SCALE), tbeam,
                             group=4)
    calls = spy.take()
    assert [c[0] for c in calls] == ["scan_planes"] * 2
    assert all(c[1][7].tolist() == [0] * 4 and c[1][8] == 1 for c in calls)
    want = jpg.regenerate_map(jcfg, jm, jst, jgrid.make_grid_map(jm, SIDE, SIDE, SCALE), jbeam)
    np.testing.assert_allclose(got.cells.numpy(), np.asarray(want.cells), atol=1e-5, rtol=0)

    got = tpg.joint_refine(
        tcfg, tm, st, tgrid.make_grid_map(tm, SIDE, SIDE, SCALE), tbeam, rounds=1,
        matcher_cfg=tmatch.BruteForceConfig(**GRID, scoring=tscore.ScoringConfig(
            reducer="overlap"))).kf_poses.numpy()
    calls = spy.take()
    assert [c[0] for c in calls] == ["scan_planes"] and calls[0][1][7] is None
    jref = jax.jit(lambda s, gm: jpg.joint_refine(
        jcfg, jm, s, gm, jbeam, rounds=1, matcher_cfg=jmatch.BruteForceConfig(
            **GRID, scoring=jscore.ScoringConfig(reducer="overlap"))))
    want = np.asarray(jref(jst, jgrid.make_grid_map(jm, SIDE, SIDE, SCALE)).kf_poses)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got[1:7] - st.kf_poses.numpy()[1:7]).max() > 0.01


def test_tbm_submap_chain_is_the_old_loop_body(loop):
    """``insert_scan_windows`` at window 0 on the M submaps gives the cells
    of the chain's old body (the batched planes of the step, then
    ``grid.apply_observations``) bit for bit."""
    _, tcfg = _configs()
    st, _ = _graph(loop, tcfg)
    tm, n, scale = tcells.TBMCell(), tcfg.local_map_size, tcfg.local_map_scale
    poses, scans = loop
    center = poses[[1, 4, 5]]
    origin = center[:, :2] - n * scale / 2.0
    fresh = tgrid.make_grid_map(tm, n, n, scale).cells
    gm = tgrid.GridMap(cells=fresh[None].expand(3, *fresh.shape), origin=origin, scale=scale)
    old = gm
    beam = tray.BeamConfig(wall_blur=True)
    for k in (1, 4, 5, 2):
        step = TScan(*(t[k].expand(3, -1) for t in (scans.ranges, scans.bearings, scans.valid)))
        pose = poses[k].expand(3, 3) + torch.tensor([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0],
                                                     [0.0, -0.05, 0.01]])
        gm = tray.insert_scan_windows(gm, tm, pose, step, beam)
        w_k, s_k = kernels.scan_planes_ref(origin, n, n, scale, pose, step, beam)
        old = tgrid.apply_observations(old, tm, w_k, s_k)
        assert _same(gm.cells, old.cells) and torch.equal(gm.origin, old.origin)
    assert int((gm.cells[..., -1] > 0).sum()) > 300
