"""Port parity of the slice as a whole: the loop-closing pipeline.

A short loop (a lap of the cecum rectangle and a few scans more, 96 beams,
160^2 map, drifting odometry) goes through the reference's
``FullSlamEngine`` and the port's, as arrays made by the port's datagen. The
reference's matcher noise chain (as in test_torch_engine.py) is rebuilt and
injected into the port's tracker. The tracker is the windowed
``tiny.fast_config`` (a 96-cell match window), the loop matcher a 5^3
brute-force grid on 64^2 submaps.

Compared: the raw tracked poses, the corrected trajectory and the keyframe
poses within 1e-4 (per-step differences are f32 ulps that the map feeds
back; a closure burst solves a 3K x 3K system on top; measured: 5e-7), the
graph's structure exactly (keyframe and edge indices, counts, order, loop
flags), the loop count, and the regenerated map: occupancy within 1e-3 in
every cell but (H-1, W-1), into which the reference on a CPU wraps samples
that fall off the map, and the observation weight equal in all but at most
3 cells (a free sample on a cell's border falls to either side; measured:
1 cell, by one count). The gates on the way (keyframe distance, ``probs > min_prob``, the Huber kernel,
``moved > half a cell``) are knife edges: the sequence is short enough that
none of them falls within the differences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import full as jfull
from slam_constructor_tpu.models import posegraph as jpg
from slam_constructor_tpu.models import tiny as jtiny
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import full as tfull
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata
from slam_constructor_tpu_torch.utils import evaluate as teval

torch.set_num_threads(1)

N_BEAMS, MAP, BATCH, ROUNDS = 96, 160, 16, 4
TRACK = dict(map_size=MAP, usable_range=4.0, stride=2, mc_batch=BATCH, mc_rounds=ROUNDS)
GRAPH = dict(max_keyframes=32, max_edges=128, keyframe_distance=1.2, loop_radius=2.0,
             min_index_gap=6, min_prob=0.55, max_candidates=2, local_map_size=64, gn_iterations=6)
BF = dict(half_x=0.5, half_y=0.5, half_theta=0.2, n_x=5, n_y=5, n_theta=5)
FULL = dict(optimize_every_loops=2, kf_batch=4)


def reference_noise_chain(key, n_steps, rounds, batch):
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, rounds)
        out.append(np.stack([np.asarray(jax.random.normal(k, (batch, 3))) for k in keys]))
    return np.stack(out)


def make_configs():
    jgraph = jpg.PoseGraphConfig(**GRAPH, loop_matcher=jmatch.BruteForceConfig(
        **BF, scoring=jscore.ScoringConfig(reducer="overlap", stride=2)))
    tgraph = tpg.PoseGraphConfig(**GRAPH, loop_matcher=tmatch.BruteForceConfig(
        **BF, scoring=tscore.ScoringConfig(reducer="overlap", stride=2)))
    jcfg = jfull.FullConfig(tracking=jtiny.fast_config(**TRACK), graph=jgraph, **FULL)
    tcfg = tfull.FullConfig(tracking=ttiny.fast_config(**TRACK), graph=tgraph, **FULL)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def run():
    occ, origin, scale = tdata.cecum_world()
    lap = tdata.rectangle_trajectory(step=0.35)
    poses = torch.cat([lap, lap[:14]])
    scans, odom, gt = tdata.synth_sequence(
        occ, origin, scale, poses, tdata.default_bearings(N_BEAMS), rng=5,
        odom_noise_xy=0.02, odom_noise_theta=0.012,
    )
    n = len(gt)
    jcfg, tcfg = make_configs()
    assert jcfg.tracking.match_window == tcfg.tracking.match_window == 96
    jscans = JScan(ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
                   valid=jnp.asarray(scans.valid.numpy()))
    je = jfull.FullSlamEngine(jcfg, n_beams=N_BEAMS)
    je.state = je.state.replace(pose=jnp.asarray(gt[0].numpy()))
    jtraj = np.asarray(je.run(jscans, jnp.asarray(odom.numpy()), segment=n))
    noise = torch.from_numpy(reference_noise_chain(jax.random.PRNGKey(0), n, ROUNDS, BATCH))
    te = tfull.FullSlamEngine(tcfg, n_beams=N_BEAMS, device="cpu")
    te.state.pose = gt[0].clone()
    ttraj = te.run(scans, odom, segment=n, noise=noise)
    return dict(scans=scans, odom=odom, gt=gt, noise=noise, je=je, te=te, jtraj=jtraj, ttraj=ttraj,
                tcfg=tcfg, n=n)


def pose_diff(a, b):
    d = np.asarray(a) - np.asarray(b)
    d[..., 2] = np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2]))
    return np.abs(d).max()


def test_full_run_matches_reference(run):
    je, te = run["je"], run["te"]
    assert te.total_loops == je.total_loops >= 2
    assert te.n_bursts >= 1
    jg, tg = je.graph, convert.graph_to_numpy(te.graph)
    n_kf, n_e = int(jg.n_kf), int(jg.n_edges)
    assert (tg["n_kf"], tg["n_edges"], tg["last_kf"]) == (n_kf, n_e, int(jg.last_kf))
    assert 10 <= n_kf <= 32
    assert tg["kf_poses"].shape == np.asarray(jg.kf_poses).shape  # the same growth of the store
    np.testing.assert_array_equal(tg["edge_i"][:n_e], np.asarray(jg.edge_i)[:n_e])
    np.testing.assert_array_equal(tg["edge_j"][:n_e], np.asarray(jg.edge_j)[:n_e])
    np.testing.assert_array_equal(tg["edge_is_loop"][:n_e], np.asarray(jg.edge_is_loop)[:n_e])
    assert not tg["kf_overflow"] and not tg["edge_overflow"]
    assert pose_diff(tg["kf_poses"][:n_kf], np.asarray(jg.kf_poses)[:n_kf]) <= 1e-4
    np.testing.assert_allclose(tg["edge_delta"][:n_e], np.asarray(jg.edge_delta)[:n_e], atol=1e-4)
    # the raw tracked poses, the corrected trajectory, the live pose, the map
    assert pose_diff(np.stack(te.trajectory), np.stack(je.trajectory)) <= 1e-4
    assert run["ttraj"].shape == (run["n"], 3)
    assert pose_diff(run["ttraj"].numpy(), run["jtraj"]) <= 1e-4
    assert pose_diff(te.state.pose.numpy(), np.asarray(je.state.pose)) <= 1e-4
    assert te.pending_loops == je.pending_loops
    diff = np.abs(te.state.gm.cells.numpy() - np.asarray(je.state.gm.cells))
    diff[MAP - 1, MAP - 1] = 0.0  # the reference's wrap cell
    assert diff[..., :-1].max() <= 1e-3
    # a free sample on a cell's border may fall to either side
    assert (diff[..., -1] > 1e-3).sum() <= 3, f"{(diff[..., -1] > 1e-3).sum()} weights differ"
    assert te.occupancy.shape == (MAP, MAP)
    assert te.keyframe_poses.shape == (n_kf, 3)


def test_loop_closure_cuts_the_drift(run):
    """What the reference's own pipeline test asks: the closure brings the
    end of the lap back onto ground truth."""
    gt, traj = run["gt"], run["ttraj"]
    raw = torch.from_numpy(np.stack(run["te"].trajectory))
    assert float(teval.ate(traj, gt, align=False)) < 0.5
    final = float((traj[-1, :2] - gt[-1, :2]).norm())
    assert final < 0.3
    assert bool(torch.isfinite(traj).all()) and bool(torch.isfinite(raw).all())
    assert float(tpg.graph_error(run["te"].graph)) < 1e3


def test_segmented_run_and_online_stepping(run):
    """``run_segments`` (closures at segment boundaries) keeps the same
    bookkeeping as scan-by-scan ``handle_scan`` over the same noise."""
    n = 40
    scans, odom, noise = run["scans"], run["odom"], run["noise"]
    a = tfull.FullSlamEngine(run["tcfg"], n_beams=N_BEAMS, device="cpu")
    a.state.pose = run["gt"][0].clone()
    a.run_segments(scans[:n], odom[:n], segment=1, noise=noise[:n])
    b = tfull.FullSlamEngine(run["tcfg"], n_beams=N_BEAMS, device="cpu")
    b.state.pose = run["gt"][0].clone()
    for i in range(n):
        pose = b.handle_scan(scans[i], odom[i], noise=noise[i])
    assert torch.equal(pose, a.state.pose)
    assert torch.equal(b.corrected_trajectory(), a.corrected_trajectory())
    assert torch.equal(a.graph.kf_poses, b.graph.kf_poses)
    assert int(a.graph.n_kf) == a._n_kf_host >= 5
    # before any loop closes the corrected trajectory is the tracked one
    assert a.total_loops == 0
    torch.testing.assert_close(a.corrected_trajectory(), torch.from_numpy(np.stack(a.trajectory)),
                               atol=1e-5, rtol=0)


def test_segmented_run_matches_reference(run):
    """``run_segments`` against the reference's, 32 scans a segment."""
    n = 64
    scans, odom = run["scans"], run["odom"]
    jcfg, tcfg = make_configs()
    jscans = JScan(ranges=jnp.asarray(scans.ranges.numpy()[:n]),
                   bearings=jnp.asarray(scans.bearings.numpy()[:n]),
                   valid=jnp.asarray(scans.valid.numpy()[:n]))
    je = jfull.FullSlamEngine(jcfg, n_beams=N_BEAMS)
    je.state = je.state.replace(pose=jnp.asarray(run["gt"][0].numpy()))
    jtraj = np.asarray(je.run_segments(jscans, jnp.asarray(odom.numpy()[:n]), segment=32))
    te = tfull.FullSlamEngine(tcfg, n_beams=N_BEAMS, device="cpu")
    te.state.pose = run["gt"][0].clone()
    ttraj = te.run_segments(scans[:n], odom[:n], segment=32, noise=run["noise"][:n])
    assert pose_diff(ttraj.numpy(), jtraj) <= 1e-4
    assert (int(te.graph.n_kf), int(te.graph.n_edges)) == (int(je.graph.n_kf), int(je.graph.n_edges))
    assert te.total_loops == je.total_loops


def test_joint_refine_rounds_route_run_through_run_segments(run):
    """With ``joint_refine_rounds`` set, ``run`` closes loops at segment
    boundaries and polishes the keyframes against the leave-one-out map."""
    cfg = dataclasses.replace(run["tcfg"], joint_refine_rounds=1)
    e = tfull.FullSlamEngine(cfg, n_beams=N_BEAMS, device="cpu")
    e.state.pose = run["gt"][0].clone()
    traj = e.run(run["scans"], run["odom"], segment=46, noise=run["noise"])
    assert e.total_loops >= 2 and e.n_bursts == 1 and e.pending_loops == 0
    assert traj.shape == (run["n"], 3) and bool(torch.isfinite(traj).all())
    assert float((traj[-1, :2] - run["gt"][-1, :2]).norm()) < 0.3
    # the gate and the anchor moved to the optimised last keyframe
    last = e.graph.kf_poses[int(e.graph.last_kf)]
    assert torch.equal(e._last_kf_dev, last) and torch.equal(e._anchor_pose_dev, last)


@pytest.mark.parametrize("close", ["_burst", "_close_loops"])
def test_failed_optimisation_stops_the_run(run, close):
    """A closure whose normal equations are not positive definite (negative
    edge weights) raises instead of going on with NaN poses."""
    te = run["te"]
    e = tfull.FullSlamEngine(te.cfg, n_beams=N_BEAMS, device="cpu")
    e.state = te.state
    e.graph = dataclasses.replace(te.graph, edge_info=-te.graph.edge_info)
    with pytest.raises(RuntimeError, match="not positive definite"):
        getattr(e, close)(*([torch.zeros(1, 3)] if close == "_burst" else []))
    e.graph = te.graph  # the sound graph goes through
    getattr(e, close)(*([torch.zeros(1, 3)] if close == "_burst" else []))
    assert bool(torch.isfinite(e.graph.kf_poses).all()) and e.n_bursts == 1


def test_capacity_grows_before_the_graph_saturates(run):
    cfg = dataclasses.replace(run["tcfg"], graph=dataclasses.replace(
        run["tcfg"].graph, max_keyframes=4, max_edges=8))
    e = tfull.FullSlamEngine(cfg, n_beams=N_BEAMS, device="cpu")
    e.state.pose = run["gt"][0].clone()
    e.run(run["scans"][:30], run["odom"][:30], segment=10, noise=run["noise"][:30])
    assert int(e.graph.n_kf) > 4 and e.cfg.graph.max_keyframes >= int(e.graph.n_kf)
    assert not bool(e.graph.kf_overflow) and not bool(e.graph.edge_overflow)
    assert e.cfg.graph.max_edges >= int(e.graph.n_edges)


def test_entry_point_defaults_to_the_card_and_checkpoints_wait(run, tmp_path):
    """The entry points default to the card; the mid-run checkpoint (no
    longer waiting for a later slice) carries the whole engine of the run
    above into a fresh one: state, graph, counters and trajectory, bit for
    bit (resuming from one: tests/test_torch_checkpoint.py)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tfull.FullSlamEngine(run["tcfg"], n_beams=N_BEAMS)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpg.init_state(run["tcfg"].graph, N_BEAMS)
    te = run["te"]
    path = str(tmp_path / "ck")
    te.save_checkpoint(path)
    e = tfull.FullSlamEngine(run["tcfg"], n_beams=N_BEAMS, device="cpu")
    e.restore_checkpoint(path)
    for name in ("kf_poses", "n_kf", "edge_i", "edge_j", "edge_delta", "edge_info", "n_edges"):
        assert torch.equal(getattr(e.graph, name), getattr(te.graph, name))
    assert torch.equal(e.state.gm.cells, te.state.gm.cells)
    assert torch.equal(e.state.pose, te.state.pose)
    assert torch.equal(e.corrected_trajectory(), te.corrected_trajectory())
    assert (e.total_loops, e.n_bursts, e.cfg) == (te.total_loops, te.n_bursts, te.cfg)
    assert torch.equal(e.generator.get_state(), te.generator.get_state())
    with pytest.raises(FileNotFoundError):
        e.restore_checkpoint(str(tmp_path / "none"))
    assert tfull.FullConfig().tracking == ttiny.tiny_config()
