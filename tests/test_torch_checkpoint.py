"""Checkpoint and resume (``utils/checkpoint.py``, ``FullSlamEngine.
save_checkpoint`` / ``restore_checkpoint``): a run stopped, saved, restored
into a fresh engine and finished equals, bit for bit, the run that was
never stopped, on the CPU: tiny, viny_m3rsm (its pyramid in the state),
the RBPF on dense maps and on the copy-on-write pool, and the loop-closing
pipeline. The engines' generators are saved with their states (the
reference keeps its PRNG key in the state), so the draws after a restore
are the unbroken run's.

The structure guard is the reference's (``tests/test_utils.py:141``): a
checkpoint restored into another engine's state raises. The reference's
own round trip (``tests/test_utils.py:127``) is held against the port's: a
state saved by each restores the same values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.models import tiny as jtiny
from slam_constructor_tpu.utils import checkpoint as jckpt
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import full as tfull
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.models import viny as tviny
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.utils import checkpoint
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)

N_BEAMS = 96


@pytest.fixture(scope="module")
def seq():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.25)[:12]
    return datagen.synth_sequence(occ, origin, scale, poses, datagen.default_bearings(N_BEAMS),
                                  rng=9, odom_noise_xy=0.02, odom_noise_theta=0.01)


def tensors(tree):
    """The tensors of a state tree, in order (``checkpoint``'s walk)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return out


def assert_bits(a, b):
    ta, tb = tensors(a), tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def engine_cases():
    return {
        "tiny": lambda: teng.Engine(ttiny.tiny_config(map_size=96, mc_batch=8, mc_rounds=4,
                                                      map_scale=0.15), device="cpu", seed=3),
        "viny_m3rsm": lambda: teng.Engine(tviny.viny_m3rsm_config(map_size=96, map_scale=0.15,
                                                                  usable_range=3.0, levels=3,
                                                                  beam_width=16),
                                          device="cpu", seed=3),
        "gmapping": lambda: tgm.GMappingEngine(tgm.fast_config(
            n_particles=4, map_size=96, map_scale=0.2, usable_range=2.5), device="cpu", seed=3),
        "gmapping_cow": lambda: tgm.GMappingEngine(dataclasses.replace(tgm.fast_config(
            n_particles=4, map_size=96, map_scale=0.2, usable_range=2.5), map_storage="cow",
            tile_block=16, window_tiles=4, tile_capacity=256), device="cpu", seed=3),
    }


@pytest.mark.parametrize("name", sorted(engine_cases()))
def test_resume_equals_the_unbroken_run(seq, tmp_path, name):
    scans, odom, gt = seq
    make = engine_cases()[name]

    def fresh():
        e = make()
        if isinstance(e, tgm.GMappingEngine):
            e.state.poses = gt[0].expand(e.cfg.n_particles, 3).clone()
        else:
            e.state = dataclasses.replace(e.state, pose=gt[0].clone())
        return e

    half = 5
    ref = fresh()
    want_a = ref.run(scans[:half], odom[:half])[0]
    want_b = ref.run(scans[half:], odom[half:])[0]

    a = fresh()
    got_a = a.run(scans[:half], odom[:half])[0]
    assert torch.equal(got_a, want_a)
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"state": a.state, "generator": a.generator})
    b = fresh()
    b.run(scans[:2], odom[:2])  # a state and a generator that have moved on
    back = checkpoint.restore(path, {"state": b.state, "generator": b.generator})
    b.state, b.generator = back["state"], back["generator"]
    assert_bits(b.state, a.state)
    got_b = b.run(scans[half:], odom[half:])[0]
    assert torch.equal(got_b, want_b)
    assert_bits(b.state, ref.state)
    if name == "viny_m3rsm":
        assert len(b.state.pyramid) == 4
    if name == "gmapping_cow":
        assert int(b.state.gm.refcnt.sum()) > 0


def test_structure_guard(tmp_path, seq):
    """A checkpoint of one engine's state does not restore into another's
    (the reference's treedef check); nor into a state of other plain
    values (a map's scale)."""
    e = teng.Engine(ttiny.tiny_config(map_size=64), device="cpu")
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, e.state)
    g = tgm.GMappingEngine(tgm.GMappingConfig(n_particles=2, map_height=64, map_width=64),
                           device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, g.state)
    other = teng.Engine(ttiny.tiny_config(map_size=64, map_scale=0.05), device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, other.state)
    back = checkpoint.restore(path[:-4], e.state)  # ".npz" appended as the reference does
    assert_bits(back, e.state)
    with pytest.raises(TypeError):
        checkpoint.save(path, {"engine": e})


def test_a_state_crosses_like_the_reference(tmp_path):
    """The reference's round trip (tests/test_utils.py:127) and the port's
    on the same state: the same pose, step and cells after each."""
    cfg = jtiny.tiny_config(map_size=64)
    st = jeng.init_state(cfg).replace(pose=np.float32([1.0, 2.0, 0.3]), step=np.int32(7))
    jckpt.save(str(tmp_path / "ref.npz"), st)
    want = jckpt.restore(str(tmp_path / "ref.npz"), jeng.init_state(cfg))
    e = teng.Engine(ttiny.tiny_config(map_size=64), device="cpu")
    e.state = dataclasses.replace(e.state, pose=torch.tensor([1.0, 2.0, 0.3]),
                                  step=torch.tensor(7, dtype=torch.int32))
    checkpoint.save(str(tmp_path / "port.npz"), e.state)
    got = checkpoint.restore(str(tmp_path / "port.npz"),
                             teng.Engine(ttiny.tiny_config(map_size=64), device="cpu").state)
    np.testing.assert_array_equal(got.pose.numpy(), np.asarray(want.pose))
    assert int(got.step) == int(want.step) == 7
    np.testing.assert_array_equal(got.gm.cells.numpy(), np.asarray(want.gm.cells))


# --- the loop-closing pipeline ---------------------------------------------------

GRAPH = dict(max_keyframes=4, max_edges=8, keyframe_distance=1.2, loop_radius=2.0,
             min_index_gap=6, min_prob=0.55, max_candidates=2, local_map_size=64,
             gn_iterations=6)


@pytest.fixture(scope="module")
def loop_seq():
    occ, origin, scale = datagen.cecum_world()
    lap = datagen.rectangle_trajectory(step=0.35)
    return datagen.synth_sequence(occ, origin, scale, torch.cat([lap, lap[:14]]),
                                  datagen.default_bearings(N_BEAMS), rng=5,
                                  odom_noise_xy=0.02, odom_noise_theta=0.012)


def full_engine(gt):
    graph = tpg.PoseGraphConfig(**GRAPH, loop_matcher=tmatch.BruteForceConfig(
        half_x=0.5, half_y=0.5, half_theta=0.2, n_x=5, n_y=5, n_theta=5,
        scoring=tscore.ScoringConfig(reducer="overlap", stride=2)))
    cfg = tfull.FullConfig(tracking=ttiny.fast_config(map_size=160, usable_range=4.0, stride=2,
                                                      mc_batch=16, mc_rounds=4),
                           graph=graph, optimize_every_loops=2, kf_batch=4)
    e = tfull.FullSlamEngine(cfg, n_beams=N_BEAMS, device="cpu", seed=4)
    e.state.pose = gt[0].clone()
    return e


def test_full_pipeline_resume_equals_the_unbroken_run(loop_seq, tmp_path):
    """tests/test_full_pipeline.py:81 on the port: half the loop, a save, a
    fresh engine restored, the rest; the graph starts at 4 keyframes and 8
    edges, so it has grown before the save and must grow again on the
    restore. Corrected trajectory, keyframes, graph, map and counters equal
    the unbroken run's bit for bit."""
    scans, odom, gt = loop_seq
    n, half, seg = len(gt), 32, 16
    ref = full_engine(gt)
    ref.run(scans, odom, segment=seg)
    want = ref.corrected_trajectory()
    assert ref.total_loops >= 2 and ref.n_bursts >= 1

    a = full_engine(gt)
    a.run(scans[:half], odom[:half], segment=seg)
    assert a.cfg.graph.max_keyframes > 4  # grown before the save
    path = str(tmp_path / "ck")
    a.save_checkpoint(path)
    b = full_engine(gt)
    b.restore_checkpoint(path)
    assert b.cfg.graph == a.cfg.graph
    b.run(scans[half:n], odom[half:n], segment=seg)
    assert torch.equal(b.corrected_trajectory(), want)
    assert_bits([b.state, b.graph], [ref.state, ref.graph])
    assert (b.total_loops, b.n_bursts, b.n_kf_batches, b.cfg.graph) == (
        ref.total_loops, ref.n_bursts, ref.n_kf_batches, ref.cfg.graph)


def test_full_restore_needs_both_halves(loop_seq, tmp_path):
    _, _, gt = loop_seq
    e = full_engine(gt)
    path = str(tmp_path / "ck")
    e.save_checkpoint(path)
    import os

    os.remove(path + ".host.npz")
    fresh = full_engine(gt)
    before = fresh.state.pose.clone()
    with pytest.raises(FileNotFoundError, match="host"):
        fresh.restore_checkpoint(path)
    assert torch.equal(fresh.state.pose, before)  # nothing of the engine changed
