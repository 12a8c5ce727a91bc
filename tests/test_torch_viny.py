"""Port parity of the vinySLAM slice: beam weights, one step, a sequence.

The sequence comes from the port's datagen (numpy-seeded odometry noise)
and goes to both engines as arrays; the reference's matcher noise chain is
rebuilt and injected into the port (see test_torch_engine.py). The
reference runs with ``free_impl='polar'`` pinned, the fill its ``'auto'``
resolves to on its accelerator and the one the port's preset names.

Tolerances: each step's pose and probability within 1e-4, map cells within
1e-4 on at least 99.9% of cells: per-step differences are f32 ulps
(sin/cos/atan2, exp/log in the TBM fold, sum order) that the map feeds back
into later steps. The 160^2 map at 0.1 m holds the whole world.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.models import viny as jviny
from slam_constructor_tpu.ops import scan as jscan
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import full as tfull
from slam_constructor_tpu_torch.models import viny as tviny
from slam_constructor_tpu_torch.ops import m3rsm as tm3
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

N_SCANS, N_BEAMS, MAP, BATCH, ROUNDS = 8, 96, 160, 16, 4
#: a gate that the match probabilities of the sequence's second half (about
#: 0.70-0.71 on the map of the first half) straddle
GATE = 0.7035


def reference_noise_chain(key, n_steps, rounds, batch):
    """The matcher normals of ``n_steps`` reference steps from ``key``;
    returns them f32[n_steps, rounds, batch, 3] and the key after."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, rounds)
        out.append(np.stack([np.asarray(jax.random.normal(k, (batch, 3))) for k in keys]))
    return np.stack(out), key


def _configs(**kwargs):
    jcfg = jviny.viny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS, **kwargs)
    jcfg = dataclasses.replace(jcfg, beam=dataclasses.replace(jcfg.beam, free_impl="polar"))
    return jcfg, tviny.viny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS, **kwargs)


def _jscans(scans):
    return jscan.LaserScan(
        ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
        valid=jnp.asarray(scans.valid.numpy()),
    )


@pytest.fixture(scope="module")
def seq():
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.1)[:N_SCANS]
    scans, odom, gt = tdata.synth_sequence(
        occ, origin, scale, poses, tdata.default_bearings(N_BEAMS), rng=7,
        odom_noise_xy=0.02, odom_noise_theta=0.01,
    )
    noise, _ = reference_noise_chain(jax.random.PRNGKey(0), N_SCANS, ROUNDS, BATCH)
    return dict(scans=scans, odom=odom, gt=gt, jscans=_jscans(scans),
                jodom=jnp.asarray(odom.numpy()), noise=torch.from_numpy(noise))


def _run_reference(seq, jcfg):
    state = jeng.init_state(jcfg).replace(pose=jnp.asarray(seq["gt"][0].numpy()))
    final, traj, probs = jeng.run_sequence(jcfg, state, seq["jscans"], seq["jodom"])
    return final, np.asarray(traj), np.asarray(probs)


def _cells_close(a, b, tol=1e-4):
    return np.all(np.abs(a - b) <= tol, axis=-1)


# --- beam weights -------------------------------------------------------------


def _edge_beams(scan, n_bins=36, eps=1e-5):
    """Beams whose wall tangent lies within ``eps`` rad of a histogram bin
    edge: a last-ulp difference in ``atan2`` may bin them differently."""
    pts = tscan.scan_points(scan).double()
    d = pts[1:] - pts[:-1]
    t = torch.atan2(d[:, 1], d[:, 0])
    t = torch.cat([t, t[-1:]])
    pos = (t + np.pi) / (2 * np.pi) * n_bins
    return (pos - torch.round(pos)).abs() < eps / (2 * np.pi) * n_bins


def test_angle_histogram_and_point_weights_match_reference(seq):
    """Equal (1e-6: one division) but for beams whose tangent lies within
    1e-5 rad of a bin edge, where a last-ulp difference in ``atan2`` may
    move a beam to the next bin. Of the 8 x 96 beams of this sequence none
    lies that close (endpoints are ray-marched, so no tangent is exactly
    axis-aligned): every histogram and all 768 weights agree."""
    jcfg, tcfg = _configs()
    n_edge = n_diff = 0
    for i in range(N_SCANS):
        ts, js = seq["scans"][i], jax.tree.map(lambda a: a[i], seq["jscans"])
        th, jh = tscan.angle_histogram(ts).numpy(), np.asarray(jscan.angle_histogram(js))
        assert th.shape == (36,) and abs(th.sum() - 1.0) < 1e-6
        tw, jw = teng._point_weights(tcfg, ts).numpy(), np.asarray(jeng._point_weights(jcfg, js))
        assert tw.shape == (N_BEAMS,) and tw.dtype == np.float32
        edge = _edge_beams(ts).numpy()
        n_edge += int(edge.sum())
        n_diff += int((np.abs(tw - jw) > 1e-6).sum())
        if not edge.any():
            np.testing.assert_allclose(th, jh, atol=1e-6)
        np.testing.assert_allclose(tw[~edge], jw[~edge], atol=1e-6)
        assert 0.0 < tw.min() and tw.max() <= 1.0
    assert n_diff <= n_edge
    assert teng._point_weights(dataclasses.replace(tcfg, use_angle_histogram=False), ts) is None


def test_angle_histogram_ignores_invalid_beams():
    rng = np.random.default_rng(0)
    ranges = rng.uniform(1.0, 6.0, 64).astype(np.float32)
    valid = rng.uniform(size=64) < 0.7
    b = np.linspace(-np.pi, np.pi, 64, endpoint=False).astype(np.float32)
    t = tscan.LaserScan(torch.from_numpy(ranges), torch.from_numpy(b), torch.from_numpy(valid))
    j = jscan.LaserScan(jnp.asarray(ranges), jnp.asarray(b), jnp.asarray(valid))
    np.testing.assert_allclose(
        tscan.angle_histogram(t, 12).numpy(), np.asarray(jscan.angle_histogram(j, 12)), atol=1e-6
    )
    none = tscan.LaserScan(t.ranges, t.bearings, torch.zeros(64, dtype=torch.bool))
    assert float(tscan.angle_histogram(none).sum()) == 0.0


# --- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(seq):
    jcfg, tcfg = _configs()
    final, traj, probs = _run_reference(seq, jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, final=final, traj=traj, probs=probs)


def test_viny_engine_matches_reference_sequence(seq, ref):
    e = teng.Engine(ref["tcfg"], device="cpu")
    e.state.pose = seq["gt"][0].clone()
    traj, probs = e.run(seq["scans"], seq["odom"], noise=seq["noise"])
    assert traj.shape == (N_SCANS, 3) and probs.shape == (N_SCANS,)
    np.testing.assert_allclose(traj.numpy(), ref["traj"], atol=1e-4)
    np.testing.assert_allclose(probs.numpy(), ref["probs"], atol=1e-4)
    cells = e.state.gm.cells.numpy()
    assert cells.shape == (MAP, MAP, 5)
    close = _cells_close(cells, np.asarray(ref["final"].gm.cells))
    assert close.mean() >= 0.999, f"{(~close).sum()} cells differ"
    assert int(e.state.step) == N_SCANS


def test_viny_step_from_converted_state(seq, ref):
    """The reference runs 4 steps; its state crosses to the port through
    ``convert``; one ``slam_step`` there equals the reference's fifth."""
    jcfg, half = ref["jcfg"], N_SCANS // 2
    jstate = jeng.init_state(jcfg).replace(pose=jnp.asarray(seq["gt"][0].numpy()))
    jhalf, _, _ = jeng.run_sequence(
        jcfg, jstate, jax.tree.map(lambda a: a[:half], seq["jscans"]), seq["jodom"][:half]
    )
    tree = {
        "cells": np.asarray(jhalf.gm.cells), "origin": np.asarray(jhalf.gm.origin),
        "scale": jhalf.gm.scale, "pose": np.asarray(jhalf.pose), "step": int(jhalf.step),
        "last_prob": float(jhalf.last_prob),
    }
    state = convert.state_from_numpy(tree, "cpu")
    assert state.gm.cells.shape == (MAP, MAP, 5)
    noise, _ = reference_noise_chain(jhalf.key, 1, ROUNDS, BATCH)
    jnext = jax.jit(jeng.slam_step, static_argnums=0)(
        jcfg, jhalf, jax.tree.map(lambda a: a[half], seq["jscans"]), seq["jodom"][half]
    )
    tnext = teng.slam_step(
        ref["tcfg"], state, seq["scans"][half], seq["odom"][half], noise=torch.from_numpy(noise[0])
    )
    np.testing.assert_allclose(tnext.pose.numpy(), np.asarray(jnext.pose), atol=1e-5)
    np.testing.assert_allclose(float(tnext.last_prob), float(jnext.last_prob), atol=1e-5)
    np.testing.assert_allclose(tnext.pose.numpy(), ref["traj"][half], atol=1e-4)
    close = _cells_close(tnext.gm.cells.numpy(), np.asarray(jnext.gm.cells), 1e-5)
    assert close.mean() >= 0.999
    assert int(tnext.step) == half + 1


def test_viny_insert_gate_matches_reference(seq, ref):
    """Four ungated steps build a map; the other four run with
    ``min_insert_prob`` between their match probabilities, so some of them
    are gated: a gated scan moves the pose but leaves the map as it was, on
    both sides."""
    half = N_SCANS // 2
    jcfg, tcfg = _configs(min_insert_prob=GATE)
    jstate = jeng.init_state(ref["jcfg"]).replace(pose=jnp.asarray(seq["gt"][0].numpy()))
    jstate, _, _ = jeng.run_sequence(
        ref["jcfg"], jstate, jax.tree.map(lambda a: a[:half], seq["jscans"]), seq["jodom"][:half]
    )
    jfinal, jtraj, jprobs = jeng.run_sequence(
        jcfg, jstate, jax.tree.map(lambda a: a[half:], seq["jscans"]), seq["jodom"][half:]
    )
    jtraj, jprobs = np.asarray(jtraj), np.asarray(jprobs)
    gated = jprobs < GATE
    assert gated.any() and not gated.all(), jprobs
    assert np.abs(jprobs - GATE).min() > 1e-3  # no probability sits on the gate

    e = teng.Engine(ref["tcfg"], device="cpu")
    e.state.pose = seq["gt"][0].clone()
    e.run(seq["scans"][:half], seq["odom"][:half], noise=seq["noise"][:half])
    e.cfg = tcfg
    weights = [float(e.state.gm.weight.sum())]
    for i in range(half, N_SCANS):
        e.handle_scan(seq["scans"][i], seq["odom"][i], noise=seq["noise"][i])
        weights.append(float(e.state.gm.weight.sum()))
    np.testing.assert_allclose(torch.stack(e.trajectory[half:]).numpy(), jtraj, atol=1e-4)
    np.testing.assert_allclose(float(e.state.last_prob), jprobs[-1], atol=1e-4)
    # a gated scan adds no observation weight; an inserted one does
    np.testing.assert_array_equal(np.diff(np.array(weights)) > 0, ~gated)
    close = _cells_close(e.state.gm.cells.numpy(), np.asarray(jfinal.gm.cells))
    assert close.mean() >= 0.999
    # and the gate changed the outcome: the ungated map saw more
    assert weights[-1] < float(np.asarray(ref["final"].gm.cells)[..., -1].sum())


def test_viny_make_engine_and_unported_preset():
    e = tviny.make_engine(device="cpu", seed=1, map_size=64, mc_batch=8, mc_rounds=2)
    assert e.cfg.beam.free_impl == "polar" and e.cfg.use_angle_histogram
    assert e.cfg.matcher_cfg.scoring.stride == 2 and e.state.gm.cells.shape == (64, 64, 5)
    with pytest.raises(NotImplementedError):  # the reference's pipeline keeps a stale pyramid
        tfull.FullConfig(tracking=tviny.viny_m3rsm_config())


# --- vinySLAM with the M3RSM matcher ------------------------------------------

#: a stretch of the lower corridor inside a 128^2 map at 0.1 m: with beams
#: capped at 5 m no sample falls off the map (the reference would wrap it,
#: trap g). The path starts off the cell grid: from a pose on a cell
#: boundary every DDA sample of an axis-aligned beam sits on one, where the
#: reference's jitted ``x * (1 / 0.1)`` and the port's IEEE ``x / 0.1``
#: (trap h) fall into neighbouring cells
M3_SCANS, M3_MAP = 12, 128


@pytest.fixture(scope="module")
def m3_seq():
    occ, origin, scale = tdata.cecum_world()
    t = torch.linspace(0.0, 1.0, M3_SCANS)
    poses = torch.stack([-0.973 + 1.8 * t, -1.517 + 0.05 * torch.sin(6 * t),
                         0.1 * torch.sin(4 * t)], dim=-1)
    scans, odom, gt = tdata.synth_sequence(
        occ, origin, scale, poses, tdata.default_bearings(N_BEAMS), rng=11,
        odom_noise_xy=0.02, odom_noise_theta=0.01,
    )
    return dict(scans=scans, odom=odom, gt=gt, jscans=_jscans(scans),
                jodom=jnp.asarray(odom.numpy()))


@pytest.mark.parametrize("wall_blur,usable_range", [(True, 5.0), (True, 3.0), (False, 3.0)])
def test_viny_m3rsm_engine_matches_reference(m3_seq, wall_blur, usable_range):
    """``viny_m3rsm_config`` at a 128^2 map over 12 scans, both engines from
    the reference's initial state (pyramid included) crossed through
    ``convert``: every step's pose and probability within 1e-4 (f32 ulps of
    the TBM fold and of sin / cos that the map feeds forward); the live
    pyramid equal to a rebuild of the final map bit for bit. At 5 m the
    insert's footprint covers the map and the pyramid is rebuilt every
    step; at 3 m a 112^2 region is refreshed, with the wall blur on and off."""
    jcfg = jviny.viny_m3rsm_config(map_size=M3_MAP, usable_range=usable_range)
    tcfg = tviny.viny_m3rsm_config(map_size=M3_MAP, usable_range=usable_range)
    if not wall_blur:
        jcfg = dataclasses.replace(jcfg, beam=dataclasses.replace(jcfg.beam, wall_blur=False))
        tcfg = dataclasses.replace(tcfg, beam=dataclasses.replace(tcfg.beam, wall_blur=False))
    jstate = jeng.init_state(jcfg).replace(pose=jnp.asarray(m3_seq["gt"][0].numpy()))
    tree = {"cells": np.asarray(jstate.gm.cells), "origin": np.asarray(jstate.gm.origin),
            "scale": jstate.gm.scale, "pose": np.asarray(jstate.pose), "step": 0,
            "last_prob": 0.0, "pyramid": tuple(np.asarray(p) for p in jstate.pyramid)}
    # run_sequence donates the state it is given
    final, jtraj, jprobs = jeng.run_sequence(jcfg, jstate, m3_seq["jscans"], m3_seq["jodom"])
    state = convert.state_from_numpy(tree, "cpu")
    assert len(state.pyramid) == tcfg.matcher_cfg.levels + 1
    state, traj, probs = teng.run_sequence(tcfg, state, m3_seq["scans"], m3_seq["odom"])
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-4, rtol=0)
    bbox = 2 * int(-(-(usable_range + 0.15) // 0.1)) + 4
    assert (tm3.pyramid_refresh_size(bbox, 4, M3_MAP) < M3_MAP) == (usable_range < 5.0)
    rebuilt = tm3.build_pyramid(tscore.MapView.of(state.gm, tcfg.cell_model),
                                tcfg.matcher_cfg.levels, 0.5)
    for a, b in zip(state.pyramid, rebuilt):
        assert torch.equal(a, b)
    back = convert.state_to_numpy(state)
    assert [p.shape for p in back["pyramid"]] == [tuple(p.shape) for p in final.pyramid]
