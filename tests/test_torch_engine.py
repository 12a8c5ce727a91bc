"""Port parity of the slice as a whole: the tinySLAM engine over a sequence.

The sequence comes from the port's own datagen (numpy-seeded odometry
noise) and is handed to both engines as arrays. The reference's matcher
noise chain (``key, sub = split(state.key)`` per step, ``split(sub,
rounds)`` per round, ``normal(keys[r], (batch, 3))``) is rebuilt here and
injected into the port. Each step's pose agrees within 1e-4 and the map
cells within 1e-4 on at least 99.9% of cells: per-step differences are
f32 ulps (sin/cos, sum order) that the map feeds back into later steps.
The map is 160^2 at 0.1 m, which holds the whole world, so the
reference's off-map wrap (see test_torch_raycast.py) does not arise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.models import tiny as jtiny
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu.utils import evaluate as jeval
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata
from slam_constructor_tpu_torch.utils import evaluate as teval

torch.set_num_threads(1)

N_SCANS, N_BEAMS, MAP, BATCH, ROUNDS = 8, 96, 160, 16, 4


def reference_noise_chain(key, n_steps, rounds, batch):
    """The matcher normals of ``n_steps`` reference steps from ``key``;
    returns them f32[n_steps, rounds, batch, 3] and the key after."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, rounds)
        out.append(np.stack([np.asarray(jax.random.normal(k, (batch, 3))) for k in keys]))
    return np.stack(out), key


@pytest.fixture(scope="module")
def run():
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.1)[:N_SCANS]
    scans, odom, gt = tdata.synth_sequence(
        occ, origin, scale, poses, tdata.default_bearings(N_BEAMS), rng=7,
        odom_noise_xy=0.02, odom_noise_theta=0.01,
    )
    jscans = JScan(
        ranges=jnp.asarray(scans.ranges.numpy()), bearings=jnp.asarray(scans.bearings.numpy()),
        valid=jnp.asarray(scans.valid.numpy()),
    )
    jcfg = jtiny.tiny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS)
    jcfg = dataclasses.replace(jcfg, beam=dataclasses.replace(jcfg.beam, free_impl="dda"))
    tcfg = ttiny.tiny_config(map_size=MAP, mc_batch=BATCH, mc_rounds=ROUNDS)
    jstate0 = jeng.init_state(jcfg).replace(pose=jnp.asarray(gt[0].numpy()))
    jodom = jnp.asarray(odom.numpy())
    jfinal, jtraj, jprobs = jeng.run_sequence(jcfg, jstate0, jscans, jodom)
    noise, _ = reference_noise_chain(jax.random.PRNGKey(0), N_SCANS, ROUNDS, BATCH)
    return dict(
        scans=scans, odom=odom, gt=gt, jscans=jscans, jodom=jodom, jcfg=jcfg, tcfg=tcfg,
        jfinal=jfinal, jtraj=np.asarray(jtraj), jprobs=np.asarray(jprobs), noise=noise,
    )


def _cells_close(a, b, tol=1e-4):
    return np.all(np.abs(a - b) <= tol, axis=-1)


def test_engine_run_matches_reference_sequence(run):
    e = teng.Engine(run["tcfg"], device="cpu")
    e.state.pose = run["gt"][0].clone()
    traj, probs = e.run(run["scans"], run["odom"], noise=torch.from_numpy(run["noise"]))
    assert traj.shape == (N_SCANS, 3) and probs.shape == (N_SCANS,)
    np.testing.assert_allclose(traj.numpy(), run["jtraj"], atol=1e-4)
    np.testing.assert_allclose(probs.numpy(), run["jprobs"], atol=1e-4)
    close = _cells_close(e.state.gm.cells.numpy(), np.asarray(run["jfinal"].gm.cells))
    assert close.mean() >= 0.999, f"{(~close).sum()} cells differ"
    assert int(e.state.step) == N_SCANS
    # the same bound as tests/test_engine.py's tracking check
    assert float(teval.ate(traj, run["gt"], align=False)) < 0.15


def test_handle_scan_equals_run(run):
    """Online stepping equals the offline run on the same noise."""
    noise = torch.from_numpy(run["noise"])
    a = teng.Engine(run["tcfg"])
    a.state.pose = run["gt"][0].clone()
    traj, _ = a.run(run["scans"][:3], run["odom"][:3], noise=noise[:3])
    b = teng.Engine(run["tcfg"])
    b.state.pose = run["gt"][0].clone()
    for i in range(3):
        b.handle_scan(run["scans"][i], run["odom"][i], noise=noise[i])
    assert torch.equal(torch.stack(b.trajectory), traj)
    assert torch.equal(a.state.gm.cells, b.state.gm.cells)


def test_run_stream_equals_run(run):
    """Streaming mode draws the same generator noise in the same order."""
    a = teng.Engine(run["tcfg"], seed=3)
    a.state.pose = run["gt"][0].clone()
    traj, _ = a.run(run["scans"][:3], run["odom"][:3])
    b = teng.Engine(run["tcfg"], seed=3)
    b.state.pose = run["gt"][0].clone()
    b.run_stream((run["scans"][i], run["odom"][i]) for i in range(3))
    assert torch.equal(b.pose, traj[-1])
    assert torch.equal(b.occupancy, a.occupancy)
    assert b.occupancy.shape == (MAP, MAP)


def test_convert_round_trip_continues_reference_run(run):
    """Reference runs 4 steps; its state crosses to the port, which runs the
    other 4; the result equals the reference's 8-step run."""
    jcfg, half = run["jcfg"], N_SCANS // 2
    jstate = jeng.init_state(jcfg).replace(pose=jnp.asarray(run["gt"][0].numpy()))
    jhalf, _, _ = jeng.run_sequence(
        jcfg, jstate, jax.tree.map(lambda a: a[:half], run["jscans"]), run["jodom"][:half]
    )
    tree = {
        "cells": np.asarray(jhalf.gm.cells), "origin": np.asarray(jhalf.gm.origin),
        "scale": jhalf.gm.scale, "pose": np.asarray(jhalf.pose), "step": int(jhalf.step),
        "last_prob": float(jhalf.last_prob),
    }
    state = convert.state_from_numpy(tree, "cpu")
    back = convert.state_to_numpy(state)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v)
    noise, _ = reference_noise_chain(jhalf.key, half, ROUNDS, BATCH)
    state, traj, _ = teng.run_sequence(
        run["tcfg"], state, run["scans"][half:], run["odom"][half:], noise=torch.from_numpy(noise)
    )
    np.testing.assert_allclose(traj.numpy(), run["jtraj"][half:], atol=1e-4)
    close = _cells_close(state.gm.cells.numpy(), np.asarray(run["jfinal"].gm.cells))
    assert close.mean() >= 0.999
    assert int(state.step) == N_SCANS


@pytest.mark.parametrize("align", [False, True])
def test_ate_and_rpe_match_reference(align):
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(size=(50, 3)) * [0.1, 0.1, 0.05], 0).astype(np.float32)
    est = (gt + rng.normal(size=gt.shape) * [0.03, 0.03, 0.01]).astype(np.float32)
    # a rotated, shifted estimate: alignment has something to undo
    c, s = np.cos(0.3), np.sin(0.3)
    est[:, :2] = est[:, :2] @ np.array([[c, -s], [s, c]], np.float32).T + [0.5, -0.2]
    te, tg = torch.from_numpy(est), torch.from_numpy(gt)
    je, jg = jnp.asarray(est), jnp.asarray(gt)
    np.testing.assert_allclose(
        float(teval.ate(te, tg, align=align)), float(jeval.ate(je, jg, align=align)), rtol=1e-5
    )
    for delta in (1, 5):
        for a, b in zip(teval.rpe(te, tg, delta), jeval.rpe(je, jg, delta)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
