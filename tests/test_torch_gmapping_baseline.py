"""Port parity of the RBPF at ``GMappingConfig()``'s defaults, the BASELINE
``gmapping`` preset (``utils.config.preset('gmapping')``): whole maps, no
match or insert window, the obstacle reducer on every beam, 16 x 6
Monte-Carlo rounds at sigma 0.08 / 0.04, the DDA free fill to 15 m.

Cut to size: 4 particles, 64^2 maps at 0.3 m (the cecum world fits), 120
beams, 5 steps. Each step runs from the reference's state (jitted),
crossed through ``convert``, with the reference's draws injected.

Tolerances: poses 1e-5, log-weights 1e-5, ancestors exact; map cells 1e-5
but for the last cell, where the reference wraps samples that leave the
map (trap g). The reference runs jitted, so it finds a beam's cell by
multiplying by ``1 / scale`` where the port divides (trap m): a particle
whose match scored a pose with an endpoint that the two forms put in
different cells may part from the reference; such particles are counted,
and any pose difference must lie on one of them.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import gmapping as jgm
from slam_constructor_tpu.ops.geometry import apply_pose as japply_pose
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu.ops.scan import scan_points as jscan_points
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.ops import kernels as tkernels
from slam_constructor_tpu_torch.utils import config as tconfig
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

P, MAP, SCALE, N_BEAMS, N_STEPS = 4, 64, 0.3, 120, 5
TOL = 1e-5
SMALL = dict(n_particles=P, map_height=MAP, map_width=MAP, map_scale=SCALE)


def reference_draws(key, cfg):
    """The reference step's random numbers from its key (``split(key,
    4)``: proposal normals, a match key a particle, the resampling offset)
    as the port's Draws, and the key after the step."""
    key, k_noise, k_match, k_res = jax.random.split(key, 4)
    mc = cfg.matcher_cfg
    keys = jax.random.split(k_match, cfg.n_particles)
    match = jax.vmap(lambda k: jax.vmap(lambda kr: jax.random.normal(kr, (mc.batch, 3)))(
        jax.random.split(k, mc.rounds)))(keys)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return tgm.Draws(proposal=t(jax.random.normal(k_noise, (cfg.n_particles, 3))),
                     u0=t(jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / cfg.n_particles)),
                     match=t(match)), key


def state_tree(st):
    return {"cells": np.asarray(st.gm.cells), "origin": np.asarray(st.gm.origin),
            "scale": st.gm.scale, "poses": np.asarray(st.poses),
            "log_weights": np.asarray(st.log_weights), "step": int(st.step)}


def pose_diff(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[..., 2] = np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2]))
    return np.abs(d).max(-1)


def flipped_particles(js, origin, scale, scored):
    """bool[P]: whether any pose that particle p's match scored (``scored``:
    f32[P, K, 3] arrays, a call each) holds an endpoint whose cell the
    reference's jitted form (a product with 1 / scale) puts elsewhere than
    the division."""
    pts = jscan_points(js)

    def cells(poses):
        world = japply_pose(poses[..., None, :], pts)
        return jnp.floor((world - origin) / scale).astype(jnp.int32)

    out = np.zeros(P, bool)
    for poses in scored:
        p = jnp.asarray(poses)
        out |= np.asarray((cells(p) != jax.jit(cells)(p)).any(-1).any(-1).any(-1))
    return out


@pytest.fixture(scope="module")
def seq():
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.12)[:N_STEPS + 1]
    return tdata.synth_sequence(occ, origin, scale, poses, tdata.default_bearings(N_BEAMS), rng=3,
                                odom_noise_xy=0.02, odom_noise_theta=0.01)


def test_preset_is_the_default_config():
    """``preset('gmapping')`` builds ``GMappingEngine()``: the reference's
    defaults, scored with the obstacle reducer on whole maps."""
    e = tconfig.preset("gmapping")(device="cpu", n_particles=2, map_height=32, map_width=32)
    assert e.cfg == dataclasses.replace(tgm.GMappingConfig(), n_particles=2, map_height=32,
                                        map_width=32)
    cfg = tgm.GMappingConfig()
    assert cfg.matcher_cfg.scoring.reducer == "obstacle" and cfg.match_window == 0
    assert cfg.beam.free_impl == "dda" and cfg.beam.max_range == 15.0


def test_default_step_matches_reference(seq, monkeypatch):
    scans, odom, gt = seq
    jcfg = jgm.GMappingConfig(**SMALL)
    tcfg = tgm.GMappingConfig(**SMALL)
    step = jax.jit(partial(jgm.gmapping_step, jcfg))
    st = jgm.init_state(jcfg, jax.random.PRNGKey(1))
    st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (P, 3)))
    scored = []
    score_ref = tkernels.overlap_score_ref

    def recording(v, poses, *rest):
        scored.append(poses.numpy().copy())
        return score_ref(v, poses, *rest)

    monkeypatch.setattr(tkernels, "overlap_score_ref", recording)
    moved = 0
    for i in range(N_STEPS):
        d, _ = reference_draws(st.key, jcfg)
        before = convert.gmapping_state_from_numpy(state_tree(st), "cpu")
        js = JScan(ranges=jnp.asarray(scans.ranges[i].numpy()),
                   bearings=jnp.asarray(scans.bearings[i].numpy()),
                   valid=jnp.asarray(scans.valid[i].numpy()))
        st, idx = step(st, js, jnp.asarray(odom[i].numpy()))
        scored.clear()
        got, got_idx = tgm.gmapping_step(tcfg, before, scans[i], odom[i], d)
        flipped = flipped_particles(js, np.asarray(before.gm.origin[0]), SCALE,
                                    [s.reshape(P, -1, 3) for s in scored])
        moved += int(flipped.sum())
        if not np.array_equal(got_idx.numpy(), np.asarray(idx)):
            assert flipped.any(), i  # only a flipped particle's weight moves the resampling
            continue
        parted = pose_diff(got.poses.numpy(), np.asarray(st.poses)) > TOL
        assert not (parted & ~flipped[np.asarray(idx)]).any(), (i, parted, flipped)
        if flipped.any():
            continue
        np.testing.assert_allclose(got.log_weights.numpy(), np.asarray(st.log_weights), atol=TOL,
                                   rtol=0)
        cells = np.abs(got.gm.cells.numpy() - np.asarray(st.gm.cells))
        cells[:, -1, -1] = 0.0  # the reference wraps off-map samples there (trap g)
        assert cells.max() <= TOL
    # flips are rare: a few of P x 97 poses x 120 beams a step at most
    assert moved <= 2, moved


def test_engine_runs_at_the_defaults_on_the_cpu(seq):
    """``GMappingEngine()`` at its defaults (cut to 4 particles and 64^2
    maps) runs a sequence, drawing from its own key, to finite poses."""
    scans, odom, gt = seq
    e = tgm.GMappingEngine(device="cpu", seed=0, **SMALL)
    e.state.poses = gt[0].expand(P, 3).clone()
    traj, neffs = e.run(scans, odom)
    assert traj.shape == (len(gt), 3) and bool(torch.isfinite(traj).all())
    assert e.winner_trajectory().shape == (len(gt), 3)
