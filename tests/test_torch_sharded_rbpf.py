"""The RBPF with its particles over ranks (``parallel/particles.py``) and
the ``distributed`` preset, over gloo ranks, against the port's unsharded
step and the reference's sharded one.

8 particles, 96^2 maps at 0.2 m, 60 beams, 3 scans of the cecum world;
every step's draws are the reference's, rebuilt from its key chain and
injected on both sides (the port draws the whole step on every rank and
takes its slice). Ancestors are equal; poses, log-weights and maps agree
to 1e-5 with the port's unsharded step (the sharded log-sum-exp adds in
another order: ROADMAP trap k) and to the tolerance of the port's
whole-run RBPF tests (3e-5) with the reference's ``make_sharded_step``.
The helpers here serve ``test_torch_ep_cow.py`` and ``test_torch_ep2d.py``.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_constructor_tpu.models import gmapping as jgm
from slam_constructor_tpu.parallel import particles as jpart
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.parallel import ep_cow
from slam_constructor_tpu_torch.utils import datagen
from test_torch_cow import jscan, reference_draws
from test_torch_ranks import flat, pool_fixture

torch.set_num_threads(1)
pool = pool_fixture()

P, MAP, SCALE, BEAMS, STEPS = 8, 96, 0.2, 60, 3
FAST = dict(n_particles=P, map_size=MAP, map_scale=SCALE, usable_range=2.5)
COW = dict(map_storage="cow", tile_block=16, window_tiles=4, tile_capacity=256)
TOL, REF_TOL = 1e-5, 3e-5


def configs(proposal="odom", storage="dense"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the improved proposal's warning, on both sides
        j, t = jgm.fast_config(proposal=proposal, **FAST), tgm.fast_config(proposal=proposal, **FAST)
    extra = dict(COW) if storage == "cow" else {}
    if proposal == "improved":
        extra["min_match_prob"] = 0.7
    return dataclasses.replace(j, **extra), dataclasses.replace(t, **extra)


@functools.cache
def sequence():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.12)[:STEPS]
    return datagen.synth_sequence(occ, origin, scale, poses, datagen.default_bearings(BEAMS),
                                  rng=3, odom_noise_xy=0.02, odom_noise_theta=0.01)


def draws_of(key, jcfg) -> tgm.Draws:
    return tgm.Draws(**{k: None if v is None else torch.from_numpy(np.array(v, np.float32))
                        for k, v in reference_draws(key, jcfg).items()})


def reference_run(jcfg, jstep, jst, outputs):
    """The reference's steps from ``jst``: (the draws of each step, the
    outputs of each step: ancestors, poses, log-weights and ``outputs``)."""
    scans, odom, gt = sequence()
    draws, out = [], []
    for i in range(STEPS):
        draws.append(draws_of(jst.key, jcfg))
        jst, anc = jstep(jst, jscan(scans, i), jnp.asarray(odom[i].numpy()))
        out.append({"idx": np.asarray(anc), "poses": np.asarray(jst.poses),
                    "logw": np.asarray(jst.log_weights), **outputs(jst)})
    return draws, out


def unsharded_run(tcfg, draws, outputs):
    """The port's unsharded steps with ``draws``."""
    scans, odom, gt = sequence()
    st = tgm.init_state(tcfg, "cpu")
    st.poses = gt[0].expand(P, 3).clone()
    out = []
    for i in range(STEPS):
        st, idx = tgm.gmapping_step(tcfg, st, scans[i], odom[i], draws[i])
        out.append({"idx": idx.numpy(), "poses": st.poses.numpy(),
                    "logw": st.log_weights.numpy(), **outputs(st)})
    return out


def pose_diff(a, b):
    d = a.astype(np.float64) - b
    d[..., 2] = np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2]))
    return np.abs(d).max()


def assert_steps(got, want, tol, maps=()):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["idx"], w["idx"], err_msg=f"step {i}")
        assert pose_diff(g["poses"], w["poses"]) <= tol, (i, pose_diff(g["poses"], w["poses"]))
        np.testing.assert_allclose(g["logw"], w["logw"], atol=tol, rtol=0, err_msg=f"step {i}")
        for k in maps:
            np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=0, err_msg=f"{k}, step {i}")


def cow_planes(st):
    return {"planes": ep_cow.particle_planes(st.gm, tgm.GMappingConfig().cell_model).numpy()}


def initial(jst):
    _, _, gt = sequence()
    return jst.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (P, 3)))


@functools.cache
def dense_runs():
    jcfg, tcfg = configs()
    m = Mesh(np.asarray(jax.devices()[:2]), ("particles",))
    jst = jpart.shard_state(initial(jgm.init_state(jcfg, jax.random.PRNGKey(0))), m)
    draws, ref = reference_run(jcfg, jpart.make_sharded_step(jcfg, m), jst,
                               lambda s: {"cells": np.asarray(s.gm.cells)})
    local = unsharded_run(tcfg, draws, lambda s: {"cells": s.gm.cells.numpy()})
    return tcfg, draws, ref, local


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_step_matches_unsharded_and_reference(pool, d):
    tcfg, draws, ref, local = dense_runs()
    scans, odom, gt = sequence()
    got = pool.run("particles", flat(d), "particles", tcfg, gt[0], scans, odom, draws)
    for g in got:
        assert_steps(g, local, TOL, maps=("cells",))
        assert_steps(g, ref, REF_TOL)
    wrapped = np.zeros((MAP, MAP), bool)
    wrapped[-1, -1] = True  # the reference wraps dropped samples into its last cell (trap n)
    for g, w in zip(got[0], ref):
        np.testing.assert_allclose(g["cells"][:, ~wrapped], w["cells"][:, ~wrapped], atol=REF_TOL,
                                   rtol=0)


def test_sharded_run_matches_run_sequence(pool):
    """``make_sharded_run`` over 4 ranks: the best particle's poses, Neff,
    every particle's poses and the ancestors of ``gmapping.run_sequence``
    with the same draws."""
    tcfg, draws, _, _ = dense_runs()
    scans, odom, gt = sequence()
    stacked = tgm.Draws(**{f.name: None if getattr(draws[0], f.name) is None else
                           torch.stack([getattr(d, f.name) for d in draws])
                           for f in dataclasses.fields(tgm.Draws)})
    st = tgm.init_state(tcfg, "cpu")
    st.poses = gt[0].expand(P, 3).clone()
    _, traj, neffs, all_poses, ancestors = tgm.run_sequence(tcfg, st, scans[:STEPS],
                                                            odom[:STEPS], stacked)
    for got in pool.run("sharded_run", flat(4), "particles", tcfg, gt[0], scans[:STEPS],
                        odom[:STEPS], stacked):
        np.testing.assert_array_equal(got["ancestors"], ancestors.numpy())
        assert pose_diff(got["traj"], traj.numpy()) <= TOL
        assert pose_diff(got["all_poses"], all_poses.numpy()) <= TOL
        np.testing.assert_allclose(got["neffs"], neffs.numpy(), rtol=TOL, atol=0)


def test_sharded_step_refuses_cow_maps():
    from slam_constructor_tpu_torch.parallel import particles

    _, tcfg = configs(storage="cow")
    with pytest.raises(ValueError, match="ep_cow"):
        particles.make_sharded_step(tcfg, mesh=None)


def test_distributed_preset_runs_over_four_ranks(pool):
    """``config.preset("distributed")`` on the flat mesh of the whole group:
    every rank holds 2 of 8 particles and draws from its own generator,
    seeded alike; the ranks agree with each other and with the unsharded
    step drawing from the same seed."""
    scans, odom, gt = sequence()
    kw = dict(n_particles=P, map_height=MAP, map_width=MAP, map_scale=SCALE)
    got = pool.run("preset", ((4,), ("particles",)), gt[0], scans, odom, kw)
    cfg = tgm.GMappingConfig(**kw)
    st = tgm.init_state(cfg, "cpu")
    st.poses = gt[0].expand(P, 3).clone()
    g = torch.Generator().manual_seed(7)
    for i in range(STEPS):
        st, idx = tgm.gmapping_step(cfg, st, scans[i], odom[i], generator=g)
        for rank in got:
            np.testing.assert_array_equal(rank[i]["idx"], idx.numpy())
            assert pose_diff(rank[i]["poses"], st.poses.numpy()) <= TOL
            np.testing.assert_allclose(rank[i]["logw"], st.log_weights.numpy(), atol=TOL, rtol=0)
