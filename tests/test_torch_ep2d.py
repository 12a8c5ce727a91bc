"""Particles over ranks times map bands over ranks (``parallel/ep2d.py``)
on the ``("pgroups", "bands")`` mesh of four gloo ranks, 2 x 2 and 4 x 1:
three steps with the reference's draws against the port's unsharded
copy-on-write step, resampling on every step (ancestors equal, the rest 1e-5; the windows straddle
the band boundary) and against the reference's ``make_ep2d_step`` on the
same mesh of four CPU devices (3e-5)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_constructor_tpu.parallel import ep2d as jep2d
from test_torch_ranks import pool_fixture
from test_torch_sharded_rbpf import (REF_TOL, TOL, assert_steps, configs, cow_planes, initial,
                                     reference_run, sequence, unsharded_run)

torch.set_num_threads(1)
pool = pool_fixture()

#: resample on every step with unequal weights, so that the blocks move between ranks
RESAMPLE = 1.0


@functools.cache
def runs(shape):
    jcfg, tcfg = (dataclasses.replace(c, resample_threshold=RESAMPLE) for c in configs("odom", "cow"))
    m = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("pgroups", "bands"))
    # jitted: eager, each shard_map call traces and compiles anew
    planes = jax.jit(lambda g: jep2d.gather_planes(g, jcfg.cell_model, m))
    jst = initial(jep2d.init_ep2d_state(jcfg, *shape, key=jax.random.PRNGKey(0)))
    draws, ref = reference_run(
        jcfg, jep2d.make_ep2d_step(jcfg, m), jst,
        lambda s: {"planes": np.asarray(planes(s.gm))})
    local = unsharded_run(tcfg, draws, cow_planes)
    return tcfg, draws, ref, local


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_ep2d_step_matches_unsharded_and_reference(pool, shape):
    tcfg, draws, ref, local = runs(shape)
    scans, odom, gt = sequence()
    got = pool.run("ep2d", (shape, ("pgroups", "bands")), tcfg, gt[0], scans, odom, draws)
    for g in got:
        assert_steps(g, local, TOL, maps=("planes",))
        assert_steps(g, ref, REF_TOL, maps=("planes",))
        assert not any(bool(s["overflow"]) for s in g)
