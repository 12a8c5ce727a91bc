"""The copy-on-write particle maps over ranks, a pool a rank
(``parallel/ep_cow.py``), over 2 and 4 gloo ranks, both proposals: three
steps with the reference's draws against the port's unsharded
copy-on-write step, resampling on every step (ancestors equal, poses, log-weights and every
particle's value plane 1e-5) and against the reference's ``make_ep_step``
on a 2-device mesh (3e-5)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_constructor_tpu.parallel import ep_cow as jep
from test_torch_ranks import flat, pool_fixture
from test_torch_sharded_rbpf import (P, REF_TOL, TOL, assert_steps, configs, cow_planes,
                                     initial, reference_run, sequence, unsharded_run)

torch.set_num_threads(1)
pool = pool_fixture()

#: resample on every step with unequal weights, so that the blocks move between ranks
RESAMPLE = 1.0


@functools.cache
def runs(proposal):
    jcfg, tcfg = (dataclasses.replace(c, resample_threshold=RESAMPLE) for c in configs(proposal, "cow"))
    m = Mesh(np.asarray(jax.devices()[:2]), ("chips",))
    # jitted: eager, each shard_map call traces and compiles anew
    planes = jax.jit(lambda g: jep.gather_planes(g, jcfg.cell_model, m))
    jst = initial(jep.init_ep_state(jcfg, 2, key=jax.random.PRNGKey(0)))
    draws, ref = reference_run(
        jcfg, jep.make_ep_step(jcfg, m), jst,
        lambda s: {"planes": np.asarray(planes(s.gm))})
    local = unsharded_run(tcfg, draws, cow_planes)
    return tcfg, draws, ref, local


@pytest.mark.parametrize("proposal", ["odom", "improved"])
@pytest.mark.parametrize("d", [2, 4])
def test_ep_step_matches_unsharded_and_reference(pool, proposal, d):
    tcfg, draws, ref, local = runs(proposal)
    scans, odom, gt = sequence()
    got = pool.run("ep_cow", flat(d, "chips"), "chips", tcfg, gt[0], scans, odom, draws)
    for g in got:
        assert_steps(g, local, TOL, maps=("planes",))
        assert_steps(g, ref, REF_TOL, maps=("planes",))
        assert not any(s["overflow"].any() for s in g)
    assert any((s["idx"] != np.arange(P)).any() for s in local), "no step moved a map"
