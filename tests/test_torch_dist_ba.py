"""The pose-graph solve over ranks (``parallel/dist_ba.py``): over 2 and 4
gloo ranks, direct and by Schur elimination, against the reference's
``dist_ba.distributed_optimize`` on a 2- and 4-device mesh (1e-5) and
against the port's unsharded ``posegraph.optimize``; the graph is the
reference's drifting circle with one loop edge (``tests/test_posegraph.py``),
crossed by ``convert``."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_constructor_tpu.parallel import dist_ba as jdist
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.utils import convert
from test_posegraph import CFG, _circle_graph
from test_torch_posegraph import from_jax
from test_torch_ranks import flat, pool_fixture

torch.set_num_threads(1)
pool = pool_fixture()

TCFG = tpg.PoseGraphConfig(max_keyframes=CFG.max_keyframes, max_edges=CFG.max_edges,
                           gn_iterations=CFG.gn_iterations)


@functools.cache
def graph(seed):
    jst, _ = _circle_graph(n=12, drift=0.06, seed=seed)
    return jst, convert.graph_from_numpy(from_jax(jst), "cpu")


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("schur", [None, 8])
def test_distributed_optimize_matches_the_reference(pool, d, schur):
    jst, tst = graph(5)
    m = Mesh(np.asarray(jax.devices()[:d]), ("hosts",))
    want = np.asarray(jax.jit(lambda st: jdist.distributed_optimize(CFG, st, m, "hosts", schur)
                              )(jst).kf_poses)
    local = tpg.optimize(TCFG, tst).kf_poses.numpy()
    for got in pool.run("dist_ba", flat(d, "hosts"), "hosts", TCFG, tst, schur):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, local, atol=1e-5, rtol=0)


def test_schur_matches_direct(pool):
    _, tst = graph(6)
    direct = pool.run("dist_ba", flat(4, "hosts"), "hosts", TCFG, tst, None)[0]
    schur = pool.run("dist_ba", flat(4, "hosts"), "hosts", TCFG, tst, 8)[0]
    np.testing.assert_allclose(schur, direct, atol=1e-5, rtol=0)
