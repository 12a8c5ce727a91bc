"""The fixed-order reductions and the weight normalisation over ranks
(``utils/determinism.py``, ``parallel/particles.py``) against the
reference's on a 2- and 4-device mesh of ``conftest``'s CPU devices; the
port's ranks are gloo processes (``test_torch_ranks.RankPool``).

The ladder is a fold in rank order on both sides: the same bits. The
normalised weights and Neff hold the tolerance of the reference's own
sharded tests (1e-5, ``tests/test_parallel.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from slam_constructor_tpu.ops import resample as jres
from slam_constructor_tpu.parallel import particles as jpart
from slam_constructor_tpu.utils import determinism as jdet
from test_torch_ranks import flat, pool_fixture

pool = pool_fixture()


def jmesh(d, axis="particles"):
    return Mesh(np.asarray(jax.devices()[:d]), (axis,))


@functools.cache
def _ladder(d):
    def f(x):
        return jdet.ladder_psum(x[0], "particles")[None], jdet.ladder_pmax(x[0], "particles")[None]

    return jax.jit(shard_map(f, mesh=jmesh(d), in_specs=PS("particles"),
                             out_specs=(PS("particles"), PS("particles"))))


@pytest.mark.parametrize("d", [2, 4])
def test_ladder_is_the_reference_bit_for_bit(pool, d):
    x = (np.random.default_rng(d).normal(size=(d, 5)) * 10.0 ** np.arange(5)).astype(np.float32)
    x[1, 2] = np.nan
    want_sum, want_max = (np.asarray(a)[0] for a in _ladder(d)(jnp.asarray(x)))
    for got in pool.run("ladder", flat(d), "particles", x):
        np.testing.assert_array_equal(got["sum"], want_sum)
        np.testing.assert_array_equal(got["max"], want_max)
        seq = x[0]
        for i in range(1, d):
            seq = seq + x[i]
        np.testing.assert_array_equal(got["sum"], seq)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("deterministic", [False, True])
def test_normalized_weights_and_neff(pool, d, deterministic):
    logw = (np.random.default_rng(10 + d).normal(size=32) * 3.0).astype(np.float32)
    want = np.asarray(jpart.psum_normalize_log_weights(jnp.asarray(logw), jmesh(d),
                                                       deterministic=deterministic))
    local = np.asarray(jres.normalize_log_weights(jnp.asarray(logw)))
    neff = float(jpart.sharded_neff(jnp.asarray(logw), jmesh(d)))
    for got in pool.run("normalize", flat(d), "particles", logw, deterministic):
        np.testing.assert_allclose(got["logw"], want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["logw"], local, atol=1e-5, rtol=0)
        assert float(got["neff"]) == pytest.approx(neff, rel=1e-5)


def test_deterministic_weights_repeat_bit_for_bit(pool):
    """The ladder's normalisation gives the same bits on every rank and on
    every run."""
    logw = (np.random.default_rng(3).normal(size=16) * 5.0).astype(np.float32)
    a = pool.run("normalize", flat(4), "particles", logw, True)
    b = pool.run("normalize", flat(4), "particles", logw, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["logw"], a[0]["logw"])
        np.testing.assert_array_equal(y["logw"], x["logw"])
