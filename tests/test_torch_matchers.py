"""Port parity: the Monte-Carlo matcher with the reference's noise injected.

The reference draws ``jax.random.normal(keys[r], (batch, 3))`` per round
with ``keys = jax.random.split(key, rounds)``; the test draws the same
numbers and hands them to the port. Scores agree to 2e-6 (see
test_torch_scoring.py), so every round keeps the same candidate: the pose
agrees within 1e-5 (a few ulps of sin/cos/atan2 in the candidate draw),
prob and the per-round trace within 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

BATCH, ROUNDS = 16, 4


def reference_noise(key, rounds, batch):
    """The standard normals the reference matcher draws from ``key``."""
    keys = jax.random.split(key, rounds)
    return np.stack([np.asarray(jax.random.normal(k, (batch, 3))) for k in keys])


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(128)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, scale)
    cfg = jray.BeamConfig(wall_blur=True, free_impl="dda")
    # a map from two scans along the lower corridor
    for p in ([-1.0, -1.5, 0.0], [0.0, -1.6, 0.1]):
        s = jray.cast_rays(occ, origin, scale, jnp.asarray(p), bearings)
        gm = jray.insert_scan(gm, model, jnp.asarray(p), s, cfg)
    true = jnp.asarray([0.5, -1.55, 0.05])
    s = jray.cast_rays(occ, origin, scale, true, bearings)
    jview = jscore.MapView.of(gm, model)
    tview = tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)), known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)), scale=jview.scale,
    )
    ts = tscan.LaserScan(
        torch.from_numpy(np.array(s.ranges)), torch.from_numpy(np.array(s.bearings)),
        torch.from_numpy(np.array(s.valid)),
    )
    return jview, s, tview, ts, np.asarray(true)


@pytest.mark.parametrize("seed,offset", [(0, [0.12, -0.06, 0.04]), (1, [-0.1, 0.05, -0.05]),
                                         (2, [0.0, 0.0, 0.0])])
def test_monte_carlo_match_matches_reference(setup, seed, offset):
    jview, js, tview, ts, true = setup
    init = (true + np.asarray(offset, np.float32)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    sc = dict(reducer="overlap", window=1)
    jcfg = jmatch.MonteCarloConfig(sigma_xy=0.08, sigma_theta=0.05, batch=BATCH, rounds=ROUNDS,
                                   scoring=jscore.ScoringConfig(**sc))
    tcfg = tmatch.MonteCarloConfig(sigma_xy=0.08, sigma_theta=0.05, batch=BATCH, rounds=ROUNDS,
                                   scoring=tscore.ScoringConfig(**sc))
    want = jmatch.monte_carlo_match(jview, js, jnp.asarray(init), key, jcfg)
    got = tmatch.monte_carlo_match(
        tview, ts, torch.from_numpy(init), None, tcfg,
        noise=torch.from_numpy(reference_noise(key, ROUNDS, BATCH)),
    )
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.prob), float(want.prob), atol=2e-6)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), atol=2e-6)
    assert float(got.prob) >= float(tscore.score_single(tview, ts, torch.from_numpy(init),
                                                         tcfg.scoring))


def test_generator_draws_are_reproducible(setup):
    _, _, tview, ts, true = setup
    cfg = tmatch.MonteCarloConfig(batch=BATCH, rounds=ROUNDS,
                                  scoring=tscore.ScoringConfig(reducer="overlap"))
    init = torch.from_numpy((true + 0.05).astype(np.float32))
    res = [
        tmatch.monte_carlo_match(tview, ts, init, torch.Generator().manual_seed(3), cfg)
        for _ in range(2)
    ]
    assert torch.equal(res[0].pose, res[1].pose) and res[0].trace.shape == (ROUNDS,)
