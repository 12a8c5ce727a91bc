"""Port parity: overlap scoring (the module that holds kernel K1).

The port's ``score_poses`` (on the CPU: the kernel's plain twin
``overlap_score_ref``) against the reference's Pallas kernel in interpret
mode (``impl='pallas'``, as tests/test_scoring_impls.py runs it) and
against its gather path. Tolerance atol 2e-6, the bound the reference
holds its Pallas path to: per-point probabilities agree to a few f32 ulps
(sin/cos of the pose, the order of the tap sums), and a score is a mean
over beams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

ATOL = 2e-6


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = jdata.box_world(8.0, 0.1, obstacles=5, seed=3)
    bearings = jdata.default_bearings(120)
    tp = jnp.array([0.3, -0.2, 0.15])
    s = jray.cast_rays(occ, origin, scale, tp, bearings)
    # a few invalid beams, so the weighted mean skips them
    s = s.replace(valid=s.valid & (jnp.arange(120) % 9 != 4))
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 96, 96, 0.1)  # holds the 8 m world
    gm = jray.insert_scan(gm, model, tp, s, jray.BeamConfig(wall_blur=True, free_impl="dda"))
    jview = jscore.MapView.of(gm, model)
    # candidates spread wide so many endpoints fall off the map (coverage)
    rng = np.random.default_rng(0)
    cand = (np.asarray(tp)[None] + rng.normal(size=(24, 3)) * [1.5, 1.5, 0.4]).astype(np.float32)
    pw = rng.uniform(0.2, 1.0, 120).astype(np.float32)
    tview = tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)),
        known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)),
        scale=jview.scale,
    )
    tscan_ = tscan.LaserScan(
        torch.from_numpy(np.array(s.ranges)), torch.from_numpy(np.array(s.bearings)),
        torch.from_numpy(np.array(s.valid)),
    )
    return jview, s, tview, tscan_, cand, pw


CASES = [
    # (n candidates, stride, point weights)
    (24, 1, False),
    (24, 2, False),
    (24, 1, True),
    (24, 2, True),
    (1, 1, False),
]


@pytest.mark.parametrize("impl", ["pallas", "gather"])
@pytest.mark.parametrize("k,stride,weighted", CASES)
def test_score_poses_matches_reference(setup, impl, k, stride, weighted):
    jview, js, tview, ts, cand, pw = setup
    cand = cand[:k]
    jpw = jnp.asarray(pw) if weighted else None
    tpw = torch.from_numpy(pw) if weighted else None
    want = jscore.score_poses(
        jview, js, jnp.asarray(cand),
        jscore.ScoringConfig(reducer="overlap", window=1, stride=stride, impl=impl), jpw,
    )
    got = tscore.score_poses(
        tview, ts, torch.from_numpy(cand),
        tscore.ScoringConfig(reducer="overlap", window=1, stride=stride), tpw,
    )
    assert got.shape == (k,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_score_single_matches_reference(setup):
    jview, js, tview, ts, cand, _ = setup
    cfg = dict(reducer="overlap", window=1)
    want = jscore.score_single(jview, js, jnp.asarray(cand[3]), jscore.ScoringConfig(**cfg))
    got = tscore.score_single(tview, ts, torch.from_numpy(cand[3]), tscore.ScoringConfig(**cfg))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=ATOL)


def test_overlap_score_ref_matches_pallas_points(setup):
    """Per-point check of the plain twin against the reference kernel's
    per-point output. With origin 0, scale 1 and a single sensor point
    (0, 0) at weight 1, candidate k's score is the sample at (x_k, y_k)."""
    from slam_constructor_tpu.ops import pallas_kernels

    jview, _, _, _, _, _ = setup
    unknown = 0.5
    v = jnp.where(jview.known, jview.occ, unknown)
    # fractional cell coords over and around the 96x96 map
    rel = np.random.default_rng(1).uniform(-3.0, 99.0, (2000, 2)).astype(np.float32)
    want = np.asarray(
        pallas_kernels.sample_plane_bilinear(v, jnp.asarray(rel), unknown, interpret=True)
    )
    per_point = kernels.overlap_score_ref(
        torch.from_numpy(np.array(v)),
        torch.cat([torch.from_numpy(rel), torch.zeros(len(rel), 1)], -1),
        torch.zeros(1, 2), torch.ones(1), torch.zeros(2), 1.0, unknown,
    )
    np.testing.assert_allclose(per_point.numpy(), want, atol=ATOL)


def test_cpu_tensors_take_the_plain_twin(setup):
    _, _, tview, ts, cand, _ = setup
    prep = tscore.prepare(tview, ts, tscore.ScoringConfig(reducer="overlap"))
    before = kernels.launch_counts()["overlap_score"]
    got = kernels.overlap_score(
        prep.plane, torch.from_numpy(cand), prep.pts, prep.beam_w, prep.origin,
        prep.scale, prep.unknown,
    )
    want = kernels.overlap_score_ref(
        prep.plane, torch.from_numpy(cand), prep.pts, prep.beam_w, prep.origin,
        prep.scale, prep.unknown,
    )
    assert kernels.launch_counts()["overlap_score"] == before  # no kernel on the CPU
    assert torch.equal(got, want)
