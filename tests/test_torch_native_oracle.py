"""Cross-validation of the port against its own copy of the C++ oracle.

The port's obstacle-reducer score (on the CPU: the kernels' plain twin) and
its SE(2) composition against an independent scalar re-derivation
(``slam_constructor_tpu_torch/native/score_oracle.cpp``, built by
``utils.native_oracle``), as tests/test_native_oracle.py holds the
reference. The oracle adds ``range * cos`` in another order than the
scan's endpoints are formed, so a score agrees within 2e-4 (a cell flip of
one beam in a hundred would part them by ~5e-3).
"""

import numpy as np
import pytest
import torch

from slam_constructor_tpu_torch.ops import cells, geometry, grid, raycast, scoring
from slam_constructor_tpu_torch.utils import datagen, native_oracle

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native_oracle.lib() is None, reason="no C++ toolchain")


@pytest.fixture(scope="module")
def setup():
    occ, origin, scale = datagen.box_world(8.0, 0.1, obstacles=5, seed=12)
    bearings = datagen.default_bearings(90)
    tp = torch.tensor([0.4, -0.2, 0.7])
    s = raycast.cast_rays(occ, origin, scale, tp, bearings)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 96, 96, 0.1, device="cpu")
    gm = raycast.insert_scan(gm, model, tp, s, raycast.BeamConfig(wall_blur=True))
    return scoring.MapView.of(gm, model), s, tp


@pytest.mark.parametrize("stride", [1, 3])
def test_score_matches_cpp_oracle(setup, stride):
    view, s, tp = setup
    rng = np.random.default_rng(0)
    cand = (tp.numpy()[None] + rng.normal(size=(12, 3)) * [1.0, 1.0, 0.5]).astype(np.float32)
    cfg = scoring.ScoringConfig(reducer="obstacle", stride=stride, unknown_prob=0.4)
    got = scoring.score_poses(view, s, torch.from_numpy(cand), cfg).numpy()
    for k in range(len(cand)):
        cpp = native_oracle.score_obstacle(view, s, cand[k], unknown_prob=0.4, stride=stride)
        assert got[k] == pytest.approx(cpp, abs=2e-4), (k, stride)


def test_compose_matches_cpp_oracle():
    rng = np.random.default_rng(3)
    for _ in range(20):
        a = rng.uniform(-3, 3, 3).astype(np.float32)
        b = rng.uniform(-3, 3, 3).astype(np.float32)
        want = geometry.compose(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        got = native_oracle.compose(a, b)
        np.testing.assert_allclose(got[:2], want[:2], atol=1e-5)
        assert abs(float(geometry.wrap_angle(torch.tensor(got[2] - want[2])))) < 1e-5


def test_oracle_builds_under_the_checkout():
    """The library lies under the checkout's ``build/``, not beside the
    reference's source."""
    path = native_oracle.library_path()
    assert path.exists() and path.parent.parent.name == "build"
    assert "slam_constructor_tpu/" not in str(path)
