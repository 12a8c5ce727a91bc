"""Port parity: ray casting and scan insertion (DDA + const + wall blur).

``cast_rays``: ``valid`` must be equal and ranges within 1e-6 (ranges are
multiples of the march step; only a last-ulp ``floor`` flip at a cell edge
could move one by a step).

``scan_observation_planes``: on a map that holds every sample, w and s
within 1e-5 on all but at most 0.1% of cells. The allowance is for a
last-ulp ``floor`` knife edge: a sample that lies on a cell edge to within
one f32 ulp may land in the neighbouring cell when one side contracts
``start + t * dir`` into a fused multiply-add and the other does not.

The reference's scatter wraps the index -1 it gives to off-map samples to
the last cell (H-1, W-1) instead of dropping it; the port drops them. One
test pins that difference on a map too small for the world; once the
reference is fixed it becomes an equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)

POSES = [[0.3, -1.45, 0.7], [-4.0, 1.5, 2.0], [2.1, -1.6, 0.0]]


@pytest.fixture(scope="module")
def cecum():
    return jdata.cecum_world()


def _tscan(s):
    return tscan.LaserScan(
        torch.from_numpy(np.array(s.ranges)), torch.from_numpy(np.array(s.bearings)),
        torch.from_numpy(np.array(s.valid)),
    )


def _planes(cecum, pose, n_beams, size, blur=True):
    occ, origin, scale = cecum
    s = jray.cast_rays(occ, origin, scale, jnp.asarray(pose), jdata.default_bearings(n_beams))
    jgm = jgrid.make_grid_map(jcells.BayesAvgCell(), size, size, scale)
    wj, sj = jray.scan_observation_planes(
        jgm, jnp.asarray(pose), s, jray.BeamConfig(wall_blur=blur, free_impl="dda")
    )
    tgm = tgrid.make_grid_map(tcells.BayesAvgCell(), size, size, scale)
    wt, st = tray.scan_observation_planes(
        tgm, torch.tensor(pose), _tscan(s), tray.BeamConfig(wall_blur=blur)
    )
    return s, np.asarray(wj), np.asarray(sj), wt.numpy(), st.numpy()


@pytest.mark.parametrize("pose", POSES)
def test_cast_rays_matches_reference(cecum, pose):
    occ, origin, scale = cecum
    b = np.array(jdata.default_bearings(128))
    j = jray.cast_rays(occ, origin, scale, jnp.asarray(pose), jnp.asarray(b))
    t = tray.cast_rays(
        torch.from_numpy(np.array(occ)), torch.from_numpy(np.array(origin)), scale,
        torch.tensor(pose), torch.from_numpy(b),
    )
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.ranges.numpy(), np.asarray(j.ranges), atol=1e-6)


def _close_cells(a, b, tol=1e-5):
    return np.abs(a - b) <= tol


@pytest.mark.parametrize("blur", [True, False])
@pytest.mark.parametrize("pose", POSES)
def test_scan_observation_planes_match_reference(cecum, pose, blur):
    # 160^2 at 0.1 m holds the whole 14.4 x 5.2 m world, blur tails included
    _, wj, sj, wt, st = _planes(cecum, pose, 128, 160, blur)
    bad = ~(_close_cells(wj, wt) & _close_cells(sj, st))
    assert bad.mean() <= 1e-3, f"{bad.sum()} cells differ"
    assert wt.sum() > 1000 and st.sum() > 50  # the scan really landed


@pytest.mark.parametrize("model", ["bayes_avg", "bayes_base"])
def test_insert_scan_matches_reference(cecum, model):
    occ, origin, scale = cecum
    pose = POSES[0]
    jm = jcells.BayesAvgCell() if model == "bayes_avg" else jcells.BayesBaseCell(quality=0.5)
    tm = tcells.BayesAvgCell() if model == "bayes_avg" else tcells.BayesBaseCell(quality=0.5)
    s = jray.cast_rays(occ, origin, scale, jnp.asarray(pose), jdata.default_bearings(128))
    j = jray.insert_scan(
        jgrid.make_grid_map(jm, 160, 160, scale), jm, jnp.asarray(pose), s,
        jray.BeamConfig(wall_blur=True, free_impl="dda"),
    )
    t = tray.insert_scan(
        tgrid.make_grid_map(tm, 160, 160, scale), tm, torch.tensor(pose), _tscan(s),
        tray.BeamConfig(wall_blur=True),
    )
    close = np.all(np.abs(t.cells.numpy() - np.asarray(j.cells)) <= 1e-5, axis=-1)
    assert (~close).mean() <= 1e-3


def test_off_map_samples_dropped_where_reference_wraps(cecum):
    """The cecum world from (0, -1.5, 0) in a 64^2 map: many free, endpoint
    and blur samples fall off the map. The reference adds them all into
    cell (63, 63); the port drops them. Every other cell agrees."""
    _, wj, sj, wt, st = _planes(cecum, [0.0, -1.5, 0.0], 120, 64, True)
    assert wj[63, 63] > 100 and sj[63, 63] > 10  # the wrapped mass
    assert wt[63, 63] == 0.0 and st[63, 63] == 0.0  # dropped
    # its neighbours see nothing in either: the mass is not real evidence
    assert wj[62, 62] == wj[62, 63] == wj[63, 62] == 0.0
    rest = np.ones((64, 64), bool)
    rest[63, 63] = False
    np.testing.assert_allclose(wt[rest], wj[rest], atol=1e-5)
    np.testing.assert_allclose(st[rest], sj[rest], atol=1e-5)
