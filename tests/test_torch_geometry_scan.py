"""Port parity: geometry, scans and synthetic data vs the JAX reference.

Elementwise f32 math on the same inputs; the tolerance (atol 1e-6) covers
the last-ulp differences of two libm's sin/cos/atan2. Bearings,
trajectories and worlds are built in numpy float64 and cast on both sides,
so they must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import geometry as jgeo
from slam_constructor_tpu.ops import scan as jscan
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import geometry as tgeo
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

ATOL = 1e-6


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([3.0, 3.0, 4.0])
    return p


@pytest.mark.parametrize("fn", ["compose", "between"])
def test_pose_pair_ops_match_reference(fn):
    a, b = _poses(0, 64), _poses(1, 64)
    want = np.asarray(getattr(jgeo, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tgeo, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("fn", ["wrap_angle", "inverse"])
def test_pose_unary_ops_match_reference(fn):
    a = _poses(2, 64)
    arg = a[:, 2] * 3.0 if fn == "wrap_angle" else a
    want = np.asarray(getattr(jgeo, fn)(jnp.asarray(arg)))
    got = getattr(tgeo, fn)(torch.from_numpy(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_apply_pose_broadcast_matches_reference():
    poses = _poses(3, 16)
    pts = np.random.default_rng(4).normal(size=(40, 2)).astype(np.float32) * 5
    want = np.asarray(jgeo.apply_pose(jnp.asarray(poses)[:, None, :], jnp.asarray(pts)[None]))
    got = tgeo.apply_pose(torch.from_numpy(poses)[:, None, :], torch.from_numpy(pts)[None]).numpy()
    assert got.shape == (16, 40, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _raw_ranges():
    rng = np.random.default_rng(5)
    r = rng.uniform(0.0, 20.0, 90).astype(np.float32)
    r[::11] = np.inf
    r[5] = np.nan
    r[7] = 0.01
    return r


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_make_scan_points_and_mask_match_reference(stride):
    r = _raw_ranges()
    b = np.array(jdata.default_bearings(90))
    js = jscan.make_scan(jnp.asarray(r), jnp.asarray(b))
    ts = tscan.make_scan(r, b)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.ranges.numpy(), np.asarray(js.ranges))
    np.testing.assert_allclose(
        tscan.scan_points(ts).numpy(), np.asarray(jscan.scan_points(js)), atol=ATOL
    )
    np.testing.assert_array_equal(
        tscan.subsample_mask(ts, stride).numpy(), np.asarray(jscan.subsample_mask(js, stride))
    )


@pytest.mark.parametrize("n,fov", [(120, 2 * np.pi), (360, 2 * np.pi), (181, np.pi)])
def test_default_bearings_bitwise(n, fov):
    np.testing.assert_array_equal(
        tdata.default_bearings(n, fov).numpy(), np.asarray(jdata.default_bearings(n, fov))
    )


@pytest.mark.parametrize("step", [0.25, 9.6 / 512 * 2])
def test_rectangle_trajectory_bitwise(step):
    np.testing.assert_array_equal(
        tdata.rectangle_trajectory(step=step).numpy(),
        np.asarray(jdata.rectangle_trajectory(step=step)),
    )


def test_corridor_trajectory_bitwise():
    np.testing.assert_array_equal(
        tdata.corridor_trajectory(30).numpy(), np.asarray(jdata.corridor_trajectory(30))
    )


@pytest.mark.parametrize("world", ["cecum", "box"])
def test_worlds_bitwise(world):
    if world == "cecum":
        t, j = tdata.cecum_world(), jdata.cecum_world()
    else:
        t, j = tdata.box_world(8.0, 0.1, obstacles=5, seed=3), jdata.box_world(8.0, 0.1, obstacles=5, seed=3)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    assert t[2] == j[2]
