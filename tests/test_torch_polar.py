"""Port parity: the dense polar free-space fill and the inserts built on it.

``kernels.polar_free_plane_ref`` (the plain twin of the CUDA kernel, and
what the wrapper runs for CPU tensors) against the reference's
``raycast._polar_free_plane`` and, through the Pallas kernel in interpret
mode, ``raycast._polar_free_plane_pallas``. Against the jitted XLA lowering
the twin is bit for bit: it computes glibc's ``atan2f``, ``sinf``, ``cosf``
and ``atanf`` (``ops/libm.py``), fuses the cell centres and ``dx*dx +
dy*dy`` as XLA's CPU code does, and multiplies by the reciprocal of the
constant ``r - 1`` as XLA does. The Pallas kernel orders its own arithmetic
(its fusions differ from the XLA lowering's), so against it the tests count
the flipped cells, at most 0.05% of the plane, and hold the other weights
within 1e-5 relative.
"""

import functools

import jax
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
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)

MAX_FLIPPED = 0.0  # share of the plane, against the XLA lowering: bit for bit
RTOL = 0.0
PALLAS_MAX_FLIPPED = 5e-4  # against the Pallas kernel's own arithmetic
PALLAS_RTOL = 1e-5


def _tscan(s):
    return tscan.LaserScan(
        torch.from_numpy(np.array(s.ranges)), torch.from_numpy(np.array(s.bearings)),
        torch.from_numpy(np.array(s.valid)),
    )


@functools.cache
def _scene(case):
    """(h, w, pose, reference scan) of a named case."""
    if case == "half_fov":
        # a half field of view: no free evidence behind the robot
        occ, origin, scale = jdata.box_world(8.0, 0.1, obstacles=0, seed=0)
        bearings = jdata.default_bearings(181, fov=jnp.pi)
        pose, h, w = [0.0, 0.0, 0.0], 120, 120
        every = None
    else:
        occ, origin, scale = jdata.cecum_world()
        n_beams, where = case
        bearings = jdata.default_bearings(n_beams)
        pose = {"mid": [0.3, -1.45, 0.7], "edge": [6.1, -1.7, -2.4]}[where]
        h, w = 96, 128
        every = 7
    s = jray.cast_rays(occ, origin, scale, jnp.asarray(pose, jnp.float32), bearings)
    if every:
        s = s.replace(valid=s.valid & (jnp.arange(s.ranges.shape[0]) % every != 3))
    return h, w, pose, s


def _compare(got, want):
    """(share of cells whose free decision differs, largest relative weight
    difference where both are free)."""
    flipped = (got > 0) != (want > 0)
    both = (got > 0) & (want > 0)
    rel = np.abs(got[both] - want[both]) / want[both]
    return flipped.mean(), (rel.max() if rel.size else 0.0)


CASES = [(360, "mid"), (120, "mid"), (90, "mid"), (360, "edge"), "half_fov"]


@pytest.mark.parametrize("lowering", ["xla", "pallas"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_polar_free_plane_ref_matches_reference(case, lowering):
    h, w, pose, s = _scene(case)
    cfg = jray.BeamConfig(wall_blur=True, free_impl="polar")
    jgm = jgrid.make_grid_map(jcells.BayesAvgCell(), h, w, 0.1)
    jfn = jray._polar_free_plane if lowering == "xla" else jray._polar_free_plane_pallas
    # jitted as the engine runs it (and one compile, not one per op)
    jfn = jax.jit(jfn, static_argnums=(0, 1, 3, 6))
    want = np.asarray(jfn(h, w, jgm.origin, 0.1, jnp.asarray(pose, jnp.float32), s, cfg))
    t = _tscan(s)
    got = kernels.polar_free_plane_ref(
        t.ranges, t.valid, t.bearings, torch.tensor(pose), torch.from_numpy(np.array(jgm.origin)),
        h, w, 0.1, cfg.hole_width / 2.0, cfg.max_range,
    ).numpy()
    assert got.shape == (h, w) and got.dtype == np.float32
    flipped, rel = _compare(got, want)
    max_flipped, rtol = (MAX_FLIPPED, RTOL) if lowering == "xla" else (PALLAS_MAX_FLIPPED,
                                                                        PALLAS_RTOL)
    assert flipped <= max_flipped, f"{flipped * h * w:.0f} of {h * w} cells flipped"
    assert rel <= rtol
    if lowering == "xla":
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got > 0).sum() > 300  # the scan really opened free space
    if case == "half_fov":
        # cells well behind the robot (x < -0.5 m => col < 55) stay empty
        assert (got[:, :55] > 0).sum() == 0 and (got[:, 65:] > 0).sum() > 100


def test_polar_free_plane_without_a_valid_beam_is_empty():
    h, w, pose, s = _scene((120, "mid"))
    t = _tscan(s)
    got = kernels.polar_free_plane_ref(
        t.ranges, torch.zeros_like(t.valid), t.bearings, torch.tensor(pose),
        torch.tensor([-6.4, -4.8]), h, w, 0.1, 0.15, 15.0,
    )
    assert got.shape == (h, w) and not bool(got.any())


def test_wrapper_runs_the_twin_for_cpu_tensors_and_counts_nothing():
    h, w, pose, s = _scene((90, "mid"))
    t = _tscan(s)
    args = (t.ranges, t.valid, t.bearings, torch.tensor(pose), torch.tensor([-6.4, -4.8]),
            h, w, 0.1, 0.15, 15.0)
    before = kernels.launch_counts()["polar_free_plane"]
    assert torch.equal(kernels.polar_free_plane(*args), kernels.polar_free_plane_ref(*args))
    assert kernels.launch_counts()["polar_free_plane"] == before


@functools.cache
def _cecum_scan():
    occ, origin, scale = jdata.cecum_world()
    pose = [0.3, -1.45, 0.7]
    s = jray.cast_rays(occ, origin, scale, jnp.asarray(pose), jdata.default_bearings(128))
    return pose, s, scale


@pytest.mark.parametrize(
    "free_impl,estimator,blur",
    [("polar", "const", True), ("polar", "area", False), ("dda", "area", True)],
)
def test_scan_observation_planes_polar_and_area_match_reference(free_impl, estimator, blur):
    """The whole rasterisation with the polar fill and with the area
    estimator. Free cells may flip as above; the area estimator's weights
    are products of f32 overlaps (1e-5 absolute); a cell that either holds
    is counted as differing, at most 0.1% of the plane."""
    pose, s, scale = _cecum_scan()
    jgm = jgrid.make_grid_map(jcells.BayesAvgCell(), 160, 160, scale)
    wj, sj = jray.scan_observation_planes(
        jgm, jnp.asarray(pose), s,
        jray.BeamConfig(wall_blur=blur, free_impl=free_impl, occupancy_estimator=estimator),
    )
    tgm = tgrid.make_grid_map(tcells.BayesAvgCell(), 160, 160, scale)
    wt, st = tray.scan_observation_planes(
        tgm, torch.tensor(pose), _tscan(s),
        tray.BeamConfig(wall_blur=blur, free_impl=free_impl, occupancy_estimator=estimator),
    )
    wj, sj, wt, st = np.asarray(wj), np.asarray(sj), wt.numpy(), st.numpy()
    bad = (np.abs(wj - wt) > 1e-5 * np.maximum(1.0, np.abs(wj))) | (np.abs(sj - st) > 1e-5)
    assert bad.mean() <= 1e-3, f"{bad.sum()} cells differ"
    assert wt.sum() > 1000 and st.sum() > 30  # the scan really landed
    if estimator == "area":
        # fractional endpoint evidence spread over up to 9 cells a beam
        assert ((st > 0) & (st < 0.99)).sum() > 100


def test_insert_scan_polar_with_tbm_cells_matches_reference():
    pose, s, scale = _cecum_scan()
    jm, tm = jcells.TBMCell(quality=0.5), tcells.TBMCell(quality=0.5)
    j = jray.insert_scan(
        jgrid.make_grid_map(jm, 160, 160, scale), jm, jnp.asarray(pose), s,
        jray.BeamConfig(wall_blur=True, free_impl="polar"),
    )
    t = tray.insert_scan(
        tgrid.make_grid_map(tm, 160, 160, scale), tm, torch.tensor(pose), _tscan(s),
        tray.BeamConfig(wall_blur=True, free_impl="polar"),
    )
    close = np.all(np.abs(t.cells.numpy() - np.asarray(j.cells)) <= 1e-5, axis=-1)
    assert (~close).mean() <= 1e-3, f"{(~close).sum()} cells differ"
    assert t.cells.shape == (160, 160, 5)
