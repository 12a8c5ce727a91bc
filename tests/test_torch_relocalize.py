"""Port parity: FFT-correlation global relocalization (kidnapped robot).

The map and the scans are the reference's own test's
(tests/test_relocalize.py: the cecum world mapped along the rectangle at
0.5 m steps into a 160^2 map at 0.1 m, 180 beams), made by the reference
and crossed to the port. Held:

- the three kidnapped poses of the reference's test: the port's pose
  within 0.12 m and 0.08 rad of the truth, the reference's thresholds;
- the FFT's pose (no refine) within one cell and one heading bin of the
  reference's (the two FFTs round differently, ~1e-4 of the largest
  score, so a near tie may fall to a neighbour);
- ``fft_correlate`` against the reference's ``_fft_correlate`` within
  1e-4 x its largest value, and against the direct sum;
- the FFT's score at its best translation against the obstacle reducer's
  score times the valid beams (the reference's docstring), the sensor at
  the cell's corner and unknown cells at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import relocalize as jrel
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu_torch.ops import relocalize as trel
from slam_constructor_tpu_torch.ops import scan as tscan
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

KIDNAPPED = [(3.0, -1.5, 2.1), (-5.0, 1.6, -0.7), (0.0, -1.5, 0.0)]

_cast = jax.jit(jray.cast_rays, static_argnums=2)
_insert = jax.jit(jray.insert_scan, static_argnums=(1, 4))


@pytest.fixture(scope="module")
def mapped_world():
    occ, origin, scale = jdata.cecum_world()
    bearings = jdata.default_bearings(180)
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, 0.1)
    traj = jdata.rectangle_trajectory(step=0.5)
    for i in range(traj.shape[0]):
        s = _cast(occ, origin, scale, traj[i], bearings)
        gm = _insert(gm, model, traj[i], s, jray.BeamConfig(wall_blur=True))
    jview = jscore.MapView.of(gm, model)
    tview = tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)), known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)), scale=float(jview.scale))
    return jview, tview, (occ, origin, scale, bearings)


def _scans(world, pose):
    occ, origin, scale, bearings = world
    js = _cast(occ, origin, scale, jnp.asarray(pose, jnp.float32), bearings)
    ts = tscan.LaserScan(torch.from_numpy(np.array(js.ranges)),
                         torch.from_numpy(np.array(js.bearings)),
                         torch.from_numpy(np.array(js.valid)))
    return js, ts


def _angle(d):
    return (d + np.pi) % (2 * np.pi) - np.pi


@pytest.mark.parametrize("pose", KIDNAPPED)
def test_kidnapped_recovery(mapped_world, pose):
    _, tview, world = mapped_world
    _, ts = _scans(world, pose)
    res = trel.relocalize(tview, ts, trel.RelocalizeConfig(n_theta=64))
    err = res.pose.numpy().astype(np.float64) - np.asarray(pose)
    err[2] = _angle(err[2])
    assert abs(err[0]) < 0.12 and abs(err[1]) < 0.12, err
    assert abs(err[2]) < 0.08, err
    assert res.trace.shape == (10,)


@pytest.mark.parametrize("pose", KIDNAPPED)
def test_fft_pose_matches_reference(mapped_world, pose):
    jview, tview, world = mapped_world
    js, ts = _scans(world, pose)
    cfg = dict(n_theta=64, refine_iterations=0)
    want = jrel.relocalize(jview, js, jrel.RelocalizeConfig(**cfg))
    got = trel.relocalize(tview, ts, trel.RelocalizeConfig(**cfg))
    d = got.pose.numpy().astype(np.float64) - np.asarray(want.pose)
    assert abs(d[0]) <= 0.1 + 1e-6 and abs(d[1]) <= 0.1 + 1e-6, d
    assert abs(_angle(d[2])) <= 2 * 3.14159265 / 64 + 1e-6, d
    np.testing.assert_allclose(float(got.prob), float(want.prob), rtol=1e-3)


def test_thetas_match_reference():
    cfg = trel.RelocalizeConfig(n_theta=64)
    want = np.asarray(jnp.linspace(-cfg.half_theta, cfg.half_theta, 64, endpoint=False))
    np.testing.assert_allclose(trel.thetas(cfg, "cpu").numpy(), want, atol=1e-6)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_fft_correlate_matches_reference(lead):
    rng = np.random.default_rng(0)
    v = rng.uniform(size=(48, 40)).astype(np.float32)
    h = (rng.uniform(size=(*lead, 48, 40)) < 0.05).astype(np.float32)
    want = np.asarray(jax.vmap(jrel._fft_correlate, (None, 0))(jnp.asarray(v),
                                                               jnp.asarray(h.reshape(-1, 48, 40))))
    got = trel.fft_correlate(torch.from_numpy(v), torch.from_numpy(h)).numpy()
    assert got.shape == (*lead, 96, 80)
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=1e-4 * np.abs(want).max())


def test_fft_correlation_matches_direct():
    """Every translation's FFT score against the direct endpoint sum."""
    rng = np.random.default_rng(1)
    v = rng.uniform(size=(24, 20)).astype(np.float32)
    h = np.zeros((24, 20), np.float32)
    for r, c in rng.integers(0, (24, 20), (12, 2)):
        h[r, c] += 1.0
    corr = trel.fft_correlate(torch.from_numpy(v), torch.from_numpy(h)).numpy()
    vp = np.zeros((3 * 24, 3 * 20), np.float64)
    vp[24:48, 20:40] = v
    for ty in range(-24, 24):
        for tx in range(-20, 20):
            want = float((h * vp[24 + ty:48 + ty, 20 + tx:40 + tx]).sum())
            assert abs(corr[24 + ty, 20 + tx] - want) <= 1e-4 * 12, (ty, tx)


def test_fft_score_is_the_obstacle_score_times_valid_beams(mapped_world):
    """The histogram holds the endpoints within half the map of the
    sensor; over those beams the FFT's score is the obstacle reducer's
    score (unknown cells at 0) times their count."""
    jview, tview, world = mapped_world
    _, ts = _scans(world, KIDNAPPED[0])
    cfg = trel.RelocalizeConfig(n_theta=64, refine_iterations=0)
    res = trel.relocalize(tview, ts, cfg)
    h, w = tview.occ.shape
    th = res.pose[2:3]
    inside = trel.endpoint_histograms(tview, ts, th)[0]
    pts = tscan.scan_points(ts)
    ex = torch.cos(th) * pts[:, 0] - torch.sin(th) * pts[:, 1]
    ey = torch.sin(th) * pts[:, 0] + torch.cos(th) * pts[:, 1]
    col = torch.floor(ex / tview.scale) + w // 2
    row = torch.floor(ey / tview.scale) + h // 2
    held = ((col >= 0) & (col < w) & (row >= 0) & (row < h)).to(torch.float32)
    assert float(inside.sum()) == float((held * ts.valid).sum())
    corner = res.pose - torch.tensor([0.05, 0.05, 0.0])  # the cell's corner
    obstacle = tscore.score_single(tview, ts, corner,
                                   tscore.ScoringConfig(reducer="obstacle", unknown_prob=0.0),
                                   point_weights=held)
    n_held = float((held * ts.valid).sum())
    fft_score = float(res.prob) * float(ts.valid.sum())
    # a beam whose endpoint lies within an ulp of a cell's edge may count
    # the neighbouring cell on one side: less than one beam's value
    assert abs(fft_score - float(obstacle) * n_held) < 1.0, (fft_score, float(obstacle) * n_held)


def test_relocalize_is_one_batched_fft_and_never_reads_the_host(mapped_world, monkeypatch):
    """All headings go through one rfft2 of the histograms (and one of the
    map); nothing is read on the host before the pose (no ``.item()``)."""
    _, tview, world = mapped_world
    _, ts = _scans(world, KIDNAPPED[2])
    calls = []
    rfft2 = torch.fft.rfft2

    def counting(x, *a, **kw):
        calls.append(tuple(x.shape))
        return rfft2(x, *a, **kw)

    monkeypatch.setattr(torch.fft, "rfft2", counting)
    monkeypatch.setattr(torch.Tensor, "item", lambda self: pytest.fail("host read"))
    res = trel.relocalize(tview, ts, trel.RelocalizeConfig(n_theta=16, refine_iterations=2))
    assert calls == [(320, 320), (16, 320, 320)]
    assert res.pose.shape == (3,)
