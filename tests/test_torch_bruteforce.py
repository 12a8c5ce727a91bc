"""Port parity: the map-batched score, the brute-force matcher, the
information estimate and the match window.

The same numpy inputs go through the JAX function (on the CPU, where
``score_poses`` takes its gather path) and its counterpart in the port (the
plain twin of the CUDA kernel). Tolerances:

- batched twin against ``scoring.score_poses`` map by map: atol 2e-6, the
  bound the reference holds its own Pallas path to (the two sum a beam's
  four taps and a scan's beams in different orders);
- ``brute_force_match``: the same grid within 1e-7 (the reference's own
  ``linspace`` differs by an ulp between its eager and its jitted lowering,
  which contracts ``start * (1 - t) + stop * t`` into a fused multiply-add)
  and the same winning index, pose within 1e-6, prob within 2e-6;
- ``estimate_information``: a second difference of scores that agree to
  ~1e-7, divided by eps^2 = 4e-4 and scaled by the beam count: rtol 2e-2
  away from the clip bounds, which are hit exactly;
- ``window_view``: bitwise, corner included;
- ``pose_distance``: atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import geometry as jgeom
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import geometry as tgeom
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import kernels as tkern
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscore
from slam_constructor_tpu_torch.ops.scan import LaserScan as TScan
from slam_constructor_tpu_torch.utils import datagen as tdata

torch.set_num_threads(1)

ATOL = 2e-6
N_MAPS, N_BEAMS, SIZE = 3, 96, 64
BF = dict(half_x=0.4, half_y=0.4, half_theta=0.2, n_x=5, n_y=5, n_theta=5)


@pytest.fixture(scope="module")
def scene():
    """Three 64^2 submaps of the cecum world at different places, each with
    its own scan and prior: numpy arrays for both sides."""
    occ, origin, scale = tdata.cecum_world()
    poses = tdata.rectangle_trajectory(step=0.5)[[2, 9, 30, 3, 10, 31]]
    scans, _, gt = tdata.synth_sequence(occ, origin, scale, poses, tdata.default_bearings(N_BEAMS))
    model = tcells.BayesAvgCell()
    beam = tray.BeamConfig(wall_blur=True)
    occs, knowns, origins = [], [], []
    for m in range(N_MAPS):
        o = gt[m, :2] - SIZE * 0.1 / 2.0
        gm = tgrid.GridMap(cells=tgrid.make_grid_map(model, SIZE, SIZE, 0.1).cells, origin=o,
                           scale=0.1)
        gm = tray.insert_scan(gm, model, gt[m], scans[m], beam)
        view = tscore.MapView.of(gm, model)
        occs.append(view.occ.numpy()), knowns.append(view.known.numpy()), origins.append(o.numpy())
    rng = np.random.default_rng(3)
    # the scans matched against map m come from a pose 0.5 m further on
    priors = gt[N_MAPS:].numpy() + rng.normal(size=(N_MAPS, 3)).astype(np.float32) * [0.1, 0.1, 0.05]
    valid = scans.valid[N_MAPS:].numpy() & (rng.uniform(size=(N_MAPS, N_BEAMS)) > 0.1)
    valid[2, :] &= np.arange(N_BEAMS) % 3 != 0
    return dict(
        occ=np.stack(occs), known=np.stack(knowns), origin=np.stack(origins),
        ranges=scans.ranges[N_MAPS:].numpy(), bearings=scans.bearings[N_MAPS:].numpy(),
        valid=valid, priors=priors.astype(np.float32),
    )


def jview(s, m):
    return jscore.MapView(occ=jnp.asarray(s["occ"][m]), known=jnp.asarray(s["known"][m]),
                          origin=jnp.asarray(s["origin"][m]), scale=0.1)


def jscan(s, m):
    return JScan(ranges=jnp.asarray(s["ranges"][m]), bearings=jnp.asarray(s["bearings"][m]),
                 valid=jnp.asarray(s["valid"][m]))


def tview(s, m=slice(None)):
    return tscore.MapView(occ=torch.from_numpy(s["occ"][m]), known=torch.from_numpy(s["known"][m]),
                          origin=torch.from_numpy(s["origin"][m]), scale=0.1)


def tscan(s, m=slice(None)):
    return TScan(torch.from_numpy(s["ranges"][m]), torch.from_numpy(s["bearings"][m]),
                 torch.from_numpy(s["valid"][m]))


@pytest.mark.parametrize("stride", [1, 2])
def test_batched_score_matches_reference_map_by_map(scene, stride):
    rng = np.random.default_rng(stride)
    poses = (scene["priors"][:, None, :]
             + rng.normal(size=(N_MAPS, 40, 3)) * [0.3, 0.3, 0.2]).astype(np.float32)
    poses[:, :4, 0] += 5.0  # some candidates mostly off the submap
    jcfg = jscore.ScoringConfig(reducer="overlap", stride=stride)
    tcfg = tscore.ScoringConfig(reducer="overlap", stride=stride)
    got = tscore.score_poses(tview(scene), tscan(scene), torch.from_numpy(poses), tcfg)
    assert got.shape == (N_MAPS, 40)
    for m in range(N_MAPS):
        want = np.asarray(jscore.score_poses(jview(scene, m), jscan(scene, m),
                                             jnp.asarray(poses[m]), jcfg))
        np.testing.assert_allclose(got[m].numpy(), want, atol=ATOL, rtol=0)
        # a slot of the batch is the single-map score, bit for bit
        one = tscore.score_poses(tview(scene, m), tscan(scene, m), torch.from_numpy(poses[m]), tcfg)
        assert torch.equal(one, got[m])


def test_batched_twin_no_valid_beam_and_shapes(scene):
    v = torch.from_numpy(np.where(scene["known"], scene["occ"], 0.5).astype(np.float32))
    pts = torch.zeros((N_MAPS, 7, 2))
    poses = torch.from_numpy(scene["priors"])[:, None, :].contiguous()
    bw = torch.ones((N_MAPS, 7))
    bw[1] = 0.0  # map 1 has no valid beam: its score is 0 / 1e-9 = 0
    got = tkern.overlap_score_batched(v, poses, pts, bw, torch.from_numpy(scene["origin"]), 0.1, 0.5)
    assert got.shape == (N_MAPS, 1) and float(got[1, 0]) == 0.0 and bool(torch.isfinite(got).all())
    with pytest.raises(ValueError):
        tkern.overlap_score_batched(v[0], poses[0], pts[0], bw[0], torch.zeros(2), 0.1, 0.5)


def test_brute_force_grid_matches_reference():
    for kw in (BF, dict(half_x=0.6, half_y=0.6, half_theta=0.3, n_x=7, n_y=7, n_theta=7), {}):
        j = jmatch.BruteForceConfig(**kw)
        dx = jnp.linspace(-j.half_x, j.half_x, j.n_x)
        dy = jnp.linspace(-j.half_y, j.half_y, j.n_y)
        dth = jnp.linspace(-j.half_theta, j.half_theta, j.n_theta)
        want = np.asarray(jnp.stack(jnp.meshgrid(dx, dy, dth, indexing="ij"), -1).reshape(-1, 3))
        got = tmatch.brute_force_offsets(tmatch.BruteForceConfig(**kw), "cpu").numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
        # x slowest, theta fastest; the ends are exact
        ends = np.asarray([j.half_x, j.half_y, j.half_theta], np.float32)
        np.testing.assert_array_equal(got[0], -ends)
        np.testing.assert_array_equal(got[-1], ends)
        assert got[1][2] > got[0][2] and got[1][0] == got[0][0]


@pytest.mark.parametrize("stride", [1, 2])
def test_brute_force_match_matches_reference(scene, stride):
    jcfg = jmatch.BruteForceConfig(**BF, scoring=jscore.ScoringConfig(reducer="overlap", stride=stride))
    tcfg = tmatch.BruteForceConfig(**BF, scoring=tscore.ScoringConfig(reducer="overlap", stride=stride))
    offsets = tmatch.brute_force_offsets(tcfg, "cpu")
    batched = tmatch.MATCHERS["brute_force"][1](
        tview(scene), tscan(scene), torch.from_numpy(scene["priors"]), None, tcfg)
    assert batched.pose.shape == (N_MAPS, 3) and batched.prob.shape == (N_MAPS,)
    for m in range(N_MAPS):
        prior = scene["priors"][m]
        want = jmatch.brute_force_match(jview(scene, m), jscan(scene, m), jnp.asarray(prior), None, jcfg)
        got = tmatch.brute_force_match(tview(scene, m), tscan(scene, m), torch.from_numpy(prior),
                                       None, tcfg)
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(got.prob), float(want.prob), atol=ATOL, rtol=0)

        def index_of(pose):  # the grid index a winning pose stands for
            d = torch.tensor(np.array(pose)) - torch.from_numpy(prior)
            return int((offsets - d).abs().sum(-1).argmin())

        assert index_of(got.pose) == index_of(want.pose)
        assert torch.equal(batched.pose[m], got.pose) and torch.equal(batched.prob[m], got.prob)
    assert float((batched.pose - torch.from_numpy(scene["priors"])).abs().max()) > 0.05


def test_brute_force_ties_go_to_the_first_index():
    """A map with nothing known scores every candidate the same."""
    view = tscore.MapView(occ=torch.full((16, 16), 0.5), known=torch.zeros((16, 16), dtype=torch.bool),
                          origin=torch.tensor([-0.8, -0.8]), scale=0.1)
    scan = TScan(torch.ones(8), torch.linspace(-1, 1, 8), torch.ones(8, dtype=torch.bool))
    cfg = tmatch.BruteForceConfig(**BF, scoring=tscore.ScoringConfig(reducer="overlap"))
    prior = torch.tensor([0.1, 0.0, 0.2])
    res = tmatch.brute_force_match(view, scan, prior, None, cfg)
    want = prior + tmatch.brute_force_offsets(cfg, "cpu")[0]
    torch.testing.assert_close(res.pose, want, atol=1e-7, rtol=0)


def test_estimate_information_matches_reference(scene):
    jcfg = jscore.ScoringConfig(reducer="overlap", stride=2)
    tcfg = tscore.ScoringConfig(reducer="overlap", stride=2)
    priors = scene["priors"].copy()
    priors[1] += [4.0, 0.0, 0.0]  # off the submap: flat score, floor of the clip
    batched = tscore.estimate_information(tview(scene), tscan(scene), torch.from_numpy(priors), tcfg)
    assert batched.shape == (N_MAPS, 3)
    for m in range(N_MAPS):
        want = np.asarray(jscore.estimate_information(
            jview(scene, m), jscan(scene, m), jnp.asarray(priors[m]), jcfg))
        got = tscore.estimate_information(tview(scene, m), tscan(scene, m),
                                          torch.from_numpy(priors[m]), tcfg)
        assert torch.equal(got, batched[m])
        clipped = (want == 1.0) | (want == 1e5)
        np.testing.assert_array_equal(got.numpy()[clipped], want[clipped])
        np.testing.assert_allclose(got.numpy()[~clipped], want[~clipped], rtol=2e-2)
    assert float(batched.max()) > 10.0  # not everything sits on the floor


@pytest.mark.parametrize("center,size", [
    ((0.3, -0.4), 32), ((-3.1, 2.9), 32), ((3.15, 3.15), 48), ((0.0, 0.0), 64), ((0.0, 0.0), 100),
    ((0.049999, -0.1), 20),
])
def test_window_view_matches_reference_bitwise(scene, center, size):
    c = np.asarray(center, np.float32) + scene["origin"][0] + 3.2
    want = jscore.window_view(jview(scene, 0), jnp.asarray(c), size)
    got = tscore.window_view(tview(scene, 0), torch.from_numpy(c), size)
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    np.testing.assert_array_equal(got.known.numpy(), np.asarray(want.known))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert got.scale == want.scale
    if size >= SIZE:
        assert torch.equal(got.occ, tview(scene, 0).occ)


def test_pose_distance_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(50, 3)).astype(np.float32) * [2, 2, 3]
    b = rng.normal(size=(50, 3)).astype(np.float32) * [2, 2, 3]
    for wgt in (1.0, 0.3):
        want = np.asarray(jgeom.pose_distance(jnp.asarray(a), jnp.asarray(b), wgt))
        got = tgeom.pose_distance(torch.from_numpy(a), torch.from_numpy(b), wgt).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
