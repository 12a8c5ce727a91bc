"""The overlap score's order yardsticks on the CPU.

``kernels.overlap_score_ordered`` and ``overlap_score_partial_ordered`` sum
each beam's probability (from a launch that scores the beam alone) in the
order of the kernels' group of 128 threads: group lane v adds beams v,
v + 128, ... from +0.0, then the tree s[t] + s[t + 64], + s[t + 32], then
strides 16 down to 1. On the card they are the bits every layout of
``csrc/overlap_score.cu`` must give (``tests/test_torch_kernels_cuda.py``).
Here ``_group_order_sum`` is held bit for bit to that order written out in
numpy, and the yardsticks (over the plain twins) to the reference's
``score_poses`` (its gather path and its Pallas kernel in interpret mode)
within 2e-6, the bound the reference holds its Pallas path to, and to the
partial twin within 2e-6 of the sums' size.
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
    s = s.replace(valid=s.valid & (jnp.arange(120) % 9 != 4))
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 96, 96, 0.1)
    gm = jray.insert_scan(gm, model, tp, s, jray.BeamConfig(wall_blur=True, free_impl="dda"))
    jview = jscore.MapView.of(gm, model)
    rng = np.random.default_rng(1)
    cand = (np.asarray(tp)[None] + rng.normal(size=(24, 3)) * [1.5, 1.5, 0.4]).astype(np.float32)
    pw = rng.uniform(0.2, 1.0, 120).astype(np.float32)
    tview = tscore.MapView(
        occ=torch.from_numpy(np.array(jview.occ)),
        known=torch.from_numpy(np.array(jview.known)),
        origin=torch.from_numpy(np.array(jview.origin)),
        scale=jview.scale,
    )
    ts = tscan.LaserScan(
        torch.from_numpy(np.array(s.ranges)), torch.from_numpy(np.array(s.bearings)),
        torch.from_numpy(np.array(s.valid)),
    )
    return jview, s, tview, ts, cand, pw


def group_order_numpy(x: np.ndarray) -> np.float32:
    """The 128-thread group's sum of x f32[R], written out."""
    lanes = np.zeros(128, np.float32)
    for i, t in enumerate(x.astype(np.float32)):
        lanes[i % 128] = np.float32(lanes[i % 128] + t)
    for half in (64, 32, 16, 8, 4, 2, 1):
        lanes = (lanes[:half] + lanes[half:2 * half]).astype(np.float32)
    return lanes[0]


@pytest.mark.parametrize("r", [0, 1, 100, 128, 360, 1000])
def test_group_order_sum_is_the_groups_order(r):
    g = torch.Generator().manual_seed(r)
    terms = torch.rand((3, r), generator=g) * torch.tensor([1.0, 100.0, 1e-3])[:, None]
    got = kernels._group_order_sum(terms)
    assert got.shape == (3,)
    for row in range(3):
        want = group_order_numpy(terms[row].numpy())
        assert np.float32(got[row]).view(np.uint32) == want.view(np.uint32)


#: (the reference's path, reducer, window, poses): its Pallas kernel is the
#: bilinear overlap reducer's; the others take its gather path
CASES = [("pallas", "overlap", 1, 24), ("pallas", "overlap", 1, 1), ("gather", "overlap", 1, 24),
         ("gather", "overlap", 1, 1), ("gather", "obstacle", 0, 24), ("gather", "max", 1, 24)]


@pytest.mark.parametrize("impl,reducer,window,k", CASES)
def test_overlap_score_ordered_matches_reference(setup, impl, reducer, window, k):
    jview, js, tview, ts, cand, pw = setup
    cfg = dict(reducer=reducer, window=window, stride=1)
    want = jscore.score_poses(jview, js, jnp.asarray(cand[:k]),
                              jscore.ScoringConfig(**cfg, impl=impl), jnp.asarray(pw))
    prep = tscore.prepare(tview, ts, tscore.ScoringConfig(**cfg), torch.from_numpy(pw))
    got = kernels.overlap_score_ordered(prep.plane, torch.from_numpy(cand[:k]), prep.pts,
                                        prep.beam_w, prep.origin, prep.scale, prep.unknown,
                                        prep.reducer)
    assert got.shape == (k,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_overlap_score_ordered_batched_is_its_single_maps(setup):
    """M maps in one call: each slot the bits of its map scored alone."""
    _, _, tview, ts, cand, pw = setup
    prep = tscore.prepare(tview, ts, tscore.ScoringConfig(reducer="overlap", window=1),
                          torch.from_numpy(pw))
    m = 3
    planes = torch.stack([prep.plane.roll(2 * i, 0) for i in range(m)])
    poses = torch.from_numpy(cand[:8])[None].repeat(m, 1, 1) + 0.05 * torch.arange(m)[:, None, None]
    weights = torch.stack([prep.beam_w * (torch.arange(120) % (3 + i) != 0) for i in range(m)])
    args = (planes, poses, prep.pts[None].expand(m, -1, -1).contiguous(), weights,
            prep.origin[None].expand(m, -1).contiguous(), prep.scale, prep.unknown)
    got = kernels.overlap_score_ordered(*args)
    singles = torch.stack([kernels.overlap_score_ordered(*(t[i] for t in args[:5]), *args[5:])
                           for i in range(m)])
    assert got.shape == (m, 8)
    assert torch.equal(got.view(torch.int32), singles.view(torch.int32))
    torch.testing.assert_close(got, kernels.overlap_score_ref(*args), atol=ATOL, rtol=0)


@pytest.mark.parametrize("reducer,window", [("overlap", 1), ("mean", 1)])
def test_overlap_score_partial_ordered_matches_twin(setup, reducer, window):
    """Two row bands with a halo row: each against the partial twin, their
    sums against the whole score."""
    _, _, tview, ts, cand, pw = setup
    prep = tscore.prepare(tview, ts, tscore.ScoringConfig(reducer=reducer, window=window),
                          torch.from_numpy(pw))
    h = prep.plane.shape[0]
    poses = torch.from_numpy(cand)
    rest = (prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    sums = torch.zeros((poses.shape[0], 2))
    for r0, r1 in ((0, h // 2), (h // 2, h)):
        g0, g1 = max(r0 - 1, 0), min(r1 + 1, h)
        args = (prep.plane[g0:g1].contiguous(), g0, h, poses, *rest, r0, r1, prep.reducer)
        got = kernels.overlap_score_partial_ordered(*args)
        want = kernels.overlap_score_partial_ref(*args)
        assert got.shape == (poses.shape[0], 2)
        assert bool(((got - want).abs() <= ATOL * want.abs().clamp(min=1.0)).all())
        sums += got
    whole = kernels.overlap_score_ref(prep.plane, poses, *rest, prep.reducer)
    torch.testing.assert_close(sums[:, 0] / sums[:, 1].clamp(min=1e-9), whole, atol=ATOL, rtol=0)
