"""The CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU and skip without one (CUDA kernels have no
CPU mode). They import no JAX, so they run where the port runs:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX). Only the order of
the sums may differ between kernel and twin: atol 2e-6, the bound the
reference holds its Pallas kernel to.
"""

import pytest
import torch

from slam_constructor_tpu_torch.models import tiny
from slam_constructor_tpu_torch.models.engine import init_state
from slam_constructor_tpu_torch.ops import kernels, raycast, scoring
from slam_constructor_tpu_torch.ops.scan import LaserScan
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)

ATOL = 2e-6


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    occ, origin, scale = datagen.cecum_world(device=dev)
    poses = datagen.rectangle_trajectory(step=0.2, device=dev)[:6]
    scans, _, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(360, device=dev), rng=0
    )
    cfg = tiny.tiny_config(map_size=256)
    gm = init_state(cfg, dev).gm
    for i in range(5):
        gm = raycast.insert_scan(gm, cfg.cell_model, gt[i], scans[i], cfg.beam)
    g = torch.Generator(device=dev).manual_seed(0)
    cand = gt[5] + torch.randn((64, 3), generator=g, device=dev) * torch.tensor(
        [0.3, 0.3, 0.2], device=dev)
    return scoring.MapView.of(gm, cfg.cell_model), scans[5], cand, g


@pytest.mark.cuda
@pytest.mark.parametrize("k,n_beams,stride,weighted", [
    (64, 360, 1, False), (1, 360, 1, False), (64, 100, 1, True), (64, 360, 2, True),
])
def test_overlap_score_kernel_matches_plain_twin(scene, k, n_beams, stride, weighted):
    view, scan, cand, g = scene
    scan = LaserScan(scan.ranges[:n_beams], scan.bearings[:n_beams],
                     scan.valid[:n_beams] & (torch.arange(n_beams, device=cand.device) % 9 != 4))
    w = torch.rand((n_beams,), generator=g, device=cand.device) if weighted else None
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap", stride=stride), w)
    args = (prep.plane, cand[:k].contiguous(), prep.pts, prep.beam_w, prep.origin,
            prep.scale, prep.unknown)
    before = kernels.overlap_score.n_launches
    got = kernels.overlap_score(*args)
    want = kernels.overlap_score_ref(*args)
    torch.cuda.synchronize()
    assert kernels.overlap_score.n_launches == before + 1
    assert got.shape == (k,)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # a fixed-order reduction: the same bits on every call
    assert torch.equal(kernels.overlap_score(*args), got)


@pytest.mark.cuda
def test_overlap_score_rejects_bad_input(scene):
    view, scan, cand, _ = scene
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap"))
    with pytest.raises(TypeError):
        kernels.overlap_score(prep.plane.double(), cand, prep.pts, prep.beam_w, prep.origin,
                              prep.scale, prep.unknown)
    with pytest.raises(ValueError):
        kernels.overlap_score(prep.plane, cand.cpu(), prep.pts, prep.beam_w, prep.origin,
                              prep.scale, prep.unknown)
