"""The CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU and skip without one (CUDA kernels have no
CPU mode). They import no JAX, so they run where the port runs:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX). For
``overlap_score`` only the order of the sums may differ between kernel and
twin: atol 2e-6, the bound the reference holds its Pallas kernel to.
``polar_free_plane`` does the twin's f32 arithmetic in the twin's order with
the same device math routines; a cell on a knife edge of its free test may
still flip, so the test counts them: at most 8 of a 256^2 plane, weights
within 1e-6 relative elsewhere. ``mc_match`` runs a whole Monte-Carlo match
in one launch with the arithmetic of ``mc_match_rounds`` (one
``overlap_score`` launch a round) in the same order: equal bit for bit; its
plain twin sums a score in another order, hence atol 2e-6 on the trace.
``overlap_score_batched`` is ``overlap_score``'s kernel with the maps on a
grid axis: every slot equals the single-plane launch on the same inputs bit
for bit, and the twin within 2e-6. ``mc_match_batched`` is ``mc_match``'s
kernel with a cluster a match: every match equals a single ``mc_match``
launch (and ``mc_match_rounds``) on its slices bit for bit, and its twin as
``mc_match``'s does.
"""

import pytest
import torch

from slam_constructor_tpu_torch.models import tiny, viny
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
    before = kernels.launch_counts()["overlap_score"]
    got = kernels.overlap_score(*args)
    want = kernels.overlap_score_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["overlap_score"] == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams,fov_half,h,w", [
    (360, False, 256, 256), (181, True, 256, 256), (120, False, 96, 128), (90, False, 96, 128),
])
def test_polar_free_plane_kernel_matches_plain_twin(scene, n_beams, fov_half, h, w):
    _, scan, cand, _ = scene
    dev = cand.device
    step = 360 // n_beams if not fov_half else 1
    sl = slice(90, 271) if fov_half else slice(0, 360, step)
    valid = scan.valid[sl] & (torch.arange(n_beams, device=dev) % 7 != 3)
    cfg = viny.viny_config(map_size=256).beam
    origin = torch.tensor([-w * 0.05, -h * 0.05], device=dev)
    args = (scan.ranges[sl].contiguous(), valid, scan.bearings[sl].contiguous(), cand[0].contiguous(),
            origin, h, w, 0.1, cfg.hole_width / 2.0, cfg.max_range)
    before = kernels.launch_counts()["polar_free_plane"]
    got = kernels.polar_free_plane(*args)
    want = kernels.polar_free_plane_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["polar_free_plane"] == before + 1
    assert got.shape == (h, w) and int((want > 0).sum()) > 300
    flipped = int(((got > 0) != (want > 0)).sum())
    assert flipped <= 8, f"{flipped} cells flipped"
    both = (got > 0) & (want > 0)
    assert float(((got - want).abs() / want.clamp(min=1e-9))[both].max()) <= 1e-6
    assert torch.equal(kernels.polar_free_plane(*args), got)  # the same bits on every call


@pytest.mark.cuda
def test_polar_free_plane_rejects_bad_input(scene):
    _, scan, cand, _ = scene
    args = [scan.ranges, scan.valid, scan.bearings, cand[0].contiguous(),
            torch.tensor([-12.8, -12.8], device=cand.device), 256, 256, 0.1, 0.15, 15.0]
    with pytest.raises(TypeError):
        kernels.polar_free_plane(args[0], scan.valid.float(), *args[2:])
    with pytest.raises(ValueError):
        kernels.polar_free_plane(args[0], args[1], args[2], cand[0].cpu(), *args[4:])
    big = 13000  # 52,000 B of shared memory
    with pytest.raises(ValueError):
        kernels.polar_free_plane(
            torch.ones(big, device=cand.device), torch.ones(big, dtype=torch.bool, device=cand.device),
            torch.linspace(-3.14, 3.14, big, device=cand.device), *args[3:])


def _match_args(scene, batch, rounds, stride, weighted, bad_rounds=2):
    view, scan, cand, g = scene
    dev = cand.device
    w = torch.rand((360,), generator=g, device=dev) if weighted else None
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap", stride=stride), w)
    noise = torch.randn((rounds, batch, 3), generator=g, device=dev)
    prior = cand[0].clone()  # within 0.3 m and 0.2 rad of the scan's pose
    return (prep.plane, prep.pts, prep.beam_w, prep.origin, prior, noise, prep.scale,
            prep.unknown, 0.1, 0.05, bad_rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,rounds,stride,weighted,bad_rounds", [
    (64, 12, 1, False, 2), (64, 16, 2, True, 2), (8, 6, 1, False, 1), (100, 5, 2, True, 2),
    (32, 1, 1, True, 2), (20, 0, 1, False, 2),
])
def test_mc_match_kernel_equals_one_launch_a_round(scene, batch, rounds, stride, weighted,
                                                   bad_rounds):
    args = _match_args(scene, batch, rounds, stride, weighted, bad_rounds)
    before = (kernels.launch_counts()["mc_match"], kernels.launch_counts()["overlap_score"])
    got = kernels.mc_match(*args)
    assert (kernels.launch_counts()["mc_match"], kernels.launch_counts()["overlap_score"]) == (
        before[0] + 1, before[1])
    want = kernels.mc_match_rounds(*args)
    twin = kernels.mc_match_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["overlap_score"] == before[1] + 1 + rounds
    assert got[0].shape == (3,) and got[1].shape == () and got[2].shape == (rounds,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # bit for bit
    # the twin keeps the same candidates unless a round is decided by less
    # than the tolerance; the trace's first round never depends on that
    torch.testing.assert_close(got[2][:1], twin[2][:1], atol=ATOL, rtol=0)
    if float((got[0] - twin[0]).abs().max()) <= 1e-6:
        torch.testing.assert_close(got[2], twin[2], atol=ATOL, rtol=0)
        torch.testing.assert_close(got[1], twin[1], atol=ATOL, rtol=0)
    for a, b in zip(kernels.mc_match(*args), got):
        assert torch.equal(a, b)  # the same bits on every call


@pytest.mark.cuda
def test_mc_match_rejects_bad_input(scene):
    args = list(_match_args(scene, 64, 4, 1, False))
    with pytest.raises(TypeError):
        kernels.mc_match(*args[:5], args[5].double(), *args[6:])
    with pytest.raises(ValueError):
        kernels.mc_match(*args[:4], args[4].cpu(), *args[5:])
    with pytest.raises(ValueError):  # a round without a candidate
        kernels.mc_match(*args[:5], args[5][:, :0].contiguous(), *args[6:])
    with pytest.raises(ValueError):  # the noise alone is 240,000 B of shared memory
        kernels.mc_match(*args[:5], torch.zeros((20, 1000, 3), device=args[4].device), *args[6:])


def _submap_batch(scene, n_maps, k, stride=2):
    """M (plane, poses, scan) triples: shifted crops of the scene's map,
    each with its own origin, scan mask and candidates."""
    view, scan, cand, g = scene
    dev = cand.device
    planes, origins, valids, poses = [], [], [], []
    for m in range(n_maps):
        r0, c0 = 40 + 3 * (m % 7), 20 + 5 * (m % 11)
        planes.append(torch.where(view.known, view.occ, 0.5)[r0:r0 + 120, c0:c0 + 120])
        origins.append(view.origin + torch.tensor([c0 * 0.1, r0 * 0.1], device=dev))
        valids.append(scan.valid & (torch.arange(360, device=dev) % (5 + m % 3) != 1))
        poses.append(cand[m % 64] + torch.randn((k, 3), generator=g, device=dev) * torch.tensor(
            [0.4, 0.4, 0.2], device=dev))
    views = scoring.MapView(occ=torch.stack(planes), known=torch.ones_like(torch.stack(planes),
                                                                         dtype=torch.bool),
                            origin=torch.stack(origins), scale=0.1)
    scans = LaserScan(
        scan.ranges[None].expand(n_maps, -1) * torch.linspace(0.8, 1.0, n_maps, device=dev)[:, None],
        scan.bearings[None].expand(n_maps, -1).contiguous(), torch.stack(valids))
    prep = scoring.prepare(views, scans, scoring.ScoringConfig(reducer="overlap", stride=stride))
    return prep, torch.stack(poses).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n_maps,k", [(1, 343), (5, 7), (32, 343), (3, 1)])
def test_overlap_score_batched_matches_twin_and_single_launches(scene, n_maps, k):
    prep, poses = _submap_batch(scene, n_maps, k)
    beam_w = prep.beam_w.clone()
    if n_maps > 1:
        beam_w[1] = 0.0  # a map with no valid beam
    args = (prep.plane, poses, prep.pts, beam_w, prep.origin, prep.scale, prep.unknown)
    before = (kernels.launch_counts()["overlap_score_batched"], kernels.launch_counts()["overlap_score"])
    got = kernels.overlap_score_batched(*args)
    assert (kernels.launch_counts()["overlap_score_batched"], kernels.launch_counts()["overlap_score"]) == (
        before[0] + 1, before[1])
    want = kernels.overlap_score_ref(*args)
    singles = torch.stack([
        kernels.overlap_score(prep.plane[m], poses[m], prep.pts[m], beam_w[m], prep.origin[m],
                              prep.scale, prep.unknown) for m in range(n_maps)])
    torch.cuda.synchronize()
    assert got.shape == (n_maps, k) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert torch.equal(got, singles)  # bit for bit
    if n_maps > 1:
        assert not bool(got[1].any())
    assert torch.equal(kernels.overlap_score_batched(*args), got)  # the same bits on every call


@pytest.mark.cuda
def test_overlap_score_batched_rejects_bad_input(scene):
    prep, poses = _submap_batch(scene, 3, 7)
    args = [prep.plane, poses, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown]
    with pytest.raises(ValueError):  # a single plane is overlap_score's
        kernels.overlap_score_batched(prep.plane[0], poses[0], prep.pts[0], prep.beam_w[0],
                                      prep.origin[0], prep.scale, prep.unknown)
    with pytest.raises(ValueError):  # two scans for three maps
        kernels.overlap_score_batched(args[0], args[1], prep.pts[:2].contiguous(), *args[3:])
    with pytest.raises(TypeError):
        kernels.overlap_score_batched(args[0], poses.double(), *args[2:])
    with pytest.raises(ValueError):  # a strided view
        kernels.overlap_score_batched(prep.plane[:, :, ::2], *args[1:])


def _particle_args(scene, n_p, k, rounds, stride=2):
    """P matches as the RBPF makes them: a 120^2 window of the scene's map
    a particle (each its own origin), the scan once a particle (each with
    its own mask of valid beams), priors around the scan's pose, noise."""
    prep, poses = _submap_batch(scene, n_p, 1, stride)
    g = scene[3]
    noise = torch.randn((n_p, rounds, k, 3), generator=g, device=poses.device)
    return (prep.plane, prep.pts, prep.beam_w, prep.origin, poses[:, 0].contiguous(), noise,
            prep.scale, prep.unknown, 0.06, 0.03, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_p,k,rounds", [
    (1, 20, 5), (30, 20, 5), (7, 13, 4), (5, 100, 3), (64, 20, 2), (3, 64, 12), (4, 1, 3),
])
def test_mc_match_batched_equals_single_launches(scene, n_p, k, rounds):
    """The RBPF's shape (P = 30, K = 20, 5 rounds), P = 1, K not a multiple
    of 8, K > 64 (two passes), P = 64, K = 1; particle 1 has no valid beam."""
    args = list(_particle_args(scene, n_p, k, rounds))
    if n_p > 1:
        args[2] = args[2].clone()
        args[2][1] = 0.0
    before = dict(kernels.launch_counts())
    got = kernels.mc_match_batched(*args)
    after = kernels.launch_counts()
    assert (after["mc_match_batched"], after["mc_match"]) == (
        before["mc_match_batched"] + 1, before["mc_match"])
    singles = [kernels.mc_match(*(t[m] for t in args[:6]), *args[6:]) for m in range(n_p)]
    rounds_ = [kernels.mc_match_rounds(*(t[m] for t in args[:6]), *args[6:]) for m in range(n_p)]
    twin = kernels.mc_match_ref(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (n_p, 3) and got[1].shape == (n_p,) and got[2].shape == (n_p, rounds)
    for i in range(3):
        assert torch.equal(got[i], torch.stack([s[i] for s in singles]))  # bit for bit
        assert torch.equal(got[i], torch.stack([s[i] for s in rounds_]))
    if n_p > 1:  # no valid beam: every score 0, nothing is better
        assert not bool(got[2][1].any()) and torch.equal(got[0][1], args[4][1])
    # the twin, as for mc_match: the first round always, the rest where the
    # match kept the same candidates
    torch.testing.assert_close(got[2][:, :1], twin[2][:, :1], atol=ATOL, rtol=0)
    same = (got[0] - twin[0]).abs().amax(-1) <= 1e-6
    assert int(same.sum()) >= n_p // 2
    torch.testing.assert_close(got[2][same], twin[2][same], atol=ATOL, rtol=0)
    torch.testing.assert_close(got[1][same], twin[1][same], atol=ATOL, rtol=0)
    for a, b in zip(kernels.mc_match_batched(*args), got):
        assert torch.equal(a, b)  # the same bits on every call


@pytest.mark.cuda
def test_mc_match_batched_rejects_bad_input(scene):
    args = list(_particle_args(scene, 3, 20, 5))
    with pytest.raises(ValueError):  # one plane is mc_match's
        kernels.mc_match_batched(args[0][0], *args[1:])
    with pytest.raises(ValueError):  # noise of two particles for three
        kernels.mc_match_batched(*args[:5], args[5][:2].contiguous(), *args[6:])
    with pytest.raises(TypeError):
        kernels.mc_match_batched(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError):  # a scan for all, not one a particle
        kernels.mc_match_batched(args[0], args[1][0], *args[2:])
