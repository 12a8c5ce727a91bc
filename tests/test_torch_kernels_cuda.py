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
``mc_match``'s does. ``mc_match_windows`` is the same kernel reading each
match's window of its map in place: it equals the same windows cut out,
bit for bit. ``m3rsm_pyramid`` (a max, exact) equals its twin bit for bit,
whole and in a refreshed region written into new planes;
``m3rsm_score_level`` sums a rect's beams in another order than its twin:
atol 2e-6. ``m3rsm_search`` (a whole M3RSM match in one launch) equals
``m3rsm_search_levels`` (a level-score launch a level, a batched score
launch a hill-climb round) bit for bit.
"""

import pytest
import torch

from slam_constructor_tpu_torch.models import tiny, viny
from slam_constructor_tpu_torch.models.engine import init_state
from slam_constructor_tpu_torch.ops import grid as gridlib
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
@pytest.mark.parametrize("n_maps,k", [(1, 343), (5, 7), (32, 343), (3, 1), (30, 16), (30, 1)])
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


def _window_args(scene, n_p, k, rounds, win, stride=2):
    """P matches on windows of P maps read in place, as the RBPF makes them:
    the scene's map as channel 0 of cells [P, 256, 256, 2] (the occupancy a
    strided view, as Bayes cells give it), windows at corners spread over the
    map and clamped at its edges, each particle with its own prior, mask of
    valid beams and noise; particle 1 has no valid beam."""
    view, scan, cand, g = scene
    dev = cand.device
    cells = torch.stack([view.occ, view.known.to(torch.float32)], -1).expand(n_p, -1, -1, -1)
    cells = cells.contiguous()
    occ, known = cells[..., 0], cells[..., 1] > 0
    h, w = occ.shape[1:]
    centre = cand[:n_p, :2] + torch.randn((n_p, 2), generator=g, device=dev) * 9.0
    origin = torch.full((n_p, 2), -12.8, device=dev)
    row, col, win_origin = gridlib.window_corner(origin, centre, 0.1, win, win, h, w)
    valid = scan.valid[None] & (torch.arange(360, device=dev) % (5 + torch.arange(n_p, device=dev) % 3)[:, None] != 1)
    scans = LaserScan(scan.ranges[None].expand(n_p, -1), scan.bearings[None].expand(n_p, -1), valid)
    pts, beam_w = scoring.prepare_scan(scans, scoring.ScoringConfig(reducer="overlap", stride=stride))
    if n_p > 1:
        beam_w = beam_w.clone()
        beam_w[1] = 0.0
    noise = torch.randn((n_p, rounds, k, 3), generator=g, device=dev)
    return (occ, known, row, col, win, win, pts, beam_w, win_origin, cand[:n_p].contiguous(), noise,
            0.1, 0.5, 0.06, 0.03, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_p,k,rounds,win", [
    (1, 20, 5, 160), (7, 7, 4, 120), (30, 20, 5, 160), (30, 1, 3, 160), (7, 33, 2, 120),
    (7, 64, 3, 256), (30, 64, 2, 160), (1, 7, 0, 256), (7, 20, 5, 256),
])
def test_mc_match_windows_equals_cut_out_and_single_launches(scene, n_p, k, rounds, win):
    """The particle match on windows read in place (up to the whole 256^2
    map) equals the same windows cut out (``mc_match_batched``), P single
    ``mc_match`` launches and ``mc_match_rounds``, bit for bit; over P in
    {1, 7, 30}, K in {1, 7, 20, 33, 64}."""
    args = _window_args(scene, n_p, k, rounds, win)
    before = dict(kernels.launch_counts())
    got = kernels.mc_match_windows(*args)
    after = kernels.launch_counts()
    assert (after["mc_match_batched"], after["mc_match"]) == (
        before["mc_match_batched"] + 1, before["mc_match"])
    occ, known, row, col = args[:4]
    plane = torch.where(gridlib.take_window(known, row, col, win, win),
                        gridlib.take_window(occ, row, col, win, win), 0.5).contiguous()
    cut = (plane, *args[6:])
    want = kernels.mc_match_batched(*cut)
    singles = [kernels.mc_match(*(t[m] for t in cut[:6]), *cut[6:]) for m in range(n_p)]
    rounds_ = [kernels.mc_match_rounds(*(t[m] for t in cut[:6]), *cut[6:]) for m in range(n_p)]
    torch.cuda.synchronize()
    assert got[0].shape == (n_p, 3) and got[1].shape == (n_p,) and got[2].shape == (n_p, rounds)
    for i in range(3):
        assert torch.equal(got[i], want[i])  # bit for bit
        assert torch.equal(got[i], torch.stack([s[i] for s in singles]))
        assert torch.equal(got[i], torch.stack([s[i] for s in rounds_]))
    if n_p > 1:  # no valid beam: every score 0, nothing is better
        assert not bool(got[2][1].any()) and torch.equal(got[0][1], args[9][1])
    for a, b in zip(kernels.mc_match_windows(*args), got):
        assert torch.equal(a, b)  # the same bits on every call


@pytest.mark.cuda
def test_mc_match_windows_rejects_bad_input(scene):
    args = list(_window_args(scene, 3, 20, 5, 120))
    occ, known = args[0], args[1]
    with pytest.raises(TypeError):  # the mask as bytes, not bool
        kernels.mc_match_windows(occ, known.to(torch.uint8), *args[2:])
    with pytest.raises(TypeError):
        kernels.mc_match_windows(occ.double(), known, *args[2:])
    with pytest.raises(ValueError):  # a window larger than the map
        kernels.mc_match_windows(occ, known, args[2], args[3], 300, 300, *args[6:])
    with pytest.raises(ValueError):  # neither contiguous nor a channel of contiguous cells
        kernels.mc_match_windows(occ.transpose(1, 2), known, *args[2:])
    with pytest.raises(ValueError):  # a strided mask
        kernels.mc_match_windows(occ, known.transpose(1, 2), *args[2:])
    with pytest.raises(ValueError):  # one corner for three maps
        kernels.mc_match_windows(occ, known, args[2][:1], *args[3:])
    with pytest.raises(ValueError):  # a round without a candidate
        kernels.mc_match_windows(*args[:10], args[10][:, :, :0].contiguous(), *args[11:])


# --- M3RSM: the pyramid (K4a) and the level score (K4b) -----------------------


def _random_plane(g, shape, dev):
    occ = torch.rand(shape, generator=g, device=dev)
    known = torch.rand(shape, generator=g, device=dev) < 0.7
    return occ, known


@pytest.mark.cuda
@pytest.mark.parametrize("shape,levels,channel", [
    ((256, 256), 4, False), ((32, 120, 120), 3, False), ((100, 90), 5, False),
    ((96, 64), 6, False), ((256, 256), 4, True), ((5, 7), 2, False), ((40, 40), 0, False),
])
def test_m3rsm_pyramid_kernel_equals_twin(scene, shape, levels, channel):
    _, _, cand, g = scene
    occ, known = _random_plane(g, shape, cand.device)
    if channel:  # the occupancy a channel of the cells, as the Bayes cell's
        occ = torch.stack([occ, torch.zeros_like(occ)], dim=-1)[..., 0]
    before = kernels.launch_counts()["m3rsm_pyramid"]
    got = kernels.m3rsm_pyramid(occ, known, levels, 0.5)
    want = kernels.m3rsm_pyramid_ref(occ, known, levels, 0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["m3rsm_pyramid"] == before + 1
    assert len(got) == levels + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("center", [(128, 128), (0, 0), (255, 255), (0, 255), (255, 0), (7, 200)])
def test_m3rsm_pyramid_update_equals_twin(scene, center):
    """A 144^2 region of a 256^2 map at 4 levels (the main path's refresh),
    clamped at each corner; a gate at 0 touches nothing."""
    _, _, cand, g = scene
    dev = cand.device
    occ, known = _random_plane(g, (256, 256), dev)
    planes = kernels.m3rsm_pyramid(occ, known, 4, 0.5)
    occ2 = torch.where(torch.rand((256, 256), generator=g, device=dev) < 0.3, 0.9, occ)
    c = torch.tensor(center, device=dev)
    got = kernels.m3rsm_pyramid_update(tuple(p.clone() for p in planes), occ2, known, c, 144, 0.5,
                                       torch.ones((), device=dev))
    want = kernels.m3rsm_pyramid_update_ref(tuple(p.clone() for p in planes), occ2, known, c, 144,
                                            0.5)
    shut = kernels.m3rsm_pyramid_update(tuple(p.clone() for p in planes), occ2, known, c, 144,
                                        0.5, torch.zeros((), device=dev))
    torch.cuda.synchronize()
    for a, b, p, z in zip(got, want, planes, shut):
        assert torch.equal(a, b) and torch.equal(z, p)
    assert not torch.equal(got[0], planes[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_b,shared,level", [(1, True, 0), (1, True, 2), (1, True, 4),
                                              (3, True, 1), (4, False, 3), (4, False, 0)])
def test_m3rsm_score_level_kernel_matches_twin(scene, n_b, shared, level):
    _, _, cand, g = scene
    dev = cand.device
    occ, known = _random_plane(g, (n_b, 256, 256), dev)
    planes = kernels.m3rsm_pyramid_ref(occ[:1] if shared else occ, known[:1] if shared else known,
                                       4, 0.5)
    s, n_t, r, k = 160, 9, 360, 192
    corner = (torch.randint(0, 96 // 16 + 1, (n_b, 2), generator=g, device=dev) * 16).int()
    c0 = torch.randint(-8, s + 8, (n_b, n_t, r, 2), generator=g, device=dev).int()
    cands = torch.stack([torch.randint(0, n_t, (n_b, k), generator=g, device=dev),
                         torch.randint(-20, 20, (n_b, k), generator=g, device=dev),
                         torch.randint(-20, 20, (n_b, k), generator=g, device=dev)], -1).int()
    mask = torch.rand((n_b, r), generator=g, device=dev) * (torch.arange(r, device=dev) % 2 == 0)
    args = (planes[level].contiguous(), corner.contiguous(), level, s >> level, s >> level,
            c0.contiguous(), cands.contiguous(), mask.contiguous(), 0.5)
    before = kernels.launch_counts()["m3rsm_level"]
    got = kernels.m3rsm_score_level(*args)
    want = kernels.m3rsm_score_level_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["m3rsm_level"] == before + 1
    assert got.shape == (n_b, k)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert torch.equal(kernels.m3rsm_score_level(*args), got)


@pytest.mark.cuda
def test_m3rsm_kernels_reject_bad_input(scene):
    _, _, cand, g = scene
    dev = cand.device
    occ, known = _random_plane(g, (64, 64), dev)
    with pytest.raises(ValueError):
        kernels.m3rsm_pyramid(occ, known, 7, 0.5)  # beyond the kernel's tile
    with pytest.raises(ValueError):
        kernels.m3rsm_pyramid(occ.t(), known, 3, 0.5)  # neither contiguous nor a channel
    planes = kernels.m3rsm_pyramid(occ, known, 3, 0.5)
    with pytest.raises(ValueError):  # a region that is not a multiple of 2^levels
        kernels.m3rsm_pyramid_update(planes, occ, known, torch.tensor([5, 5], device=dev), 36,
                                     0.5)
    c0 = torch.zeros((1, 2, 8, 2), dtype=torch.int32, device=dev)
    cands = torch.zeros((1, 4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.m3rsm_score_level(planes[0][None], torch.zeros((1, 2), device=dev), 0, 64, 64,
                                  c0, cands, torch.ones((1, 8), device=dev), 0.5)


@pytest.mark.cuda
def test_m3rsm_pyramid_update_writes_new_planes(scene):
    """Three maps, the gate open, shut and open: one launch writes new
    planes equal to the twin's; the planes handed in (here not views into
    one buffer, so the wrapper lays them out first) stay as they were."""
    _, _, cand, g = scene
    dev = cand.device
    occ, known = _random_plane(g, (3, 128, 128), dev)
    planes = tuple(p.clone() for p in kernels.m3rsm_pyramid(occ, known, 3, 0.5))
    before = [p.clone() for p in planes]
    occ2 = torch.where(torch.rand(occ.shape, generator=g, device=dev) < 0.3, 0.9, occ)
    centers = torch.tensor([[64, 64], [3, 120], [125, 2]], device=dev)
    gate = torch.tensor([1.0, 0.0, 1.0], device=dev)
    n = kernels.launch_counts()["m3rsm_pyramid"]
    got = kernels.m3rsm_pyramid_update(planes, occ2, known, centers, 48, 0.5, gate)
    assert kernels.launch_counts()["m3rsm_pyramid"] == n + 1
    want = kernels.m3rsm_pyramid_update_ref(planes, occ2, known, centers, 48, 0.5, gate)
    torch.cuda.synchronize()
    for a, b, p, q in zip(got, want, planes, before):
        assert torch.equal(a, b) and torch.equal(p, q) and a.data_ptr() != p.data_ptr()
        assert torch.equal(a[1], q[1]) and not torch.equal(a[0], q[0])


def _m3rsm_case(scene, case):
    """(view, scan, priors, config, weights) of a match on the scene's map:
    viny_m3rsm's matcher (a 160^2 window, 4 levels, K = 9 .. 192) and
    variants, ``M3RSMConfig``'s defaults (the whole 256^2 map, 5 levels, 17
    thetas, K = 153 .. 1024) with the scene's scan and with a scan of 1,081
    beams from the same pose, B requests on one map, and M maps with the
    loop closer's matcher (the whole 120^2 submap, 3 levels, K = 28 ..
    1024)."""
    import dataclasses

    from slam_constructor_tpu_torch.ops import m3rsm

    view, scan, cand, g = scene
    dev = cand.device
    cfg = viny.viny_m3rsm_config(map_size=256).matcher_cfg
    w = torch.rand((360,), generator=g, device=dev)
    prior = cand[0].clone()
    if case == "viny_m3rsm":
        return view, scan, prior, cfg, w
    if case == "window 0":
        return view, scan, prior, dataclasses.replace(cfg, window=0), w
    if case == "refine 0":
        return view, scan, prior, dataclasses.replace(cfg, refine_iterations=0), w
    if case == "4 requests":
        scans = LaserScan(*(a.expand(4, -1) for a in (scan.ranges, scan.bearings, scan.valid)))
        return view, scans, cand[:4].contiguous(), cfg, w.expand(4, -1)
    defaults = m3rsm.M3RSMConfig(scoring=scoring.ScoringConfig(reducer="overlap"))
    if case == "defaults":
        return view, scan, prior, defaults, w
    if case == "defaults, 1081 beams":
        occ, origin, scale = datagen.cecum_world(device=dev)
        pose = datagen.rectangle_trajectory(step=0.2, device=dev)[5:6]
        scans, _, _ = datagen.synth_sequence(occ, origin, scale, pose,
                                             datagen.default_bearings(1081, device=dev), rng=0)
        return view, scans[0], prior, defaults, torch.rand((1081,), generator=g, device=dev)
    loop = m3rsm.M3RSMConfig(levels=3, half_x=0.6, half_y=0.6, half_theta=0.3, n_theta=7,
                             scoring=scoring.ScoringConfig(reducer="overlap", stride=2))
    cells = ((prior[:2] - view.origin) / view.scale).long().tolist()
    rows, cols, origins = [], [], []
    for dr, dc in ((0, 0), (-7, 5), (9, -3)):
        r0 = min(max(cells[1] + dr - 60, 0), 136)
        c0 = min(max(cells[0] + dc - 60, 0), 136)
        rows.append(r0)
        cols.append(c0)
        origins.append(view.origin + torch.tensor([c0, r0], device=dev) * view.scale)
    maps = scoring.MapView(
        occ=torch.stack([view.occ[r:r + 120, c:c + 120] for r, c in zip(rows, cols)]),
        known=torch.stack([view.known[r:r + 120, c:c + 120] for r, c in zip(rows, cols)]),
        origin=torch.stack(origins), scale=view.scale)
    scans = LaserScan(*(a.expand(3, -1) for a in (scan.ranges, scan.bearings, scan.valid)))
    return maps, scans, cand[:3].contiguous(), loop, None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["viny_m3rsm", "window 0", "refine 0", "4 requests",
                                  "3 maps, the loop matcher", "defaults",
                                  "defaults, 1081 beams"])
def test_m3rsm_search_equals_the_level_launches(scene, case, monkeypatch):
    """One launch of the whole match equals, bit for bit, the match with a
    level-score launch a level and a batched score launch a hill-climb
    round (pose, prob, trace); it counts one launch a call."""
    from slam_constructor_tpu_torch.ops import m3rsm

    view, scan, prior, cfg, w = _m3rsm_case(scene, case)
    n = kernels.launch_counts()
    got = m3rsm.m3rsm_match(view, scan, prior, None, cfg, w)
    after = kernels.launch_counts()
    assert after["m3rsm_search"] == n["m3rsm_search"] + 1
    assert after["m3rsm_level"] == n["m3rsm_level"]
    again = m3rsm.m3rsm_match(view, scan, prior, None, cfg, w)
    monkeypatch.setattr(kernels, "m3rsm_search", kernels.m3rsm_search_levels)
    want = m3rsm.m3rsm_match(view, scan, prior, None, cfg, w)
    torch.cuda.synchronize()
    for a, b, c in ((got.pose, want.pose, again.pose), (got.prob, want.prob, again.prob),
                    (got.trace, want.trace, again.trace)):
        assert a.shape == b.shape and torch.equal(a, b) and torch.equal(a, c)
    assert bool(torch.isfinite(got.pose).all())


@pytest.mark.cuda
def test_m3rsm_search_rejects_bad_input(scene, monkeypatch):
    import dataclasses

    from slam_constructor_tpu_torch.ops import m3rsm

    view, scan, prior, cfg, w = _m3rsm_case(scene, "viny_m3rsm")
    kept, real = [], kernels.m3rsm_search
    monkeypatch.setattr(kernels, "m3rsm_search", lambda s: kept.append(s) or real(s))
    m3rsm.m3rsm_match(view, scan, prior, None, cfg, w)
    monkeypatch.undo()
    s = kept[0]
    with pytest.raises(ValueError, match="shared memory"):  # 1,800 top rects, 7,200 next
        kernels.m3rsm_search(dataclasses.replace(s, top=s.top.repeat(200, 1).contiguous(),
                                                 beam_width=2048))
    with pytest.raises(ValueError):  # the mask on the CPU, the rest on the card
        kernels.m3rsm_search(dataclasses.replace(s, mask=s.mask.cpu()))
    with pytest.raises(ValueError):  # the maps on the CPU
        kernels.m3rsm_search(dataclasses.replace(s, occ=s.occ.cpu(), known=s.known.cpu()))
    with pytest.raises(TypeError):  # i64 rects
        kernels.m3rsm_search(dataclasses.replace(s, top=s.top.long()))
    with pytest.raises(ValueError):  # a window larger than the map
        kernels.m3rsm_search(dataclasses.replace(s, window=512))
    with pytest.raises(ValueError):  # a window not a multiple of 2^levels
        kernels.m3rsm_search(dataclasses.replace(s, window=72))
