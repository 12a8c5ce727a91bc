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
for bit, and the twin within 2e-6. Each of its layouts (a beam a thread,
a group of 128 threads or a warp a (pose, map), by a fixed rule on the
launch's size) and ``overlap_score_partial`` give the bits of the
128-thread group's sums, ``overlap_score_ordered`` and
``overlap_score_partial_ordered`` (each beam's probability from a one-beam
launch, the sums by PyTorch ops in the group's order), at every shape and
on both sides of each boundary of the rule. ``mc_match_batched`` is ``mc_match``'s
kernel with a cluster a match: every match equals a single ``mc_match``
launch (and ``mc_match_rounds``) on its slices bit for bit, and its twin as
``mc_match``'s does. ``mc_match_windows`` is the same kernel reading each
match's window of its map in place: it equals the same windows cut out,
bit for bit. ``m3rsm_pyramid`` (a max, exact) equals its twin bit for bit,
whole and in a refreshed region written into new planes;
``m3rsm_score_level`` sums a rect's beams in another order than its twin:
atol 2e-6. ``m3rsm_search`` (a whole M3RSM match in one launch) equals
``m3rsm_search_levels`` (a level-score launch a level, a batched score
launch a hill-climb round) bit for bit. ``overlap_score_grad`` gives the
score with ``overlap_score``'s bits and its pose gradient within 1e-5 x
max(1, |g|) of its twin (autograd over the score's twin: the sums run in
another order), the beams within 1e-4 cell of a kink (a cell's centre or
edge, where the derivative jumps) at weight 0; ``matchers.gradient_match``
on the card lands within 1e-5 m of the CPU's. ``gradient_refine`` and
``hill_climb`` (a whole refine in one launch, one map or M for the climb)
equal their yardsticks ``gradient_refine_rounds`` and ``hill_climb_rounds``
(a score launch a pass, the rest in PyTorch ops) bit for bit. Every scoring
kernel also runs the other reducers (``kernels.Reducer``: the obstacle
reducer, the max and the mean over a window, the overlap reducer at other
extents and windows): against the twin within 2e-6, and against the same
yardsticks, single launches and cut-out windows bit for bit. ``scan_insert``
(K3: the rasterisation and the fold in one launch) equals
``scan_insert_ordered`` (the samples summed on the host in sample order,
the same fold) bit for bit on one map, P windows in place (clamped at each
edge of the map) and P whole maps, with any number of samples, and its twin
but where the card's ``index_put_`` sums a cell's run of 32 occupied
samples or more in another order (within 1e-6 relative). ``scan_planes``
(K3 without the fold: N scans into P planes) equals ``scan_planes_ordered``
the same way, for every ``plane_of`` form and a plane of 57,600 occupied
samples. ``pool_insert`` (K3 over a block pool: the tiled map's one table,
the copy-on-write RBPF's P tables) equals ``pool_insert_ordered`` bit for
bit on every live slot (beams along tile boundaries, a particle at the
table's corner, a scan without a valid beam, a shared untouched block,
q = 0, an exhausted pool), leaves the dead slots as they were, and its twin
within 2e-6 relative; ``pool_touched`` equals its twin exactly; a call the
kernel cannot take raises. ``pool_prepare`` (one cluster launch: the marks
by crossings, the copy-on-write compaction with its block copies or the
tiled map's allocation, the owners and the insert's work list) equals
its plain versions (``cow.prepare_insert_ref``,
``blockmap.prepare_tiles_ref``) bit for bit (marks, tables, refcounts,
latch or ``n_alloc``, the whole pool, owners, list; block 0's state in its
shared memory or, for a pool too large for it, in device memory), and the
insert from its list
(the robot's tile in row bands) equals ``pool_insert_ordered``.
``mc_match_scan`` (the single match from the scan and the odometry: the
prior's compose and the scan's points in its prologue) equals ``mc_match``
handed them (``scan_match_args``) bit for bit; ``beam_weights`` (viny's
weights in one launch) equals its plain version ``scan.point_weights_ref``
on the card and on the CPU bit for bit; K5 drawing each particle's numbers
from its key equals K5 handed those draws bit for bit.
"""

import dataclasses

import pytest
import torch

from slam_constructor_tpu_torch.models import tiny, viny
from slam_constructor_tpu_torch.models.engine import init_state
from slam_constructor_tpu_torch.ops import cells
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


PARTIAL_REDUCERS = [kernels.BILINEAR, kernels.Reducer("obstacle"), kernels.Reducer("max", 1),
                    kernels.Reducer("mean", 2), kernels.Reducer("overlap", 2, 1.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("red", PARTIAL_REDUCERS, ids=lambda r: f"{r.kind}{r.radius}")
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_overlap_score_partial_matches_twin_and_whole_score(scene, red, d):
    """Each rank's band against the twin (2e-6), the ranks' sums over d row
    partitions against overlap_score (2e-6 x max(1, |s|))."""
    view, scan, cand, _ = scene
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap"))
    h = prep.plane.shape[0]
    need = max(kernels._partial_need(red), 1)
    whole = kernels.overlap_score(prep.plane, cand, prep.pts, prep.beam_w, prep.origin,
                                  prep.scale, prep.unknown, red)
    sums = torch.zeros((cand.shape[0], 2), device=cand.device)
    bounds = [h * i // d for i in range(d + 1)]
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        g0, g1 = max(r0 - need, 0), min(r1 + need, h)
        args = (prep.plane[g0:g1].contiguous(), g0, h, cand, prep.pts, prep.beam_w, prep.origin,
                prep.scale, prep.unknown, r0, r1, red)
        before = kernels.launch_counts()["overlap_score_partial"]
        got = kernels.overlap_score_partial(*args)
        assert kernels.launch_counts()["overlap_score_partial"] == before + 1
        torch.testing.assert_close(got, kernels.overlap_score_partial_ref(*args), atol=2e-6,
                                   rtol=2e-6)
        assert torch.equal(kernels.overlap_score_partial(*args), got)
        sums += got
    score = sums[:, 0] / sums[:, 1].clamp(min=1e-9)
    assert bool(((score - whole).abs() <= 2e-6 * whole.abs().clamp(min=1.0)).all())


@pytest.mark.cuda
def test_overlap_score_partial_rejects_bad_input(scene):
    view, scan, cand, _ = scene
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap"))
    args = (cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    with pytest.raises(ValueError):  # the band misses a row the owned beams read
        kernels.overlap_score_partial(prep.plane[10:50].contiguous(), 10, 256, *args, 10, 50)
    with pytest.raises(ValueError):
        kernels.overlap_score_partial(prep.plane, 0, 256, cand.cpu(), *args[1:], 0, 256)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _order_scan(scene, n_beams):
    """The scene's prepared scan cut or stretched to ``n_beams`` beams (past
    360: copies at 0.97 and 1.03 of the endpoints), a hole every 9th beam;
    one beam: the first of nonzero weight. Returns (prep, pts, beam_w)."""
    view, scan, cand, _ = scene
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap"))
    if n_beams == 1:
        i = int(torch.nonzero(prep.beam_w)[0])
        return prep, prep.pts[i:i + 1].contiguous(), prep.beam_w[i:i + 1].contiguous()
    pts = torch.cat([prep.pts, prep.pts * 0.97, prep.pts * 1.03])[:n_beams].contiguous()
    keep = torch.arange(n_beams, device=cand.device) % 9 != 4
    return prep, pts, (torch.cat([prep.beam_w] * 3)[:n_beams] * keep).contiguous()


def _order_poses(scene, k):
    """The scene's first ``k`` candidates; 1,089: the brute-force matcher's
    11 x 11 x 9 grid around the first."""
    from slam_constructor_tpu_torch.ops import matchers

    cand = scene[2]
    if k <= cand.shape[0]:
        return cand[:k].contiguous()
    grid = matchers.brute_force_offsets(matchers.BruteForceConfig(), cand.device)
    assert grid.shape[0] == k
    return (cand[0] + grid).contiguous()


ORDER_REDUCERS = [kernels.BILINEAR, kernels.Reducer("obstacle"), kernels.Reducer("max", 1),
                  kernels.Reducer("mean", 2), kernels.Reducer("overlap", 1, 1.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("red", ORDER_REDUCERS, ids=lambda r: f"{r.kind}{r.radius}")
@pytest.mark.parametrize("k,n_beams", [(1, 360), (6, 360), (64, 360), (1089, 360), (64, 1),
                                       (1, 1000), (64, 1000), (1089, 1000)])
def test_overlap_score_sums_in_the_group_order(scene, red, k, n_beams):
    """The score's bits are the 128-thread group's sums (group lane v adds
    beams v, v + 128, ... in order, then the tree): overlap_score against
    overlap_score_ordered bit for bit at every shape (1,000 beams: more than
    a block's threads), and against the twin within 2e-6."""
    prep, pts, bw = _order_scan(scene, n_beams)
    args = (prep.plane, _order_poses(scene, k), pts, bw, prep.origin, prep.scale, prep.unknown,
            red)
    got = kernels.overlap_score(*args)
    assert got.shape == (k,) and bool(torch.isfinite(got).all())
    assert torch.equal(_bits(got), _bits(kernels.overlap_score_ordered(*args)))
    torch.testing.assert_close(got, kernels.overlap_score_ref(*args), atol=ATOL, rtol=0)


def _rule_poses(scene, n):
    """``n`` poses spread around the scene's first candidate, pose 5 NaN,
    poses 7 to 9 40 m off the map."""
    cand, g = scene[2], scene[3]
    poses = cand[0] + torch.randn((n, 3), generator=g, device=cand.device) * torch.tensor(
        [0.3, 0.3, 0.2], device=cand.device)
    poses[5] = float("nan")
    poses[7:10, 0] += 40.0
    return poses.contiguous()


def _layout_boundary(layout, n_beams):
    """The least (pose, map) pairs from which a launch of ``n_beams`` beams
    runs ``layout`` (1 a group a pair, 2 a warp a pair) or a later one."""
    lo, hi = 1, 1 << 24
    while lo < hi:
        mid = (lo + hi) // 2
        if kernels.overlap_score_layout(mid, n_beams) >= layout:
            hi = mid
        else:
            lo = mid + 1
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("red", [kernels.BILINEAR, kernels.Reducer("obstacle"),
                                 kernels.Reducer("overlap", 2, 1.5)],
                         ids=lambda r: f"{r.kind}{r.radius}")
@pytest.mark.parametrize("layout", [1, 2], ids=["beam|group", "group|warp"])
def test_overlap_score_layouts_agree_at_the_rule(scene, red, layout):
    """One map scored with one pose fewer than a boundary of the layout
    rule and with as many (a beam a thread | a group a pair, a group | a
    warp a pair): the shared poses' bits equal, both the group's sums
    (overlap_score_ordered) bit for bit, the twin within 2e-6; a NaN pose
    and poses off the map among them."""
    n = _layout_boundary(layout, 360)
    assert kernels.overlap_score_layout(n - 1, 360) == layout - 1
    assert kernels.overlap_score_layout(n, 360) == layout
    prep, pts, bw = _order_scan(scene, 360)
    poses = _rule_poses(scene, n)
    rest = (pts, bw, prep.origin, prep.scale, prep.unknown, red)
    below = kernels.overlap_score(prep.plane, poses[:n - 1].contiguous(), *rest)
    at = kernels.overlap_score(prep.plane, poses, *rest)
    assert torch.equal(_bits(below), _bits(at[:n - 1]))
    assert torch.equal(_bits(at), _bits(kernels.overlap_score_ordered(prep.plane, poses, *rest)))
    torch.testing.assert_close(at, kernels.overlap_score_ref(prep.plane, poses, *rest), atol=ATOL,
                               rtol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [1, 2], ids=["beam|group", "group|warp"])
@pytest.mark.parametrize("side", ["below", "at"])
def test_overlap_score_batched_layouts_equal_single_launches(scene, layout, side):
    """M submaps x K poses (180 beams) with M x K on each side of a boundary
    of the layout rule against single-plane launches (a beam a thread) and
    the group's sums bit for bit, the twin within 2e-6; a map with no valid
    beam, a NaN pose, poses off their submap."""
    n = _layout_boundary(layout, 180)
    k = min(343, _layout_boundary(1, 180) - 1)
    n_maps = (n - 1) // k if side == "below" else -(-n // k)
    assert kernels.overlap_score_layout(k, 180) == 0
    assert kernels.overlap_score_layout(n_maps * k, 180) == layout - (side == "below")
    prep, poses = _submap_batch(scene, n_maps, k)
    beam_w = prep.beam_w.clone()
    beam_w[1] = 0.0
    poses[0, 3] = float("nan")
    poses[-1, :5, 0] += 40.0
    args = (prep.plane, poses, prep.pts, beam_w, prep.origin, prep.scale, prep.unknown)
    got = kernels.overlap_score_batched(*args)
    singles = torch.stack([kernels.overlap_score(*(t[m] for t in args[:5]), *args[5:])
                           for m in range(n_maps)])
    assert torch.equal(_bits(got), _bits(singles))
    assert torch.equal(_bits(got), _bits(kernels.overlap_score_ordered(*args)))
    assert not bool(got[1].any())
    torch.testing.assert_close(got, kernels.overlap_score_ref(*args), atol=ATOL, rtol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("red", PARTIAL_REDUCERS, ids=lambda r: f"{r.kind}{r.radius}")
@pytest.mark.parametrize("k,n_beams", [(64, 360), (1, 1000), (1089, 360)])
def test_overlap_score_partial_whole_band_is_overlap_score(scene, red, k, n_beams):
    """The partial mode over one band that holds the whole plane sums every
    beam in the group's order: num / fmax(den, 1e-9) has overlap_score's
    bits, and (num, den) are overlap_score_partial_ordered's bit for bit."""
    prep, pts, bw = _order_scan(scene, n_beams)
    poses = _order_poses(scene, k)
    h = prep.plane.shape[0]
    rest = (pts, bw, prep.origin, prep.scale, prep.unknown)
    part = kernels.overlap_score_partial(prep.plane, 0, h, poses, *rest, 0, h, red)
    whole = kernels.overlap_score(prep.plane, poses, *rest, red)
    mean = part[:, 0] / torch.fmax(part[:, 1], torch.full_like(part[:, 1], 1e-9))
    assert torch.equal(_bits(mean), _bits(whole))
    assert torch.equal(_bits(part), _bits(kernels.overlap_score_partial_ordered(
        prep.plane, 0, h, poses, *rest, 0, h, red)))


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
@pytest.mark.parametrize("stride,weighted,draws", [
    (1, False, "normals"), (2, True, "normals"), (2, True, "erf_inv"), (1, False, "step key"),
    (2, True, "step key"),
])
def test_mc_match_scan_equals_the_handed_route(scene, stride, weighted, draws):
    """``mc_match_scan`` (the prior's compose and the scan's points in the
    match's prologue) against ``mc_match`` handed the prior and the points
    (``scan_match_args``: a ``libm`` launch each), bit for bit, with
    standard normals, erf_inv draws and a step's key."""
    view, scan, cand, g = scene
    dev = cand.device
    w = torch.rand((360,), generator=g, device=dev) if weighted else None
    plane = torch.where(view.known, view.occ, 0.5).contiguous()
    pose = cand[1].clone()
    odom = torch.tensor([0.12, -0.03, 0.04], device=dev)
    rounds, batch = 12, 64
    if draws == "step key":
        noise = kernels.KeyNoise(torch.tensor([0, 7], dtype=torch.uint32, device=dev), rounds,
                                 batch, step=True)
    else:
        noise = torch.randn((rounds, batch, 3), generator=g, device=dev)
        noise = kernels.ErfInvDraws(noise) if draws == "erf_inv" else noise
    args = (plane, scan.ranges, scan.bearings, scan.valid, w, stride, view.origin, pose, odom,
            noise, view.scale, 0.5, 0.1, 0.05, 2)
    before = kernels.launch_counts()["mc_match"]
    got = kernels.mc_match_scan(*args)
    assert kernels.launch_counts()["mc_match"] == before + 1
    want = kernels.mc_match(*kernels.scan_match_args(*args))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("n_scans,n_beams,n_bins", [(1, 360, 36), (8, 360, 36), (3, 1081, 36),
                                                    (2, 2, 36), (4, 720, 72)])
def test_beam_weights_kernel_equals_plain_version(scene, n_scans, n_beams, n_bins):
    """``beam_weights`` (the endpoint angles, the integer bins, the weights
    in one launch) against ``scan.point_weights_ref`` on the card (its libm
    functions' plain versions) and on the CPU, bit for bit; some beams
    invalid, some pairs repeated (a zero step)."""
    from slam_constructor_tpu_torch.ops import libm
    from slam_constructor_tpu_torch.ops import scan as scanlib

    g = scene[3]
    dev = g.device
    ranges = 0.3 + 5.0 * torch.rand((n_scans, n_beams), generator=g, device=dev)
    ranges[:, 3::17] = ranges[:, 2::17][:, :ranges[:, 3::17].shape[1]]
    bearings = torch.linspace(-3.0, 3.0, n_beams, device=dev).expand(n_scans, -1).contiguous()
    valid = torch.rand((n_scans, n_beams), generator=g, device=dev) > 0.1
    before = kernels.launch_counts()["beam_weights"]
    got = kernels.beam_weights(ranges, bearings, valid, n_bins)
    assert kernels.launch_counts()["beam_weights"] == before + 1
    with libm.plain_versions():
        plain = scanlib.point_weights_ref(scanlib.LaserScan(ranges, bearings, valid), n_bins)
    cpu = kernels.beam_weights(ranges.cpu(), bearings.cpu(), valid.cpu(), n_bins)
    assert torch.equal(got, plain) and torch.equal(got.cpu(), cpu)
    one = kernels.beam_weights(ranges[0], bearings[0], valid[0], n_bins)
    assert torch.equal(one, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [False, True])
def test_particle_matches_from_keys_equal_their_erf_inv_draws(scene, windows):
    """K5 drawing each particle's numbers from its key (``KeyNoise`` with a
    leading particle dimension: the RBPF's match keys) equals K5 handed the
    same keys' ``erf_inv`` draws, bit for bit, cut out and in place."""
    from slam_constructor_tpu_torch.ops import prng

    args = list(_particle_args(scene, 30, 20, 5))
    dev = args[0].device
    keys = prng.draw_ref(prng.key(9, dev), prng.Draw((prng.Each(30),), "key"))
    keyed = kernels.KeyNoise(keys, 5, 20)
    handed = kernels.ErfInvDraws(keyed.draws()[1].contiguous())
    if windows:
        p = args[0].shape[0]
        occ = args[0]
        known = torch.ones_like(occ, dtype=torch.bool)
        row = torch.zeros((p,), dtype=torch.int64, device=dev)
        col = torch.zeros((p,), dtype=torch.int64, device=dev)
        h, w = occ.shape[-2:]
        run = lambda n: kernels.mc_match_windows(occ, known, row, col, h - 8, w - 8,  # noqa: E731
                                                 *args[1:5], n, *args[6:])
    else:
        run = lambda n: kernels.mc_match_batched(*args[:5], n, *args[6:])  # noqa: E731
    got, want = run(keyed), run(handed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # bit for bit


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


@pytest.mark.cuda
@pytest.mark.parametrize("k,n_beams,stride,weighted", [
    (1, 360, 1, False), (7, 360, 1, False), (64, 100, 1, True), (7, 360, 2, True),
])
def test_overlap_score_grad_kernel_matches_plain_twin(scene, k, n_beams, stride, weighted):
    view, scan, cand, g = scene
    scan = LaserScan(scan.ranges[:n_beams], scan.bearings[:n_beams],
                     scan.valid[:n_beams] & (torch.arange(n_beams, device=cand.device) % 9 != 4))
    w = torch.rand((n_beams,), generator=g, device=cand.device) if weighted else None
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap", stride=stride), w)
    args = (prep.plane, cand[:k].contiguous(), prep.pts, prep.beam_w, prep.origin,
            prep.scale, prep.unknown)
    before = kernels.launch_counts()["overlap_score_grad"]
    score, grad = kernels.overlap_score_grad(*args)
    want_s, _ = kernels.overlap_score_grad_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["overlap_score_grad"] == before + 1
    assert torch.equal(score, kernels.overlap_score(*args))
    torch.testing.assert_close(score, want_s, atol=ATOL, rtol=0)
    # where an endpoint lies on a cell's centre or edge the derivative jumps,
    # and a position an ulp apart picks the other side: the gradients are
    # compared with the beams within 1e-4 cell of such a kink at weight 0
    clear = kernels.clear_of_kinks(args[1], args[2], args[4], prep.scale, 1e-4)
    args = (*args[:3], (args[3] * clear).contiguous(), *args[4:])
    masked_score, grad = kernels.overlap_score_grad(*args)
    _, want_g = kernels.overlap_score_grad_ref(*args)
    tol = 1e-5 * torch.clamp(want_g.norm(dim=1, keepdim=True), min=1.0)
    assert bool(((grad - want_g).abs() <= tol).all()), (grad - want_g).abs().max()
    # a fixed-order reduction: the same bits on every call
    again = kernels.overlap_score_grad(*args)
    assert torch.equal(again[0], masked_score) and torch.equal(again[1], grad)


@pytest.mark.cuda
def test_gradient_match_on_the_card_matches_the_cpu(scene):
    from slam_constructor_tpu_torch.ops import matchers

    view, scan, cand, _ = scene
    cfg = matchers.GradientConfig(iterations=12, step_xy=0.03, step_theta=0.015,
                                  scoring=scoring.ScoringConfig(reducer="overlap", window=1))
    cpu_view = scoring.MapView(view.occ.cpu(), view.known.cpu(), view.origin.cpu(), view.scale)
    before = kernels.launch_counts()
    got = matchers.gradient_match(view, scan, cand[3], None, cfg)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gradient_refine"] - before["gradient_refine"] == 1
    assert after["overlap_score_grad"] - before["overlap_score_grad"] == 0
    assert after["overlap_score"] - before["overlap_score"] == 0
    want = matchers.gradient_match(cpu_view, scan.to("cpu"), cand[3].cpu(), None, cfg)
    torch.testing.assert_close(got.pose.cpu(), want.pose, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.prob.cpu(), want.prob, atol=ATOL, rtol=0)


def refine_case(scene, n_beams, stride, weighted, offset):
    """A refine's inputs on the scene's map: (plane, pts, beam_w, origin,
    start pose, scale, unknown)."""
    view, scan, cand, g = scene
    dev = cand.device
    reps = -(-n_beams // scan.ranges.shape[0])  # more beams than the scan's: it repeats
    ranges, bearings, valid = (t.repeat(reps)[:n_beams] for t in (scan.ranges, scan.bearings,
                                                                   scan.valid))
    scan = LaserScan(ranges, bearings, valid & (torch.arange(n_beams, device=dev) % 9 != 4))
    w = torch.rand((n_beams,), generator=g, device=dev) if weighted else None
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap", stride=stride), w)
    pose = (cand[0] + torch.tensor(offset, device=dev)).contiguous()
    return prep.plane, prep.pts, prep.beam_w, prep.origin, pose, prep.scale, prep.unknown


def same_bits(a, b):
    return all(x.shape == y.shape and torch.equal(x.reshape(-1).view(torch.int32),
                                                  y.reshape(-1).view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams,stride,weighted,iterations", [
    (360, 1, False, 12), (360, 1, True, 12), (360, 2, True, 24), (100, 1, True, 1),
    (360, 1, False, 0), (1000, 1, True, 6), (500, 3, False, 6),
])
def test_gradient_refine_equals_the_launch_loop(scene, n_beams, stride, weighted, iterations):
    args = (*refine_case(scene, n_beams, stride, weighted, (0.05, -0.04, 0.02)), 0.03, 0.015,
            iterations, 0.5)
    before = kernels.launch_counts()["gradient_refine"]
    got = kernels.gradient_refine(*args)
    want = kernels.gradient_refine_rounds(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gradient_refine"] == before + 1
    assert got[0].shape == (3,) and got[1].shape == () and got[2].shape == (iterations,)
    assert same_bits(got, want), (got, want)
    assert same_bits(kernels.gradient_refine(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams,stride,weighted,iterations", [
    (360, 1, False, 10), (360, 2, True, 8), (100, 1, True, 1), (360, 1, False, 0),
    (1000, 1, True, 5),
])
def test_hill_climb_equals_the_launch_loop(scene, n_beams, stride, weighted, iterations):
    args = (*refine_case(scene, n_beams, stride, weighted, (0.06, 0.03, -0.02)), 0.025, 0.01,
            iterations, 0.5)
    before = kernels.launch_counts()["hill_climb"]
    got = kernels.hill_climb(*args)
    want = kernels.hill_climb_rounds(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hill_climb"] == before + 1
    assert got[0].shape == (3,) and got[1].shape == () and got[2].shape == (iterations,)
    assert same_bits(got, want), (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_maps", [1, 5, 32])
def test_hill_climb_over_m_maps_equals_single_climbs(scene, n_maps):
    """M maps (the plane flipped and shifted, a start pose each) in one
    launch: the batched yardstick and M single-map launches, bit for bit."""
    plane, pts, beam_w, origin, pose, scale, unknown = refine_case(scene, 360, 2, True,
                                                                   (0.06, 0.03, -0.02))
    g = scene[3]
    dev = plane.device
    planes = torch.stack([plane.flip(0) if m % 2 else plane.roll(m, 1) for m in range(n_maps)])
    poses = pose + torch.randn((n_maps, 3), generator=g, device=dev) * torch.tensor(
        [0.05, 0.05, 0.03], device=dev)
    args = (planes.contiguous(), pts.expand(n_maps, -1, -1).contiguous(),
            beam_w.expand(n_maps, -1).contiguous(), origin.expand(n_maps, -1).contiguous(),
            poses.contiguous(), scale, unknown, 0.025, 0.01, 6, 0.5)
    got = kernels.hill_climb(*args)
    want = kernels.hill_climb_rounds(*args)
    singles = [kernels.hill_climb(*(t[m] for t in args[:5]), *args[5:]) for m in range(n_maps)]
    torch.cuda.synchronize()
    assert got[0].shape == (n_maps, 3) and got[2].shape == (n_maps, 6)
    assert same_bits(got, want)
    assert same_bits(got, [torch.stack([s[i] for s in singles]) for i in range(3)])


@pytest.mark.cuda
def test_refine_kernels_reject_bad_input(scene):
    plane, pts, beam_w, origin, pose, scale, unknown = refine_case(scene, 360, 1, False,
                                                                   (0.0, 0.0, 0.0))
    tail = (scale, unknown, 0.03, 0.015, 4, 0.5)
    for fn in (kernels.gradient_refine, kernels.hill_climb):
        with pytest.raises(TypeError):  # f64 plane
            fn(plane.double(), pts, beam_w, origin, pose, *tail)
        with pytest.raises(ValueError):  # points not contiguous
            fn(plane, pts.t().contiguous().t(), beam_w, origin, pose, *tail)
        with pytest.raises(ValueError):  # the pose on the CPU
            fn(plane, pts, beam_w, origin, pose.cpu(), *tail)
        with pytest.raises(ValueError):  # a weight short
            fn(plane, pts, beam_w[:-1], origin, pose, *tail)


# --- the reducers other than the bilinear overlap ------------------------------

#: the obstacle reducer (GMappingConfig()'s, M3RSMConfig()'s), the max and the
#: mean over 3^2 and 5^2 cells, the overlap reducer at other extents and at
#: window 0
REDUCERS = [kernels.Reducer("obstacle"), kernels.Reducer("max", 1), kernels.Reducer("max", 2),
            kernels.Reducer("mean", 1), kernels.Reducer("mean", 2),
            kernels.Reducer("overlap", 0, 0.5), kernels.Reducer("overlap", 1, 1.6),
            kernels.Reducer("overlap", 2, 2.5), kernels.Reducer("overlap", 0, 1.0)]
REDUCER_IDS = [f"{r.kind}-{r.radius}-{r.extent}" for r in REDUCERS]


def _wide(scene, k):
    """k candidates, a quarter of them 8 to 20 m off: endpoints off the map."""
    _, _, cand, g = scene
    far = torch.randn((k, 3), generator=g, device=cand.device) * torch.tensor(
        [9.0, 9.0, 1.0], device=cand.device)
    return torch.where((torch.arange(k, device=cand.device) % 4 == 3)[:, None], cand[:k] + far,
                       cand[:k]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("red", REDUCERS, ids=REDUCER_IDS)
def test_reducer_scores_match_twin_and_single_launches(scene, red):
    """``overlap_score`` against its twin (2e-6); ``overlap_score_batched``
    against the twin and M single launches (bit for bit); each launch
    counted under its reducer."""
    view, scan, _, g = scene
    w = torch.rand((360,), generator=g, device=scan.ranges.device)
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap", stride=2), w)
    args = (prep.plane, _wide(scene, 64), prep.pts, prep.beam_w, prep.origin, prep.scale,
            prep.unknown, red)
    n = kernels.reducer_launch_counts()[f"overlap_score/{red.kind}"]
    got = kernels.overlap_score(*args)
    assert kernels.reducer_launch_counts()[f"overlap_score/{red.kind}"] == n + 1
    torch.testing.assert_close(got, kernels.overlap_score_ref(*args), atol=ATOL, rtol=0)
    assert torch.equal(kernels.overlap_score(*args), got)
    bprep, poses = _submap_batch(scene, 5, 33)
    bargs = (bprep.plane, poses, bprep.pts, bprep.beam_w, bprep.origin, bprep.scale,
             bprep.unknown, red)
    batched = kernels.overlap_score_batched(*bargs)
    torch.testing.assert_close(batched, kernels.overlap_score_ref(*bargs), atol=ATOL, rtol=0)
    singles = torch.stack([kernels.overlap_score(*(t[m] for t in bargs[:5]), *bargs[5:])
                           for m in range(5)])
    assert torch.equal(batched, singles)


@pytest.mark.cuda
@pytest.mark.parametrize("red", REDUCERS, ids=REDUCER_IDS)
def test_reducer_mc_match_equals_one_launch_a_round(scene, red):
    args = (*_match_args(scene, 16, 6, 1, True), red)
    got = kernels.mc_match(*args)
    want = kernels.mc_match_rounds(*args)
    twin = kernels.mc_match_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # bit for bit
    torch.testing.assert_close(got[2][:1], twin[2][:1], atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("red", REDUCERS, ids=REDUCER_IDS)
def test_reducer_particle_matches_equal_single_launches(scene, red):
    """``mc_match_batched`` (P = 30, K = 16, 6 rounds: the gmapping preset's
    shape on 120^2 planes) against single ``mc_match`` launches and
    ``mc_match_rounds``; ``mc_match_windows`` against the windows cut out;
    bit for bit."""
    args = (*_particle_args(scene, 30, 16, 6), red)
    got = kernels.mc_match_batched(*args)
    singles = [kernels.mc_match(*(t[m] for t in args[:6]), *args[6:]) for m in range(0, 30, 7)]
    rounds_ = [kernels.mc_match_rounds(*(t[m] for t in args[:6]), *args[6:])
               for m in range(0, 30, 7)]
    for i in range(3):
        assert torch.equal(got[i][::7], torch.stack([s[i] for s in singles]))
        assert torch.equal(got[i][::7], torch.stack([s[i] for s in rounds_]))
    wargs = (*_window_args(scene, 7, 16, 6, 160), red)
    occ, known, row, col = wargs[:4]
    plane = torch.where(gridlib.take_window(known, row, col, 160, 160),
                        gridlib.take_window(occ, row, col, 160, 160), 0.5).contiguous()
    in_place = kernels.mc_match_windows(*wargs)
    cut = kernels.mc_match_batched(plane, *wargs[6:])
    torch.cuda.synchronize()
    for a, b in zip(in_place, cut):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("red", REDUCERS, ids=REDUCER_IDS)
def test_reducer_hill_climb_equals_the_launch_loop(scene, red):
    args = (*refine_case(scene, 360, 2, True, (0.06, 0.03, -0.02)), 0.1, 0.05, 10, 0.5, red)
    got = kernels.hill_climb(*args)
    assert same_bits(got, kernels.hill_climb_rounds(*args))
    plane, pts, beam_w, origin, pose = args[:5]
    planes = torch.stack([plane, plane.flip(0), plane.roll(7, 1)]).contiguous()
    margs = (planes, pts.expand(3, -1, -1).contiguous(), beam_w.expand(3, -1).contiguous(),
             origin.expand(3, -1).contiguous(), pose.expand(3, -1).contiguous(), *args[5:])
    many = kernels.hill_climb(*margs)
    assert same_bits(many, kernels.hill_climb_rounds(*margs))
    assert same_bits([t[0] for t in many], got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["defaults, obstacle", "viny_m3rsm, max", "viny_m3rsm, mean",
                                  "viny_m3rsm, overlap 1.6", "3 maps, obstacle"])
def test_reducer_m3rsm_search_equals_the_level_launches(scene, case, monkeypatch):
    """``M3RSMConfig()`` (the obstacle reducer: its climb on one cell a
    beam) and other reducers in the climb: one launch equals the level and
    score launches bit for bit."""
    import dataclasses

    from slam_constructor_tpu_torch.ops import m3rsm

    base, kind = case.split(", ")
    view, scan, prior, cfg, w = _m3rsm_case(
        scene, {"defaults": "defaults", "viny_m3rsm": "viny_m3rsm"}.get(
            base, "3 maps, the loop matcher"))
    sc = {"obstacle": scoring.ScoringConfig(stride=cfg.scoring.stride),
          "max": scoring.ScoringConfig(reducer="max", window=1, stride=cfg.scoring.stride),
          "mean": scoring.ScoringConfig(reducer="mean", window=2, stride=cfg.scoring.stride),
          "overlap 1.6": scoring.ScoringConfig(reducer="overlap", overlap_extent=1.6,
                                               stride=cfg.scoring.stride)}[kind]
    cfg = m3rsm.M3RSMConfig() if base == "defaults" else dataclasses.replace(cfg, scoring=sc)
    assert base != "defaults" or cfg.scoring.reducer == "obstacle"
    n = kernels.reducer_launch_counts()
    got = m3rsm.m3rsm_match(view, scan, prior, None, cfg, w)
    red = scoring.reducer_of(cfg.scoring).kind
    assert kernels.reducer_launch_counts()[f"m3rsm_search/{red}"] == n[f"m3rsm_search/{red}"] + 1
    monkeypatch.setattr(kernels, "m3rsm_search", kernels.m3rsm_search_levels)
    want = m3rsm.m3rsm_match(view, scan, prior, None, cfg, w)
    torch.cuda.synchronize()
    assert same_bits((got.pose, got.prob, got.trace), (want.pose, want.prob, want.trace))
    assert bool(torch.isfinite(got.pose).all())


@pytest.mark.cuda
def test_reducer_launches_reject_bad_codes(scene):
    view, scan, cand, _ = scene
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap"))
    bad = kernels.Reducer("max", 1)
    object.__setattr__(bad, "radius", -1)  # past the dataclass's own check
    with pytest.raises(RuntimeError):
        kernels.overlap_score(prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale,
                              prep.unknown, bad)


# --- K3: the scan insert with its cell fold --------------------------------------


def _stack(gm, n_p):
    return gridlib.GridMap(cells=gm.cells.expand(n_p, *gm.cells.shape).contiguous(),
                           origin=gm.origin.expand(n_p, 2).contiguous(), scale=gm.scale)


@pytest.fixture(scope="module")
def insert_scene(scene):
    """Maps of the tiny and the viny path after 5 bench scans (inserted by
    the kernel), the 6th scan and its pose."""
    view, _, _, _ = scene
    dev = view.occ.device
    occ, origin, scale = datagen.cecum_world(device=dev)
    poses = datagen.rectangle_trajectory(step=0.2, device=dev)[:6]
    scans, _, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(360, device=dev), rng=0)
    maps = {}
    for name, cfg in (("tiny", tiny.tiny_config(map_size=256)),
                      ("viny", viny.viny_config(map_size=256))):
        gm = init_state(cfg, dev).gm
        for i in range(5):
            gm = raycast.insert_scan(gm, cfg.cell_model, gt[i], scans[i], cfg.beam)
        maps[name] = (cfg, gm)
    return maps, scans[5], gt[5]


def _insert_case(insert_scene, case):
    """(gm, model, pose, scan, beam, q, window) of a named case."""
    maps, scan, pose = insert_scene
    dev = pose.device
    q1 = torch.ones((), device=dev)
    name, _, what = case.partition(":")
    cfg, gm = maps["viny" if name in ("viny", "tbm windows") else "tiny"]
    beam, model = cfg.beam, cfg.cell_model
    if what == "q=0":
        return gm, model, pose, scan, beam, torch.zeros((), device=dev), 0
    if what == "no valid beam":
        scan = LaserScan(scan.ranges, scan.bearings, torch.zeros_like(scan.valid))
    if what == "past max_range":
        beam = dataclasses.replace(beam, max_range=1.0)
    if what == "area, bayes_base":
        beam = dataclasses.replace(beam, occupancy_estimator="area", wall_blur=False)
        model = cells.BayesBaseCell(quality=0.3)
    if what == "off the map":  # a 64^2 map: most samples fall off it
        gm = gridlib.GridMap(cells=gm.cells[96:160, 96:160].contiguous(),
                             origin=gm.origin + 96 * gm.scale, scale=gm.scale)
    if what == "area and blur":  # 360 beams x (9 + 4) samples
        beam = dataclasses.replace(beam, occupancy_estimator="area")
    if what == "band boundary":  # beam 90 runs along the boundary of rows 127 and 128
        pose = torch.stack([pose[0], gm.origin[1] + 128 * gm.scale, -scan.bearings[90]])
    if what in ("above the old cap", "one cell over chunks"):
        # 3,000 beams with the area estimator and the blur: 39,000 occupied
        # samples (the sort took 16,384 keys at most); or 1,024 beams into
        # one endpoint cell, a run of 1,024 samples and more over chunks of 512
        big, spread = (3000, 3.0) if what == "above the old cap" else (1024, 0.0)
        scan = LaserScan(torch.full((big,), 2.0, device=dev),
                         torch.linspace(-spread, spread, big, device=dev) + 0.3,
                         torch.ones(big, dtype=torch.bool, device=dev))
        if what == "above the old cap":
            beam = dataclasses.replace(beam, occupancy_estimator="area")
    if name in ("windows", "tbm windows"):
        g = torch.Generator(device=dev).manual_seed(3)
        poses = pose + torch.randn((6, 3), generator=g, device=dev) * 0.05
        poses[5, 0] = 11.9  # the window clamped at the map's edge (it ends at x = 12.8)
        if what == "every edge":  # clamped at the left, right, bottom and top, two corners
            lo, hi = gm.origin + 0.3, gm.origin + 256 * gm.scale - 0.3
            poses[0, 0], poses[1, 0], poses[2, 1], poses[3, 1] = lo[0], hi[0], lo[1], hi[1]
            poses[4, :2], poses[5, :2] = lo, hi
        n_p = 6
        return (_stack(gm, n_p), model, poses, LaserScan(*(
            t.expand(n_p, -1) for t in (scan.ranges, scan.bearings, scan.valid))), beam, None,
            160 if what != "whole maps" else 0)
    if what == "band boundary":
        return gm, model, pose, scan, beam, q1, 0
    return gm, model, pose, scan, beam, (q1 * 0.5 if what == "q=0.5" else q1), 0


INSERT_CASES = ["tiny", "tiny:q=0", "tiny:q=0.5", "tiny:no valid beam", "tiny:past max_range",
                "tiny:area, bayes_base", "tiny:off the map", "viny", "viny:no valid beam",
                "windows", "windows:whole maps", "tbm windows", "tbm windows:whole maps",
                "tiny:area and blur", "tiny:band boundary", "tiny:above the old cap",
                "tiny:one cell over chunks", "windows:every edge", "tbm windows:every edge"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INSERT_CASES)
def test_scan_insert_equals_the_ordered_sums(insert_scene, case):
    """K3 against its yardstick (the samples summed on the host in sample
    order, the same fold) bit for bit; two launches, the same bits; against
    the twin bit for bit but in cells whose occupied run the card's
    index_put_ may sum in another order (32 samples or more)."""
    args = _insert_case(insert_scene, case)
    gm = args[0]
    before = kernels.launch_counts()["scan_insert"]
    got = kernels.scan_insert(*args)
    again = kernels.scan_insert(*args)
    want = kernels.scan_insert_ordered(*args)
    twin = kernels.scan_insert_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["scan_insert"] == before + 2
    assert got.shape == gm.cells.shape and got.data_ptr() != gm.cells.data_ptr()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{int((got != want).any(-1).sum())} cells differ from the ordered sums")
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    differ = (got.view(torch.int32) != twin.view(torch.int32)).any(-1)
    if args[6]:  # windows: the twin's runs are counted in each window
        row, col, _ = gridlib.window_corner(gm.origin, args[2][:, :2], gm.scale, 160, 160,
                                            gm.height, gm.width)
        inside = torch.stack([differ[p, int(row[p]):int(row[p]) + 160,
                                     int(col[p]):int(col[p]) + 160] for p in range(6)])
        assert int(differ.sum()) == int(inside.sum())
        differ = inside
    differ = differ.reshape(-1, *differ.shape[-2:])
    runs = kernels.scan_insert_runs(args[0], args[2], args[3], args[4], args[6])
    assert int((differ & (runs < 32)).sum()) == 0
    rel = ((got - twin).abs() / twin.abs().clamp(min=1e-30)).max()
    # a run of thousands of samples in one cell: the twin's warp-strided sum
    # of n terms parts from the ordered one by up to ~n 2^-24 relative
    big = case in ("tiny:above the old cap", "tiny:one cell over chunks")
    assert float(rel) <= (max(1e-6, float(runs.max()) * 2.0**-24) if big else 1e-6)
    if case.endswith("q=0") or case.endswith("no valid beam"):
        pass
    elif "whole maps" not in case:  # the scan landed (one ray's cells where every beam is one)
        assert int((got != gm.cells).any(-1).sum()) > (10 if "one cell" in case else 100)


@pytest.mark.cuda
def test_scan_insert_rejects_bad_input(insert_scene):
    gm, model, pose, scan, beam, q, _ = _insert_case(insert_scene, "tiny")
    with pytest.raises(ValueError):
        kernels.scan_insert(gm, cells.TBMCell(), pose, scan, beam, q)  # 2 channels, not 5
    with pytest.raises(ValueError):
        kernels.scan_insert(gm, model, pose.cpu(), scan, beam, q)
    with pytest.raises(TypeError):
        kernels.scan_insert(gridlib.GridMap(cells=gm.cells.double(), origin=gm.origin,
                                            scale=gm.scale), model, pose, scan, beam, q)
    with pytest.raises(ValueError):  # a scan without beams
        empty = LaserScan(*(t[:0] for t in (scan.ranges, scan.bearings, scan.valid)))
        kernels.scan_insert(gm, model, pose, empty, beam, q)


@pytest.fixture(scope="module")
def planes_scene(insert_scene):
    """32 keyframe-like scans (the 6 bench scans at jittered poses, every
    7th beam of every 3rd scan invalid) with their poses, on a 256^2 plane's
    origin."""
    maps, _, _ = insert_scene
    cfg, gm = maps["tiny"]
    dev = gm.cells.device
    occ, origin, scale = datagen.cecum_world(device=dev)
    poses = datagen.rectangle_trajectory(step=0.2, device=dev)[:6]
    scans, _, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(360, device=dev), rng=0)
    idx = torch.arange(32, device=dev) % 6
    g = torch.Generator(device=dev).manual_seed(5)
    kf = gt[idx] + torch.randn((32, 3), generator=g, device=dev) * 0.03
    valid = scans.valid[idx] & ~((torch.arange(32, device=dev) % 3 == 0)[:, None]
                                 & (torch.arange(360, device=dev) % 7 == 3))
    return gm, kf, LaserScan(scans.ranges[idx], scans.bearings[idx], valid)


PLANES_CASES = ["a plane a scan", "one plane", "sorted", "unsorted", "polar, a plane a scan",
                "area, unsorted", "32 scans into one plane"]


def _planes_case(planes_scene, case):
    gm, kf, scans = planes_scene
    dev = kf.device
    beam = raycast.BeamConfig(wall_blur=True)
    n = 32 if case == "32 scans into one plane" else 8
    kf, scans = kf[:n], LaserScan(scans.ranges[:n], scans.bearings[:n], scans.valid[:n])
    plane_of, n_planes = {
        "one plane": ([0] * 8, 1), "sorted": ([0, 0, 0, 1, 1, 2, 2, 2], 3),
        "unsorted": ([2, 0, 1, 0, 2, 1, 1, 0], 3), "area, unsorted": ([2, 0, 1, 0, 2, 1, 1, 0], 3),
        "32 scans into one plane": ([0] * 32, 1)}.get(case, (None, None))
    if plane_of is not None:
        plane_of = torch.tensor(plane_of, device=dev)
    if case.startswith("polar"):
        beam = dataclasses.replace(beam, free_impl="polar", wall_blur=False)
    if case.startswith("area"):
        beam = dataclasses.replace(beam, occupancy_estimator="area")
    return gm.origin, gm.height, gm.width, gm.scale, kf, scans, beam, plane_of, n_planes


@pytest.mark.cuda
@pytest.mark.parametrize("case", PLANES_CASES)
def test_scan_planes_equals_the_ordered_sums(planes_scene, case):
    """K3 without the fold against its yardstick (each plane's samples summed
    on the host in scan-major order) bit for bit; two launches the same
    bits; against the twin bit for bit but in cells whose occupied run the
    card's index_put_ may sum in another order (32 samples or more)."""
    args = _planes_case(planes_scene, case)
    before = kernels.launch_counts()["scan_planes"]
    got = kernels.scan_planes(*args)
    again = kernels.scan_planes(*args)
    want = kernels.scan_planes_ordered(*args)
    twin = kernels.scan_planes_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["scan_planes"] == before + 2
    runs = kernels.scan_planes_runs(*args)
    if case == "32 scans into one plane":  # 32 x 360 x (1 + 4) occupied samples in one plane
        assert int(runs.sum()) == 57600
    for g, a, w, t in zip(got, again, want, twin):
        assert g.shape == w.shape == runs.shape and bool(torch.isfinite(g).all())
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (
            f"{int((g != w).sum())} cells differ from the ordered sums")
        assert torch.equal(a.view(torch.int32), g.view(torch.int32))
        differ = g.view(torch.int32) != t.view(torch.int32)
        assert int((differ & (runs < 32)).sum()) == 0
        # a cell's run of n samples summed in another order: ~n 2^-24 relative
        assert float(((g - t).abs() / t.abs().clamp(min=1e-30)).max()) <= max(
            1e-6, float(runs.max()) * 2.0**-24)
    assert int((got[1] > 0).sum()) > 500


# --- K3 over a block pool (pool_touched, pool_insert) --------------------------


@pytest.fixture(scope="module")
def pool_scene():
    """Six bench scans at their poses on 256^2 cells of 0.1 m (8 x 8 tiles
    of 32), and the same at 0.05 m with 16 x 16 tiles (the tiled map's
    scale); the pose of scan 0 moved onto a tile corner (beams along tile
    boundaries) and scan 1 near the table's corner (samples off it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    occ, origin, scale = datagen.cecum_world(device=dev)
    poses = datagen.rectangle_trajectory(step=0.2, device=dev)[:6]
    scans, _, gt = datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(360, device=dev), rng=0)
    return scans, gt


def _pool_case(pool_scene, case):
    """(state, model, poses, scans, beam, touched, q, live kwargs)."""
    from slam_constructor_tpu_torch.ops import blockmap, cow

    scans, gt = pool_scene
    dev = gt.device
    beam = raycast.BeamConfig(max_range=6.0, wall_blur=True,
                              occupancy_estimator="area" if "area" in case else "const")
    poses = gt.clone()
    valid = scans.valid.clone()
    if "no valid beam" in case:
        valid[2] = False
    sc = LaserScan(scans.ranges, scans.bearings, valid)
    q = torch.zeros((), device=dev) if "q=0" in case else None
    if case.startswith("tiled"):
        model = cells.TBMCell()
        cap = 12 if "exhausted" in case else 2048
        bm = blockmap.make_block_map(model, 64, 64, cap, block=32, scale=0.05, device=dev)
        touched = kernels.pool_touched((64, 64), 32, bm.origin, bm.scale, poses[3:4], sc[3:4],
                                       beam, q)
        bm = blockmap.allocate_tiles(bm, touched[0])
        return (bm.pool, bm.table[None], bm.origin, bm.scale, model, poses[3:4], sc[3:4], beam,
                touched, q), {"n_live": bm.n_alloc}
    model = cells.BayesAvgCell()
    st = cow.make_cow_maps(model, 6, 8, 8, 1024, block=32, scale=0.1, device=dev)
    poses[0, :2] = st.origin + 4 * 32 * 0.1  # a tile corner
    poses[0, 2] = 0.0
    poses[1, :2] = st.origin + 0.4
    touched = kernels.pool_touched((8, 8), 32, st.origin, st.scale, poses, sc, beam, q)
    st = cow.prepare_write(st, model, touched)
    st.pool.copy_(torch.rand(st.pool.shape, generator=torch.Generator(device=dev).manual_seed(1),
                             device=dev))
    if "shared" in case:  # a block of particles 4 and 5 that neither touches
        free = int(torch.nonzero(st.refcnt == 0)[0])
        free_tiles = torch.nonzero(~touched[4] & ~touched[5])[0]
        st.tables[4, free_tiles[0], free_tiles[1]] = free
        st.tables[5, free_tiles[0], free_tiles[1]] = free
        st.refcnt[free] = 2
    return (st.pool, st.tables, st.origin, st.scale, model, poses, sc, beam, touched, q), {
        "refcnt": st.refcnt}


POOL_CASES = ("cow", "cow area", "cow shared", "cow no valid beam", "cow q=0", "tiled",
              "tiled exhausted")


@pytest.mark.cuda
@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_insert_equals_the_ordered_sums(pool_scene, case):
    """The pool insert against its yardstick (the kept samples summed on the
    host in order, the same fold) bit for bit on every live slot, twice the
    same bits; the marks against their twin exactly; the twin within 2e-6
    relative (the card's index_put_ sums a run of 32 or more its own way)."""
    args, live = _pool_case(pool_scene, case)
    pool, tables, origin, scale, model, poses, sc, beam, touched, q = args
    want_touched = kernels.pool_touched_ref(tuple(tables.shape[1:]), pool.shape[1], origin,
                                            scale, poses, sc, beam, q)
    assert torch.equal(touched, want_touched)
    before = kernels.launch_counts()["pool_insert"]
    got, again, want, twin = (pool.clone() for _ in range(4))
    kernels.pool_insert(got, *args[1:], **live)
    kernels.pool_insert(again, *args[1:], **live)
    kernels.pool_insert_ordered(want, *args[1:], **live)
    kernels.pool_insert_ref(twin, *args[1:], **live)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pool_insert"] == before + 2
    n = pool.shape[0]
    is_live = live["refcnt"] > 0 if "refcnt" in live else torch.arange(n, device=pool.device) < \
        live["n_live"]
    assert torch.equal(got[is_live].view(torch.int32), want[is_live].view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    assert torch.equal(got[~is_live], pool[~is_live])  # a dead slot is left as it was
    torch.testing.assert_close(got[is_live], twin[is_live], rtol=2e-6, atol=2e-6)


@pytest.mark.cuda
def test_pool_insert_never_falls_back(pool_scene):
    """A CUDA call the kernel cannot take raises; it never runs the twin."""
    args, live = _pool_case(pool_scene, "cow")
    pool = args[0]
    with pytest.raises(ValueError):  # not 16-byte aligned
        flat = torch.empty(pool.numel() + 1, device=pool.device)
        kernels.pool_insert(flat[1:].view(pool.shape), *args[1:], **live)
    with pytest.raises(ValueError):  # 2 channels, not TBM's 5
        kernels.pool_insert(pool, *args[1:4], cells.TBMCell(), *args[5:], **live)
    with pytest.raises(ValueError):  # the live slots named twice
        kernels.pool_insert(pool, *args[1:], refcnt=live["refcnt"],
                            n_live=torch.zeros((), dtype=torch.int32, device=pool.device))
    big = torch.zeros((4, 128, 128, 2), device=pool.device)  # a slot past the shared memory
    with pytest.raises(RuntimeError):
        kernels.pool_insert(big, torch.zeros((6, 2, 2), dtype=torch.int32, device=pool.device),
                            *args[2:8], torch.ones((6, 2, 2), dtype=torch.bool, device=pool.device),
                            None, refcnt=torch.ones(4, dtype=torch.int32, device=pool.device))


def _prepare_case(pool_scene, case):
    """The arguments of a ``pool_prepare`` call (a dict) of one case: the
    copy-on-write state of :func:`_pool_case` before its prepare, or an
    empty one, or the tiled map."""
    from slam_constructor_tpu_torch.ops import blockmap, cow

    scans, gt = pool_scene
    dev = gt.device
    beam = raycast.BeamConfig(max_range=6.0, wall_blur=True)
    poses = gt.clone()
    q = torch.zeros((), device=dev) if "q=0" in case else None
    if case.startswith("tiled"):
        model = cells.TBMCell()
        # 20,480 slots: the table and two lists of the slots pass block 0's
        # shared memory (kPrepCacheBytes)
        cap = 12 if "exhausted" in case else (20480 if "uncached" in case else 2048)
        bm = blockmap.make_block_map(model, 64, 64, cap, block=32, scale=0.05, device=dev)
        return dict(pool=bm.pool, tables=bm.table[None], origin=bm.origin, scale=bm.scale,
                    model=model, poses=poses[3:4], scans=scans[3:4], cfg=beam, q=q,
                    n_alloc=bm.n_alloc)
    model = cells.BayesAvgCell()
    # 16,384 slots: the tables and three lists of the slots pass block 0's
    # shared memory (kPrepCacheBytes), as a pool that has grown does
    cap = 16 if "trap o" in case else (16384 if "uncached" in case else 1024)
    st = cow.make_cow_maps(model, 6, 8, 8, cap, block=32, scale=0.1, device=dev)
    poses[0, :2] = st.origin + 4 * 32 * 0.1  # a tile corner
    poses[0, 2] = 0.0
    poses[1, :2] = st.origin + 0.4
    if "nan" in case:
        poses[2, 0] = float("nan")
    if "steady" in case or "copies" in case or "uncached" in case:  # a step before
        touched = kernels.pool_touched_ref((8, 8), 32, st.origin, st.scale, gt, scans, beam)
        st = cow.prepare_write(st, model, touched)
        st.pool.copy_(torch.rand(st.pool.shape, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(1)))
    if "copies" in case:  # resampled to particle 0: every touched tile is shared
        st.tables = st.tables[:1].expand_as(st.tables).contiguous()
        st.refcnt = cow._counts(st.tables.reshape(-1), st.capacity)
    return dict(pool=st.pool, tables=st.tables, origin=st.origin, scale=st.scale, model=model,
                poses=poses, scans=scans, cfg=beam, q=q, refcnt=st.refcnt, overflow=st.overflow,
                k_max=cow.write_budget(6, 64, 7 if "budget" in case else None))


def _prepare_plain(c):
    """The plain version of the ``pool_prepare`` call ``c`` on its tensors,
    in place: ``cow.prepare_insert_ref`` or ``blockmap.prepare_tiles_ref``."""
    from slam_constructor_tpu_torch.ops import blockmap, cow

    b = c["pool"].shape[1]
    if c.get("refcnt") is not None:
        st = cow.CowBlockMaps(pool=c["pool"], tables=c["tables"], refcnt=c["refcnt"],
                              origin=c["origin"], scale=c["scale"], block=b,
                              overflow=c["overflow"])
        return cow.prepare_insert_ref(st, c["model"], c["poses"], c["scans"], c["cfg"], c["q"],
                                      c["k_max"])
    bm = blockmap.BlockMap(pool=c["pool"], table=c["tables"][0], n_alloc=c["n_alloc"],
                           origin=c["origin"], scale=c["scale"], block=b)
    return blockmap.prepare_tiles_ref(bm, c["poses"], c["scans"], c["cfg"], c["q"])


PREPARE_CASES = ("cow first step", "cow steady", "cow copies", "cow copies nan", "cow trap o",
                 "cow budget", "cow q=0", "cow uncached", "tiled", "tiled exhausted", "tiled q=0",
                 "tiled uncached")


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREPARE_CASES)
def test_pool_prepare_equals_its_plain_version(pool_scene, case):
    """The prepare launch against its plain version (:func:`_prepare_plain`:
    the marks' twin, then ``cow.prepare_write`` or
    ``blockmap.allocate_tiles``, then the work list's twin) bit for bit:
    marks, tables, refcounts, latch or n_alloc, the whole pool, owners and
    the work list; then the insert from its
    work list (the robot's tile in bands) equal to the ordered sums on every
    live slot, twice the same bits, and the list's counters set back."""
    c = _prepare_case(pool_scene, case)
    state = ("pool", "tables", "refcnt", "overflow", "n_alloc")
    got = {k: v.clone() if k in state and v is not None else v for k, v in c.items()}
    want = {k: v.clone() if k in state and v is not None else v for k, v in c.items()}
    before = kernels.launch_counts()["pool_prepare"]
    touched, work = kernels.pool_prepare(**got)
    t_want, w_want = _prepare_plain(want)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pool_prepare"] == before + 1
    assert torch.equal(touched, t_want)
    for k in state:
        if got.get(k) is not None:
            assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                               want[k].reshape(-1).view(torch.uint8)), k
    count = int(work.buf[2])
    assert torch.equal(work.owner, w_want.owner)
    assert torch.equal(work.buf[2:5], w_want.buf[2:5])
    assert torch.equal(work.items[:count], w_want.items[:count])
    if "copies" in case:
        assert int(work.buf[4]) > 0
    if "trap o" in case or "budget" in case:
        assert bool(got["overflow"])
    live = {"refcnt": got["refcnt"]} if got.get("refcnt") is not None else {
        "n_live": got["n_alloc"]}
    args = (got["tables"], got["origin"], got["scale"], got["model"], got["poses"], got["scans"],
            got["cfg"], touched, got["q"])
    a, again, ordered = (got["pool"].clone() for _ in range(3))
    kernels.pool_insert(a, *args, **live, work=work)
    kernels.pool_insert(again, *args, **live, work=work)
    kernels.pool_insert_ordered(ordered, *args, **live)
    torch.cuda.synchronize()
    n = a.shape[0]
    is_live = live["refcnt"] > 0 if "refcnt" in live else torch.arange(n, device=a.device) < \
        live["n_live"]
    assert torch.equal(a[is_live].view(torch.int32), ordered[is_live].view(torch.int32))
    assert torch.equal(again.view(torch.int32), a.view(torch.int32))
    assert torch.equal(a[~is_live], got["pool"][~is_live])
    assert int(work.buf[0]) == 0 and int(work.buf[1]) == 0  # the counters, set back


@pytest.mark.cuda
def test_pool_touched_is_the_prepare_marks(pool_scene):
    """``pool_touched`` (the prepare kernel's marking phase alone) equals
    the prepare's marks and the twin's on every case's scans."""
    for case in PREPARE_CASES:
        c = _prepare_case(pool_scene, case)
        marks = kernels.pool_touched(tuple(c["tables"].shape[1:]), c["pool"].shape[1], c["origin"],
                                     c["scale"], c["poses"], c["scans"], c["cfg"], c["q"])
        twin = kernels.pool_touched_ref(tuple(c["tables"].shape[1:]), c["pool"].shape[1],
                                        c["origin"], c["scale"], c["poses"], c["scans"], c["cfg"],
                                        c["q"])
        touched, _ = kernels.pool_prepare(**c)
        assert torch.equal(marks, twin) and torch.equal(touched, twin), case


@pytest.mark.cuda
def test_pool_prepare_never_falls_back(pool_scene):
    """A CUDA call the prepare or the insert cannot take raises, and a
    prepare on the card calls none of the plain versions."""
    from slam_constructor_tpu_torch.ops import blockmap, cow

    c = _prepare_case(pool_scene, "cow steady")
    with pytest.raises(ValueError):  # the live slots named twice
        kernels.pool_prepare(**dict(c, n_alloc=torch.zeros((), dtype=torch.int32,
                                                           device=c["pool"].device)))
    with pytest.raises(ValueError):  # more table entries than a launch marks
        kernels.pool_touched((600, 600), 32, c["origin"], c["scale"], c["poses"], c["scans"],
                             c["cfg"])
    touched, work = kernels.pool_prepare(**c)
    with pytest.raises(ValueError):  # a work list for other tables
        kernels.pool_insert(c["pool"], c["tables"][:3], c["origin"], c["scale"], c["model"],
                            c["poses"][:3], c["scans"][:3], c["cfg"], touched[:3],
                            refcnt=c["refcnt"], work=work)
    plain = (cow.prepare_insert_ref, kernels.pool_touched_ref, kernels.pool_work_ref,
             cow.prepare_write, blockmap.allocate_tiles)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    saved = [(m, f.__name__) for m, f in zip((cow, kernels, kernels, cow, blockmap), plain)]
    cases = [_prepare_case(pool_scene, case) for case in ("cow copies", "tiled")]
    try:
        for m, name in saved:
            setattr(m, name, refuse)
        for case in cases:
            kernels.pool_prepare(**case)
    finally:
        for (m, name), f in zip(saved, plain):
            setattr(m, name, f)
    torch.cuda.synchronize()


# --- the pose gradient and the gradient refine at every reducer, over M maps -------

#: the reducers of the scoring kernels and the bilinear one
GRAD_REDUCERS = [kernels.BILINEAR, *REDUCERS]
GRAD_IDS = ["bilinear", *REDUCER_IDS]


@pytest.mark.cuda
@pytest.mark.parametrize("red", GRAD_REDUCERS, ids=GRAD_IDS)
def test_reducer_score_grad_matches_twin_and_single_launches(scene, red):
    """``overlap_score_grad`` with a reducer: the score with
    ``overlap_score``'s bits (and within 2e-6 of the twin), the gradient
    within 1e-5 x max(1, |g|) of its twin on the beams clear of the
    reducer's kinks (exactly 0 for the piecewise-constant reducers); over M
    maps each map's rows equal a single-map launch bit for bit."""
    view, scan, _, g = scene
    w = torch.rand((360,), generator=g, device=scan.ranges.device)
    prep = scoring.prepare(view, scan, scoring.ScoringConfig(reducer="overlap", stride=2), w)
    poses = _wide(scene, 16)
    args = (prep.plane, poses, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown, red)
    n = kernels.reducer_launch_counts()[f"overlap_score_grad/{red.kind}"]
    score, _ = kernels.overlap_score_grad(*args)
    assert kernels.reducer_launch_counts()[f"overlap_score_grad/{red.kind}"] == n + 1
    assert torch.equal(score, kernels.overlap_score(*args))
    torch.testing.assert_close(score, kernels.overlap_score_grad_ref(*args)[0], atol=ATOL,
                               rtol=0)
    clear = kernels.clear_of_kinks(poses, prep.pts, prep.origin, prep.scale, 1e-4, red)
    masked = (*args[:3], (prep.beam_w * clear).contiguous(), *args[4:])
    _, grad = kernels.overlap_score_grad(*masked)
    _, want_g = kernels.overlap_score_grad_ref(*masked)
    tol = 1e-5 * torch.clamp(want_g.norm(dim=1, keepdim=True), min=1.0)
    assert bool(((grad - want_g).abs() <= tol).all()), (grad - want_g).abs().max()
    if red.flat:
        assert torch.equal(grad, torch.zeros_like(grad))
    bprep, bposes = _submap_batch(scene, 5, 9)
    bargs = (bprep.plane, bposes, bprep.pts, bprep.beam_w, bprep.origin, bprep.scale,
             bprep.unknown, red)
    got = kernels.overlap_score_grad(*bargs)
    singles = [kernels.overlap_score_grad(*(t[m] for t in bargs[:5]), *bargs[5:])
               for m in range(5)]
    assert same_bits(got, [torch.stack([s[i] for s in singles]) for i in range(2)])
    assert torch.equal(got[0], kernels.overlap_score_batched(*bargs))


@pytest.mark.cuda
@pytest.mark.parametrize("red", GRAD_REDUCERS, ids=GRAD_IDS)
@pytest.mark.parametrize("n_maps", [0, 5, 30])
def test_reducer_gradient_refine_equals_the_launch_loop(scene, red, n_maps):
    """One map (``n_maps`` 0) or M in one launch, every reducer: bit for bit
    ``gradient_refine_rounds`` (and, for M, single-map launches). A
    piecewise-constant score is one ``overlap_score`` (or
    ``overlap_score_batched``) launch and no ``gradient_refine``."""
    plane, pts, beam_w, origin, pose, scale, unknown = refine_case(scene, 360, 2, True,
                                                                   (0.05, -0.04, 0.02))
    dev = plane.device
    if n_maps:
        g = scene[3]
        planes = torch.stack([plane.flip(0) if m % 2 else plane.roll(m, 1)
                              for m in range(n_maps)])
        poses = pose + torch.randn((n_maps, 3), generator=g, device=dev) * torch.tensor(
            [0.05, 0.05, 0.03], device=dev)
        head = (planes.contiguous(), pts.expand(n_maps, -1, -1).contiguous(),
                beam_w.expand(n_maps, -1).contiguous(), origin.expand(n_maps, -1).contiguous(),
                poses.contiguous())
    else:
        head = (plane, pts, beam_w, origin, pose)
    args = (*head, scale, unknown, 0.03, 0.015, 10, 0.5, red)
    before = kernels.launch_counts()
    got = kernels.gradient_refine(*args)
    after = kernels.launch_counts()
    score_name = "overlap_score_batched" if n_maps else "overlap_score"
    assert after["gradient_refine"] - before["gradient_refine"] == (0 if red.flat else 1)
    assert after[score_name] - before[score_name] == (1 if red.flat else 0)
    want = kernels.gradient_refine_rounds(*args)
    torch.cuda.synchronize()
    lead = (n_maps,) if n_maps else ()
    assert got[0].shape == (*lead, 3) and got[2].shape == (*lead, 10)
    assert same_bits(got, want), (got, want)
    if red.flat:
        assert torch.equal(got[0], args[4])
    if n_maps:
        singles = [kernels.gradient_refine(*(t[m] for t in args[:5]), *args[5:])
                   for m in range(0, n_maps, 4)]
        assert same_bits([t[::4] for t in got],
                         [torch.stack([s[i] for s in singles]) for i in range(3)])


# --- the gradient refine's kernel against its launch loop: radii, extents, ----
# --- maps, iterations and edge cases ------------------------------------------

E15, E2 = kernels.Reducer("overlap", 1, 1.5), kernels.Reducer("overlap", 2, 2.0)
#: (reducer, maps, iterations, beams, edit): edit names a change to the case
REFINE_CASES = {
    "radius 0": (kernels.Reducer("overlap", 0, 1.5), 0, 10, 360, None),
    "radius 1": (E15, 0, 10, 360, None),
    "radius 2": (E2, 0, 10, 360, None),
    "radius 3 (the generic loop)": (kernels.Reducer("overlap", 3, 2.5), 0, 10, 360, None),
    "extent 0.5": (kernels.Reducer("overlap", 1, 0.5), 0, 10, 360, None),
    "extent 1.5 at radius 2": (kernels.Reducer("overlap", 2, 1.5), 0, 10, 360, None),
    "extent 2 at radius 1": (kernels.Reducer("overlap", 1, 2.0), 0, 10, 360, None),
    "extent 2.5": (kernels.Reducer("overlap", 2, 2.5), 0, 10, 360, None),
    "M=1": (E2, 1, 8, 360, None),
    "M=8 bilinear": (kernels.BILINEAR, 8, 24, 360, None),
    "M=30": (E2, 30, 8, 360, None),
    "M=133 (more maps than SMs)": (E15, 133, 4, 360, None),
    "0 iterations": (E15, 0, 0, 360, None),
    "1 iteration": (E2, 0, 1, 360, None),
    "24 iterations": (E15, 0, 24, 360, None),
    "24 iterations bilinear": (kernels.BILINEAR, 0, 24, 360, None),
    "1000 beams (three chunks a pass)": (E2, 0, 8, 1000, None),
    "a NaN weight": (E2, 0, 8, 360, "nan"),
    "no valid beam": (E15, 0, 8, 360, "none valid"),
    "a start pose 0.4 m from the map's edge": (E2, 0, 8, 360, "edge"),
    "long steps that shrink slowly": (E2, 8, 12, 360, "long steps"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_gradient_refine_kernel_equals_its_launch_loop(scene, case):
    """The kernel (a block a map, a thread a beam, warp 0 folding the sums
    and stepping) equals ``gradient_refine_rounds`` bit for bit in pose,
    prob and trace at every radius (the unrolled ones and the loop),
    extent, count of maps and iterations and on the edge cases; M maps also
    equal single-map launches."""
    red, n_maps, iterations, n_beams, edit = REFINE_CASES[case]
    plane, pts, beam_w, origin, pose, scale, unknown = refine_case(scene, n_beams, 2, True,
                                                                   (0.05, -0.04, 0.02))
    dev = plane.device
    steps = (0.04, 0.02, 0.5)
    if edit == "nan":
        beam_w = beam_w.clone()
        beam_w[5] = float("nan")
    elif edit == "none valid":
        beam_w = torch.zeros_like(beam_w)
    elif edit == "edge":
        pose = torch.stack([origin[0] + 0.4, origin[1] + plane.shape[0] * scale / 2, pose[2]])
    elif edit == "long steps":  # candidates up to metres away
        steps = (0.6, 0.3, 0.95)
    head = (plane, pts, beam_w, origin, pose.contiguous())
    if n_maps:
        g = scene[3]
        planes = torch.stack([plane.flip(0) if m % 2 else plane.roll(m, 1)
                              for m in range(n_maps)])
        poses = pose + torch.randn((n_maps, 3), generator=g, device=dev) * torch.tensor(
            [0.05, 0.05, 0.03], device=dev)
        head = (planes.contiguous(), *(t.expand(n_maps, *t.shape).contiguous()
                                       for t in head[1:4]), poses.contiguous())
    args = (*head, scale, unknown, steps[0], steps[1], iterations, steps[2], red)
    before = kernels.launch_counts()["gradient_refine"]
    got = kernels.gradient_refine(*args)
    assert kernels.launch_counts()["gradient_refine"] - before == (0 if red.flat else 1)
    want = kernels.gradient_refine_rounds(*args)
    torch.cuda.synchronize()
    lead = (n_maps,) if n_maps else ()
    assert got[0].shape == (*lead, 3) and got[1].shape == lead
    assert got[2].shape == (*lead, iterations)
    assert same_bits(got, want), (got, want)
    if n_maps:
        picks = range(0, n_maps, max(1, n_maps // 4))
        singles = [kernels.gradient_refine(*(t[m] for t in args[:5]), *args[5:]) for m in picks]
        assert same_bits([t[list(picks)] for t in got],
                         [torch.stack([s[i] for s in singles]) for i in range(3)])
