"""Kernel wrappers and their plain PyTorch twins.

``overlap_score`` scores K candidate poses against a map plane with the
overlap reducer at extent 1. It replaces the TPU kernel
``slam_constructor_tpu/ops/pallas_kernels.py::sample_plane_bilinear`` fused
with the pose transform and weighted mean of ``scoring.score_poses``.
``overlap_score_batched`` is the same kernel over M maps in one launch,
each with its own plane, poses, scan and origin: what the reference gets
from ``vmap`` over submaps when it closes loops, and over particles in the
RBPF's improved proposal and minimumScore gate.

``mc_match`` runs one whole Monte-Carlo match (the first score, every
round's candidates, argmax, keep-if-better and the sigma anneal) in one
launch on a thread-block cluster (``csrc/mc_match.cu``); it is the same TPU
kernel's counterpart on the matcher's path, with the matcher's round loop
folded in. ``mc_match_batched`` is the same kernel over P matches at once,
a cluster each, each with its own plane, scan, prior and noise: the RBPF's
particles, each match with the bits of a single ``mc_match``.
``mc_match_windows`` is the same again, each particle's window of its map
read in place, with no window cut out first. ``mc_match_rounds`` is the same match with ``overlap_score`` launched once
a round, kept as the yardstick the fused kernels must equal bit for bit.

``m3rsm_pyramid`` builds M3RSM's max-pooled occupancy pyramid of one map
or of M maps in one launch (``csrc/m3rsm_pyramid.cu``, K4a), and
``m3rsm_pyramid_update`` refreshes one aligned region of it into new
planes in one launch, gated by a flag on the device. ``m3rsm_search`` runs
B whole M3RSM matches (the branch and bound over the pyramid, then the hill
climb) in one launch, a thread-block cluster a request
(``csrc/m3rsm_match.cu``, K4b); ``m3rsm_search_levels`` is the same match
with ``m3rsm_score_level`` (``csrc/m3rsm_level.cu``: one level's rects for
B requests) launched once a level and ``overlap_score_batched`` once a
hill-climb round, kept as the yardstick ``m3rsm_search`` must equal bit for
bit. The reference compiled all of it with XLA
(``slam_constructor_tpu/ops/m3rsm.py``: ``build_pyramid``,
``update_pyramid``, ``_score_level``, ``m3rsm_match``); no Pallas kernel
stood there but the hill climb's score.

``polar_free_plane`` fills the dense polar free-space weight plane of one
scan. It replaces ``pallas_kernels.py::polar_free_lookup`` together with
the plane math that ``raycast._polar_free_plane_pallas`` computes around
it: the whole of ``raycast._polar_free_plane`` in one launch.

On a CUDA tensor a wrapper launches its hand-written kernel (``csrc/*.cu``)
or raises; it never falls back. On a CPU tensor it runs the plain twin
(``*_ref``), which the CPU tests hold against the reference and which the
card's smoke run holds the kernel to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..device import constant
from . import _build
from . import grid as gridlib
from .geometry import wrap_angle

Tensor = torch.Tensor

#: shared memory a block may use without opting in to more
_MAX_SHARED_BYTES = 48 * 1024

#: kernel launches of each wrapper since the counts were last set to 0. A
#: wrapper adds one where it launches its kernel (CUDA tensors only), under
#: its own name whatever name it was called by.
_LAUNCHES = dict.fromkeys(
    ("overlap_score", "overlap_score_batched", "mc_match", "mc_match_batched",
     "polar_free_plane", "m3rsm_pyramid", "m3rsm_level", "m3rsm_search"), 0
)


def launch_counts() -> dict[str, int]:
    """Kernel launches of each wrapper since :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _axis_taps(pos: Tensor, n: int):
    """Bilinear (overlap, extent 1) taps along one axis: weights of cells
    ``i0`` and ``i0 + 1``, zero where a cell lies off the map, and the
    tap indices clamped into the map."""
    f = torch.floor(pos - 0.5)
    w0 = (f + 1.5) - pos
    ok0 = (f >= 0) & (f < n)
    ok1 = (f + 1.0 >= 0) & (f + 1.0 < n)
    a0 = torch.where(ok0, w0, 0.0)
    a1 = torch.where(ok1, 1.0 - w0, 0.0)
    i0 = torch.clamp(f, 0, n - 1).to(torch.int64)
    i1 = torch.clamp(f + 1.0, 0, n - 1).to(torch.int64)
    return a0, a1, i0, i1


def overlap_score_ref(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
) -> Tensor:
    """Plain PyTorch version of the kernel, with the same arithmetic.

    v f32[H, W] (``where(known, occ, unknown)``), poses f32[K, 3], pts
    f32[R, 2] sensor-frame endpoints, beam_w f32[R] (validity x point
    weights), origin f32[2] -> f32[K] weighted mean of per-beam overlap
    probabilities. With a leading map dimension on every tensor (v
    f32[M, H, W], poses f32[M, K, 3], pts f32[M, R, 2], beam_w f32[M, R],
    origin f32[M, 2]) -> f32[M, K]: map m scores its own poses and scan.
    """
    if v.dim() == 2:
        return overlap_score_ref(
            v[None], poses[None], pts[None], beam_w[None], origin[None], scale, unknown
        )[0]
    n_m, h, w = v.shape
    c = torch.cos(poses[..., 2:3])
    s = torch.sin(poses[..., 2:3])
    qx, qy = pts[:, None, :, 0], pts[:, None, :, 1]  # [M, 1, R]
    wx = poses[..., 0:1] + c * qx - s * qy  # [M, K, R]
    wy = poses[..., 1:2] + s * qx + c * qy
    x = (wx - origin[:, 0, None, None]) / scale
    y = (wy - origin[:, 1, None, None]) / scale
    ay0, ay1, r0, r1 = _axis_taps(y, h)
    ax0, ax1, c0, c1 = _axis_taps(x, w)
    flat = v.reshape(n_m, -1)

    def tap(a, b, r, col):
        got = torch.gather(flat, 1, (r * w + col).reshape(n_m, -1)).reshape(r.shape)
        return torch.where((a != 0) & (b != 0), got, 0.0)

    v00 = tap(ay0, ax0, r0, c0)
    v10 = tap(ay1, ax0, r1, c0)
    v01 = tap(ay0, ax1, r0, c1)
    v11 = tap(ay1, ax1, r1, c1)
    ssum = (ay0 * v00 + ay1 * v10) * ax0 + (ay0 * v01 + ay1 * v11) * ax1
    coverage = (ay0 + ay1) * (ax0 + ax1)
    p = ssum + (1.0 - coverage) * unknown
    bw = beam_w[:, None, :]
    return (p * bw).sum(-1) / torch.clamp(bw.sum(-1), min=1e-9)


@functools.cache
def _overlap_score_fn():
    fn = _build.load().overlap_score_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # v, m, h, w
        ctypes.c_void_p, ctypes.c_int,  # poses, k
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # origin, scale, unknown
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(
    name: str, t: Tensor, shape: tuple, device: torch.device, dtype=torch.float32
) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cell_stride(name: str, occ: Tensor, device: torch.device) -> int:
    """The floats from one cell of ``occ`` f32[..., H, W] to the next:
    1 when it is contiguous, C when it is a channel of contiguous cells
    f32[..., H, W, C] (``BayesAvgCell``'s occupancy); raises otherwise."""
    if occ.dtype != torch.float32:
        raise TypeError(f"occ must be torch.float32, got {occ.dtype}")
    stride = occ.stride(-1)
    want = [stride]
    for n in reversed(occ.shape[1:]):
        want.insert(0, want[0] * n)
    if occ.device != device or stride < 1 or any(
            n > 1 and s != x for n, s, x in zip(occ.shape, occ.stride(), want)):
        raise ValueError(f"{name}: occ must be contiguous or a channel of contiguous cells, "
                         f"got strides {occ.stride()}")
    return stride


#: most maps one launch takes: they lie on the grid's y axis
_MAX_MAPS = 65535


def _overlap_score_launch(name, lead, v, poses, pts, beam_w, origin, scale, unknown):
    """Checks the inputs against the leading shape ``lead`` (``()`` or
    ``(M,)``), launches the kernel and adds one to the count of ``name``;
    returns f32[*lead, K]. Nothing is launched or counted when there is
    nothing to score."""
    if v.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {v.device}")
    h, w = v.shape[-2:]
    k, r = poses.shape[-2], pts.shape[-2]
    _check("v", v, (*lead, h, w), v.device)
    _check("poses", poses, (*lead, k, 3), v.device)
    _check("pts", pts, (*lead, r, 2), v.device)
    _check("beam_w", beam_w, (*lead, r), v.device)
    _check("origin", origin, (*lead, 2), v.device)
    n_m = lead[0] if lead else 1
    if n_m > _MAX_MAPS:
        raise ValueError(f"{name}: {n_m} maps, more than {_MAX_MAPS} a launch")
    out = torch.empty((*lead, k), dtype=torch.float32, device=v.device)
    if k == 0 or n_m == 0:
        return out
    fn = _overlap_score_fn()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(
            v.data_ptr(), n_m, h, w, poses.data_ptr(), k, pts.data_ptr(),
            beam_w.data_ptr(), r, origin.data_ptr(), scale, unknown,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _LAUNCHES[name] += 1
    return out


def overlap_score(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
) -> Tensor:
    """Score poses f32[K, 3] against plane v f32[H, W] -> f32[K]: the
    kernel's M = 1 case.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to the ``overlap_score`` count of
    :func:`launch_counts`. It is counted apart from
    :func:`overlap_score_batched` so that a run through
    :func:`mc_match_rounds` (one launch a round) can be told from the loop
    closer's launches.
    """
    if v.device.type == "cpu":
        return overlap_score_ref(v, poses, pts, beam_w, origin, scale, unknown)
    return _overlap_score_launch(
        "overlap_score", (), v, poses, pts, beam_w, origin, scale, unknown
    )


def overlap_score_batched(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
) -> Tensor:
    """Score, for each of M maps, its own poses and scan: v f32[M, H, W],
    poses f32[M, K, 3], pts f32[M, R, 2], beam_w f32[M, R], origin
    f32[M, 2] -> f32[M, K], in one launch.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for the whole batch, and add one to the
    ``overlap_score_batched`` count of :func:`launch_counts`.
    """
    if v.dim() != 3:
        raise ValueError(f"v has shape {tuple(v.shape)}, expected (M, H, W)")
    if v.device.type == "cpu":
        return overlap_score_ref(v, poses, pts, beam_w, origin, scale, unknown)
    return _overlap_score_launch(
        "overlap_score_batched", (v.shape[0],), v, poses, pts, beam_w, origin, scale, unknown
    )


# --- Monte-Carlo matches -------------------------------------------------------


def mc_match_loop(
    score,
    plane: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
):
    """The match as a Python loop over device tensors with no host sync:
    keep-if-better and the anneal are ``torch.where``. ``score`` has
    ``overlap_score``'s signature and is called once for the first pose and
    once a round. With a leading match dimension on every tensor (plane
    f32[P, H, W], pts f32[P, R, 2], beam_w f32[P, R], origin f32[P, 2],
    init_pose f32[P, 3], noise f32[P, rounds, K, 3]) ``score`` must take it
    too, and every match runs its own state: pose f32[P, 3], prob f32[P],
    trace f32[P, rounds]."""
    dev = init_pose.device
    best_pose = init_pose
    best_prob = score(plane, init_pose[..., None, :].contiguous(), pts, beam_w, origin, scale,
                      unknown)[..., 0]
    # built from fills: assigning a Python float into a CUDA tensor syncs
    sigma = torch.cat([
        torch.full((2,), sigma_xy, dtype=torch.float32, device=dev),
        torch.full((1,), sigma_theta, dtype=torch.float32, device=dev),
    ])
    bad = torch.zeros(init_pose.shape[:-1], dtype=torch.int32, device=dev)
    trace = []
    for r in range(noise.shape[-3]):
        nz = noise[..., r, :, :] * sigma[..., None, :]
        cand = torch.cat(
            [best_pose[..., None, :2] + nz[..., :2], wrap_angle(best_pose[..., None, 2:] + nz[..., 2:])],
            dim=-1,
        )
        probs = score(plane, cand.contiguous(), pts, beam_w, origin, scale, unknown)
        # argmax ties go to the first index, as in the reference
        i = torch.argmax(probs, dim=-1, keepdim=True)
        p_i = probs.gather(-1, i)[..., 0]
        better = p_i > best_prob  # strict, and never true for a NaN score
        won = cand.gather(-2, i[..., None].expand(*i.shape, 3))[..., 0, :]
        best_pose = torch.where(better[..., None], won, best_pose)
        best_prob = torch.where(better, p_i, best_prob)
        bad = torch.where(better, 0, bad + 1)
        anneal = bad >= bad_rounds_before_anneal
        sigma = torch.where(anneal[..., None], sigma * 0.5, sigma)
        bad = torch.where(anneal, 0, bad)
        trace.append(p_i)
    if not trace:
        return best_pose, best_prob, torch.empty(
            (*init_pose.shape[:-1], 0), dtype=torch.float32, device=dev)
    return best_pose, best_prob, torch.stack(trace, dim=-1)


def mc_match_ref(
    plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy, sigma_theta,
    bad_rounds_before_anneal,
):
    """Plain PyTorch version of :func:`mc_match` and, with a leading match
    dimension on every tensor, of :func:`mc_match_batched`: the round loop
    over ``overlap_score_ref``."""
    return mc_match_loop(
        overlap_score_ref, plane, pts, beam_w, origin, init_pose, noise, scale, unknown,
        sigma_xy, sigma_theta, bad_rounds_before_anneal,
    )


def mc_match_rounds(
    plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy, sigma_theta,
    bad_rounds_before_anneal,
):
    """The same match with :func:`overlap_score` called once for the first
    pose and once a round (``1 + rounds`` launches on the card) and the rest
    of a round in PyTorch ops. Nothing on the main path calls it: it is what
    :func:`mc_match` is held to, bit for bit, on the card."""
    return mc_match_loop(
        overlap_score, plane, pts, beam_w, origin, init_pose, noise, scale, unknown,
        sigma_xy, sigma_theta, bad_rounds_before_anneal,
    )


@functools.cache
def _mc_match_fn():
    fn = _build.load().mc_match_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # occ, known, occ's cell stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P, the maps' H and W
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # row, col, h, w
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_void_p,  # origin, init_pose
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # noise, rounds, k
        ctypes.c_float, ctypes.c_float,  # scale, unknown
        ctypes.c_float, ctypes.c_float, ctypes.c_int,  # sigma_xy, sigma_theta, bad rounds
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pose, prob, trace
        ctypes.c_int, ctypes.c_void_p,  # dynamic shared bytes, stream
    ]
    fn.restype = ctypes.c_int
    return fn


#: groups (candidates scored at once) a block of the ``mc_match`` kernel,
#: and the most blocks a cluster (mc_match.cu)
_MC_GROUPS, _MC_MAX_CLUSTER_BLOCKS = 8, 8


def _mc_cluster_blocks(k: int) -> int:
    """Blocks of a match's cluster: ceil(K / 8), at least 1, at most 8."""
    return min(_MC_MAX_CLUSTER_BLOCKS, max(1, -(-k // _MC_GROUPS)))


def _mc_match_shared_bytes(r: int, k: int, rounds: int) -> int:
    """Dynamic shared memory a block of the ``mc_match`` kernel asks for:
    the scan (``pts`` and ``beam_w``, 12 B a beam), two buffers of this
    block's scores, 8 a pass, and the noise (12 B a candidate and round)."""
    passes = -(-k // (_MC_GROUPS * _mc_cluster_blocks(k)))
    return 12 * r + 2 * _MC_GROUPS * passes * 4 + 12 * rounds * k


#: what a block of the ``mc_match`` kernel may ask for: Hopper's 227 KB a
#: block less the kernel's static part (per-thread partial sums, 2 x 1024
#: floats, and the replicated match state)
_MC_MAX_DYNAMIC_SHARED_BYTES = 227 * 1024 - (2 * 1024 * 4 + 64)


def _mc_match_launch(name, lead, occ, window, pts, beam_w, origin, init_pose, noise, scale,
                     unknown, sigma_xy, sigma_theta, bad_rounds_before_anneal):
    """Checks the inputs against the leading shape ``lead`` (``()`` for one
    match, ``(P,)`` for P: occ f32[*lead, H, W], ..., noise f32[*lead,
    rounds, K, 3]), launches the kernel once and adds one to the count of
    ``name``; returns (pose f32[*lead, 3], prob f32[*lead], trace f32[*lead,
    rounds]). ``window`` is None when ``occ`` is the plane itself, else
    (known, row, col, sh, sw): the ``sh x sw`` window at ``row``, ``col``
    of each map ``where(known, occ, unknown)``, read in place."""
    dev = occ.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if occ.dim() != len(lead) + 2 or noise.dim() != len(lead) + 3:
        raise ValueError(f"{name}: plane {tuple(occ.shape)} and noise {tuple(noise.shape)} "
                         f"are not {(*lead, 'H', 'W')} and {(*lead, 'rounds', 'K', 3)}")
    h, w = occ.shape[-2:]
    r = pts.shape[-2]
    rounds, k = noise.shape[-3], noise.shape[-2]
    n_p = lead[0] if lead else 1
    if rounds > 0 and k < 1:
        raise ValueError(f"{name}: a round needs at least one candidate")
    if not 1 <= n_p <= _MAX_MAPS:
        raise ValueError(f"{name}: {n_p} matches, not between 1 and {_MAX_MAPS} a launch")
    shared = _mc_match_shared_bytes(r, k, rounds)
    if shared > _MC_MAX_DYNAMIC_SHARED_BYTES:
        raise ValueError(
            f"{name}: {r} beams and {rounds} rounds of {k} candidates need {shared} B of "
            f"dynamic shared memory, more than {_MC_MAX_DYNAMIC_SHARED_BYTES} B"
        )
    if window is None:
        _check("plane", occ, (*lead, h, w), dev)
        known = row = col = None
        stride, sh, sw = 1, h, w
    else:
        known, row, col, sh, sw = window
        if not (1 <= sh <= h and 1 <= sw <= w):
            raise ValueError(f"{name}: a {sh} x {sw} window of a {h} x {w} map")
        stride = _cell_stride(name, occ, dev)
        _check("known", known, (*lead, h, w), dev, torch.bool)
        _check("row", row, lead, dev, torch.int64)
        _check("col", col, lead, dev, torch.int64)
    _check("pts", pts, (*lead, r, 2), dev)
    _check("beam_w", beam_w, (*lead, r), dev)
    _check("origin", origin, (*lead, 2), dev)
    _check("init_pose", init_pose, (*lead, 3), dev)
    _check("noise", noise, (*lead, rounds, k, 3), dev)
    pose = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    prob = torch.empty(lead, dtype=torch.float32, device=dev)
    trace = torch.empty((*lead, rounds), dtype=torch.float32, device=dev)
    fn = _mc_match_fn()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            occ.data_ptr(), ptr(known), stride, n_p, h, w, ptr(row), ptr(col), sh, sw,
            pts.data_ptr(), beam_w.data_ptr(), r, origin.data_ptr(), init_pose.data_ptr(),
            noise.data_ptr(), rounds, k, scale, unknown, sigma_xy, sigma_theta,
            bad_rounds_before_anneal, pose.data_ptr(), prob.data_ptr(), trace.data_ptr(), shared,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _LAUNCHES[name] += 1
    return pose, prob, trace


def mc_match(
    plane: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
):
    """One Monte-Carlo match -> (pose f32[3], prob f32[], trace f32[rounds]).

    plane f32[H, W] (``where(known, occ, unknown)``), pts f32[R, 2], beam_w
    f32[R], origin f32[2], init_pose f32[3], noise f32[rounds, K, 3]
    standard normals. Round r scores the K candidates ``best + noise[r] *
    sigma`` (theta wrapped), takes the best (ties to the first), keeps it if
    it is strictly better, and halves sigma after
    ``bad_rounds_before_anneal`` rounds without improvement.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once (the P = 1 case of :func:`mc_match_batched`'s
    kernel, with the same bits), and add one to the ``mc_match`` count of
    :func:`launch_counts`.
    """
    args = (plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
            sigma_theta, bad_rounds_before_anneal)
    if plane.device.type == "cpu":
        return mc_match_ref(*args)
    return _mc_match_launch("mc_match", (), plane, None, *args[1:])


def mc_match_batched(
    plane: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
):
    """P Monte-Carlo matches, each on its own plane with its own scan,
    origin, prior and noise, in one launch -> (pose f32[P, 3], prob f32[P],
    trace f32[P, rounds]).

    plane f32[P, H, W], pts f32[P, R, 2], beam_w f32[P, R], origin f32[P,
    2], init_pose f32[P, 3], noise f32[P, rounds, K, 3]: match p gives the
    bits of :func:`mc_match` on the p-th slices. The RBPF's particles, one
    scan matched against each particle's window cut out (the improved
    proposal and the gate) or whole map.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for all P, a cluster a match, and add one to the
    ``mc_match_batched`` count of :func:`launch_counts`.
    """
    args = (plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
            sigma_theta, bad_rounds_before_anneal)
    if plane.dim() != 3:
        raise ValueError(f"plane has shape {tuple(plane.shape)}, expected (P, H, W)")
    if plane.device.type == "cpu":
        return mc_match_ref(*args)
    return _mc_match_launch("mc_match_batched", (plane.shape[0],), plane, None, *args[1:])


def mc_match_windows_ref(occ, known, row, col, sh, sw, pts, beam_w, origin, init_pose, noise,
                         scale, unknown, sigma_xy, sigma_theta, bad_rounds_before_anneal):
    """Plain PyTorch version of :func:`mc_match_windows`: the windows cut
    out (``grid.take_window``), ``where(known, occ, unknown)``, then
    :func:`mc_match_ref`."""
    plane = torch.where(gridlib.take_window(known, row, col, sh, sw),
                        gridlib.take_window(occ, row, col, sh, sw), unknown)
    return mc_match_ref(plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
                        sigma_theta, bad_rounds_before_anneal)


def mc_match_windows(
    occ: Tensor,
    known: Tensor,
    row: Tensor,
    col: Tensor,
    sh: int,
    sw: int,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
):
    """P Monte-Carlo matches, each on an ``sh x sw`` window of its own map
    read in place -> (pose f32[P, 3], prob f32[P], trace f32[P, rounds]).

    occ f32[P, H, W] (contiguous, or a channel of contiguous cells), known
    bool[P, H, W], row, col i64[P] (the window's first cell, as
    ``grid.window_corner`` gives it), origin f32[P, 2] (the window's world
    origin); pts, beam_w, init_pose and noise as for
    :func:`mc_match_batched`. Match p gives the bits of
    :func:`mc_match_batched` on the cut-out plane ``where(known, occ,
    unknown)[p, row:row + sh, col:col + sw]``, without the cut.

    CPU tensors take the plain twin :func:`mc_match_windows_ref`; CUDA
    tensors launch the kernel of :func:`mc_match_batched` on the current
    stream, once for all P, its taps reading each window in place, and add
    one to the ``mc_match_batched`` count of :func:`launch_counts` (the same
    kernel).
    """
    args = (occ, known, row, col, sh, sw, pts, beam_w, origin, init_pose, noise, scale, unknown,
            sigma_xy, sigma_theta, bad_rounds_before_anneal)
    if occ.device.type == "cpu":
        return mc_match_windows_ref(*args)
    if occ.dim() != 3:
        raise ValueError(f"occ has shape {tuple(occ.shape)}, expected (P, H, W)")
    return _mc_match_launch("mc_match_batched", (occ.shape[0],), occ, (known, row, col, sh, sw),
                            *args[6:])


# --- polar free-space fill ----------------------------------------------------


def polar_range_table(ranges: Tensor, valid: Tensor, bearings: Tensor):
    """(rng_eff f32[R], db f32[], full_circle bool[]) of one scan: the
    conservative range of each bearing bin, the bearing spacing, and whether
    the scan goes round the circle. No cell further than ``max(rng_eff)``
    from the sensor can be free."""
    r = ranges.shape[0]
    b0 = bearings[0]
    db = (bearings[-1] - b0) / torch.full_like(b0, float(max(r - 1, 1)))
    db = torch.where(torch.abs(db) < 1e-6, 1.0, db)
    full_circle = torch.abs(db) * r >= 2.0 * math.pi - 1.5 * torch.abs(db)
    # conservative range per bin: min over the beam and its neighbours.
    # Invalid beams give no free evidence themselves (0) but do not cut
    # their neighbours' sectors short (inf).
    rng_inf = torch.where(valid, ranges, math.inf)
    prev_r = torch.where(
        full_circle, torch.roll(rng_inf, 1), torch.cat([rng_inf[:1], rng_inf[:-1]])
    )
    next_r = torch.where(
        full_circle, torch.roll(rng_inf, -1), torch.cat([rng_inf[1:], rng_inf[-1:]])
    )
    rng_eff = torch.where(valid, torch.minimum(ranges, torch.minimum(prev_r, next_r)), 0.0)
    return rng_eff, db, full_circle


def polar_free_plane_ref(
    ranges: Tensor,
    valid: Tensor,
    bearings: Tensor,
    pose: Tensor,
    origin: Tensor,
    h: int,
    w: int,
    scale: float,
    hole_half: float,
    max_range: float,
) -> Tensor:
    """Plain PyTorch version of the kernel, with the same arithmetic in the
    reference's order.

    ranges f32[R], valid bool[R], bearings f32[R] (uniformly spaced), pose
    f32[3], origin f32[2] -> f32[H, W]: for every cell the expected number
    of beams crossing it, ``2 atan(scale / 2d) / spacing``, where the cell
    lies closer than ``min(range of its beam and the two neighbours) -
    hole_half`` and ``max_range`` and inside the field of view, else 0.
    Nothing of the scan is read on the host.

    The two divisions that involve a Python scalar are written tensor by
    tensor: PyTorch turns ``tensor / scalar`` into a product with the
    scalar's reciprocal on the card and ``scalar / tensor`` into
    ``reciprocal * scalar`` everywhere, one rounding more than the IEEE
    division that the reference and the kernel do.
    """
    dev = ranges.device
    r = ranges.shape[0]
    ys = origin[1] + (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * scale
    xs = origin[0] + (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * scale
    dy = ys[:, None] - pose[1]  # [H, 1]
    dx = xs[None, :] - pose[0]  # [1, W]
    d = torch.sqrt(dx * dx + dy * dy)  # [H, W]
    ang = torch.atan2(dy, dx) - pose[2]
    rng_eff, db, full_circle = polar_range_table(ranges, valid, bearings)
    binf = wrap_angle(ang - bearings[0]) / db
    bini = torch.round(binf).to(torch.int64)  # half to even, as jnp.round
    in_fov = (bini >= 0) & (bini <= r - 1)
    ok = in_fov | full_circle
    # remainder takes the divisor's sign: never negative
    bini = torch.where(full_circle, torch.remainder(bini, r), torch.clamp(bini, 0, r - 1))
    cell_range = rng_eff[bini]
    free = ok & (d < cell_range - hole_half) & (d < max_range)
    den = 2.0 * torch.clamp(d, min=scale * 0.5)
    wgt = 2.0 * torch.atan(torch.full_like(den, scale) / den) / torch.abs(db)
    return torch.where(free, wgt, 0.0)


@functools.cache
def _polar_free_fn():
    fn = _build.load().polar_free_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # ranges, valid, bearings, r
        ctypes.c_void_p, ctypes.c_void_p,  # pose, origin
        ctypes.c_int, ctypes.c_int,  # h, w
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # scale, hole_half, max_range
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def polar_free_plane(
    ranges: Tensor,
    valid: Tensor,
    bearings: Tensor,
    pose: Tensor,
    origin: Tensor,
    h: int,
    w: int,
    scale: float,
    hole_half: float,
    max_range: float,
) -> Tensor:
    """Dense polar free-space weights f32[H, W] of one scan seen from
    ``pose`` (see :func:`polar_free_plane_ref`).

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to the ``polar_free_plane`` count of
    :func:`launch_counts`.
    """
    if ranges.device.type == "cpu":
        return polar_free_plane_ref(
            ranges, valid, bearings, pose, origin, h, w, scale, hole_half, max_range
        )
    dev = ranges.device
    if dev.type != "cuda":
        raise ValueError(f"polar_free_plane: unsupported device {dev}")
    r = ranges.shape[0]
    if r < 1 or h < 1 or w < 1:
        raise ValueError(f"polar_free_plane: empty scan or plane (R={r}, H={h}, W={w})")
    # the range table, its maximum, and 32 B of static shared memory
    shared = (r + 1) * 4 + 32
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(
            f"polar_free_plane: {r} beams need {shared} B of shared memory, "
            f"more than {_MAX_SHARED_BYTES} B"
        )
    _check("ranges", ranges, (r,), dev)
    _check("valid", valid, (r,), dev, torch.bool)
    _check("bearings", bearings, (r,), dev)
    _check("pose", pose, (3,), dev)
    _check("origin", origin, (2,), dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    fn = _polar_free_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            ranges.data_ptr(), valid.data_ptr(), bearings.data_ptr(), r,
            pose.data_ptr(), origin.data_ptr(), h, w, scale, hole_half, max_range,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"polar_free_plane kernel launch failed: cudaError_t {err}")
    _LAUNCHES["polar_free_plane"] += 1
    return out


# --- M3RSM: the pyramid (K4a) and the whole match (K4b) ----------------------

#: most levels above the finest that ``m3rsm_pyramid`` builds: a block pools
#: a tile of 2^levels x 2^levels cells in shared memory (m3rsm_pyramid.cu)
M3RSM_MAX_LEVELS = 6


@functools.lru_cache(maxsize=None)
def pyramid_shapes(h: int, w: int, levels: int) -> tuple[tuple[int, int], ...]:
    """(rows, cols) of each level: a level halves the one below, an odd
    side padded first."""
    shapes = [(h, w)]
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return tuple(shapes)


def _max_pool2(p: Tensor, unknown: float) -> Tensor:
    """The 2 x 2 max of ``p`` f32[..., H, W], an odd side padded with
    ``unknown`` first; NaN propagates."""
    h, w = p.shape[-2:]
    p = torch.nn.functional.pad(p, (0, w % 2, 0, h % 2), value=unknown)
    h2, w2 = p.shape[-2] // 2, p.shape[-1] // 2
    return p.reshape(*p.shape[:-2], h2, 2, w2, 2).amax(dim=(-3, -1))


def m3rsm_pyramid_ref(occ: Tensor, known: Tensor, levels: int, unknown: float) -> tuple:
    """Plain PyTorch version of :func:`m3rsm_pyramid`: level 0
    ``where(known, occ, unknown)``, each level above the 2 x 2 max of the
    one below (``_max_pool2``)."""
    planes = [torch.where(known, occ, unknown)]
    for _ in range(levels):
        planes.append(_max_pool2(planes[-1], unknown))
    return tuple(planes)


def _update_region(center_rc: Tensor, size: int, h: int, w: int, step: int):
    """The refreshed region's first cell of each map (rows, cols i64[M]):
    ``clip(center - size // 2, 0, dim - size)`` aligned down to ``step``."""
    r0 = torch.clamp(center_rc[..., 0].to(torch.int64) - size // 2, 0, h - size)
    c0 = torch.clamp(center_rc[..., 1].to(torch.int64) - size // 2, 0, w - size)
    return (r0 // step * step).reshape(-1), (c0 // step * step).reshape(-1)


def m3rsm_pyramid_update_ref(planes: tuple, occ: Tensor, known: Tensor, center_rc: Tensor,
                             size: int, unknown: float, gate: Tensor | None = None) -> tuple:
    """Plain PyTorch version of :func:`m3rsm_pyramid_update`: a copy of the
    planes, the region cut out, pooled level by level and written into the
    copy, map by map (the region's corner is read on the host). ``planes``
    stay as they were."""
    planes = tuple(p.clone() for p in planes)
    levels = len(planes) - 1
    h, w = planes[0].shape[-2:]
    flat = [p.view(-1, *p.shape[-2:]) for p in planes]
    occ = occ.reshape(-1, h, w)
    known = known.reshape(-1, h, w)
    rows, cols = _update_region(center_rc, size, h, w, 1 << levels)
    gates = None if gate is None else gate.reshape(-1)
    for m in range(flat[0].shape[0]):
        if gates is not None and not bool(gates[m] > 0):
            continue
        r0, c0 = int(rows[m]), int(cols[m])
        reg = torch.where(known[m, r0:r0 + size, c0:c0 + size],
                          occ[m, r0:r0 + size, c0:c0 + size], unknown)
        for lvl, plane in enumerate(flat):
            if lvl:
                reg, r0, c0 = _max_pool2(reg, unknown), r0 // 2, c0 // 2
            plane[m, r0:r0 + reg.shape[0], c0:c0 + reg.shape[1]] = reg
    return planes


@functools.lru_cache(maxsize=None)
def _pyramid_layout(lead: tuple, h: int, w: int, levels: int):
    """Each plane's shape (``lead`` + level shape), its floats, its
    contiguous strides and where it starts: a pyramid lives in one buffer,
    level l right after level l - 1."""
    n = math.prod(lead)
    shapes = tuple((*lead, hl, wl) for hl, wl in pyramid_shapes(h, w, levels))
    sizes = tuple(n * hl * wl for hl, wl in pyramid_shapes(h, w, levels))
    strides = tuple(((hl * wl,) if lead else ()) + (wl, 1)
                    for hl, wl in pyramid_shapes(h, w, levels))
    starts = tuple(sum(sizes[:lvl]) for lvl in range(levels + 1))
    return shapes, sizes, strides, starts


def _new_pyramid(lead: tuple, h: int, w: int, levels: int, device) -> tuple[Tensor, tuple]:
    """An empty pyramid's buffer and its planes (views into it), in as few
    ATen calls as a tuple of planes allows: one allocation, a view a plane."""
    shapes, sizes, strides, starts = _pyramid_layout(lead, h, w, levels)
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=device)
    return buf, tuple(buf.as_strided(shape, stride, start)
                      for shape, stride, start in zip(shapes, strides, starts))


def _pyramid_buffer(name: str, planes: tuple, lead: tuple, h: int, w: int,
                    device: torch.device) -> Tensor:
    """The buffer that holds ``planes`` in the kernels' layout: their own
    when they are views into one (a pyramid of :func:`m3rsm_pyramid` or
    :func:`m3rsm_pyramid_update`), else a copy of them laid out so."""
    shapes, _, _, starts = _pyramid_layout(lead, h, w, len(planes) - 1)
    base = planes[0].data_ptr()
    for p, shape, start in zip(planes, shapes, starts):
        if (p.dtype != torch.float32 or p.shape != shape or not p.is_contiguous()
                or p.data_ptr() != base + 4 * start or p.device != device):
            break
    else:
        return planes[0]
    for lvl, (p, shape) in enumerate(zip(planes, shapes)):
        _check(f"{name}: plane {lvl}", p, shape, device)
    return torch.cat([p.reshape(-1) for p in planes])


def _launch(name: str, device: torch.device, call) -> None:
    """Runs ``call(stream)`` (a ctypes launch onto ``device``'s current
    stream, given as an int) with ``device`` the current device, and raises
    if the launch failed. The device is switched only when it is not the
    current one already."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        err = call(torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = call(torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


@functools.cache
def _m3rsm_pyramid_fn():
    fn = _build.load().m3rsm_pyramid_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # occ, its cell stride, known
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # m, h, w, levels
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,  # unknown, out, old
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # center, size, gate
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _m3rsm_pyramid_launch(occ, known, levels, unknown, old=None, center_rc=None, size=0,
                          gate=None):
    """Checks the inputs (occ and known [H, W] or [M, H, W]; ``old``: a
    pyramid of the same leading shape to refresh), launches the kernel once
    into a new pyramid and adds one to the ``m3rsm_pyramid`` count; returns
    the new planes."""
    dev = occ.device
    if dev.type != "cuda":
        raise ValueError(f"m3rsm_pyramid: unsupported device {dev}")
    lead, (h, w) = tuple(occ.shape[:-2]), occ.shape[-2:]
    if len(lead) > 1:
        raise ValueError(f"m3rsm_pyramid: occ {tuple(occ.shape)} is not (H, W) or (M, H, W)")
    if not 0 <= levels <= M3RSM_MAX_LEVELS:
        raise ValueError(f"m3rsm_pyramid: {levels} levels, at most {M3RSM_MAX_LEVELS}")
    n_m = lead[0] if lead else 1
    if not 1 <= n_m <= _MAX_MAPS:
        raise ValueError(f"m3rsm_pyramid: {n_m} maps, not between 1 and {_MAX_MAPS} a launch")
    stride = _cell_stride("m3rsm_pyramid", occ, dev)
    _check("known", known, (*lead, h, w), dev, torch.bool)
    old_ptr = center_ptr = gate_ptr = None
    if old is not None:
        old_ptr = _pyramid_buffer("m3rsm_pyramid_update", old, lead, h, w, dev).data_ptr()
        _check("center_rc", center_rc, (*lead, 2), dev, torch.int64)
        center_ptr = center_rc.data_ptr()
        if gate is not None:
            _check("gate", gate, lead, dev)
            gate_ptr = gate.data_ptr()
    buf, planes = _new_pyramid(lead, h, w, levels, dev)
    fn = _m3rsm_pyramid_fn()
    _launch("m3rsm_pyramid", dev, lambda stream: fn(
        occ.data_ptr(), stride, known.data_ptr(), n_m, h, w, levels, unknown, buf.data_ptr(),
        old_ptr, center_ptr, size, gate_ptr, stream))
    _LAUNCHES["m3rsm_pyramid"] += 1
    return planes


def m3rsm_pyramid(occ: Tensor, known: Tensor, levels: int, unknown: float) -> tuple:
    """M3RSM's max-occupancy pyramid: ``levels + 1`` planes, level 0
    ``where(known, occ, unknown)`` f32[..., H, W], level l f32[..., ceil(H /
    2^l), ceil(W / 2^l)] the 2 x 2 max of level l - 1 with an odd side
    padded with ``unknown``. occ f32[H, W] or f32[M, H, W] (contiguous, or a
    channel of contiguous cells), known bool of the same shape: M maps in
    one launch. On the card the planes are views into one buffer.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to the ``m3rsm_pyramid`` count of
    :func:`launch_counts`.
    """
    if occ.device.type == "cpu":
        return m3rsm_pyramid_ref(occ, known, levels, unknown)
    return _m3rsm_pyramid_launch(occ, known, levels, unknown)


def m3rsm_pyramid_update(planes: tuple, occ: Tensor, known: Tensor, center_rc: Tensor,
                         size: int, unknown: float, gate: Tensor | None = None) -> tuple:
    """``planes`` (a pyramid of :func:`m3rsm_pyramid`'s shapes) refreshed
    over the ``size x size`` region around ``center_rc`` i64[2] (row, col;
    i64[M, 2] for M maps), as new planes: its first cell ``clip(center -
    size // 2, 0, dim - size)`` aligned down to ``2^levels``, as the
    reference's ``update_pyramid`` places it, the rest of every level
    copied. The map's sides and ``size`` must be multiples of
    ``2^levels``. Where ``gate`` f32[] (f32[M]) is given, only the maps
    whose gate is above 0 are refreshed (the others copied); it is read on
    the device. ``planes`` stay as they were.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream (one launch writes every level of the new planes) and
    add one to the ``m3rsm_pyramid`` count of :func:`launch_counts`.
    """
    h, w = planes[0].shape[-2:]
    step = 1 << (len(planes) - 1)
    if h % step or w % step or size % step or not 0 < size <= min(h, w):
        raise ValueError(f"m3rsm_pyramid_update: a {h} x {w} map and a {size}-cell region "
                         f"must be multiples of 2^levels = {step}, the region inside the map")
    if occ.device.type == "cpu":
        return m3rsm_pyramid_update_ref(planes, occ, known, center_rc, size, unknown, gate)
    return _m3rsm_pyramid_launch(occ, known, len(planes) - 1, unknown, planes, center_rc, size,
                                 gate)


def m3rsm_score_level_ref(plane: Tensor, corner: Tensor, level: int, wh: int, ww: int,
                          c0: Tensor, cands: Tensor, mask: Tensor, unknown: float) -> Tensor:
    """Plain PyTorch version of :func:`m3rsm_score_level`: the reference's
    ``_score_level`` (``grid.gather_plane`` on the window, the max over the
    rect's corner cells, the weighted mean) on every request at once."""
    n_b = c0.shape[0]
    dev = c0.device
    b = torch.arange(n_b, device=dev)
    base = c0[b[:, None], cands[..., 0].long()]  # [B, K, R, 2]
    fine = base + cands[:, :, None, 1:]
    e = (1 << level) - 1
    corners = torch.tensor([[0, 0]] if e == 0 else [[0, 0], [0, e], [e, 0], [e, e]],
                           dtype=torch.int32, device=dev)
    idx = (fine[..., None, :] + corners) >> level  # [B, K, R, C, 2]
    # the window is cut out first in the reference: a cell off it reads unknown
    wh = torch.clamp(plane.shape[-2] - (corner[:, 0] >> level), max=wh)
    ww = torch.clamp(plane.shape[-1] - (corner[:, 1] >> level), max=ww)
    shape = (n_b, 1, 1, 1)
    ok = ((idx[..., 0] >= 0) & (idx[..., 0] < wh.reshape(shape))
          & (idx[..., 1] >= 0) & (idx[..., 1] < ww.reshape(shape)))
    rows = torch.clamp(idx[..., 0] + (corner[:, 0] >> level).reshape(shape), 0,
                       plane.shape[-2] - 1)
    cols = torch.clamp(idx[..., 1] + (corner[:, 1] >> level).reshape(shape), 0,
                       plane.shape[-1] - 1)
    pm = b.reshape(shape) if plane.shape[0] > 1 else torch.zeros_like(b).reshape(shape)
    vals = torch.where(ok, plane[pm, rows.long(), cols.long()], unknown).amax(-1)
    return (vals * mask[:, None, :]).sum(-1) / torch.clamp(mask.sum(-1, keepdim=True), min=1e-9)


@functools.cache
def _m3rsm_level_fn():
    fn = _build.load().m3rsm_level_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plane, planes, hp, wp
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # corner, level, wh, ww
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # c0, n_t, r
        ctypes.c_void_p, ctypes.c_int,  # cands, k
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # mask, b, unknown
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def m3rsm_score_level(plane: Tensor, corner: Tensor, level: int, wh: int, ww: int,
                      c0: Tensor, cands: Tensor, mask: Tensor, unknown: float) -> Tensor:
    """Score the rects ``cands`` i32[B, K, 3] (theta index, row and col
    offset in level-0 cells) of B requests at pyramid level ``level`` ->
    f32[B, K]: for every beam the max of the level plane over the rect's
    corner cells ``(c0[b, t] + (ty, tx) + d) >> level``, then the
    ``mask``-weighted mean over the beams.

    plane f32[1, Hp, Wp] (shared by the requests) or f32[B, Hp, Wp], read in
    place; corner i32[B, 2] the level-0 cell at which request b's window
    starts (``corner >> level`` at this level) and ``wh x ww`` its extent at
    this level: a cell off the window reads ``unknown``; c0 i32[B, T, R, 2]
    the endpoint cells (row, col) at each theta, relative to the window;
    mask f32[B, R].

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for all B, and add one to the ``m3rsm_level``
    count of :func:`launch_counts`. The match's main path does not call
    it: :func:`m3rsm_search_levels` does, as the yardstick of
    :func:`m3rsm_search`.
    """
    if plane.device.type == "cpu":
        return m3rsm_score_level_ref(plane, corner, level, wh, ww, c0, cands, mask, unknown)
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"m3rsm_score_level: unsupported device {dev}")
    n_b, n_t, r = c0.shape[:3]
    k = cands.shape[1]
    n_p, hp, wp = plane.shape
    if n_p not in (1, n_b) or not 1 <= n_b <= _MAX_MAPS:
        raise ValueError(f"m3rsm_score_level: {n_p} planes for {n_b} requests")
    _check("plane", plane, (n_p, hp, wp), dev)
    _check("corner", corner, (n_b, 2), dev, torch.int32)
    _check("c0", c0, (n_b, n_t, r, 2), dev, torch.int32)
    _check("cands", cands, (n_b, k, 3), dev, torch.int32)
    _check("mask", mask, (n_b, r), dev)
    out = torch.empty((n_b, k), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    fn = _m3rsm_level_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(plane.data_ptr(), n_p, hp, wp, corner.data_ptr(), level, wh, ww, c0.data_ptr(),
                 n_t, r, cands.data_ptr(), k, mask.data_ptr(), n_b, unknown, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"m3rsm_score_level kernel launch failed: cudaError_t {err}")
    _LAUNCHES["m3rsm_level"] += 1
    return out


#: the six axis steps of a hill-climbing round, in the reference's order
HILL_CLIMB_STEPS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def hill_climb_loop(score, plane, pts, beam_w, origin, pose, scale, unknown, step_xy,
                    step_theta, iterations, shrink):
    """The hill climb as a Python loop over device tensors with no host
    sync: each round scores the six poses one step along each axis (theta
    wrapped), moves to the best (ties to the first) if it is strictly
    better, else multiplies every step by ``shrink``. ``score`` has
    ``overlap_score``'s signature and is called once for the first pose and
    once a round. With a leading map dimension on every tensor (plane
    f32[M, H, W], pts f32[M, R, 2], beam_w f32[M, R], origin f32[M, 2], pose
    f32[M, 3]) ``score`` must take it too: pose f32[M, 3], prob f32[M],
    trace f32[M, iterations]."""
    dev = pose.device
    prob = score(plane, pose[..., None, :].contiguous(), pts, beam_w, origin, scale,
                 unknown)[..., 0]
    units = constant(HILL_CLIMB_STEPS, torch.float32, dev)
    steps = constant((step_xy, step_xy, step_theta), torch.float32, dev)
    steps = steps.expand(*pose.shape[:-1], 3)
    trace = []
    for _ in range(iterations):
        cand = pose[..., None, :] + units * steps[..., None, :]
        cand = torch.cat([cand[..., :2], wrap_angle(cand[..., 2:])], dim=-1)
        probs = score(plane, cand.contiguous(), pts, beam_w, origin, scale, unknown)
        i = torch.argmax(probs, dim=-1, keepdim=True)  # ties -> first index
        p_i = probs.gather(-1, i)[..., 0]
        better = p_i > prob
        won = cand.gather(-2, i[..., None].expand(*i.shape, 3))[..., 0, :]
        pose = torch.where(better[..., None], won, pose)
        prob = torch.where(better, p_i, prob)
        steps = torch.where(better[..., None], steps, steps * shrink)
        trace.append(prob)
    trace = (torch.stack(trace, dim=-1) if trace
             else torch.empty((*pose.shape[:-1], 0), dtype=torch.float32, device=dev))
    return pose, prob, trace


@dataclasses.dataclass
class M3RSMSearch:
    """Everything one M3RSM match of B requests reads: the branch and bound
    over a max-occupancy pyramid, then the hill climb.

    The maps: ``planes`` the pyramid, levels + 1 planes f32[Hl, Wl] (one
    map, shared by the requests) or f32[B, Hl, Wl] (a map a request), as
    ``m3rsm_pyramid`` gives them; ``occ`` f32 (contiguous, or a channel of
    contiguous cells) and ``known`` bool of the planes' leading shape and
    level-0 size; ``origin`` f32[B, 2] the maps' world origins. ``window``:
    the side (a multiple of 2^levels) of each request's prior-centred
    window, aligned to 2^levels and clipped into the map (0: the whole map);
    every level is read on its window (a cell off it reads ``unknown``), the
    hill climb on its level-0 window.

    The requests: ``pts`` f32[B, R, 2] every beam's endpoint in the sensor
    frame, ``mask`` f32[B, R] the level scores' beam weights (zero off every
    ``stride``-th beam: the hill climb scores beams ``::stride`` with these
    weights, as ``scoring.prepare`` gives them); ``prior`` f32[B, 3];
    ``top`` i32[K0, 3] the top level's rects (theta index, row and col
    offset); ``thetas`` f32[T]; ``beam_width`` rects kept a level;
    ``iterations`` hill-climb rounds (0: none) with the steps ``step_xy``,
    ``step_theta`` and ``shrink``."""

    planes: tuple
    occ: Tensor
    known: Tensor
    origin: Tensor
    window: int
    pts: Tensor
    mask: Tensor
    stride: int
    prior: Tensor
    top: Tensor
    thetas: Tensor
    scale: float
    beam_width: int
    unknown: float
    step_xy: float
    step_theta: float
    iterations: int
    shrink: float = 0.5


def m3rsm_frontiers(k0: int, beam_width: int, levels: int) -> list[int]:
    """Rects the search scores at each level, top first: the top level's
    ``k0``, then four children of each of the best ``min(beam_width, K)``."""
    ks = [k0]
    for _ in range(levels):
        ks.append(4 * min(beam_width, ks[-1]))
    return ks


def m3rsm_tiebreak(cands: Tensor, n_theta: int) -> Tensor:
    """-1e-6 x (|ty| + |tx| + |t - n_theta // 2|): between equal scores the
    rect nearest the prior wins (a flat, unmapped region must not pull the
    pose to the window's corner)."""
    d = (cands[..., 1].abs() + cands[..., 2].abs() + (cands[..., 0] - n_theta // 2).abs())
    return d.to(torch.float32) * -1e-6


def m3rsm_ranks_ref(scores: Tensor) -> Tensor:
    """Each score's place in the stable descending sort of its row, as the
    ``m3rsm_search`` kernel selects the frontier: scores f32[B, K] -> i64[B,
    K], the count of scores that come before it (a larger order key, or an
    equal key at a lower index). The key orders NaN first (every NaN
    alike) and -0.0 as 0.0, as ``torch.sort(descending=True,
    stable=True)`` does."""
    bits = torch.where(scores == 0, 0.0, scores).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits | 0x80000000)
    key = torch.where(torch.isnan(scores), 0xFFFFFFFF, key)
    k = scores.shape[-1]
    idx = torch.arange(k, device=scores.device)
    before = (key[..., None, :] > key[..., :, None]) | (
        (key[..., None, :] == key[..., :, None]) & (idx[None, :] < idx[:, None]))
    return before.sum(-1)


def m3rsm_window_cells(s: M3RSMSearch):
    """The search's geometry, in the reference's f32 arithmetic (the
    kernel computes the same values itself): each request's window, its
    first level-0 cell ``corner`` i32[B, 2] (row, col) and extent (rows,
    cols), its world ``origin`` f32[B, 2], and ``c0`` i32[B, T, R, 2] every
    theta's endpoint cells (row, col) at zero translation, relative to the
    window."""
    n_b = s.prior.shape[0]
    h0, w0 = s.occ.shape[-2:]
    step_top = 1 << (len(s.planes) - 1)
    origin = s.origin.expand(n_b, 2)
    poses = s.prior
    if s.window > 0:
        side = s.window
        rel = (poses[:, :2] - origin) / torch.full_like(origin, s.scale)
        cell = torch.floor(rel).to(torch.int32)
        c0w = torch.clamp(cell[:, 0] - side // 2, 0, w0 - side) // step_top * step_top
        r0w = torch.clamp(cell[:, 1] - side // 2, 0, h0 - side) // step_top * step_top
        corner = torch.stack([r0w, c0w], dim=-1)
        origin = origin + torch.stack([c0w, r0w], dim=-1).to(torch.float32) * s.scale
        extent = (side, side)
    else:
        corner = torch.zeros((n_b, 2), dtype=torch.int32, device=poses.device)
        extent = (h0, w0)
    ang = poses[:, 2:3] + s.thetas  # [B, T]
    c, s_ = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px, py = s.pts[:, None, :, 0], s.pts[:, None, :, 1]
    ex = (poses[:, 0, None, None] + c * px) - s_ * py  # [B, T, R]
    ey = (poses[:, 1, None, None] + s_ * px) + c * py
    scale_t = torch.full_like(ex, s.scale)
    rel_x = (ex - origin[:, 0, None, None]) / scale_t
    rel_y = (ey - origin[:, 1, None, None]) / scale_t
    c0 = torch.stack([torch.floor(rel_y).to(torch.int32), torch.floor(rel_x).to(torch.int32)],
                     dim=-1).contiguous()
    return corner, extent, origin, c0


def m3rsm_search_loop(score_level, score, s: M3RSMSearch):
    """The match as a Python loop over device tensors with no host sync:
    the window and endpoint cells (:func:`m3rsm_window_cells`), the top
    level's rects scored with ``score_level`` (``m3rsm_score_level``'s
    signature) plus the tie-break, then level by level the best
    ``beam_width`` by a stable descending sort (equal scores keep index
    order, as the reference's ``top_k``), their children scored one level
    down; the argmax of level 0 (ties to the first) and its pose; then
    :func:`hill_climb_loop` with ``score`` (``overlap_score``'s signature,
    called with the leading request dimension) on the level-0 window cut
    out. Returns pose f32[B, 3], prob f32[B], trace f32[B, iterations]."""
    n_b = s.prior.shape[0]
    n_t = s.thetas.shape[0]
    levels = len(s.planes) - 1
    dev = s.prior.device
    planes = [p if p.dim() == 3 else p[None] for p in s.planes]
    corner, (wh, ww), origin, c0 = m3rsm_window_cells(s)
    mask = s.mask.contiguous()

    def level_scores(level, cands):
        side = 1 << level
        return score_level(planes[level], corner, level, -(-wh // side), -(-ww // side), c0,
                           cands, mask, s.unknown) + m3rsm_tiebreak(cands, n_t)

    cands = s.top.expand(n_b, -1, 3).contiguous()
    scores = level_scores(levels, cands)
    for level in range(levels - 1, -1, -1):
        # keep the best beam_width rects, split each into its 4 children
        take_n = min(s.beam_width, cands.shape[1])
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :take_n]
        parents = torch.gather(cands, 1, order[..., None].expand(-1, -1, 3))
        child = constant(((0, 0, 0), (0, 1 << level, 0), (0, 0, 1 << level),
                          (0, 1 << level, 1 << level)), torch.int32, dev)
        cands = (parents[:, :, None, :] + child).reshape(n_b, -1, 3)
        scores = level_scores(level, cands)

    best = torch.argmax(scores, dim=-1, keepdim=True)  # ties -> first index
    win = torch.gather(cands, 1, best[..., None].expand(-1, -1, 3))[:, 0]  # [B, 3]
    pose = torch.stack([
        s.prior[:, 0] + win[:, 2].to(torch.float32) * s.scale,
        s.prior[:, 1] + win[:, 1].to(torch.float32) * s.scale,
        wrap_angle(s.prior[:, 2] + s.thetas[win[:, 0].long()]),
    ], dim=-1)
    prob = torch.gather(scores, 1, best)[:, 0]
    if s.iterations == 0:
        return pose, prob, torch.empty((n_b, 0), dtype=torch.float32, device=dev)
    occ = s.occ if s.occ.dim() == 3 else s.occ[None]
    known = s.known if s.known.dim() == 3 else s.known[None]
    if occ.shape[0] != n_b:  # B requests on one map
        occ, known = occ.expand(n_b, -1, -1), known.expand(n_b, -1, -1)
    row, col = corner[:, 0].long(), corner[:, 1].long()
    plane = torch.where(gridlib.take_window(known, row, col, wh, ww),
                        gridlib.take_window(occ, row, col, wh, ww), s.unknown).contiguous()
    pts = s.pts[:, ::s.stride].contiguous()
    beam_w = s.mask[:, ::s.stride].contiguous()
    return hill_climb_loop(score, plane, pts, beam_w, origin.contiguous(), pose, s.scale,
                           s.unknown, s.step_xy, s.step_theta, s.iterations, s.shrink)


def m3rsm_search_ref(s: M3RSMSearch):
    """Plain PyTorch version of :func:`m3rsm_search`: the loop over the
    level score's and the overlap score's plain twins."""
    return m3rsm_search_loop(m3rsm_score_level_ref, overlap_score_ref, s)


def m3rsm_search_levels(s: M3RSMSearch):
    """The same match with :func:`m3rsm_score_level` launched once a level
    and :func:`overlap_score_batched` once a hill-climb round, the rest in
    PyTorch ops between them. Nothing on a main path calls it: it is what
    :func:`m3rsm_search` is held to, bit for bit, on the card."""
    return m3rsm_search_loop(m3rsm_score_level, overlap_score_batched, s)


@functools.lru_cache(maxsize=None)
def _m3rsm_search_shared(index: int, *sizes: int) -> tuple[int, int]:
    """The dynamic shared memory a launch of the ``m3rsm_search`` kernel
    with these sizes (h, w, window, levels, n_t, r, stride, iterations,
    k_max) asks for, and what a block of it may ask for on card ``index``,
    in bytes, as ``m3rsm_match.cu`` lays its shared memory out."""
    fn = _build.load().m3rsm_match_shared_bytes
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)] * 2
    fn.restype = ctypes.c_int
    need, cap = ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(index):
        err = fn(*sizes, ctypes.byref(need), ctypes.byref(cap))
    if err != 0:
        raise RuntimeError(f"m3rsm_search: shared memory query failed: cudaError_t {err}")
    return need.value, cap.value


@functools.cache
def _m3rsm_search_fn():
    fn = _build.load().m3rsm_match_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pyramid
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # occ, known, occ's cell stride
        ctypes.c_void_p, ctypes.c_int,  # origin, window
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # pts, mask, r, stride
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # prior, b, top, k0
        ctypes.c_void_p, ctypes.c_int,  # thetas, n_t
        ctypes.c_int, ctypes.c_float, ctypes.c_float,  # beam width, scale, unknown
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # steps, shrink, iterations
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pose, prob, trace
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # k_max, dynamic shared bytes, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _m3rsm_search_launch(s: M3RSMSearch):
    """Checks the inputs, launches the kernel once for all B requests and
    adds one to the ``m3rsm_search`` count."""
    dev = s.prior.device
    if dev.type != "cuda":
        raise ValueError(f"m3rsm_search: unsupported device {dev}")
    occ = s.occ
    lead, (h, w) = tuple(occ.shape[:-2]), occ.shape[-2:]
    n_b = s.prior.shape[0]
    n_p = lead[0] if lead else 1
    levels = len(s.planes) - 1
    n_t, r, k0 = s.thetas.shape[0], s.mask.shape[-1], s.top.shape[0]
    if len(lead) > 1 or n_p not in (1, n_b) or not 1 <= n_b <= _MAX_MAPS:
        raise ValueError(f"m3rsm_search: maps {tuple(occ.shape)} for {n_b} requests")
    step = 1 << levels
    if (not 0 <= levels <= 8 or k0 < 1 or s.beam_width < 1 or s.stride < 1
            or s.window < 0 or s.window % step or s.window > min(h, w)
            or (s.window and (h % step or w % step))):
        raise ValueError(f"m3rsm_search: {levels} levels, a {s.window}-cell window of {h} x {w}, "
                         f"{k0} top rects, beam width {s.beam_width}, stride {s.stride}")
    k_max = max(m3rsm_frontiers(k0, s.beam_width, levels))
    index = torch._C._cuda_getDevice() if dev.index is None else dev.index
    shared, cap = _m3rsm_search_shared(index, h, w, s.window, levels, n_t, r, s.stride,
                                       s.iterations, k_max)
    if shared > cap:
        raise ValueError(f"m3rsm_search: {n_t} thetas, {r} beams and a frontier of {k_max} rects "
                         f"need {shared} B of shared memory a block, more than the kernel's cap "
                         f"of {cap} B on this card")
    stride = _cell_stride("m3rsm_search", occ, dev)
    _check("known", s.known, (*lead, h, w), dev, torch.bool)
    pyramid = _pyramid_buffer("m3rsm_search", s.planes, lead, h, w, dev)
    _check("origin", s.origin, (n_b, 2), dev)
    _check("pts", s.pts, (n_b, r, 2), dev)
    _check("mask", s.mask, (n_b, r), dev)
    _check("prior", s.prior, (n_b, 3), dev)
    _check("top", s.top, (k0, 3), dev, torch.int32)
    _check("thetas", s.thetas, (n_t,), dev)
    pose = torch.empty((n_b, 3), dtype=torch.float32, device=dev)
    prob = torch.empty((n_b,), dtype=torch.float32, device=dev)
    trace = torch.empty((n_b, s.iterations), dtype=torch.float32, device=dev)
    fn = _m3rsm_search_fn()
    _launch("m3rsm_search", dev, lambda stream: fn(
        pyramid.data_ptr(), n_p, h, w, levels, occ.data_ptr(), s.known.data_ptr(), stride,
        s.origin.data_ptr(), s.window, s.pts.data_ptr(), s.mask.data_ptr(), r, s.stride,
        s.prior.data_ptr(), n_b, s.top.data_ptr(), k0, s.thetas.data_ptr(), n_t, s.beam_width,
        s.scale, s.unknown, s.step_xy, s.step_theta, s.shrink, s.iterations, pose.data_ptr(),
        prob.data_ptr(), trace.data_ptr(), k_max, shared, stream))
    _LAUNCHES["m3rsm_search"] += 1
    return pose, prob, trace


def m3rsm_search(s: M3RSMSearch):
    """B whole M3RSM matches (see :class:`M3RSMSearch`) -> (pose f32[B, 3],
    prob f32[B], trace f32[B, iterations]): the branch and bound, its
    winner's pose and score, then the hill climb (prob and trace its own).

    CPU tensors take the plain twin :func:`m3rsm_search_ref`; CUDA tensors
    launch the kernel on the current stream, once for all B (a cluster a
    request), with the bits of :func:`m3rsm_search_levels`, and add one to
    the ``m3rsm_search`` count of :func:`launch_counts`. Raises where the
    frontier, the beams and the thetas do not fit a block's shared memory.
    """
    if s.prior.device.type == "cpu":
        return m3rsm_search_ref(s)
    return _m3rsm_search_launch(s)
