"""Kernel wrappers and their plain PyTorch twins.

``overlap_score`` scores K candidate poses against a map plane with the
overlap reducer at extent 1. It replaces the TPU kernel
``slam_constructor_tpu/ops/pallas_kernels.py::sample_plane_bilinear`` fused
with the pose transform and weighted mean of ``scoring.score_poses``.
``overlap_score_batched`` is the same kernel over M maps in one launch,
each with its own plane, poses, scan and origin: what the reference gets
from ``vmap`` over submaps when it closes loops.

``mc_match`` runs one whole Monte-Carlo match (the first score, every
round's candidates, argmax, keep-if-better and the sigma anneal) in one
launch on a thread-block cluster; it is the same TPU kernel's counterpart
on the matcher's path, with the matcher's round loop folded in.
``mc_match_batched`` is the same kernel over P matches at once, a cluster
each, each with its own plane, scan, prior and noise: the RBPF's particles
(``mc_match`` is its P = 1 case, with the same bits).
``mc_match_rounds`` is the same match with ``overlap_score`` launched once
a round, kept as the yardstick the fused kernel must equal bit for bit.

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
import functools
import math

import torch

from . import _build
from .geometry import wrap_angle

Tensor = torch.Tensor

#: shared memory a block may use without opting in to more
_MAX_SHARED_BYTES = 48 * 1024

#: kernel launches of each wrapper since the counts were last set to 0. A
#: wrapper adds one where it launches its kernel (CUDA tensors only), under
#: its own name whatever name it was called by.
_LAUNCHES = dict.fromkeys(
    ("overlap_score", "overlap_score_batched", "mc_match", "mc_match_batched",
     "polar_free_plane"), 0
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
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plane, P, h, w
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


def _mc_match_launch(name, lead, plane, pts, beam_w, origin, init_pose, noise, scale, unknown,
                     sigma_xy, sigma_theta, bad_rounds_before_anneal):
    """Checks the inputs against the leading shape ``lead`` (``()`` for one
    match, ``(P,)`` for P: plane f32[*lead, H, W], ..., noise f32[*lead,
    rounds, K, 3]), launches the kernel once and adds one to the count of
    ``name``; returns (pose f32[*lead, 3], prob f32[*lead], trace f32[*lead,
    rounds])."""
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if plane.dim() != len(lead) + 2 or noise.dim() != len(lead) + 3:
        raise ValueError(f"{name}: plane {tuple(plane.shape)} and noise {tuple(noise.shape)} "
                         f"are not {(*lead, 'H', 'W')} and {(*lead, 'rounds', 'K', 3)}")
    h, w = plane.shape[-2:]
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
    _check("plane", plane, (*lead, h, w), dev)
    _check("pts", pts, (*lead, r, 2), dev)
    _check("beam_w", beam_w, (*lead, r), dev)
    _check("origin", origin, (*lead, 2), dev)
    _check("init_pose", init_pose, (*lead, 3), dev)
    _check("noise", noise, (*lead, rounds, k, 3), dev)
    pose = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    prob = torch.empty(lead, dtype=torch.float32, device=dev)
    trace = torch.empty((*lead, rounds), dtype=torch.float32, device=dev)
    fn = _mc_match_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            plane.data_ptr(), n_p, h, w, pts.data_ptr(), beam_w.data_ptr(), r,
            origin.data_ptr(), init_pose.data_ptr(), noise.data_ptr(), rounds, k,
            scale, unknown, sigma_xy, sigma_theta, bad_rounds_before_anneal,
            pose.data_ptr(), prob.data_ptr(), trace.data_ptr(), shared, stream,
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
    current stream, once (the P = 1 case of :func:`mc_match_batched`), and
    add one to the ``mc_match`` count of :func:`launch_counts`.
    """
    args = (plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
            sigma_theta, bad_rounds_before_anneal)
    if plane.device.type == "cpu":
        return mc_match_ref(*args)
    return _mc_match_launch("mc_match", (), *args)


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
    2], init_pose f32[P, 3], noise f32[P, rounds, K, 3]: match p is
    :func:`mc_match` on the p-th slices, and gives its bits. The RBPF's
    particles, one scan matched against each particle's own map window.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for all P, and add one to the ``mc_match_batched``
    count of :func:`launch_counts`.
    """
    args = (plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
            sigma_theta, bad_rounds_before_anneal)
    if plane.dim() != 3:
        raise ValueError(f"plane has shape {tuple(plane.shape)}, expected (P, H, W)")
    if plane.device.type == "cpu":
        return mc_match_ref(*args)
    return _mc_match_launch("mc_match_batched", (plane.shape[0],), *args)


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
