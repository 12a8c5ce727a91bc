"""Kernel wrappers and their plain PyTorch twins.

``overlap_score`` scores K candidate poses against a map plane with the
overlap reducer at extent 1. It replaces the TPU kernel
``slam_constructor_tpu/ops/pallas_kernels.py::sample_plane_bilinear`` fused
with the pose transform and weighted mean of ``scoring.score_poses``.

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
    probabilities.
    """
    h, w = v.shape
    c = torch.cos(poses[:, 2:3])
    s = torch.sin(poses[:, 2:3])
    wx = poses[:, 0:1] + c * pts[:, 0] - s * pts[:, 1]  # [K, R]
    wy = poses[:, 1:2] + s * pts[:, 0] + c * pts[:, 1]
    x = (wx - origin[0]) / scale
    y = (wy - origin[1]) / scale
    ay0, ay1, r0, r1 = _axis_taps(y, h)
    ax0, ax1, c0, c1 = _axis_taps(x, w)
    flat = v.reshape(-1)

    def tap(a, b, r, col):
        return torch.where((a != 0) & (b != 0), flat[r * w + col], 0.0)

    v00 = tap(ay0, ax0, r0, c0)
    v10 = tap(ay1, ax0, r1, c0)
    v01 = tap(ay0, ax1, r0, c1)
    v11 = tap(ay1, ax1, r1, c1)
    ssum = (ay0 * v00 + ay1 * v10) * ax0 + (ay0 * v01 + ay1 * v11) * ax1
    coverage = (ay0 + ay1) * (ax0 + ax1)
    p = ssum + (1.0 - coverage) * unknown
    return (p * beam_w).sum(-1) / torch.clamp(beam_w.sum(-1), min=1e-9)


@functools.cache
def _overlap_score_fn():
    fn = _build.load().overlap_score_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # v, h, w
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


def overlap_score(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
) -> Tensor:
    """Score poses f32[K, 3] against plane v f32[H, W] -> f32[K].

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to ``overlap_score.n_launches``.
    """
    if v.device.type == "cpu":
        return overlap_score_ref(v, poses, pts, beam_w, origin, scale, unknown)
    if v.device.type != "cuda":
        raise ValueError(f"overlap_score: unsupported device {v.device}")
    h, w = v.shape
    k, r = poses.shape[0], pts.shape[0]
    _check("v", v, (h, w), v.device)
    _check("poses", poses, (k, 3), v.device)
    _check("pts", pts, (r, 2), v.device)
    _check("beam_w", beam_w, (r,), v.device)
    _check("origin", origin, (2,), v.device)
    out = torch.empty((k,), dtype=torch.float32, device=v.device)
    if k == 0:
        return out
    fn = _overlap_score_fn()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(
            v.data_ptr(), h, w, poses.data_ptr(), k, pts.data_ptr(),
            beam_w.data_ptr(), r, origin.data_ptr(), scale, unknown,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"overlap_score kernel launch failed: cudaError_t {err}")
    overlap_score.n_launches += 1
    return out


#: kernel launches since the count was last set to 0 (CUDA tensors only)
overlap_score.n_launches = 0


# --- polar free-space fill ----------------------------------------------------

#: static shared memory a block may use without opting in to more
_MAX_SHARED_BYTES = 48 * 1024


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
    b0 = bearings[0]
    db = (bearings[-1] - b0) / torch.full_like(b0, float(max(r - 1, 1)))
    db = torch.where(torch.abs(db) < 1e-6, 1.0, db)
    binf = wrap_angle(ang - b0) / db
    bini = torch.round(binf).to(torch.int64)  # half to even, as jnp.round
    in_fov = (bini >= 0) & (bini <= r - 1)
    full_circle = torch.abs(db) * r >= 2.0 * math.pi - 1.5 * torch.abs(db)
    ok = in_fov | full_circle
    # remainder takes the divisor's sign: never negative
    bini = torch.where(full_circle, torch.remainder(bini, r), torch.clamp(bini, 0, r - 1))
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
    current stream and add one to ``polar_free_plane.n_launches``.
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
    if r * 4 > _MAX_SHARED_BYTES:
        raise ValueError(
            f"polar_free_plane: {r} beams need {r * 4} B of shared memory, "
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
    polar_free_plane.n_launches += 1
    return out


#: kernel launches since the count was last set to 0 (CUDA tensors only)
polar_free_plane.n_launches = 0
