"""Kernel wrappers and their plain PyTorch twins.

``overlap_score`` scores K candidate poses against a map plane with the
overlap reducer at extent 1. It replaces the TPU kernel
``slam_constructor_tpu/ops/pallas_kernels.py::sample_plane_bilinear`` fused
with the pose transform and weighted mean of ``scoring.score_poses``.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/overlap_score.cu``) or raises; it never falls back. On a CPU tensor
it runs the plain twin ``overlap_score_ref``, which the CPU tests hold
against the reference and which the card's smoke run holds the kernel to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

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


def _check(name: str, t: Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
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
