"""Synthetic worlds, trajectories and scan sequences (port of
``slam_constructor_tpu.utils.datagen``).

Worlds, bearings and trajectories are built in numpy float64 and cast to
f32 as the reference does, so they equal the reference's bit for bit.
Randomness (odometry and range noise) comes from a numpy ``Generator`` or
a seed, or from the reference's threefry key, which gives the reference's
sequence bit for bit (:func:`synth_sequence`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels, prng, raycast
from ..ops import scan as scanlib
from ..ops.geometry import between, wrap_angle

Tensor = torch.Tensor


def ascii_to_occupancy(art: str) -> np.ndarray:
    """ASCII art -> occupancy plane f32[H, W] (``#`` = wall). The first text
    line is the TOP row of the world (y grows upward, so rows reverse)."""
    lines = [ln for ln in art.strip("\n").splitlines()]
    width = max(len(ln) for ln in lines)
    rows = [[1.0 if ch == "#" else 0.0 for ch in ln.ljust(width)] for ln in lines]
    return np.asarray(rows[::-1], np.float32)


_CECUM_ART = """
####################################
#                                  #
#                                  #
#                                  #
#      ####################        #
#      #                  #        #
#      #                  #        #
#      #                  #        #
#      ########  ##########        #
#                                  #
#                                  #
#                                  #
####################################
"""


def cecum_world(scale: float = 0.1, upscale: int = 4, device=None):
    """The corridor-with-dead-end ("cecum") fixture: a ring corridor around
    a central block, 14.4 m x 5.2 m at the defaults.
    Returns (occ f32[H, W], origin f32[2], scale)."""
    occ = np.kron(ascii_to_occupancy(_CECUM_ART), np.ones((upscale, upscale), np.float32))
    h, w = occ.shape
    origin = np.array([-w * scale / 2, -h * scale / 2], np.float32)
    return (
        torch.as_tensor(occ, device=device),
        torch.as_tensor(origin, device=device),
        scale,
    )


def box_world(
    size_m: float = 10.0, scale: float = 0.1, obstacles: int = 6, seed: int = 0,
    device=None,
):
    """Square room with random rectangular obstacles."""
    n = int(round(size_m / scale))
    occ = np.zeros((n, n), np.float32)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 1.0
    rng = np.random.default_rng(seed)
    for _ in range(obstacles):
        ch, cw = rng.integers(2, max(3, n // 8), 2)
        r = rng.integers(2, n - ch - 2)
        c = rng.integers(2, n - cw - 2)
        # keep the center clear so the robot can start there
        if abs(r + ch / 2 - n / 2) < n / 6 and abs(c + cw / 2 - n / 2) < n / 6:
            continue
        occ[r : r + ch, c : c + cw] = 1.0
    origin = np.array([-size_m / 2, -size_m / 2], np.float32)
    return torch.as_tensor(occ, device=device), torch.as_tensor(origin, device=device), scale


def default_bearings(n_beams: int = 360, fov: float = 2 * np.pi, device=None) -> Tensor:
    return torch.as_tensor(
        np.linspace(-fov / 2, fov / 2, n_beams, endpoint=False).astype(np.float32),
        device=device,
    )


def corridor_trajectory(n_steps: int = 60, y: float = -1.6, device=None) -> Tensor:
    """Drive +x along the lower corridor of the default cecum world."""
    xs = np.linspace(-4.5, 4.5, n_steps)
    poses = np.stack([xs, np.full_like(xs, y), np.zeros_like(xs)], axis=-1)
    return torch.as_tensor(poses.astype(np.float32), device=device)


def rectangle_trajectory(
    corners=((-5.6, -1.6), (4.8, -1.6), (4.8, 1.6), (-5.6, 1.6)),
    step: float = 0.25,
    close: bool = True,
    device=None,
) -> Tensor:
    """Piecewise-linear loop through ``corners`` (default: a lap around the
    cecum world's inner block), heading along each segment."""
    pts = [np.asarray(c, np.float64) for c in corners]
    if close:
        pts.append(pts[0])
    poses = []
    for a, b in zip(pts[:-1], pts[1:]):
        seg = b - a
        length = float(np.hypot(*seg))
        heading = float(np.arctan2(seg[1], seg[0]))
        n = max(1, int(round(length / step)))
        for t in np.linspace(0, 1, n, endpoint=False):
            p = a + t * seg
            poses.append((p[0], p[1], heading))
    return torch.as_tensor(np.asarray(poses).astype(np.float32), device=device)


def loop_trajectory(n_steps: int = 120, radius: float = 3.0, center=(0.0, 0.0),
                    device=None) -> Tensor:
    """A closed circle of ``n_steps`` poses, heading along it (for
    loop-closure tests)."""
    a = np.linspace(0, 2 * np.pi, n_steps, endpoint=False)
    x = torch.as_tensor((center[0] + radius * np.cos(a)).astype(np.float32), device=device)
    y = torch.as_tensor((center[1] + radius * np.sin(a)).astype(np.float32), device=device)
    # the reference wraps the heading in f32
    th = wrap_angle(torch.as_tensor((a + np.pi / 2).astype(np.float32), device=device))
    return torch.stack([x, y, th], dim=-1)


def synth_sequence(
    occ: Tensor,
    origin: Tensor,
    scale: float,
    poses: Tensor,
    bearings: Tensor,
    rng: np.random.Generator | int | Tensor = 0,
    max_range: float = 15.0,
    odom_noise_xy: float = 0.01,
    odom_noise_theta: float = 0.005,
    range_noise: float = 0.0,
):
    """Generate (scans, odom_deltas, true_poses) along a trajectory, on the
    device of ``occ``.

    Odometry deltas are the true between-pose deltas plus Gaussian noise
    drawn from ``rng``; the first delta is 0. ``rng`` is a numpy Generator
    or a seed, or a threefry key uint32[2], from which the noise is drawn as
    the reference draws it from its ``key``: ``keys = split(key, T + 1)``,
    scan i's range noise ``normal(keys[i], (R,))``, the odometry noise
    ``normal(keys[T], (T, 3))`` (one launch of ``kernels.prng_draws`` on the
    key's device). Returns ``(LaserScan batched [T, R], odom f32[T, 3],
    poses f32[T, 3])``.
    """
    dev = occ.device
    poses = poses.to(dev)
    bearings = bearings.to(dev)
    n = poses.shape[0]
    sd = np.array([odom_noise_xy, odom_noise_xy, odom_noise_theta], np.float32)
    if torch.is_tensor(rng):
        plan = (prng.Draw((n,), "normal", (n, 3)),
                *((prng.Draw((prng.Each(n),), "normal", (bearings.shape[0],)),)
                  if range_noise > 0 else ()))
        drawn = kernels.prng_draws(rng.to(dev), plan)
        noise = drawn[0] * torch.from_numpy(sd).to(dev)
        rn = (drawn[1] * torch.full((), float(np.float32(range_noise)), device=dev)
              if range_noise > 0 else None)
    else:  # numpy: the range noise first, then the odometry's
        rng = np.random.default_rng(rng)
        rn = (torch.as_tensor(rng.standard_normal((n, bearings.shape[0])).astype(np.float32)
                              * np.float32(range_noise), device=dev)
              if range_noise > 0 else None)
        noise = torch.as_tensor((rng.standard_normal((n, 3)).astype(np.float32) * sd)
                                .astype(np.float32), device=dev)
    scans = [raycast.cast_rays(occ, origin, scale, p, bearings, max_range) for p in poses]
    ranges = torch.stack([s.ranges for s in scans])
    valid = torch.stack([s.valid for s in scans])
    if rn is not None:
        ranges = torch.where(valid, ranges + rn, ranges)
    batch = scanlib.LaserScan(
        ranges=ranges, bearings=bearings[None, :].expand(n, -1).contiguous(), valid=valid
    )
    deltas = between(poses[:-1], poses[1:])
    deltas = torch.cat([torch.zeros((1, 3), device=dev), deltas], dim=0)
    noise = torch.cat([torch.zeros((1, 3), device=dev), noise[1:]], dim=0)  # the first delta is 0
    return batch, (deltas + noise).to(torch.float32), poses
