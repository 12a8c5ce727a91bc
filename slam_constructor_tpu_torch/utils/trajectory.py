"""Trajectory and map files (port of
``slam_constructor_tpu.utils.trajectory``): TUM-format trajectories for
the standard ATE tools, and PGM occupancy maps in the ROS map_server
convention. They take tensors (on any device) or numpy arrays."""

from __future__ import annotations

import numpy as np
import torch


def as_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_tum(path: str, poses, timestamps=None) -> None:
    """Write SE(2) poses f32[T, 3] as TUM lines:
    ``t x y 0 0 0 sin(th/2) cos(th/2)`` (a yaw-only quaternion)."""
    poses = as_numpy(poses)
    if timestamps is None:
        timestamps = np.arange(len(poses), dtype=np.float64)
    with open(path, "w") as f:
        for t, (x, y, th) in zip(timestamps, poses):
            qz, qw = np.sin(th / 2), np.cos(th / 2)
            f.write(f"{t:.6f} {x:.6f} {y:.6f} 0.000000 0.000000 0.000000 {qz:.6f} {qw:.6f}\n")


def load_tum(path: str):
    """Read a TUM trajectory -> (timestamps f64[T], poses f32[T, 3]); the
    yaw comes from the quaternion (planar motion)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, x, y, _z, qx, qy, qz, qw = [float(v) for v in line.split()][:8]
            yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
            ts.append(t)
            poses.append((x, y, yaw))
    return np.asarray(ts), np.asarray(poses, np.float32)


def save_map_pgm(path: str, occupancy, threshold_free=0.25, threshold_occ=0.65):
    """Write an occupancy plane as PGM (0 = occupied/black, 254 =
    free/white, 205 = unknown grey), its top row first."""
    occ = as_numpy(occupancy)
    img = np.full(occ.shape, 205, np.uint8)
    img[occ <= threshold_free] = 254
    img[occ >= threshold_occ] = 0
    img = img[::-1]  # row 0 is the map's bottom
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())
