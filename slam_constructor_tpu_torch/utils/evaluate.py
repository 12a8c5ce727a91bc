"""Trajectory and map evaluation: ATE, RPE and map quality against a
ground-truth occupancy plane (port of ``slam_constructor_tpu.utils.evaluate``)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.geometry import between, wrap_angle

Tensor = torch.Tensor


def align_2d(est_xy: Tensor, gt_xy: Tensor) -> tuple[Tensor, Tensor]:
    """Closed-form rigid 2D alignment (rotation + translation) minimizing
    RMSE. Returns (R 2x2, t 2)."""
    mu_e = est_xy.mean(0)
    mu_g = gt_xy.mean(0)
    e = est_xy - mu_e
    g = gt_xy - mu_g
    sxx = (e[:, 0] * g[:, 0]).sum()
    syy = (e[:, 1] * g[:, 1]).sum()
    sxy = (e[:, 0] * g[:, 1]).sum()
    syx = (e[:, 1] * g[:, 0]).sum()
    theta = torch.atan2(sxy - syx, sxx + syy)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    t = mu_g - rot @ mu_e
    return rot, t


def ate(est: Tensor, gt: Tensor, align: bool = True) -> Tensor:
    """Absolute trajectory error (RMSE over positions), optionally after
    rigid alignment. est/gt: f32[T, 3] poses."""
    e, g = est[:, :2], gt[:, :2]
    if align:
        rot, t = align_2d(e, g)
        e = e @ rot.T + t
    return torch.sqrt(((e - g) ** 2).sum(-1).mean())


def rpe(est: Tensor, gt: Tensor, delta: int = 1) -> tuple[Tensor, Tensor]:
    """Relative pose error over ``delta``-step increments.
    Returns (rmse_translation, rmse_rotation)."""
    de = between(est[:-delta], est[delta:])
    dg = between(gt[:-delta], gt[delta:])
    dt = de[:, :2] - dg[:, :2]
    dr = wrap_angle(de[:, 2] - dg[:, 2])
    return torch.sqrt((dt**2).sum(-1).mean()), torch.sqrt((dr**2).mean())


def map_quality(occ_est: Tensor, occ_gt: Tensor, occupied_thresh: float = 0.6,
                free_thresh: float = 0.25) -> dict:
    """Map-vs-ground-truth metrics on co-registered occupancy planes of one
    extent and scale: occupied-cell IoU, the share of the cells claimed
    free that are free, and coverage (the share of the true structure
    seen occupied). Floats on the host."""
    occ_gt = torch.as_tensor(occ_gt, device=occ_est.device)
    est_occ = occ_est >= occupied_thresh
    est_free = occ_est <= free_thresh
    gt_occ = occ_gt >= 0.5
    inter = (est_occ & gt_occ).sum()
    union = (est_occ | gt_occ).sum()
    free_ok = (est_free & ~gt_occ).sum()
    n = torch.stack([inter, union, free_ok, est_free.sum(), gt_occ.sum()]).tolist()
    return {
        "occupied_iou": float(np.float32(n[0]) / np.float32(max(n[1], 1))),
        "free_accuracy": float(np.float32(n[2]) / np.float32(max(n[3], 1))),
        "coverage": float(np.float32(n[0]) / np.float32(max(n[4], 1))),
    }
