"""SE(2) pose algebra on tensors (port of ``slam_constructor_tpu.ops.geometry``).

A pose is ``f32[..., 3]`` ``[x, y, theta]``; a delta is a pose increment in
the body frame of the pose it is applied to. Every op broadcasts over
leading axes and keeps the reference's order of arithmetic.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def wrap_angle(theta: Tensor) -> Tensor:
    """Normalize angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def compose(a: Tensor, b: Tensor) -> Tensor:
    """``a ⊕ b``: apply delta ``b`` (in a's body frame) to pose ``a``."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, th], dim=-1)


def inverse(a: Tensor) -> Tensor:
    """Inverse pose: ``compose(a, inverse(a)) == identity``."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, wrap_angle(-a[..., 2])], dim=-1)


def between(a: Tensor, b: Tensor) -> Tensor:
    """Delta ``d`` (in a's body frame) such that ``compose(a, d) == b``."""
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = ca * dx + sa * dy
    y = -sa * dx + ca * dy
    th = wrap_angle(b[..., 2] - a[..., 2])
    return torch.stack([x, y, th], dim=-1)


def apply_pose(p: Tensor, pts: Tensor) -> Tensor:
    """Transform body-frame points ``f32[..., 2]`` into the world frame;
    ``apply_pose(poses[K, None, :], pts[R, 2])`` -> ``[K, R, 2]``."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = p[..., 0] + c * pts[..., 0] - s * pts[..., 1]
    y = p[..., 1] + s * pts[..., 0] + c * pts[..., 1]
    return torch.stack([x, y], dim=-1)


def pose_distance(a: Tensor, b: Tensor, angle_weight: float = 1.0) -> Tensor:
    """Weighted SE(2) distance used for keyframe gating."""
    d = b - a
    ang = wrap_angle(d[..., 2])
    return torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + (angle_weight * ang) ** 2)


def linspace(start: float, stop: float, n: int, device) -> Tensor:
    """f32 ``linspace`` rounded as the reference's: ``start * (1 - t) +
    stop * t`` with ``t = i / (n - 1)``, the last point exactly ``stop``
    (``torch.linspace`` rounds the inner points differently)."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    inner = start * (1.0 - t) + stop * t
    return torch.cat([inner, torch.full((1,), stop, dtype=torch.float32, device=device)])
