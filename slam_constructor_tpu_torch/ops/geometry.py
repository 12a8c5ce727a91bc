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
