"""SE(2) pose algebra on tensors (port of ``slam_constructor_tpu.ops.geometry``).

A pose is ``f32[..., 3]`` ``[x, y, theta]``; a delta is a pose increment in
the body frame of the pose it is applied to. Every op broadcasts over
leading axes and keeps the reference's order of arithmetic.
"""

from __future__ import annotations

import torch

from . import libm

Tensor = torch.Tensor


def wrap_angle(theta: Tensor) -> Tensor:
    """Normalize angles to (-pi, pi]: ``atan2(sin, cos)`` with the
    reference's functions (``libm.wrap_angle``; one launch on the card)."""
    return libm.wrap_angle(theta)


# The reference's jitted CPU code fuses each sum of products below into
# fused multiply-adds (``libm.fma32``), in the pattern written out in each
# ``*_ref``; on a CUDA tensor the whole operation is one launch of
# ``kernels.libm_pose`` with the same operations (csrc/libm.cu).


def _pose_op(op: str, ref, *args: Tensor) -> Tensor:
    args = tuple(map(libm._f32, args))
    if libm._on_card(args[0]):
        from . import kernels
        return kernels.libm_pose(op, *args)
    return ref(*args)


def _compose_ref(a: Tensor, b: Tensor) -> Tensor:
    sa, ca = libm.sincos(a[..., 2])
    x = libm.fma32(-sa, b[..., 1], libm.fma32(ca, b[..., 0], a[..., 0]))
    y = libm.fma32(ca, b[..., 1], libm.fma32(sa, b[..., 0], a[..., 1]))
    th = libm.wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, th], dim=-1)


def _inverse_ref(a: Tensor) -> Tensor:
    sa, ca = libm.sincos(a[..., 2])
    x = -libm.fma32(ca, a[..., 0], sa * a[..., 1])
    y = -libm.fma32(ca, a[..., 1], -sa * a[..., 0])
    return torch.stack([x, y, libm.wrap_angle(-a[..., 2])], dim=-1)


def _between_ref(a: Tensor, b: Tensor) -> Tensor:
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    sa, ca = libm.sincos(a[..., 2])
    x = libm.fma32(ca, dx, sa * dy)
    y = libm.fma32(ca, dy, -sa * dx)
    th = libm.wrap_angle(b[..., 2] - a[..., 2])
    return torch.stack([x, y, th], dim=-1)


def compose(a: Tensor, b: Tensor) -> Tensor:
    """``a ⊕ b``: apply delta ``b`` (in a's body frame) to pose ``a``."""
    return _pose_op("compose", _compose_ref, a, b)


def inverse(a: Tensor) -> Tensor:
    """Inverse pose: ``compose(a, inverse(a)) == identity``."""
    return _pose_op("inverse", _inverse_ref, a)


def between(a: Tensor, b: Tensor) -> Tensor:
    """Delta ``d`` (in a's body frame) such that ``compose(a, d) == b``."""
    return _pose_op("between", _between_ref, a, b)


def apply_pose(p: Tensor, pts: Tensor) -> Tensor:
    """Transform body-frame points ``f32[..., 2]`` into the world frame;
    ``apply_pose(poses[K, None, :], pts[R, 2])`` -> ``[K, R, 2]``."""
    s, c = libm.sincos(p[..., 2])
    x = libm.fma32(-s, pts[..., 1], libm.fma32(c, pts[..., 0], p[..., 0]))
    y = libm.fma32(c, pts[..., 1], libm.fma32(s, pts[..., 0], p[..., 1]))
    return torch.stack([x, y], dim=-1)


def pose_distance(a: Tensor, b: Tensor, angle_weight: float = 1.0) -> Tensor:
    """Weighted SE(2) distance used for keyframe gating."""
    d = b - a
    ang = wrap_angle(d[..., 2])
    return libm.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + (angle_weight * ang) ** 2)


def linspace(start: float, stop: float, n: int, device) -> Tensor:
    """f32 ``linspace`` rounded as the reference's: ``start * (1 - t) +
    stop * t`` with ``t = i / (n - 1)``, the last point exactly ``stop``
    (``torch.linspace`` rounds the inner points differently)."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    inner = start * (1.0 - t) + stop * t
    return torch.cat([inner, torch.full((1,), stop, dtype=torch.float32, device=device)])
