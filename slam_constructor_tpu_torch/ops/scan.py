"""Laser-scan container and preprocessing (port of
``slam_constructor_tpu.ops.scan``): fixed-width tensors with a validity
mask, so every scan of a sequence has one shape."""

from __future__ import annotations

import dataclasses
import math

import torch

from . import libm

Tensor = torch.Tensor


@dataclasses.dataclass
class LaserScan:
    """One 2D scan in the sensor frame, or a batch ``[T, R]`` of them.

    ranges:   f32[..., R] measured ranges (meters); max_range where invalid
    bearings: f32[..., R] beam angles (radians, sensor frame)
    valid:    bool[..., R] range inside [min_range, max_range] and finite
    """

    ranges: Tensor
    bearings: Tensor
    valid: Tensor

    @property
    def n_beams(self) -> int:
        return self.ranges.shape[-1]

    def __getitem__(self, i) -> "LaserScan":
        """Scan ``i`` of a batched sequence (a view, no copy)."""
        return LaserScan(self.ranges[i], self.bearings[i], self.valid[i])

    def __len__(self) -> int:
        return self.ranges.shape[0]

    def to(self, device) -> "LaserScan":
        return LaserScan(
            self.ranges.to(device), self.bearings.to(device), self.valid.to(device)
        )


@dataclasses.dataclass
class OdomScan:
    """A scan with the odometry delta since the previous scan and its
    quality (the reference's ``TransformedLaserScan``)."""

    scan: LaserScan
    odom_delta: Tensor  # f32[3] body-frame pose increment
    quality: Tensor  # f32[] confidence in [0, 1]

    def to(self, device) -> "OdomScan":
        return OdomScan(self.scan.to(device), self.odom_delta.to(device), self.quality.to(device))


def make_scan(
    ranges,
    bearings,
    min_range: float = 0.05,
    max_range: float = 15.0,
    device=None,
) -> LaserScan:
    """Build a scan with validity mask (the LaserScanObserver filter)."""
    ranges = torch.as_tensor(ranges, dtype=torch.float32, device=device)
    bearings = torch.as_tensor(bearings, dtype=torch.float32, device=ranges.device)
    valid = torch.isfinite(ranges) & (ranges >= min_range) & (ranges <= max_range)
    return LaserScan(
        ranges=torch.where(valid, ranges, max_range), bearings=bearings, valid=valid
    )


def scan_points(scan: LaserScan) -> Tensor:
    """Sensor-frame cartesian endpoints ``f32[..., R, 2]``."""
    return scan.ranges[..., None] * libm.cossin(scan.bearings)


def _endpoint_angles_ref(ranges: Tensor, bearings: Tensor) -> Tensor:
    s, c = libm.sincos(bearings)
    x, y = ranges * c, ranges * s
    dx = libm.fma32(ranges[..., 1:], c[..., 1:], -x[..., :-1])
    dy = libm.fma32(ranges[..., 1:], s[..., 1:], -y[..., :-1])
    return libm.atan2(dy, dx)


def endpoint_angles(scan: LaserScan) -> Tensor:
    """The direction of each consecutive-endpoint difference ``f32[...,
    R - 1]`` in (-pi, pi]: ``atan2`` of ``scan_points`` differenced, each
    difference fused as the reference's jitted code fuses it (the later
    endpoint's product, minus the earlier one rounded). One launch on the
    card (``kernels.libm_endpoint_angles``)."""
    if libm._on_card(scan.ranges):
        from . import kernels
        return kernels.libm_endpoint_angles(scan.ranges, scan.bearings)
    return _endpoint_angles_ref(scan.ranges, scan.bearings)


def subsample_mask(scan: LaserScan, stride: int) -> Tensor:
    """Validity mask with every ``stride``-th beam kept."""
    if stride <= 1:
        return scan.valid
    idx = torch.arange(scan.n_beams, device=scan.valid.device)
    return scan.valid & (idx % stride == 0)


def angle_histogram(scan: LaserScan, n_bins: int = 36) -> Tensor:
    """Histogram of consecutive-endpoint direction angles (vinySLAM's scan
    degeneracy feature): normalized bin weights ``f32[n_bins]``.

    The counts go through ``scatter_add_`` into a vector of fixed length
    (``bincount`` and ``histc`` read a maximum back to the host); they are
    integers, so the sums are exact in any order.
    """
    ang = endpoint_angles(scan)  # (-pi, pi]
    ok = (scan.valid[1:] & scan.valid[:-1]).to(torch.float32)
    bins = torch.floor((ang + math.pi) / (2 * math.pi) * n_bins).to(torch.int64)
    bins = torch.clamp(bins, 0, n_bins - 1)
    hist = torch.zeros((n_bins,), dtype=torch.float32, device=ang.device)
    hist.scatter_add_(0, bins, ok)
    return hist / torch.clamp(hist.sum(), min=1.0)
