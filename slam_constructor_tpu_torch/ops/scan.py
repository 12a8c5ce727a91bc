"""Laser-scan container and preprocessing (port of
``slam_constructor_tpu.ops.scan``): fixed-width tensors with a validity
mask, so every scan of a sequence has one shape."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
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


def endpoint_angles(scan: LaserScan) -> Tensor:
    """The direction of each consecutive-endpoint difference ``f32[...,
    R - 1]`` in (-pi, pi]: ``atan2`` of ``scan_points`` differenced, each
    difference fused as the reference's jitted code fuses it (the later
    endpoint's product, minus the earlier one rounded). On the card
    ``kernels.beam_weights`` computes them inside its launch."""
    s, c = libm.sincos(scan.bearings)
    x, y = scan.ranges * c, scan.ranges * s
    dx = libm.fma32(scan.ranges[..., 1:], c[..., 1:], -x[..., :-1])
    dy = libm.fma32(scan.ranges[..., 1:], s[..., 1:], -y[..., :-1])
    return libm.atan2(dy, dx)


def subsample_mask(scan: LaserScan, stride: int) -> Tensor:
    """Validity mask with every ``stride``-th beam kept."""
    if stride <= 1:
        return scan.valid
    idx = torch.arange(scan.n_beams, device=scan.valid.device)
    return scan.valid & (idx % stride == 0)


def bin_factor(n_bins: int) -> float:
    """``f32(f32(1 / f32(2 pi)) * n_bins)``: the reference's jitted code folds
    ``/ (2 * pi) * n_bins`` into one product with this constant."""
    inv = np.float32(1.0) / np.float32(2 * math.pi)
    return float(np.float32(inv * np.float32(n_bins)))


def angle_bins(ang: Tensor, n_bins: int) -> Tensor:
    """The histogram bin i64 of each angle in (-pi, pi]: ``floor((ang + pi)
    / (2 pi) * n_bins)`` clamped into the bins, as the reference's jitted
    code computes it (one product with :func:`bin_factor`; the same on
    every device)."""
    bins = torch.floor((ang + math.pi) * bin_factor(n_bins))
    return torch.clamp(bins, 0, n_bins - 1).to(torch.int64)


def angle_histogram(scan: LaserScan, n_bins: int = 36) -> Tensor:
    """Histogram of consecutive-endpoint direction angles (vinySLAM's scan
    degeneracy feature): normalized bin weights ``f32[..., n_bins]``.

    The counts go through ``scatter_add_`` into a vector of fixed length
    (``bincount`` and ``histc`` read a maximum back to the host); they are
    integers, so the sums are exact in any order.
    """
    ang = endpoint_angles(scan)  # (-pi, pi]
    ok = (scan.valid[..., 1:] & scan.valid[..., :-1]).to(torch.float32)
    hist = torch.zeros((*ang.shape[:-1], n_bins), dtype=torch.float32, device=ang.device)
    hist.scatter_add_(-1, angle_bins(ang, n_bins), ok)
    return hist / torch.clamp(hist.sum(-1, keepdim=True), min=1.0)


def point_weights_ref(scan: LaserScan, n_bins: int = 36) -> Tensor:
    """vinySLAM's beam weights f32[..., R], the plain version of
    ``kernels.beam_weights`` (the reference's ``engine._point_weights``):
    the :func:`angle_histogram` of the scan, each beam's local wall tangent
    (its endpoint difference with the next beam; the last beam takes the
    one before) binned, and the weight ``1 / (1 + hist[bin] n_bins)`` (the
    reference's code fuses the multiply-add), which down-weights beams on
    over-represented wall directions."""
    hist = angle_histogram(scan, n_bins)
    tangent = endpoint_angles(scan)  # [..., R - 1]
    tangent = torch.cat([tangent, tangent[..., -1:]], dim=-1)
    h = torch.gather(hist, -1, angle_bins(tangent, n_bins))
    return torch.reciprocal(libm.fma32(h, float(n_bins), 1.0))
