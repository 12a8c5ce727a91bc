"""Laser-scan container and preprocessing (port of
``slam_constructor_tpu.ops.scan``): fixed-width tensors with a validity
mask, so every scan of a sequence has one shape."""

from __future__ import annotations

import dataclasses

import torch

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
    c, s = torch.cos(scan.bearings), torch.sin(scan.bearings)
    return torch.stack([scan.ranges * c, scan.ranges * s], dim=-1)


def subsample_mask(scan: LaserScan, stride: int) -> Tensor:
    """Validity mask with every ``stride``-th beam kept."""
    if stride <= 1:
        return scan.valid
    idx = torch.arange(scan.n_beams, device=scan.valid.device)
    return scan.valid & (idx % stride == 0)
