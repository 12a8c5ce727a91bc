"""Global relocalization: FFT cross-correlation over the whole map (port of
``slam_constructor_tpu.ops.relocalize``).

For each candidate heading the scan's endpoint histogram is
cross-correlated with the map's occupancy value plane by zero-padded 2D
FFTs: every translation in the map scored in O(HW log HW), all headings in
one batched ``torch.fft.rfft2`` / ``irfft2`` call. The best translation and
heading seed a hill climb (``matchers.hill_climbing_match``, one launch of
``kernels.hill_climb`` on the card) on the config's scoring.

score(t) = sum_i v[c_i + t] = (h ⋆ v)[t], where h is the histogram of the
rotated endpoint cells: the obstacle reducer's score times the number of
valid beams (with ``v`` 0 where the map is unknown). The reference's FFT is
XLA's, not a Pallas kernel; its counterpart here is the library's FFT. The
histogram is an ``index_add_`` of integer counts, so its sums do not depend
on their order. Nothing is read on the host before the final pose.
"""

from __future__ import annotations

import dataclasses

import torch

from . import grid as gridlib
from . import libm
from . import scan as scanlib
from .geometry import wrap_angle
from .matchers import HillClimbingConfig, MatchResult, hill_climbing_match
from .scoring import MapView, ScoringConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RelocalizeConfig:
    n_theta: int = 32
    #: full heading sweep by default (kidnapped robot)
    half_theta: float = 3.14159265
    unknown_prob: float = 0.5
    refine_iterations: int = 10
    scoring: ScoringConfig = ScoringConfig(reducer="overlap")


def fft_correlate(v: Tensor, h: Tensor) -> Tensor:
    """Cross-correlation (h ⋆ v) with zero padding (no circular aliasing).

    v f32[H, W], h f32[..., H, W] (any leading dimensions: one correlation
    each, in one batched FFT) -> f32[..., 2H, 2W], where entry [H + ty,
    W + tx] is sum_rc h[r, c] * v[r + ty, c + tx]."""
    hh, ww = v.shape
    fv = torch.fft.rfft2(torch.nn.functional.pad(v, (0, ww, 0, hh)))
    fh = torch.fft.rfft2(torch.nn.functional.pad(h, (0, ww, 0, hh)))
    corr = torch.fft.irfft2(torch.conj(fh) * fv, s=(2 * hh, 2 * ww))
    # corr[t mod 2H] = sum h[r] v[r + t]; negative t wrap to the top end
    return torch.roll(corr, (hh, ww), dims=(-2, -1))


def thetas(cfg: RelocalizeConfig, device) -> Tensor:
    """The headings f32[n_theta]: ``n_theta`` steps over [-half, half),
    ``start * (1 - t) + stop * t`` with ``t = i / n_theta`` (the
    reference's ``jnp.linspace(..., endpoint=False)``)."""
    n = cfg.n_theta
    i = torch.arange(n, dtype=torch.float32, device=device)
    t = i / torch.full_like(i, float(n))
    return -cfg.half_theta * (1.0 - t) + cfg.half_theta * t


def endpoint_histograms(view: MapView, scan: scanlib.LaserScan, th: Tensor) -> Tensor:
    """f32[T, H, W]: for each heading, the count of valid endpoints in each
    cell, the sensor placed at the origin corner and shifted by (H / 2,
    W / 2) so that the scan's +-range fits."""
    h, w = view.occ.shape
    pts = scanlib.scan_points(scan)  # [R, 2] sensor frame
    s, c = libm.sincos(th)
    c, s = c[:, None], s[:, None]
    ex = c * pts[:, 0] - s * pts[:, 1]  # [T, R]
    ey = s * pts[:, 0] + c * pts[:, 1]
    # divided: no reference path jits relocalize, and eagerly it divides
    col = torch.floor(gridlib.div_scale(ex, view.scale)).to(torch.int64) + w // 2
    row = torch.floor(gridlib.div_scale(ey, view.scale)).to(torch.int64) + h // 2
    ok = scan.valid & (row >= 0) & (row < h) & (col >= 0) & (col < w)
    plane = torch.arange(th.shape[0], device=th.device)[:, None] * (h * w)
    idx = plane + torch.where(ok, row * w + col, 0)
    hist = torch.zeros(th.shape[0] * h * w, dtype=torch.float32, device=th.device)
    hist.index_add_(0, idx.reshape(-1), ok.to(torch.float32).reshape(-1))
    return hist.reshape(-1, h, w)


def relocalize(
    view: MapView,
    scan: scanlib.LaserScan,
    cfg: RelocalizeConfig = RelocalizeConfig(),
    key: Tensor | None = None,
) -> MatchResult:
    """The best pose f32[3] for ``scan`` anywhere in the map (one map):
    the FFT's best translation and heading (ties to the first, in cell
    order, then heading order), then ``cfg.refine_iterations`` rounds of
    hill climbing from it. Deterministic, so ``key`` is ignored."""
    del key
    h, w = view.occ.shape
    dev = view.occ.device
    v = torch.where(view.known, view.occ, 0.0)  # unknown contributes 0 evidence
    th = thetas(cfg, dev)
    corr = fft_correlate(v, endpoint_histograms(view, scan, th)).reshape(th.shape[0], -1)
    best = torch.argmax(corr, dim=-1, keepdim=True)  # ties -> the first index
    scores = torch.gather(corr, 1, best)[:, 0]
    bi = torch.argmax(scores, dim=0, keepdim=True)
    at = best.index_select(0, bi)[0, 0]
    # the histogram placed the sensor at the origin corner shifted by (H/2,
    # W/2): undo both shifts
    row0 = torch.div(at, 2 * w, rounding_mode="floor") - h + h // 2
    col0 = at % (2 * w) - w + w // 2
    pose = torch.stack([
        view.origin[0] + (col0.to(torch.float32) + 0.5) * view.scale,
        view.origin[1] + (row0.to(torch.float32) + 0.5) * view.scale,
        wrap_angle(th.index_select(0, bi)[0]),
    ])
    if cfg.refine_iterations > 0:
        hc = HillClimbingConfig(
            step_xy=view.scale,
            step_theta=float(2 * cfg.half_theta / cfg.n_theta / 2),
            iterations=cfg.refine_iterations,
            scoring=cfg.scoring,
        )
        return hill_climbing_match(view, scan, pose, None, hc, None)
    n_valid = torch.clamp(scan.valid.sum().to(torch.float32), min=1.0)
    return MatchResult(pose=pose, prob=scores.index_select(0, bi)[0] / n_valid,
                       trace=torch.empty((0,), dtype=torch.float32, device=dev))
