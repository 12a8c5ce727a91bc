"""Row-sharded and beam-sharded scan scoring (port of
``slam_constructor_tpu.parallel.halo``).

The plane ``where(known, occ, unknown)`` is split by rows over a mesh
axis: rank d owns rows [d H/D, (d + 1) H/D). A beam's endpoint reads the
cells around it (the bilinear taps one row on either side, a reducer of
radius r that many rows), so endpoints near a boundary read a neighbour's
rows. Each rank swaps ``halo`` boundary rows with its two ring neighbours
(:func:`_exchange_rows`), scores the endpoints whose centre row it owns on
its extended block with one launch of ``kernels.overlap_score_partial``
(the sums (num, den) of each pose over its owned beams), and an all-reduce
adds the ranks' sums: the unsharded score, up to the order of the sums,
for any reducer whose radius is at most ``halo``.

:func:`beam_sharded_score_poses` splits the beams instead (they are
independent given the pose): each rank scores its share against the whole
plane, by the same kernel with every row owned, and one all-reduce adds
the sums.

The reference's one-hot matmul path for the TPU's matrix unit
(``_use_matmul``, ``_ext_point_probs_matmul``) is not ported: the port's
kernel reads the cells.
"""

from __future__ import annotations

import torch

from ..ops import kernels
from ..ops import scan as scanlib
from ..ops import scoring
from . import mesh as meshlib

Tensor = torch.Tensor


def _exchange_rows(block: Tensor, halo: int, mesh, axis: str) -> Tensor:
    """f32[Hl, W] -> f32[Hl + 2 halo, W]: the last ``halo`` rows of the rank
    before and the first ``halo`` rows of the rank after, around the block.
    The first and the last rank get the ring's wrap-around rows, which lie
    off the plane and are never read."""
    if not 0 < halo <= block.shape[0]:
        raise ValueError(f"a halo of {halo} rows around a block of {block.shape[0]}")
    from_below = meshlib.ppermute(block[-halo:], mesh, axis, 1)
    from_above = meshlib.ppermute(block[:halo], mesh, axis, -1)
    return torch.cat([from_below, block, from_above], dim=0)


def _halo_rows(cfg: scoring.ScoringConfig, halo: int | None) -> tuple[kernels.Reducer, int]:
    red = scoring.reducer_of(cfg)
    need = kernels._partial_need(red)
    halo = max(need, 1) if halo is None else halo
    if halo < need:
        raise ValueError(f"a halo of {halo} rows is less than the {need} the reducer reads")
    return red, halo


def _ratio(sums: Tensor) -> Tensor:
    return sums[:, 0] / torch.clamp(sums[:, 1], min=1e-9)


def sharded_band_score(band: Tensor, row0: int, h: int, halo: int, scan: scanlib.LaserScan,
                       poses: Tensor, origin: Tensor, scale: float, cfg: scoring.ScoringConfig,
                       red: kernels.Reducer, mesh, axis: str) -> Tensor:
    """The score f32[K] of poses f32[K, 3] on an h-row plane of which this
    rank holds the rows [row0, row0 + Hl) in ``band``: halo rows swapped,
    the owned beams' sums taken, the sums added over ``axis``."""
    ext = _exchange_rows(band, halo, mesh, axis)
    pts, beam_w = scoring.prepare_scan(scan, cfg)
    part = kernels.overlap_score_partial(
        ext, row0 - halo, h, poses.contiguous(), pts, beam_w, origin.contiguous(), float(scale),
        float(cfg.unknown_prob), row0, row0 + band.shape[0], red)
    return _ratio(meshlib.psum(part, mesh, axis))


def sharded_score_poses(view: scoring.MapView, scan: scanlib.LaserScan, poses: Tensor,
                        cfg: scoring.ScoringConfig, mesh, axis: str = "chips",
                        halo: int | None = None) -> Tensor:
    """Row-sharded ``scoring.score_poses``, every reducer: the view on
    every rank, this rank's rows taken from it; the score f32[K] on every
    rank. ``halo`` defaults to the rows the reducer reads (at least 1)."""
    h = view.occ.shape[0]
    lo, hi = meshlib.shard_bounds(h, mesh, axis)
    red, halo = _halo_rows(cfg, halo)
    plane = torch.where(view.known[lo:hi], view.occ[lo:hi], cfg.unknown_prob).contiguous()
    return sharded_band_score(plane, lo, h, halo, scan, poses, view.origin, view.scale, cfg, red,
                              mesh, axis)


def beam_sharded_score_poses(view: scoring.MapView, scan: scanlib.LaserScan, poses: Tensor,
                             cfg: scoring.ScoringConfig, mesh, axis: str = "chips") -> Tensor:
    """Beam-sharded ``scoring.score_poses``: this rank's share of the
    kept beams scored on the whole plane (every row owned), the sums added
    over ``axis``."""
    h = view.occ.shape[0]
    pts, beam_w = scoring.prepare_scan(scan, cfg)
    d, i = meshlib.axis_size(mesh, axis), meshlib.axis_index(mesh, axis)
    pts = pts.tensor_split(d)[i].contiguous()
    beam_w = beam_w.tensor_split(d)[i].contiguous()
    plane = torch.where(view.known, view.occ, cfg.unknown_prob).contiguous()
    part = kernels.overlap_score_partial(
        plane, 0, h, poses.contiguous(), pts, beam_w, view.origin.contiguous(),
        float(view.scale), float(cfg.unknown_prob), 0, h, scoring.reducer_of(cfg))
    return _ratio(meshlib.psum(part, mesh, axis))
