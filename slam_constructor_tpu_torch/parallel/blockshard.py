"""The block-pool map sharded by tile rows (port of
``slam_constructor_tpu.parallel.blockshard``).

The tile table ``[TH, TW]`` is split by rows over a mesh axis: rank d owns
the tile rows [d TH/D, (d + 1) TH/D) in a pool of its own, so the pool's
capacity grows with the ranks. A rank's band is a port ``BlockMap`` over
its tile rows whose origin is the map's shifted by the band's first row.

- **Insertion needs no communication.** Every rank rasterises the whole
  scan and keeps the samples that fall in its band: the unchanged
  ``kernels.pool_prepare`` and ``kernels.pool_insert`` run on the band's
  map, where a sample off the band's table is dropped, as the reference's
  band scatter zeroes its weight (``ops/blockmap.py`` neither allocates
  nor writes a sample of weight 0). A band's slots are given in the order
  the reference gives them.
- **Scoring swaps halos.** Each rank densifies its band
  (``blockmap.gather_window``), swaps ``halo`` boundary rows with its ring
  neighbours and sums the beams whose centre row it owns
  (``parallel.halo``: one launch of ``kernels.overlap_score_partial``), and
  an all-reduce adds the sums.

The band's origin is the map's plus ``row0 * scale`` in float32, so a
sample within an ulp of a cell's edge may fall in the neighbouring cell
where the unsharded map would not (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import blockmap as bmlib
from ..ops import grid as gridlib
from ..ops import scan as scanlib
from ..ops import scoring
from . import halo as halolib
from . import mesh as meshlib

Tensor = torch.Tensor


@dataclasses.dataclass
class ShardedBlockMap:
    band: bmlib.BlockMap  # this rank's tile rows, in a pool of its own
    origin: Tensor  # f32[2] world (x, y) of the whole map's cell (0, 0)
    row0: int  # the band's first cell row in the whole map
    tiles_h: int  # the whole map's tile rows

    @property
    def height(self) -> int:
        return self.tiles_h * self.band.block

    @property
    def width(self) -> int:
        return self.band.width

    @property
    def overflowed(self) -> Tensor:
        return self.band.overflowed


def make_sharded_block_map(model, tiles_h: int, tiles_w: int, capacity_per_shard: int, mesh,
                           axis: str = "chips", block: int = 32, scale: float = 0.1,
                           origin: tuple[float, float] | None = None,
                           device=None) -> ShardedBlockMap:
    """This rank's band of an empty ``tiles_h x tiles_w`` map (the tile
    rows must divide the ranks); the default origin centres the map."""
    lo, hi = meshlib.shard_bounds(tiles_h, mesh, axis)
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    g_origin = torch.tensor(origin, dtype=torch.float32, device=device)
    band = bmlib.make_block_map(model, hi - lo, tiles_w, capacity_per_shard, block, scale,
                                device=device)
    band.origin = g_origin + torch.stack(
        [torch.zeros((), device=device), torch.full((), float(lo * block), device=device)]
    ) * scale
    return ShardedBlockMap(band=band, origin=g_origin, row0=lo * block, tiles_h=tiles_h)


def insert_scan(sbm: ShardedBlockMap, model, pose: Tensor, scan: scanlib.LaserScan,
                cfg) -> ShardedBlockMap:
    """The scan's samples in this rank's band (``blockmap.insert_scan`` on
    the band: a sample off it is dropped); no communication, in place."""
    bmlib.insert_scan(sbm.band, model, pose, scan, cfg)
    return sbm


def band_value_plane(sbm: ShardedBlockMap, model, unknown_prob: float) -> Tensor:
    """f32[Hl, W]: this rank's band densified, ``where(known, occ,
    unknown)``."""
    bm = sbm.band
    th, tw = bm.table.shape
    gm = bmlib.gather_window(bm.table, bm.pool, model, bm.origin, bm.scale,
                             torch.zeros(2, device=bm.origin.device), th, tw)
    return torch.where(gridlib.known_mask(gm), gridlib.occupancy_plane(gm, model),
                       unknown_prob).contiguous()


def score_poses(sbm: ShardedBlockMap, model, scan: scanlib.LaserScan, poses: Tensor,
                cfg: scoring.ScoringConfig, mesh, axis: str = "chips",
                halo: int | None = None) -> Tensor:
    """The scan's score f32[K] on the whole map at poses f32[K, 3] (every
    reducer): bands densified, halo rows swapped, owned beams summed, the
    sums added over ``axis``."""
    red, halo = halolib._halo_rows(cfg, halo)
    plane = band_value_plane(sbm, model, cfg.unknown_prob)
    return halolib.sharded_band_score(plane, sbm.row0, sbm.height, halo, scan, poses, sbm.origin,
                                      sbm.band.scale, cfg, red, mesh, axis)


def gather_value_plane(sbm: ShardedBlockMap, model, mesh, axis: str = "chips",
                       unknown_prob: float = 0.5) -> Tensor:
    """f32[H, W]: the whole map's value plane, the bands stacked (on every
    rank)."""
    plane = band_value_plane(sbm, model, unknown_prob)
    return meshlib.all_gather(plane, mesh, axis).flatten(0, 1)


def allocated_per_shard(sbm: ShardedBlockMap, mesh, axis: str = "chips") -> Tensor:
    """i32[D]: the blocks each rank's band has asked for."""
    return meshlib.all_gather(sbm.band.n_alloc, mesh, axis)
