"""Particles over ranks times map bands over ranks, on one 2-D mesh
``("pgroups", "bands")`` (port of ``slam_constructor_tpu.parallel.ep2d``).

``parallel/ep_cow.py`` splits the particles; ``parallel/blockshard.py``
splits a map's tile rows. A large RBPF needs both: more particles than one
device holds maps for, and maps larger than one device's pool. Rank
``(g, b)`` holds, for the particles of group ``g``, the blocks of tile-row
band ``b`` only, in a pool of its own (a ``cow.CowBlockMaps`` over the
band's tile rows, its origin shifted by the band's first row):

- **Insertion is local.** A rank inserts its particles' scans into its
  band (``kernels.pool_prepare`` and ``kernels.pool_insert`` on the band's
  maps): a sample off the band is dropped.
- **Matching windows are added over ``"bands"``.** Each band fills the
  window tiles it owns (the init cell where a tile has no block) and zeros
  elsewhere; an all-reduce over the bands gives every band the whole
  windows, and the match (``gmapping.match_particles``) runs alike on every
  band of a group.
- **Resampling moves blocks between particle groups within a band**
  (``ep_cow.ep_resample`` over ``"pgroups"`` only): a band's rows stay in
  that band under any ancestry.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..models import gmapping as gm_lib
from ..ops import cow as cowlib
from ..ops import grid as gridlib
from ..ops import resample, scoring
from ..ops.cells import init_cell
from . import ep_cow
from . import mesh as meshlib
from . import particles as plib

Tensor = torch.Tensor

AXES = ("pgroups", "bands")


@dataclasses.dataclass
class Ep2dMaps:
    band: cowlib.CowBlockMaps  # this rank's particles' tables over its band, its own pool
    origin: Tensor  # f32[2] world (x, y) of the whole map's cell (0, 0)
    row0: int  # the band's first cell row in the whole map
    tiles_h: int  # the whole map's tile rows


def make_ep2d_maps(model, n_particles: int, tiles_h: int, tiles_w: int,
                   capacity_per_device: int, mesh, block: int = 32, scale: float = 0.1,
                   origin: tuple[float, float] | None = None, device=None) -> Ep2dMaps:
    """This rank's empty band of its group's particles' maps."""
    plo, phi = meshlib.shard_bounds(n_particles, mesh, "pgroups")
    tlo, thi = meshlib.shard_bounds(tiles_h, mesh, "bands")
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    g_origin = torch.tensor(origin, dtype=torch.float32, device=device)
    band = cowlib.make_cow_maps(model, phi - plo, thi - tlo, tiles_w, capacity_per_device, block,
                                scale, origin, device)
    band.origin = g_origin + torch.stack(
        [torch.zeros((), device=device), torch.full((), float(tlo * block), device=device)]
    ) * scale
    return Ep2dMaps(band=band, origin=g_origin, row0=tlo * block, tiles_h=tiles_h)


def ep2d_insert(st: Ep2dMaps, model, poses: Tensor, scans, cfg) -> Ep2dMaps:
    """This rank's particles' scans into its band, in place; no
    communication."""
    ep_cow.ep_insert(st.band, model, poses, scans, cfg)
    return st


def _band_window_contrib(st: Ep2dMaps, model, center: Tensor, wt: int):
    """This band's share of each of its particles' ``wt x wt``-tile windows
    around ``center`` f32[P/Dp, 2] (placed as ``blockmap.gather_window``
    places them on the whole table): the tiles it owns (the init cell
    where unallocated), zeros elsewhere. Returns (cells f32[P/Dp, wt B, wt
    B, C], window origins f32[P/Dp, 2])."""
    bm = st.band
    b, n = bm.block, bm.capacity
    thl, tw = bm.tables.shape[1:]
    th = st.tiles_h
    dev = center.device
    rel = gridlib.div_scale(center - st.origin, bm.scale)
    ct = torch.floor(rel).to(torch.int64)  # (col, row)
    t0r = torch.clamp(ct[..., 1] // b - wt // 2, 0, max(th - wt, 0))
    t0c = torch.clamp(ct[..., 0] // b - wt // 2, 0, max(tw - wt, 0))
    tr = torch.clamp(t0r[:, None] + torch.arange(wt, device=dev), max=th - 1)
    tc = torch.clamp(t0c[:, None] + torch.arange(wt, device=dev), max=tw - 1)
    ltr = tr - st.row0 // b
    own = (ltr >= 0) & (ltr < thl)  # [P, wt]
    which = torch.arange(bm.tables.shape[0], device=dev)[:, None, None]
    slots = bm.tables[which, ltr.clamp(0, thl - 1)[:, :, None], tc[:, None, :]].to(torch.int64)
    cell = init_cell(model, dev)
    owned = own[:, :, None, None, None, None]
    blocks = torch.where(owned & (slots >= 0)[..., None, None, None],
                         bm.pool[slots.clamp(0, n - 1)],
                         torch.where(owned, cell, torch.zeros_like(cell)))
    dense = blocks.transpose(-4, -3).reshape(blocks.shape[0], wt * b, wt * b, -1)
    w_origin = st.origin + torch.stack([t0c, t0r], dim=-1).to(torch.float32) * (b * bm.scale)
    return dense, w_origin


def make_ep2d_match(cfg: gm_lib.GMappingConfig, mesh):
    """The match of this rank's group's particles: ``ep2d_match(st, scans,
    priors, centers, sigma, draws) -> (poses f32[P/Dp, 3], increments
    f32[P/Dp])``, the same on every band of the group. The windows are
    added over ``"bands"``, then ``gmapping.match_particles``."""
    wt = cfg.window_tiles

    def ep2d_match(st: Ep2dMaps, scans, priors, centers, sigma, draws):
        dense, w_origin = _band_window_contrib(st, cfg.cell_model, priors[:, :2], wt)
        dense = meshlib.psum(dense, mesh, "bands")
        gm = gridlib.GridMap(cells=dense, origin=w_origin, scale=st.band.scale)
        view = scoring.MapView.of(gm, cfg.cell_model)
        return gm_lib.match_particles(cfg, view, scans, priors, centers, sigma, draws)

    return ep2d_match


def ep2d_resample(st: Ep2dMaps, model, idx: Tensor, mesh) -> Ep2dMaps:
    """The ancestors' band blocks (``idx`` i64[P]) moved between the
    particle groups of this band: ``ep_cow.ep_resample`` over
    ``"pgroups"``."""
    band = ep_cow.ep_resample(st.band, model, idx, mesh, "pgroups")
    return dataclasses.replace(st, band=band)


def init_ep2d_state(cfg: gm_lib.GMappingConfig, mesh, capacity_per_device: int | None = None,
                    device=None) -> gm_lib.GMappingState:
    """This rank's part of the copy-on-write state on the 2-D mesh (pools
    of ``tile_capacity / (Dp Db)`` blocks by default)."""
    p = cfg.n_particles
    n_dev = meshlib.axis_size(mesh, "pgroups") * meshlib.axis_size(mesh, "bands")
    lo, hi = meshlib.shard_bounds(p, mesh, "pgroups")
    st = make_ep2d_maps(cfg.cell_model, p, cfg.map_height // cfg.tile_block,
                        cfg.map_width // cfg.tile_block,
                        capacity_per_device or max(cfg.tile_capacity // n_dev, 1), mesh,
                        cfg.tile_block, cfg.map_scale, device=device)
    return gm_lib.GMappingState(
        gm=st, poses=torch.zeros((hi - lo, 3), dtype=torch.float32, device=device),
        log_weights=resample.log_uniform_weights(p, device)[lo:hi],
        step=torch.zeros((), dtype=torch.int32, device=device))


def make_ep2d_step(cfg: gm_lib.GMappingConfig, mesh):
    """The RBPF step on the 2-D mesh: ``step(state, scan, odom_delta,
    draws=None, generator=None) -> (state, ancestors i64[P])``;
    ``gmapping.rbpf_step`` with the weights normalised over ``"pgroups"``
    (every band of a group holds the same) and :func:`ep2d_resample` when
    resampling fires."""

    def take(st: Ep2dMaps, idx: Tensor, did) -> Ep2dMaps:
        return ep2d_resample(st, cfg.cell_model, idx, mesh) if bool(did) else st

    ops = plib.sharded_ops(cfg, make_ep2d_match(cfg, mesh),
                           lambda st, poses, scans: ep2d_insert(st, cfg.cell_model, poses, scans,
                                                                cfg.beam),
                           take, mesh, "pgroups")
    return functools.partial(gm_lib.rbpf_step, cfg, ops)


def gather_planes(st: Ep2dMaps, model, mesh) -> Tensor:
    """f32[P, H, W]: every particle's value plane (on every rank): each
    rank densifies its band of its particles, the bands stacked along H."""
    planes = ep_cow.particle_planes(st.band, model)  # [P/Dp, Hl, W]
    bands = meshlib.all_gather(planes, mesh, "bands")  # [Db, P/Dp, Hl, W]
    whole = bands.transpose(0, 1).flatten(1, 2)  # [P/Dp, H, W]
    return meshlib.all_gather(whole.contiguous(), mesh, "pgroups").flatten(0, 1)
