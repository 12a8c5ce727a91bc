"""The copy-on-write particle maps over ranks, a pool a rank (port of
``slam_constructor_tpu.parallel.ep_cow``).

The single-device map (``ops/cow.py``) keeps one pool for all particles.
Here the particles are split over a mesh axis and each rank holds a
``cow.CowBlockMaps`` of its own particles, with a pool of its own:

- every operation of a scan is local: the windows for matching
  (``cow.extract_window``, then K5), the copy-on-write preparation and the
  insert (``cow.prepare_insert``: ``kernels.pool_prepare`` on the card;
  ``cow.scatter_observations``: ``kernels.pool_insert``). Sharing happens
  within a rank.
- only resampling crosses ranks: a particle may take its ancestor's map
  from another rank. :func:`ep_resample` all-gathers the tables and the
  pools, as the reference does, and each rank compacts the blocks its new
  particles refer to into its pool (a block whose descendants land on two
  ranks is copied to both). It runs only when resampling fires: the step
  reads the decision on the host (the reference's ``lax.cond``), one read
  a step.

The weights are normalised across ranks (``parallel.particles``), the
ancestors computed alike on every rank from the gathered weights.
"""

from __future__ import annotations

import functools

import torch

from ..models import gmapping as gm_lib
from ..ops import cow as cowlib
from ..ops import grid as gridlib
from ..ops import resample
from ..ops.cells import init_cell
from . import mesh as meshlib
from . import particles as plib

Tensor = torch.Tensor

#: a rank's maps: the tables of its particles over its own pool
EpCowMaps = cowlib.CowBlockMaps

_SENTINEL = torch.iinfo(torch.int64).max  # "no block" after the global-id mapping


def make_ep_maps(model, n_particles: int, tiles_h: int, tiles_w: int, capacity_per_shard: int,
                 mesh, axis: str = "chips", block: int = 32, scale: float = 0.1,
                 origin: tuple[float, float] | None = None, device=None) -> EpCowMaps:
    """This rank's empty maps: the tables of its P/D particles and a pool
    of ``capacity_per_shard`` blocks."""
    lo, hi = meshlib.shard_bounds(n_particles, mesh, axis)
    return cowlib.make_cow_maps(model, hi - lo, tiles_h, tiles_w, capacity_per_shard, block,
                                scale, origin, device)


def ep_insert(st: EpCowMaps, model, poses: Tensor, scans, cfg) -> EpCowMaps:
    """This rank's particles' scans (poses f32[P/D, 3], scans [P/D, R]) into
    its pool, in place (``cow.insert_scans``). No communication."""
    return cowlib.insert_scans(st, model, poses, scans, cfg)


def _unique_fixed(x: Tensor, size: int) -> tuple[Tensor, Tensor]:
    """(the first ``size`` distinct values of ``x`` other than the sentinel,
    ascending, then the sentinel; how many there are), with no host read:
    ``jnp.unique(size=...)``."""
    s, _ = torch.sort(x)
    first = s != _SENTINEL
    first[1:] &= s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1
    out = torch.full((size + 1,), _SENTINEL, dtype=x.dtype, device=x.device)
    out.index_put_((torch.where(first & (rank < size), rank, size),), s)
    return out[:size], first.sum()


def ep_resample(st: EpCowMaps, model, idx: Tensor, mesh, axis: str = "chips") -> EpCowMaps:
    """The ancestors' maps (``idx`` i64[P], the same on every rank) on this
    rank's new particles: the tables and pools of ``axis`` all-gathered,
    the blocks its particles refer to compacted into its pool in the order
    of their global id, the refcounts counted anew. A slot no table refers
    to holds the init cell (the reference's holds zeros; neither is read).
    Past the pool's capacity the overflow latch is set and the blocks that
    found no slot read as unmapped."""
    d = meshlib.axis_size(mesh, axis)
    pl = st.tables.shape[0]
    n = st.capacity
    lo, hi = meshlib.shard_bounds(pl * d, mesh, axis)
    tables_all = meshlib.all_gather(st.tables, mesh, axis).flatten(0, 1)  # [P, TH, TW]
    pools_all = meshlib.all_gather(st.pool, mesh, axis).flatten(0, 1)  # [D N, B, B, C]
    anc = idx[lo:hi]
    t = tables_all.index_select(0, anc).to(torch.int64)
    gid = torch.where(t >= 0, (anc // pl)[:, None, None] * n + t, _SENTINEL)
    uq, n_unique = _unique_fixed(gid.reshape(-1), n)
    valid = uq != _SENTINEL
    pool = torch.where(valid[:, None, None, None],
                       pools_all.index_select(0, torch.where(valid, uq, 0)),
                       init_cell(model, st.pool.device))
    pos = torch.searchsorted(uq, gid).clamp(max=n - 1)
    hit = (gid != _SENTINEL) & (uq[pos] == gid)
    tables = torch.where(hit, pos, -1).to(torch.int32)
    return cowlib.CowBlockMaps(
        pool=pool, tables=tables, refcnt=cowlib._counts(tables.reshape(-1), n),
        origin=st.origin, scale=st.scale, block=st.block,
        overflow=st.overflow | (n_unique > n))


def init_ep_state(cfg: gm_lib.GMappingConfig, mesh, axis: str = "chips",
                  capacity_per_shard: int | None = None, device=None) -> gm_lib.GMappingState:
    """This rank's part of ``gmapping.init_state``'s copy-on-write state: its
    P/D particles at the origin with weights 1/P, over a pool of
    ``capacity_per_shard`` blocks (``tile_capacity / D`` by default)."""
    d = meshlib.axis_size(mesh, axis)
    p = cfg.n_particles
    lo, hi = meshlib.shard_bounds(p, mesh, axis)
    st = make_ep_maps(cfg.cell_model, p, cfg.map_height // cfg.tile_block,
                      cfg.map_width // cfg.tile_block,
                      capacity_per_shard or max(cfg.tile_capacity // d, 1), mesh, axis,
                      cfg.tile_block, cfg.map_scale, device=device)
    return gm_lib.GMappingState(
        gm=st, poses=torch.zeros((hi - lo, 3), dtype=torch.float32, device=device),
        log_weights=resample.log_uniform_weights(p, device)[lo:hi],
        step=torch.zeros((), dtype=torch.int32, device=device))


def make_ep_match(cfg: gm_lib.GMappingConfig):
    """The match of this rank's particles on their own maps:
    ``ep_match(st, scans, priors, centers, sigma, draws) -> (poses f32[P/D,
    3], log-weight increments f32[P/D])``, every argument this rank's
    particles'; the unsharded step's ``gmapping.match_cow``."""
    return functools.partial(gm_lib.match_cow, cfg)


def make_ep_step(cfg: gm_lib.GMappingConfig, mesh, axis: str = "chips"):
    """The RBPF step over copy-on-write pools a rank: ``step(state, scan,
    odom_delta, draws=None, generator=None) -> (state, ancestors i64[P])``
    with ``state`` from :func:`init_ep_state`; ``gmapping.rbpf_step`` with
    the match and insert local, the weights normalised over ranks and
    :func:`ep_resample` when resampling fires."""

    def take(st: EpCowMaps, idx: Tensor, did) -> EpCowMaps:
        return ep_resample(st, cfg.cell_model, idx, mesh, axis) if bool(did) else st

    ops = plib.sharded_ops(cfg, make_ep_match(cfg),
                           lambda st, poses, scans: ep_insert(st, cfg.cell_model, poses, scans,
                                                              cfg.beam),
                           take, mesh, axis)
    return functools.partial(gm_lib.rbpf_step, cfg, ops)


def particle_planes(st: EpCowMaps, model, unknown_prob: float = 0.5) -> Tensor:
    """f32[P/D, H, W]: this rank's particles' value planes,
    ``where(known, occ, unknown)``."""
    pl, th, tw = st.tables.shape
    centers = torch.zeros((pl, 2), device=st.origin.device)
    gm = cowlib.extract_window(st, model, None, centers, th, tw)
    return torch.where(gridlib.known_mask(gm), gridlib.occupancy_plane(gm, model), unknown_prob)


def gather_planes(st: EpCowMaps, model, mesh, axis: str = "chips") -> Tensor:
    """f32[P, H, W]: every particle's value plane (on every rank)."""
    return meshlib.all_gather(particle_planes(st, model), mesh, axis).flatten(0, 1)
