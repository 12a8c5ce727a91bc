"""Copy-on-write block-pool maps for the particle filter (port of
``slam_constructor_tpu.ops.cow``).

One block pool ``f32[N, B, B, C]`` is shared by the P particles, each of
which maps its tiles to pool slots through a table ``i32[P, TH, TW]`` (-1:
no block yet, the tile reads as the init cell). Resampling copies tables
and recounts the blocks' references; map data never moves. Before a
particle writes a tile that it does not own alone, :func:`prepare_write`
gives it a free slot: a fresh tile's block is reset to the init cell, a
shared one's copied from its source. Converged particles share most
blocks, so the pool follows the number of distinct blocks, not P times the
map.

Everything in a step stays on the device. :func:`prepare_insert` is, on
the card, one launch of ``kernels.pool_prepare``: it marks the tiles each
particle's scan touches, compacts the needed (particle, tile) pairs and
the free slots by block prefix sums (the reference's stable ``argsort``
gives the same order), updates the tables, refcounts and the overflow
latch and copies or resets only the new blocks, all in place (the
reference writes only those blocks into a donated state). On the CPU it
is its plain version, :func:`prepare_insert_ref`
(``kernels.pool_touched_ref``, then :func:`prepare_write`, which the tests
hold to the reference). :func:`scatter_observations` then inserts the
scans with ``kernels.pool_insert`` (K3 over the pool's P tables, one launch
on the card from the prepare's work list, the pool updated in place). The
overflow latch is a device bool the host polls now and then
(``GMappingEngine.handle_scan``) before it grows the pool
(:func:`grow_pool`).

Trap o: where more new blocks are needed than the pool has free slots, the
reference's ``prepare_write`` hands the excess entries used slots (its
free-slot list continues with them), so their writes land in other
particles' blocks; the port leaves those entries' tables as they were and
drops their writes (``kernels.pool_insert`` writes a slot only for its one
owner). The overflow latch is set on both sides alike.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import constant
from . import blockmap
from . import grid as gridlib
from . import kernels
from .cells import init_cell

Tensor = torch.Tensor

#: floor of the (particle, tile) new blocks a step may take; the bound grows
#: with the particles (every particle may claim a fresh footprint on one
#: step, the first notably): ``max(MAX_WRITES_PER_STEP, 96 P)``
MAX_WRITES_PER_STEP = 2048


@dataclasses.dataclass
class CowBlockMaps:
    pool: Tensor  # f32[N, B, B, C] shared blocks (belief channels + weight)
    tables: Tensor  # i32[P, TH, TW] each particle's slot of each tile, -1 = none
    refcnt: Tensor  # i32[N] references from all tables
    origin: Tensor  # f32[2] world (x, y) of the corner of tile (0, 0)
    scale: float
    block: int
    overflow: Tensor  # bool[]: a write could not be given a block

    @property
    def n_particles(self) -> int:
        return self.tables.shape[0]

    @property
    def capacity(self) -> int:
        return self.pool.shape[0]


def make_cow_maps(model, n_particles: int, tiles_h: int, tiles_w: int, capacity: int,
                  block: int = 32, scale: float = 0.1, origin: tuple[float, float] | None = None,
                  device=None) -> CowBlockMaps:
    """An empty pool of ``capacity`` blocks and P empty tables; the default
    origin centres the tables on world (0, 0)."""
    cell = init_cell(model, device)
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    return CowBlockMaps(
        pool=cell.expand(capacity, block, block, cell.shape[0]).contiguous(),
        tables=torch.full((n_particles, tiles_h, tiles_w), -1, dtype=torch.int32, device=device),
        refcnt=torch.zeros(capacity, dtype=torch.int32, device=device),
        origin=torch.tensor(origin, dtype=torch.float32, device=device),
        scale=float(scale),
        block=block,
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def _compact(mask: Tensor, size: int, fill: int) -> Tensor:
    """i64[size]: the indices where ``mask`` (1-D) holds, in increasing
    order, then ``fill``: a stable ``argsort(~mask)``'s head, from a
    cumsum and a scatter, with no host read."""
    rank = torch.cumsum(mask, 0) - 1
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    at = torch.where(mask & (rank < size), rank, size)
    out.index_put_((at,), torch.arange(mask.numel(), device=mask.device))
    return out[:size]


def _counts(idx: Tensor, n: int) -> Tensor:
    """i32[n]: how often each of 0 .. n-1 appears in ``idx`` (-1: none)."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    at = torch.where(idx >= 0, idx.to(torch.int64), n)
    out.index_add_(0, at, torch.ones(at.shape, dtype=torch.int32, device=idx.device))
    return out[:n]


def write_budget(p: int, t: int, max_writes: int | None = None) -> int:
    """``k_max``, the new blocks a step may take over P tables of T tiles:
    ``min(max_writes, P T)``, by default ``max_writes = max(
    MAX_WRITES_PER_STEP, 96 P)``."""
    if max_writes is None:
        max_writes = max(MAX_WRITES_PER_STEP, 96 * p)
    return min(max_writes, p * t)


def prepare_write(st: CowBlockMaps, model, touched: Tensor,
                  max_writes: int | None = None) -> CowBlockMaps:
    """Make every (particle, tile) of ``touched`` bool[P, TH, TW] owned
    alone: a free slot for an unmapped tile (reset to the init cell) and
    for a shared one (a copy of its block), in row-major order of the
    needed pairs, the free slots taken in increasing order. At most
    ``k_max = min(max(MAX_WRITES_PER_STEP, 96 P), P TH TW)`` a step; demand
    past it or past the free slots latches ``overflow``, and those writes
    keep their tables (trap o). Returns a state with a new pool."""
    p, th, tw = st.tables.shape
    t = th * tw
    n = st.capacity
    dev = st.pool.device
    k_max = write_budget(p, t, max_writes)
    slot = st.tables.reshape(p * t).to(torch.int64)
    mapped = slot >= 0
    shared = mapped & (st.refcnt.index_select(0, slot.clamp(0, n - 1)) > 1)
    need_new = touched.reshape(p * t) & (~mapped | shared)
    k_needed = need_new.sum()

    sel = _compact(need_new, k_max, p * t)  # the needed pairs first, in order
    free = st.refcnt == 0
    n_free = free.sum()
    free_slots = _compact(free, n, -1)  # the free slots, ascending
    overflow = st.overflow | (k_needed > torch.clamp(n_free, max=k_max))

    ks = torch.arange(k_max, device=dev)
    dst = torch.where((sel < p * t) & (ks < n_free), free_slots[ks.clamp(max=n - 1)], -1)
    sel_c = sel.clamp(max=p * t - 1)
    src = torch.where((dst >= 0) & shared[sel_c], slot[sel_c], -1)

    tables = torch.cat([slot, slot.new_full((1,), -1)])
    tables.index_put_((torch.where(dst >= 0, sel, p * t),), dst)
    tables = tables[:p * t].to(torch.int32).reshape(p, th, tw)

    # each new slot's content: -2 kept, -1 the init cell, else a copy of that slot
    src_of = torch.full((n + 1,), -2, dtype=torch.int64, device=dev)
    src_of.index_put_((torch.where(dst >= 0, dst, n),), src)
    src_of = src_of[:n]
    index = torch.where(src_of == -2, torch.arange(n, device=dev), src_of.clamp(min=0))
    pool = st.pool.index_select(0, index)
    cell = constant((*model.init_belief(), 0.0), torch.float32, dev)
    pool = torch.where((src_of == -1)[:, None, None, None], cell, pool)

    refcnt = st.refcnt - _counts(src, n) + _counts(dst, n)
    return dataclasses.replace(st, tables=tables, pool=pool, refcnt=refcnt, overflow=overflow)


def touched_tiles(st: CowBlockMaps, poses: Tensor, scans, cfg) -> Tensor:
    """bool[P, TH, TW]: the tiles that particle p's scan (``poses`` f32[P,
    3], ``scans`` [P, R]) puts evidence in (``kernels.pool_touched``)."""
    return kernels.pool_touched(tuple(st.tables.shape[1:]), st.block, st.origin, st.scale,
                                poses, scans, cfg)


def prepare_insert(st: CowBlockMaps, model, poses: Tensor, scans, cfg,
                   q: Tensor | None = None, max_writes: int | None = None):
    """:func:`touched_tiles` and :func:`prepare_write` (``k_max`` by
    :func:`write_budget`), in place: the state's pool, tables, refcounts and
    latch are the prepared ones. Returns (touched bool[P, TH, TW], the work
    list for :func:`scatter_observations`). On the card one launch of
    ``kernels.pool_prepare``; on the CPU :func:`prepare_insert_ref`."""
    p, th, tw = st.tables.shape
    if st.pool.device.type == "cpu":
        return prepare_insert_ref(st, model, poses, scans, cfg, q, max_writes)
    return kernels.pool_prepare(st.pool, st.tables, st.origin, st.scale, model, poses, scans,
                                cfg, q, refcnt=st.refcnt, overflow=st.overflow,
                                k_max=write_budget(p, th * tw, max_writes))


def prepare_insert_ref(st: CowBlockMaps, model, poses: Tensor, scans, cfg,
                       q: Tensor | None = None, max_writes: int | None = None):
    """Plain PyTorch version of ``kernels.pool_prepare`` on the
    copy-on-write pool: ``kernels.pool_touched_ref``, then
    :func:`prepare_write`, its state copied into ``st``'s tensors, then
    ``kernels.pool_work_ref``."""
    p, th, tw = st.tables.shape
    touched = kernels.pool_touched_ref((th, tw), st.block, st.origin, st.scale, poses, scans,
                                       cfg, q)
    new = prepare_write(st, model, touched, max_writes)
    new_blocks = (new.tables != st.tables).sum()
    for name in ("tables", "refcnt", "overflow", "pool"):
        getattr(st, name).copy_(getattr(new, name))
    return touched, kernels.pool_work_ref(st.tables, touched, st.capacity, poses, st.origin,
                                          st.scale, st.block, st.refcnt, copies=new_blocks)


def scatter_observations(st: CowBlockMaps, model, poses: Tensor, scans, cfg,
                         touched: Tensor, work=None) -> CowBlockMaps:
    """Insert particle p's scan into its tiles and fold every live block:
    ``kernels.pool_insert`` over the P tables, the pool updated in place
    (``work``: :func:`prepare_insert`'s). Every touched (particle, tile)
    must own its block alone (:func:`prepare_write`); a write that does not
    is dropped. The reference takes the samples, flattened across
    particles; the kernel makes them from the scans, in the same order."""
    kernels.pool_insert(st.pool, st.tables, st.origin, st.scale, model, poses, scans, cfg,
                        touched, refcnt=st.refcnt, work=work)
    return st


def extract_window(st: CowBlockMaps, model, p, center: Tensor, tiles_h: int,
                   tiles_w: int) -> gridlib.GridMap:
    """The dense window of ``tiles_h x tiles_w`` tiles around ``center``
    f32[2] of particle ``p``'s map (``blockmap.gather_window`` over its
    table); ``p`` None: every particle's around ``center`` f32[P, 2], in
    one gather."""
    tables = st.tables if p is None else st.tables[p]
    return blockmap.gather_window(tables, st.pool, model, st.origin, st.scale, center, tiles_h,
                                  tiles_w)


def resample(st: CowBlockMaps, idx: Tensor) -> CowBlockMaps:
    """The ancestors' tables (``idx`` i64[P]), the references recounted;
    no block moves."""
    tables = st.tables.index_select(0, idx)
    return dataclasses.replace(st, tables=tables, refcnt=_counts(tables.reshape(-1), st.capacity))


def distinct_blocks(st: CowBlockMaps) -> Tensor:
    """i64[]: the blocks some table refers to."""
    return (st.refcnt > 0).sum()


def grow_pool(st: CowBlockMaps, model, new_capacity: int) -> CowBlockMaps:
    """A host event: the pool padded with init blocks to ``new_capacity``,
    the refcounts with zeros, the overflow latch cleared. Slots keep their
    numbers, so the tables stay valid."""
    if new_capacity < st.capacity:
        raise ValueError(f"grow_pool: {new_capacity} blocks < the pool's {st.capacity}")
    dev = st.pool.device
    cell = init_cell(model, dev)
    pad = cell.expand(new_capacity - st.capacity, st.block, st.block, cell.shape[0])
    return dataclasses.replace(
        st, pool=torch.cat([st.pool, pad]),
        refcnt=torch.cat([st.refcnt, torch.zeros(new_capacity - st.capacity, dtype=torch.int32,
                                                  device=dev)]),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )
