"""Block-pool tiled occupancy map (port of
``slam_constructor_tpu.ops.blockmap``): the sparse map whose memory follows
the visited area.

A fixed-capacity pool of blocks ``f32[N, B, B, C]`` (C = the cell model's
belief channels + the weight) and a table ``i32[TH, TW]`` that gives each
tile of the map its pool slot (-1: no block yet, the tile reads as the
init cell). Tiles are allocated on the device, by a cumsum over the tiles a
scan touches: no host round trip, ``n_alloc`` stays a device tensor, and
the slots are the reference's, so that two pools compare directly. At
exhaustion a tile stays unallocated and its samples are dropped, while
``n_alloc`` counts the demand, so ``overflowed`` latches.

A scan goes in by :func:`insert_scan`: ``kernels.pool_touched`` marks the
tiles its samples touch, :func:`allocate_tiles` gives them slots, and
``kernels.pool_insert`` (K3 over the pool: one launch on the card, a block
a slot) adds the samples in the reference's order and folds every
allocated block, in place: the state's pool is the new state's. The
reference's ``scatter_observations`` took the samples themselves; its body
is ``kernels.pool_insert_ref``, with the samples made from the scan.

The reference adds an exhausted tile's samples at flat index -1, which
wraps into the last cell of the last block (its scatter drops only indices
past the end); the port drops them (ROADMAP Queue 3, trap n).

Scoring reads a dense window: :func:`extract_window` gathers the
block-aligned ``tiles_h x tiles_w`` tiles around the robot into a
``GridMap``, and every matcher runs on it unchanged; :func:`gather_window`
takes P tables and P centres in one gather (the copy-on-write maps'
particles).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import constant
from . import grid as gridlib
from .cells import init_cell

Tensor = torch.Tensor


@dataclasses.dataclass
class BlockMap:
    pool: Tensor  # f32[N, B, B, C] allocated blocks (belief channels + weight)
    table: Tensor  # i32[TH, TW] pool slot of each tile, -1 = unallocated
    n_alloc: Tensor  # i32[] blocks asked for so far (may pass the capacity)
    origin: Tensor  # f32[2] world (x, y) of the corner of tile (0, 0)
    scale: float
    block: int

    @property
    def capacity(self) -> int:
        return self.pool.shape[0]

    @property
    def height(self) -> int:
        return self.table.shape[0] * self.block

    @property
    def width(self) -> int:
        return self.table.shape[1] * self.block

    @property
    def overflowed(self) -> Tensor:
        return self.n_alloc > self.capacity


def make_block_map(model, tiles_h: int, tiles_w: int, capacity: int, block: int = 32,
                   scale: float = 0.1, origin: tuple[float, float] | None = None,
                   device=None) -> BlockMap:
    """An empty pool; the default origin centres the table on world (0, 0)."""
    cell = init_cell(model, device)
    pool = cell.expand(capacity, block, block, cell.shape[0]).contiguous()
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    return BlockMap(
        pool=pool,
        table=torch.full((tiles_h, tiles_w), -1, dtype=torch.int32, device=device),
        n_alloc=torch.zeros((), dtype=torch.int32, device=device),
        origin=torch.tensor(origin, dtype=torch.float32, device=device),
        scale=float(scale),
        block=block,
    )


def allocate_tiles(bm: BlockMap, needed: Tensor) -> BlockMap:
    """Give a pool slot to every tile where ``needed`` bool[TH, TW] is set
    and the table has none, in row-major order from ``n_alloc``. A tile
    past the capacity stays unallocated (-1)."""
    new = (needed & (bm.table < 0)).reshape(-1)
    slots = bm.n_alloc + torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = torch.where(slots < bm.capacity, slots, -1)
    slots = torch.where(new, slots, bm.table.reshape(-1))
    return dataclasses.replace(
        bm, table=slots.reshape(bm.table.shape),
        n_alloc=bm.n_alloc + new.sum(dtype=torch.int32),
    )


def cells_to_slots(bm: BlockMap, rows: Tensor, cols: Tensor):
    """Cell (row, col) -> (pool slot, row in the block, col in the block,
    valid): valid where the cell lies on the table and its tile has a
    block."""
    b = bm.block
    th, tw = bm.table.shape
    tr, rr = rows // b, rows % b
    tc, cc = cols // b, cols % b
    ok = (tr >= 0) & (tr < th) & (tc >= 0) & (tc < tw)
    slot = bm.table[tr.clamp(0, th - 1), tc.clamp(0, tw - 1)]
    slot = torch.where(ok, slot, -1)
    return slot, rr, cc, ok & (slot >= 0)


def insert_scan(bm: BlockMap, model, pose: Tensor, scan, cfg, q: Tensor | None = None
                ) -> BlockMap:
    """Scan insertion into the tiled map: the dense path's rasterisation
    (``raycast.scan_sample_cells``, scaled by ``q``) into the pool, after
    allocating the tiles it touches; every allocated block is folded. The
    pool is updated in place. Two kernel launches on the card
    (``kernels.pool_touched``, ``kernels.pool_insert``), nothing read on
    the host."""
    from . import kernels

    scans = type(scan)(scan.ranges[None], scan.bearings[None], scan.valid[None])
    touched = kernels.pool_touched(tuple(bm.table.shape), bm.block, bm.origin, bm.scale,
                                   pose[None], scans, cfg, q)
    bm = allocate_tiles(bm, touched[0])
    kernels.pool_insert(bm.pool, bm.table[None], bm.origin, bm.scale, model, pose[None], scans,
                        cfg, touched, q, n_live=bm.n_alloc)
    return bm


def gather_window(table: Tensor, pool: Tensor, model, origin: Tensor, scale: float,
                  center: Tensor, tiles_h: int, tiles_w: int) -> gridlib.GridMap:
    """The block-aligned ``tiles_h x tiles_w`` tiles around world point
    ``center`` f32[2], clamped into the table, as a dense ``GridMap``
    (unallocated tiles read as the init cell). With P tables ``table``
    i32[P, TH, TW] and ``center`` f32[P, 2], P windows in one gather
    (cells f32[P, h, w, C], origin f32[P, 2]). The corners stay on the
    device: the tiles are gathered by index tensors."""
    n, b = pool.shape[0], pool.shape[1]
    th, tw = table.shape[-2:]
    dev = table.device
    rel = gridlib.div_scale(center - origin, scale)
    ct = torch.floor(rel).to(torch.int64)  # (col, row)
    t0r = torch.clamp(ct[..., 1] // b - tiles_h // 2, 0, max(th - tiles_h, 0))
    t0c = torch.clamp(ct[..., 0] // b - tiles_w // 2, 0, max(tw - tiles_w, 0))
    # a window wider than the table repeats its last tile, as the
    # reference's clamped gather does
    tr = torch.clamp(t0r[..., None] + torch.arange(tiles_h, device=dev), max=th - 1)
    tc = torch.clamp(t0c[..., None] + torch.arange(tiles_w, device=dev), max=tw - 1)
    if table.dim() == 3:
        which = torch.arange(table.shape[0], device=dev)[:, None, None]
        slots = table[which, tr[:, :, None], tc[:, None, :]]
    else:
        slots = table[tr[:, None], tc[None, :]]
    slots = slots.to(torch.int64)  # [..., tiles_h, tiles_w]
    # the init cell from the constants made once a process: a copy from
    # the host would wait for the device
    cell = constant((*model.init_belief(), 0.0), torch.float32, dev)
    blocks = torch.where((slots >= 0)[..., None, None, None], pool[slots.clamp(0, n - 1)],
                         cell)  # [..., tiles_h, tiles_w, B, B, C]
    lead = blocks.shape[:-5]
    dense = blocks.transpose(-4, -3).reshape(*lead, tiles_h * b, tiles_w * b, -1)
    w_origin = origin + torch.stack([t0c, t0r], dim=-1).to(torch.float32) * (b * scale)
    return gridlib.GridMap(cells=dense, origin=w_origin, scale=scale)


def extract_window(bm: BlockMap, model, center: Tensor, tiles_h: int,
                   tiles_w: int) -> gridlib.GridMap:
    """The ``tiles_h x tiles_w`` window around ``center`` as a dense map,
    for scoring and matching."""
    return gather_window(bm.table, bm.pool, model, bm.origin, bm.scale, center, tiles_h, tiles_w)


def occupancy_plane(bm: BlockMap, model) -> Tensor:
    """f32[TH * B, TW * B]: the whole map's occupancy, densified."""
    th, tw = bm.table.shape
    gm = extract_window(bm, model, torch.zeros(2, device=bm.origin.device), th, tw)
    return gridlib.occupancy_plane(gm, model)


def allocated_fraction(bm: BlockMap) -> Tensor:
    return bm.n_alloc.to(torch.float32) / bm.capacity
