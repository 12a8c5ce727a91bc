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

The reference adds an exhausted tile's samples at flat index -1, which
wraps into the last cell of the last block (its scatter drops only indices
past the end); the port drops them (ROADMAP Queue 3, trap n).

Scoring reads a dense window: :func:`extract_window` gathers the
block-aligned ``tiles_h x tiles_w`` tiles around the robot into a
``GridMap``, and every matcher runs on it unchanged.
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


def scatter_observations(bm: BlockMap, model, rows: Tensor, cols: Tensor, w: Tensor,
                         s: Tensor) -> BlockMap:
    """Add observation samples (weight ``w``, occupancy sum ``s`` at cell
    (row, col)) into the pool, allocating the tiles they touch, then fold
    them into the cells with the cell model, over the whole pool (a cell
    with no sample is left as it was).

    The sums are ``index_put_(accumulate=True)``: a fixed order on the card,
    so the pool is the same bits on every run. A sample of weight 0, off
    the map or in a tile the exhausted pool could not give a block is
    dropped."""
    b = bm.block
    th, tw = bm.table.shape
    valid = (w > 0) & (rows >= 0) & (rows < th * b) & (cols >= 0) & (cols < tw * b)
    tile = (rows // b).clamp(0, th - 1) * tw + (cols // b).clamp(0, tw - 1)
    touched = torch.zeros(th * tw, dtype=torch.int32, device=w.device)
    touched.scatter_add_(0, tile.reshape(-1), valid.reshape(-1).to(torch.int32))
    bm = allocate_tiles(bm, touched.reshape(th, tw) > 0)

    slot, rr, cc, ok = cells_to_slots(bm, rows, cols)
    n, bb = bm.capacity, b * b
    keep = (ok & valid).reshape(-1)
    # a dropped sample adds 0.0 to a cell spread by its position, so that
    # dropped samples do not pile up on one address of the sorted scatter
    spread = torch.arange(keep.numel(), device=w.device) % (n * bb)
    lin = torch.where(keep, (slot.to(torch.int64) * bb + rr * b + cc).reshape(-1), spread)
    w_flat = torch.zeros(n * bb, dtype=torch.float32, device=w.device)
    s_flat = torch.zeros(n * bb, dtype=torch.float32, device=w.device)
    w_flat.index_put_((lin,), torch.where(keep, w.reshape(-1), 0.0), accumulate=True)
    s_flat.index_put_((lin,), torch.where(keep, s.reshape(-1), 0.0), accumulate=True)
    w_obs, s_obs = w_flat.reshape(n, b, b), s_flat.reshape(n, b, b)

    n_prev = bm.pool[..., -1]
    belief = model.update(bm.pool[..., :-1], n_prev, w_obs, s_obs)
    return dataclasses.replace(bm, pool=torch.cat([belief, (n_prev + w_obs)[..., None]], dim=-1))


def insert_scan(bm: BlockMap, model, pose: Tensor, scan, cfg) -> BlockMap:
    """Scan insertion into the tiled map: the dense path's rasterisation
    (``raycast.scan_sample_cells``) scattered into the pool."""
    from . import raycast

    rows, cols, w_obs, s_obs = raycast.scan_sample_cells(bm.origin, bm.scale, pose, scan, cfg)
    return scatter_observations(bm, model, rows, cols, w_obs, s_obs)


def gather_window(table: Tensor, pool: Tensor, model, origin: Tensor, scale: float,
                  center: Tensor, tiles_h: int, tiles_w: int) -> gridlib.GridMap:
    """The block-aligned ``tiles_h x tiles_w`` tiles around world point
    ``center`` f32[2], clamped into the table, as a dense ``GridMap``
    (unallocated tiles read as the init cell). The corner stays on the
    device: the tiles are gathered by index tensors."""
    n, b = pool.shape[0], pool.shape[1]
    th, tw = table.shape
    rel = gridlib.div_scale(center - origin, scale)
    ct = torch.floor(rel).to(torch.int64)  # (col, row)
    t0r = torch.clamp(ct[1] // b - tiles_h // 2, 0, max(th - tiles_h, 0))
    t0c = torch.clamp(ct[0] // b - tiles_w // 2, 0, max(tw - tiles_w, 0))
    dev = table.device
    # a window wider than the table repeats its last tile, as the
    # reference's clamped gather does
    tr = torch.clamp(t0r + torch.arange(tiles_h, device=dev), max=th - 1)
    tc = torch.clamp(t0c + torch.arange(tiles_w, device=dev), max=tw - 1)
    slots = table[tr[:, None], tc[None, :]].to(torch.int64)  # [tiles_h, tiles_w]
    # the init cell from the constants made once a process: a copy from
    # the host would wait for the device
    cell = constant((*model.init_belief(), 0.0), torch.float32, dev)
    blocks = torch.where((slots >= 0)[..., None, None, None], pool[slots.clamp(0, n - 1)],
                         cell)  # [tiles_h, tiles_w, B, B, C]
    dense = blocks.permute(0, 2, 1, 3, 4).reshape(tiles_h * b, tiles_w * b, -1)
    w_origin = origin + torch.stack([t0c, t0r]).to(torch.float32) * (b * scale)
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
