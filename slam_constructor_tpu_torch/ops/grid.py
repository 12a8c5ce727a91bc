"""Dense occupancy grid maps as tensor state (port of
``slam_constructor_tpu.ops.grid``).

The map holds one ``f32[H, W, C]`` tensor: the cell model's belief channels
plus a trailing observation-weight channel. Cell index ``[row, col]`` with
``row ~ y`` and ``col ~ x``; ``origin`` is the world coordinate of the
lower-left corner of cell (0, 0). A stack of P same-shaped maps (the loop
closer's submaps, the RBPF's particles) is ``f32[P, H, W, C]`` with
``origin`` f32[P, 2]; ``window_corner``, ``take_window`` and
``put_window`` cut a window out of each and write it back.

The map may grow (:func:`grow_to_contain`, the reference's unbounded map
as a host event: the engine's ``auto_grow``) and change its resolution by
an integer factor (:func:`rescale`). Both build the new cells on the
map's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

#: channel index of the accumulated observation weight
WEIGHT_CHANNEL = -1

#: floor of the evidence a coarsened cell divides by (:func:`rescale`)
_RES_EPS = 1e-9


@dataclasses.dataclass
class GridMap:
    #: f32[H, W, C]: model belief channels + weight channel; a batch of
    #: same-shaped maps (the loop closer's submaps, the RBPF's particles) is
    #: f32[M, H, W, C] with ``origin`` f32[M, 2]
    cells: Tensor
    origin: Tensor  # f32[2]: world (x, y) of the lower-left corner of (0, 0)
    scale: float  # meters per cell

    @property
    def height(self) -> int:
        return self.cells.shape[-3]

    @property
    def width(self) -> int:
        return self.cells.shape[-2]

    @property
    def belief(self) -> Tensor:
        return self.cells[..., :-1]

    @property
    def weight(self) -> Tensor:
        return self.cells[..., WEIGHT_CHANNEL]


def make_grid_map(
    model,
    height: int,
    width: int,
    scale: float,
    origin: tuple[float, float] | None = None,
    device=None,
) -> GridMap:
    """Create an empty map; the default origin centers it on world (0, 0)."""
    if origin is None:
        origin = (-width * scale / 2.0, -height * scale / 2.0)
    cells = torch.empty((height, width, model.n_channels + 1), dtype=torch.float32, device=device)
    cells[..., :-1] = torch.tensor(model.init_belief(), dtype=torch.float32, device=device)
    cells[..., -1] = 0.0
    return GridMap(
        cells=cells,
        origin=torch.tensor(origin, dtype=torch.float32, device=device),
        scale=float(scale),
    )


def div_scale(x: Tensor, scale: float) -> Tensor:
    """``x / scale``, an IEEE division on every device. PyTorch's CUDA
    kernel turns a division by a Python number into a product with its
    reciprocal, which rounds otherwise than the CPU's division (trap h):
    a sample on a cell's border would land in another cell on the card
    than on the CPU. A divisor on the device is divided by."""
    return x / torch.full((), scale, dtype=x.dtype, device=x.device)


def world_to_cell(gm: GridMap, pts: Tensor) -> Tensor:
    """World points ``f32[..., 2]`` -> int64 cell indices ``[..., 2]`` as
    (row, col). May be out of bounds."""
    rel = div_scale(pts - gm.origin, gm.scale)
    col = torch.floor(rel[..., 0]).to(torch.int64)
    row = torch.floor(rel[..., 1]).to(torch.int64)
    return torch.stack([row, col], dim=-1)


def cell_center(gm: GridMap, idx: Tensor) -> Tensor:
    """Cell indices ``[..., 2]`` (row, col) -> world centres ``f32[..., 2]``."""
    x = gm.origin[0] + (idx[..., 1].to(torch.float32) + 0.5) * gm.scale
    y = gm.origin[1] + (idx[..., 0].to(torch.float32) + 0.5) * gm.scale
    return torch.stack([x, y], dim=-1)


def clip_index(gm: GridMap, idx: Tensor) -> Tensor:
    """Cell indices ``[..., 2]`` (row, col) clamped onto the map."""
    return torch.stack([torch.clamp(idx[..., 0], 0, gm.height - 1),
                        torch.clamp(idx[..., 1], 0, gm.width - 1)], dim=-1)


def in_bounds(idx: Tensor, h: int, w: int) -> Tensor:
    return (idx[..., 0] >= 0) & (idx[..., 0] < h) & (idx[..., 1] >= 0) & (idx[..., 1] < w)


def gather_plane(plane: Tensor, idx: Tensor, oob_value: float, h: int, w: int) -> Tensor:
    """Gather ``plane[idx]`` with out-of-bounds indices mapped to
    ``oob_value``. ``plane`` is f32[H, W]; ``idx`` int[..., 2] (row, col)."""
    r = torch.clamp(idx[..., 0], 0, h - 1)
    c = torch.clamp(idx[..., 1], 0, w - 1)
    return torch.where(in_bounds(idx, h, w), plane[r, c], oob_value)


def apply_observations(gm: GridMap, model, w_obs: Tensor, s_obs: Tensor) -> GridMap:
    """Fold one step's per-cell observation planes into the map (returns a
    new map; the input is not modified)."""
    n_prev = gm.weight
    belief = model.update(gm.belief, n_prev, w_obs, s_obs)
    cells = torch.cat([belief, (n_prev + w_obs)[..., None]], dim=-1)
    return dataclasses.replace(gm, cells=cells)


def window_corner(origin: Tensor, center_xy: Tensor, scale: float, sh: int, sw: int, h: int,
                  w: int):
    """The ``sh x sw`` cell window around a world point, clamped into an
    ``h x w`` map: (row, col) int64 of its first cell and its world origin
    f32[2]. With a leading map dimension (``origin``, ``center_xy``
    f32[P, 2]) each map has its own: row, col i64[P], origin f32[P, 2].

    The reference's arithmetic (``scoring.window_view``, the RBPF's insert
    window): ``floor((center - origin) / scale)`` less half the window, the
    window's origin ``origin + [col, row] * scale`` (``div_scale``'s
    division). Nothing is read on the host."""
    rel = div_scale(center_xy - origin, scale)
    cell = torch.floor(rel).to(torch.int64)
    col = torch.clamp(cell[..., 0] - sw // 2, 0, w - sw)
    row = torch.clamp(cell[..., 1] - sh // 2, 0, h - sh)
    return row, col, origin + torch.stack([col, row], dim=-1).to(torch.float32) * scale


def _window_index(row: Tensor, col: Tensor, sh: int, sw: int):
    """Index tensors of the window at (row, col) of each of P planes:
    (plane [P, 1, 1], rows [P, sh, 1], cols [P, 1, sw])."""
    dev = row.device
    rows = (row[:, None] + torch.arange(sh, device=dev))[:, :, None]
    cols = (col[:, None] + torch.arange(sw, device=dev))[:, None, :]
    return torch.arange(row.shape[0], device=dev)[:, None, None], rows, cols


def take_window(planes: Tensor, row: Tensor, col: Tensor, sh: int, sw: int) -> Tensor:
    """The ``sh x sw`` window at (row, col) of each of P planes ``f32[P, H,
    W, ...]`` -> ``f32[P, sh, sw, ...]``, in one gather whose offsets stay
    on the device."""
    return planes[_window_index(row, col, sh, sw)]


def put_window(planes: Tensor, windows: Tensor, row: Tensor, col: Tensor) -> Tensor:
    """``planes`` with each plane's window at (row, col) replaced by
    ``windows[p]`` (returns a new tensor; the windows of different planes
    never meet)."""
    return planes.index_put(_window_index(row, col, *windows.shape[1:3]), windows)


def occupancy_plane(gm: GridMap, model) -> Tensor:
    """f32[H, W] occupancy-probability readout under the cell model."""
    return model.occupancy(gm.belief)


def known_mask(gm: GridMap) -> Tensor:
    return gm.weight > 0.0


def contains(gm: GridMap, pts: Tensor, valid: Tensor | None = None) -> Tensor:
    """bool[] on the map's device: every world point ``f32[..., 2]`` (where
    ``valid``) lies in a cell of the map."""
    inside = in_bounds(world_to_cell(gm, pts), gm.height, gm.width)
    if valid is not None:
        inside = inside | ~valid
    return inside.all()


def grow_to_contain(gm: GridMap, model, pts, margin_cells: int = 16) -> GridMap:
    """The map grown so that it covers the world points ``pts`` ``[N, 2]``
    (a tensor or an array), the old cells copied in, the new ones the init
    cell; the map itself when it covers them already. A host event, as in
    the reference (the UnboundedPlainGridMap's expansion): it reads the
    points' extent, and a grown map has another shape. The new cells are
    made on the map's device, and the new origin in float64 from the
    integer offsets, then cast to f32, as the reference does."""
    dev = gm.cells.device
    pts = torch.as_tensor(pts, dtype=torch.float32).to(dev)
    idx = world_to_cell(gm, pts)
    h, w, c = gm.cells.shape
    if pts.shape[0] == 0 or bool(in_bounds(idx, h, w).all()):
        return gm
    lo = idx.min(0).values.tolist()
    hi = idx.max(0).values.tolist()
    lo_r, lo_c = min(0, lo[0] - margin_cells), min(0, lo[1] - margin_cells)
    hi_r, hi_c = max(h, hi[0] + 1 + margin_cells), max(w, hi[1] + 1 + margin_cells)
    cells = make_grid_map(model, hi_r - lo_r, hi_c - lo_c, gm.scale, (0.0, 0.0), dev).cells
    cells[-lo_r:-lo_r + h, -lo_c:-lo_c + w] = gm.cells
    origin = gm.origin.cpu().numpy().astype(np.float64) + np.array([lo_c, lo_r], np.float64) * gm.scale
    return GridMap(cells=cells, origin=torch.tensor(origin.astype(np.float32), device=dev),
                   scale=gm.scale)


def rescale(gm: GridMap, model, factor: int) -> GridMap:
    """The map at another resolution, the same world area (the origin
    stays). ``factor > 0`` coarsens: a new cell holds a ``factor x
    factor`` block, its weight the block's sum and its belief the
    weight-weighted mean (the init belief where the block saw nothing); the
    sides must divide by ``factor``. ``factor < 0`` refines by ``k =
    -factor``: each cell splits into ``k x k`` cells of its belief and a
    ``k^2``-th of its weight."""
    h, w, c = gm.cells.shape
    if factor == 0:
        raise ValueError("rescale factor must be a nonzero integer")
    if factor in (1, -1):
        return gm
    if factor > 0:
        k = factor
        if h % k or w % k:
            raise ValueError(f"extent {h}x{w} not divisible by factor {k}")
        blocks = gm.cells.reshape(h // k, k, w // k, k, c)
        wgt = blocks[..., -1]
        wsum = wgt.sum(dim=(1, 3))
        bel = (blocks[..., :-1] * wgt[..., None]).sum(dim=(1, 3)) / torch.clamp(
            wsum, min=_RES_EPS)[..., None]
        init = torch.tensor(model.init_belief(), dtype=torch.float32, device=gm.cells.device)
        bel = torch.where((wsum > 0)[..., None], bel, init)
        return dataclasses.replace(gm, cells=torch.cat([bel, wsum[..., None]], dim=-1),
                                   scale=gm.scale * k)
    k = -factor
    cells = gm.cells.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)
    cells = torch.cat([cells[..., :-1], cells[..., -1:] * (1.0 / (k * k))], dim=-1)
    return dataclasses.replace(gm, cells=cells, scale=gm.scale / k)
