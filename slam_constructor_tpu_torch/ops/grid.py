"""Dense occupancy grid maps as tensor state (port of
``slam_constructor_tpu.ops.grid``).

The map holds one ``f32[H, W, C]`` tensor: the cell model's belief channels
plus a trailing observation-weight channel. Cell index ``[row, col]`` with
``row ~ y`` and ``col ~ x``; ``origin`` is the world coordinate of the
lower-left corner of cell (0, 0). A stack of P same-shaped maps (the loop
closer's submaps, the RBPF's particles) is ``f32[P, H, W, C]`` with
``origin`` f32[P, 2]; ``window_corner``, ``take_window`` and
``put_window`` cut a window out of each and write it back. Growth and
rescaling wait for a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

#: channel index of the accumulated observation weight
WEIGHT_CHANNEL = -1


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
