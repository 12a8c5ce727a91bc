"""Dense occupancy grid maps as tensor state (port of
``slam_constructor_tpu.ops.grid``).

The map holds one ``f32[H, W, C]`` tensor: the cell model's belief channels
plus a trailing observation-weight channel. Cell index ``[row, col]`` with
``row ~ y`` and ``col ~ x``; ``origin`` is the world coordinate of the
lower-left corner of cell (0, 0). Growth and rescaling wait for a later
slice.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

#: channel index of the accumulated observation weight
WEIGHT_CHANNEL = -1


@dataclasses.dataclass
class GridMap:
    cells: Tensor  # f32[H, W, C]: model belief channels + weight channel
    origin: Tensor  # f32[2]: world (x, y) of the lower-left corner of (0, 0)
    scale: float  # meters per cell

    @property
    def height(self) -> int:
        return self.cells.shape[0]

    @property
    def width(self) -> int:
        return self.cells.shape[1]

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


def world_to_cell(gm: GridMap, pts: Tensor) -> Tensor:
    """World points ``f32[..., 2]`` -> int64 cell indices ``[..., 2]`` as
    (row, col). May be out of bounds."""
    rel = (pts - gm.origin) / gm.scale
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


def occupancy_plane(gm: GridMap, model) -> Tensor:
    """f32[H, W] occupancy-probability readout under the cell model."""
    return model.occupancy(gm.belief)


def known_mask(gm: GridMap) -> Tensor:
    return gm.weight > 0.0
