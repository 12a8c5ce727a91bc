"""Bayesian grid-cell models of tinySLAM (port of
``slam_constructor_tpu.ops.cells``).

A scan's observations arrive as two dense planes, per-cell weight ``w`` and
weight-summed observed occupancy ``s``; a model folds them into every cell
at once in closed form. The TBM cell of vinySLAM waits for its slice.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

_EPS = 1e-9


def _mean_obs(w: Tensor, s: Tensor) -> Tensor:
    return s / torch.clamp(w, min=_EPS)


def init_cell(model, device=None) -> Tensor:
    """The stored cell vector of an untouched cell: init belief + weight 0."""
    return torch.tensor(list(model.init_belief()) + [0.0], dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class BayesBaseCell:
    """tinySLAM's base cell: ``p <- (1-q)^w p + (1 - (1-q)^w) mean_obs``."""

    quality: float = 0.5

    n_channels: int = dataclasses.field(default=1, init=False)

    def init_belief(self):
        return (0.5,)

    def update(self, belief: Tensor, n_prev: Tensor, w: Tensor, s: Tensor) -> Tensor:
        keep = torch.pow(1.0 - self.quality, w)
        p = keep * belief[..., 0] + (1.0 - keep) * _mean_obs(w, s)
        p = torch.where(w > 0, p, belief[..., 0])
        return p[..., None]

    def occupancy(self, belief: Tensor) -> Tensor:
        return belief[..., 0]


@dataclasses.dataclass(frozen=True)
class BayesAvgCell:
    """tinySLAM's averaging cell: ``p <- (p n + s) / (n + w)``."""

    n_channels: int = dataclasses.field(default=1, init=False)
    #: folding (w1, s1) then (w2, s2) equals folding (w1+w2, s1+s2)
    fold_additive: bool = dataclasses.field(default=True, init=False)

    def init_belief(self):
        return (0.5,)

    def update(self, belief: Tensor, n_prev: Tensor, w: Tensor, s: Tensor) -> Tensor:
        p = (belief[..., 0] * n_prev + s) / torch.clamp(n_prev + w, min=_EPS)
        p = torch.where(n_prev + w > 0, p, belief[..., 0])
        return p[..., None]

    def occupancy(self, belief: Tensor) -> Tensor:
        return belief[..., 0]


#: registry for the config system; 'tbm' joins with the vinySLAM slice
CELL_MODELS = {
    "bayes_base": BayesBaseCell,
    "bayes_avg": BayesAvgCell,
}
