"""Grid-cell belief models: Bayesian (tinySLAM) and Transferable Belief
Model (vinySLAM) (port of ``slam_constructor_tpu.ops.cells``).

A scan's observations arrive as two dense planes, per-cell weight ``w`` and
weight-summed observed occupancy ``s``; a model folds them into every cell
at once in closed form.
"""

from __future__ import annotations

import dataclasses

import torch

from . import libm

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


@dataclasses.dataclass(frozen=True)
class TBMCell:
    """vinySLAM's Transferable-Belief-Model cell: masses ``[m_occ, m_emp,
    m_unknown, m_conflict]`` combined with the unnormalized conjunctive
    rule. An observation of occupancy ``o`` at quality ``q`` is the mass
    function ``(q o, q (1 - o), 1 - q, 0)``; weight ``w`` applies
    ``floor(w)`` rounds in closed form (one round is linear and triangular
    in the state, so k rounds are powers of ``uu``, ``oo + uu``, ``ee +
    uu``) plus one partial round at quality ``q frac(w)``. A fraction
    ``conflict_decay`` of the conflict mass then returns to unknown, and
    the masses are renormalized. Occupancy is the pignistic readout with
    conflict split evenly."""

    quality: float = 0.4
    conflict_decay: float = 0.1

    n_channels: int = dataclasses.field(default=4, init=False)

    def init_belief(self):
        return (0.0, 0.0, 1.0, 0.0)

    def update(self, belief: Tensor, n_prev: Tensor, w: Tensor, s: Tensor) -> Tensor:
        o = _mean_obs(w, s)
        q = self.quality
        k = torch.floor(w)
        frac = w - k

        # closed form for k = floor(w) full rounds
        uu = 1.0 - q

        def powk(base):
            # base^k for k >= 0 and base in [0, 1]; exp(0 * log(eps)) = 1
            # keeps the k = 0 identity even when base == 0 (q == 1)
            if not isinstance(base, Tensor):
                base = torch.full_like(k, base)
            return libm.exp(k * libm.log(torch.clamp(base, min=_EPS)))

        mo, me, mu, mx = belief.unbind(-1)
        total = mo + me + mu + mx
        pu = powk(uu)
        # q o + uu and q (1 - o) + uu each one fused multiply-add, as the
        # reference's jitted code fuses them
        po = powk(libm.fma32(o, q, uu))
        pe = powk(libm.fma32(1.0 - o, q, uu))
        mo = mo * po + mu * (po - pu)
        me = me * pe + mu * (pe - pu)
        mu = mu * pu
        mx = torch.clamp(total - mo - me - mu, min=0.0)

        # one partial round at quality q * frac (identity when frac == 0)
        qi = q * frac
        oo, ee, uu = qi * o, qi * (1.0 - o), 1.0 - qi
        no = mo * (oo + uu) + mu * oo
        ne = me * (ee + uu) + mu * ee
        nu = mu * uu
        nx = mx * (oo + ee + uu) + mo * ee + me * oo

        # conflict forgetting
        seen = w > 0
        nu = nu + self.conflict_decay * nx * seen
        nx = nx * torch.where(seen, 1.0 - self.conflict_decay, 1.0)
        m = torch.stack([no, ne, nu, nx], dim=-1)
        # renormalize (guards fp drift; masses stay a partition of unity)
        m = m / torch.clamp(m.sum(-1, keepdim=True), min=_EPS)
        return torch.where(seen[..., None], m, belief)

    def occupancy(self, belief: Tensor) -> Tensor:
        mo, mu, mx = belief[..., 0], belief[..., 2], belief[..., 3]
        return mo + 0.5 * mu + 0.5 * mx


#: registry for the config system
CELL_MODELS = {
    "bayes_base": BayesBaseCell,
    "bayes_avg": BayesAvgCell,
    "tbm": TBMCell,
}
