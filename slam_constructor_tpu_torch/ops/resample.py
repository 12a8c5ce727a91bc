"""Particle-filter primitives: weights, effective sample size, resampling
(port of ``slam_constructor_tpu.ops.resample``).

Weights live in log space and are normalised with ``logsumexp``;
systematic resampling is one uniform offset, a stratified comb and
``searchsorted`` on the cumulative weights. Nothing here reads a value on
the host: the resampling decision is a ``torch.where`` between the drawn
indices and the identity. The comb's offset ``u0`` is drawn from the
reference's key (:func:`uniform_offset`) or handed in.
"""

from __future__ import annotations

import functools

import torch

from . import kernels, libm, prng

Tensor = torch.Tensor


def normalize_log_weights(logw: Tensor) -> Tensor:
    """Shift-normalise so that exp(logw) sums to 1 (``libm.normalize_log``:
    the reference's ``logsumexp`` with its ``exp`` and ``log``)."""
    return libm.normalize_log(logw)


def effective_sample_size(logw: Tensor) -> Tensor:
    """Neff = 1 / sum(w^2) for normalised weights."""
    return libm.effective_sample_size(logw)


def offset_draw(n: int, path: tuple = ()) -> prng.Draw:
    """The comb's offset of ``n`` particles from the key reached by
    ``path``: ``uniform(key, (), 0, 1/n)`` (the reference's
    ``resample.py:43``)."""
    return prng.Draw(path, "uniform", (), 0.0, 1.0 / n)


def uniform_offset(n: int, key: Tensor) -> Tensor:
    """The comb's offset f32[], uniform in [0, 1/n), drawn from ``key`` on
    its device as the reference draws it."""
    return kernels.prng_draws(key, (offset_draw(n),))[0]


@functools.lru_cache(maxsize=64)
def _neg_log(p: int) -> float:
    return -float(libm._log_ref(torch.tensor([float(p)], dtype=torch.float32))[0])


def log_uniform_weights(p: int, device=None) -> Tensor:
    """f32[p] of ``-log(p)``: the f32 log of an f32 ``p``, as the reference
    takes it (``-jnp.log(float(p))``, XLA's ``log``), not ``math.log``
    rounded to f32."""
    return torch.full((p,), _neg_log(p), dtype=torch.float32, device=device)


def systematic_resample(u0: Tensor, logw: Tensor, n: int | None = None) -> Tensor:
    """Systematic (low-variance) resampling.

    Returns int64 ancestor indices ``[n]`` such that particle i is replaced
    by particle ``idx[i]``: the comb ``u0 + i / n`` (``u0`` f32[] in [0,
    1/n)) located in the cumulative weights, to the right of ties. The
    comb's division is tensor by tensor (a scalar divisor becomes a product
    with its reciprocal on the card).
    """
    p = logw.shape[0]
    n = n or p
    w = libm.softmax_lse(logw)[0]
    cdf = torch.cumsum(w, dim=0)
    steps = torch.arange(n, dtype=torch.float32, device=logw.device)
    comb = u0 + steps / torch.full_like(steps, float(n))
    idx = torch.searchsorted(cdf, comb, side="right")
    return torch.clamp(idx, 0, p - 1)


def maybe_resample(u0: Tensor, logw: Tensor, threshold_frac: float):
    """Branch-free conditional resampling: (ancestor indices i64[P], new
    log-weights f32[P], did_resample bool[]). When Neff >= threshold_frac *
    P the indices are the identity and the weights are only normalised."""
    p = logw.shape[0]
    do = effective_sample_size(logw) < threshold_frac * p
    idx = systematic_resample(u0, logw, p)
    idx = torch.where(do, idx, torch.arange(p, device=logw.device))
    new_logw = torch.where(do, log_uniform_weights(p, logw.device), normalize_log_weights(logw))
    return idx, new_logw, do
