"""Fixed-order reductions across ranks (port of
``slam_constructor_tpu.utils.determinism``).

An all-reduce adds in an order that the backend picks (NCCL's ring or
tree, gloo's algorithm), so a float sum over ranks is reproducible only for
one backend, world size and rank order, and is not the sum a single device
takes. :func:`ladder_psum` fixes the order: an all-gather, then a fold in
rank order, ``((x_0 + x_1) + x_2) + ...`` on every rank, whatever the
backend. It is for small payloads on the path that must be reproducible
(the particles' log-weights, Neff), not for maps.

The reference also audits buffer donation (``audit_donation``,
``DONATING_ENTRY_POINTS``): JAX frees a donated input for reuse. PyTorch
has no donation, so there is nothing to audit; the port's in-place updates
are named in the docstrings of the functions that make them.
"""

from __future__ import annotations

import torch

from ..ops import libm
from ..parallel import mesh as meshlib

Tensor = torch.Tensor


def ladder_psum(x: Tensor, mesh, axis: str) -> Tensor:
    """The sum over the ranks of ``axis`` as a fold in rank order: the same
    bits on every rank, for any backend."""
    parts = meshlib.all_gather(x, mesh, axis)
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i]
    return acc


def ladder_pmax(x: Tensor, mesh, axis: str) -> Tensor:
    """The max over the ranks of ``axis``, on the same path as
    :func:`ladder_psum` (a NaN anywhere gives NaN, as ``jnp.maximum``)."""
    parts = meshlib.all_gather(x, mesh, axis)
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = torch.maximum(acc, parts[i])
    return acc


def deterministic_normalize_log_weights(logw: Tensor, mesh, axis: str = "particles") -> Tensor:
    """This rank's log-weights f32[P/D] normalised over every rank's, with
    the max and the sum taken by the ladder: reproducible bit for bit from
    run to run and across backends. The partials are those of
    ``parallel.particles.psum_normalize_log_weights``."""
    gmax = ladder_pmax(logw.max(), mesh, axis)
    gsum = ladder_psum(libm.sum_exp(logw, gmax), mesh, axis)
    return logw - (gmax + libm.log(gsum))
