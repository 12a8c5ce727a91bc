"""The reference's random numbers: threefry2x32 keys, bit for bit with
``jax.random`` (port of what the reference calls from ``jax.random``:
``PRNGKey``, ``split``, ``bits``, ``uniform``, ``normal``).

A key is a tensor ``[..., 2]`` of dtype ``torch.uint32`` holding the two
32-bit words of a threefry key; leading dimensions are a batch of keys,
which every function here maps over as the reference's ``vmap`` does.
The counters are JAX's partitionable ones (``jax_threefry_partitionable``,
the default): element ``i`` of a draw hashes the 64-bit counter ``i`` as
two words (hi, lo), a split's key ``i`` is the pair ``(y0, y1)`` of
counter ``i`` and a draw's bits are ``y0 ^ y1``. So ``split(k, n)[i]``
does not depend on ``n``, and a key's draws are a counter-indexed table.

``normal`` takes XLA's own transform: a uniform on ``(nextafter(-1, 0),
1)``, then ``sqrt(2) * erf_inv(u)`` with ``erf_inv`` as XLA compiles it
for the CPU: Giles' single-precision polynomial, a fused multiply-add at
each Horner step, and XLA's ``log1p`` (a rational approximation near 0
and Cephes' ``logf`` elsewhere, with the multiply-adds that XLA's CPU
code fuses fused here too). :func:`log1p_xla` and :func:`erf_inv_xla`
write that out one float32 operation at a time, a fused multiply-add by
``libm.fma32``'s plain version and XLA's ``log`` by ``libm.log``'s (the
test over every input of the normal transform holds it to JAX).

Everything here is the plain version: it runs on any device, in int64
masked to 32 bits for the words. :func:`draws` evaluates a :class:`Draw`
plan; ``kernels.prng_draws`` is the same on the card in one launch
(``csrc/threefry.cu``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import libm

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key(seed: int, device="cpu") -> Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``[0, seed mod
    2^32]`` as uint32[2] on ``device``."""
    return _from_words(torch.tensor([0, int(seed) % (1 << 32)], dtype=torch.int64,
                                    device=device))


def _words(k: Tensor) -> Tensor:
    """uint32 words -> int64 in [0, 2^32)."""
    if k.dtype != torch.uint32:
        raise TypeError(f"a key must be torch.uint32, got {k.dtype}")
    return k.view(torch.int32).to(torch.int64) & MASK


def _from_words(x: Tensor) -> Tensor:
    """int64 in [0, 2^32) -> uint32."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor) -> tuple[Tensor, Tensor]:
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) on int64
    words in [0, 2^32), broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _hash(k: Tensor, counter: Tensor) -> tuple[Tensor, Tensor]:
    """Hash int64 counters ``counter`` (any shape) under keys ``k``
    [..., 2] -> (y0, y1), each ``[..., *counter.shape]``."""
    w = _words(k)
    lead = (1,) * counter.dim()
    k0 = w[..., 0].reshape(*w.shape[:-1], *lead) if lead else w[..., 0]
    k1 = w[..., 1].reshape(*w.shape[:-1], *lead) if lead else w[..., 1]
    return threefry2x32(k0, k1, counter >> 32, counter & MASK)


def _counters(shape: tuple, device) -> Tensor:
    n = math.prod(shape)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def fold(k: Tensor, i: int) -> Tensor:
    """``split(k, n)[..., i, :]`` for any ``n > i``: key ``i`` of a split."""
    y0, y1 = _hash(k, torch.full((), int(i), dtype=torch.int64, device=k.device))
    return _from_words(torch.stack([y0, y1], -1))


def split(k: Tensor, n: int = 2) -> Tensor:
    """``jax.random.split``: keys [..., 2] -> [..., n, 2]."""
    y0, y1 = _hash(k, _counters((n,), k.device))
    return _from_words(torch.stack([y0, y1], -1))


def bits(k: Tensor, shape: tuple = ()) -> Tensor:
    """``jax.random.bits`` (32-bit): uint32 [..., *shape]."""
    y0, y1 = _hash(k, _counters(tuple(shape), k.device))
    return _from_words(y0 ^ y1)


def _f32(v: float, like: Tensor) -> Tensor:
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=like.device)


def uniform(k: Tensor, shape: tuple = (), minval: float = 0.0, maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform`` in float32: the 23 high bits as a mantissa of
    [1, 2), minus 1, times ``maxval - minval`` (in float32) plus ``minval``
    in one fused multiply-add (XLA's CPU code fuses them), then at least
    ``minval``."""
    y0, y1 = _hash(k, _counters(tuple(shape), k.device))
    b = (y0 ^ y1) >> 9 | 0x3F800000
    f = b.to(torch.int32).view(torch.float32) - _f32(1.0, b)
    lo = _f32(minval, f)
    span = _f32(np.float32(maxval) - np.float32(minval), f)
    return torch.maximum(lo, _fma(f, span, lo))


#: the lower bound of ``normal``'s uniform: ``nextafter(-1, 0)`` in float32
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k: Tensor, shape: tuple = ()) -> Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` of a
    uniform on ``(nextafter(-1, 0), 1)``, with XLA's ``erf_inv``."""
    return normal_transform(uniform(k, shape, NORMAL_LO, 1.0))


def transform_table(shape: tuple, device="cpu") -> Tensor:
    """The normal of the uniform whose 23 mantissa bits are the element's
    flat index (modulo 2^23), f32[*shape]: over shape (2^23,), every value
    ``normal`` can return, in mantissa order."""
    j = _counters(tuple(shape), device) & 0x7FFFFF
    f = (j | 0x3F800000).to(torch.int32).view(torch.float32) - _f32(1.0, j)
    lo = _f32(NORMAL_LO, f)
    return normal_transform(torch.maximum(lo, _fma(f, _f32(2.0, f), lo)))


def _bits_f32(b: int) -> float:
    return float(np.array([b], np.uint32).view(np.float32)[0])


# XLA's CPU log1p (f32), as its LLVM IR computes it, by the constants' bits
_L1P_T = _bits_f32(0x3ED413CD)  # |x| below it: the rational branch
_L1P_P = tuple(map(_bits_f32, (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
                               0x42707982)))  # denominator, after a leading 1
_L1P_Q = tuple(map(_bits_f32, (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
                               0x426473AD, 0x41A05101)))  # numerator
# Giles' erf_inv, w < 5 and w >= 5, highest degree first
_ERFINV_LT = tuple(map(_bits_f32, (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB,
                                   0xBAA45408, 0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F)))
_ERFINV_GE = tuple(map(_bits_f32, (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B,
                                   0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB, 0x40354F7E)))
_SQRT2 = _bits_f32(0x3FB504F3)


#: float32 ``a * b + c`` rounded once (``libm.fma32``'s plain version)
_fma = libm._fma32_ref


def log1p_xla(x: Tensor) -> Tensor:
    """XLA's CPU ``log1p`` of float32 ``x``, operation for operation."""
    def c(v):
        return _f32(v, x)

    # |x| < sqrt(2) - 1: x + (-x^2 / 2 + x^3 N(x) / D(x))
    x2 = x * x
    z0 = x * c(0.0)
    den = z0 + c(1.0)
    for p in _L1P_P:
        den = _fma(den, x, c(p))
    num = z0 + c(_L1P_Q[0])
    for q in _L1P_Q[1:]:
        num = _fma(num, x, c(q))
    s = (x * x2) * (num / den)
    small = x + _fma(c(-0.5), x2, s)
    # else: XLA's log (Cephes' logf) of v = 1 + x
    big = libm._log_ref(x + c(1.0))
    return torch.where(x.abs() < c(_L1P_T), small, big)


def erf_inv_xla(x: Tensor) -> Tensor:
    """XLA's ``erf_inv`` of float32 ``x`` on the CPU, operation for
    operation (Giles' polynomial, a fused multiply-add a Horner step)."""
    def c(v):
        return _f32(v, x)

    lg = log1p_xla((-x) * x)
    lt = lg > c(-5.0)  # w = -log1p(-x^2) < 5
    # the square root through float64, correctly rounded to float32 (the CPU's
    # float32 ``torch.sqrt`` is not, in a few inputs in a thousand)
    z = torch.where(lt, c(-2.5) - lg, (-lg).double().sqrt().float() + c(-3.0))
    p = torch.where(lt, c(_ERFINV_LT[0]), c(_ERFINV_GE[0]))
    for lo, hi in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = _fma(z, p, torch.where(lt, c(lo), c(hi)))
    return x * torch.where(x.abs() == c(1.0), c(math.inf), p)


def normal_transform(u: Tensor) -> Tensor:
    """``sqrt(2) * erf_inv(u)`` as ``jax.random.normal`` computes it."""
    return erf_inv_xla(u) * _f32(_SQRT2, u)


# --- plans: a step's draws as one table ------------------------------------

@dataclasses.dataclass(frozen=True)
class Each:
    """A path step taking every key of ``split(k, n)``: an output dimension."""

    n: int


@dataclasses.dataclass(frozen=True)
class Draw:
    """One output of a plan: the key reached from the root by ``path`` (an
    int ``i`` takes ``split(k, n)[i]`` for any ``n``; :class:`Each` takes
    them all), then the leaf: ``"key"`` the key itself, ``"bits"``,
    ``"uniform"`` on [minval, maxval), ``"normal"`` or ``"erfinv"`` (the
    normal before its last multiply by sqrt(2)), of ``shape``;
    ``"transform"`` is the normal of the uniform whose 23 mantissa bits
    are the element's index instead of its hash (the normal transform over
    every input it can take, for the checks). The output is ``[*root
    batch, *each n, *shape]`` (a key adds ``[2]``)."""

    path: tuple = ()
    kind: str = "normal"
    shape: tuple = ()
    minval: float = 0.0
    maxval: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"Draw.kind={self.kind!r}: not one of {KINDS}")
        for s in self.path:
            if not (isinstance(s, Each) and s.n >= 1 or isinstance(s, int) and 0 <= s < 1 << 32):
                raise ValueError(f"Draw.path step {s!r}: an index in [0, 2^32) or Each(n >= 1)")


KINDS = ("key", "bits", "uniform", "normal", "transform", "erfinv")


def draw_ref(k: Tensor, d: Draw) -> Tensor:
    """One :class:`Draw` from root keys ``k`` [..., 2] with the functions above."""
    for s in d.path:
        k = split(k, s.n) if isinstance(s, Each) else fold(k, s)
    if d.kind == "key":
        return k
    if d.kind == "bits":
        return bits(k, d.shape)
    if d.kind == "uniform":
        return uniform(k, d.shape, d.minval, d.maxval)
    if d.kind == "transform":
        return transform_table(d.shape, k.device).expand(*k.shape[:-1], *d.shape)
    if d.kind == "erfinv":
        return erf_inv_xla(uniform(k, d.shape, NORMAL_LO, 1.0))
    return normal(k, d.shape)


def draws_ref(k: Tensor, plan: tuple) -> tuple:
    """Every :class:`Draw` of ``plan`` from root keys ``k`` [..., 2]: the
    plain version of ``kernels.prng_draws``."""
    return tuple(draw_ref(k, d) for d in plan)


def draw_of(spec: dict) -> Draw:
    """A :class:`Draw` from its JSON form (``scripts/torch_port/
    prng_fixture.py``): ``path`` ``[[n, i], ...]`` (``i`` null for every
    key of the split), ``kind``, ``shape``, ``minval``, ``maxval``."""
    path = tuple(Each(n) if i is None else i for n, i in spec["path"])
    return Draw(path, spec["kind"], tuple(spec["shape"]), spec.get("minval", 0.0),
                spec.get("maxval", 1.0))
