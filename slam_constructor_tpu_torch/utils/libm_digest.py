"""SHA-256 digests of ``ops/libm``'s functions over every float32 input.

A unary function is evaluated on all 2^32 float32 words in 16 blocks of
2^28 consecutive words; each block's outputs (float32, little-endian, every
NaN written as ``0x7FC00000``) are hashed, and the digest is the SHA-256 of
the 16 block digests in order, so blocks can be hashed in parallel.
``atan2`` is evaluated on 16 blocks of 2^22 seeded pairs of words
(``numpy.random.default_rng([ATAN2_SEED, block])``) and on every pair of
:func:`atan2_grid` (zeros, subnormals, infinities, NaN, multiples of pi/4
and their neighbours, powers of two), the grid a 17th block.

``scripts/torch_port/libm_exhaustive.py`` writes the jitted reference's
digests to ``tests/data/libm_digests.json`` and checks the port's plain
versions against them; ``chip_smoke.py``'s ``libm`` phase checks the card's
kernel.
"""

from __future__ import annotations

import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

UNARY = ("sin", "cos", "atan", "exp", "log", "sqrt", "wrap_angle")
BLOCKS = 16
BLOCK_WORDS = 1 << 28
ATAN2_SEED = 20261018
ATAN2_BLOCK_PAIRS = 1 << 22
CANONICAL_NAN = 0x7FC00000
DIGESTS = Path(__file__).resolve().parents[2] / "tests" / "data" / "libm_digests.json"


def load() -> dict:
    """The committed digests: ``{"unary": {op: {"digest": hex, "blocks":
    [16 hex]}}, "atan2": hex, "source": ...}``."""
    return json.loads(DIGESTS.read_text())


def canonical(out) -> np.ndarray:
    """float32 outputs (numpy or a tensor, on any device) as hashed: a
    contiguous little-endian uint32 array with NaNs canonical."""
    if torch.is_tensor(out):
        w = out.float().contiguous().view(torch.int32)
        w = torch.where(torch.isnan(out), torch.full_like(w, CANONICAL_NAN), w)
        return w.cpu().numpy().view(np.uint32)
    a = np.asarray(out, dtype=np.float32)
    w = np.ascontiguousarray(a).view(np.uint32).copy()
    w[np.isnan(a)] = CANONICAL_NAN
    return w


def words(start: int, n: int, device="cpu") -> torch.Tensor:
    """float32 tensor of the words ``start .. start + n - 1``."""
    w = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return (w - ((w >> 31) << 32)).to(torch.int32).view(torch.float32)


def unary_block(fn, block: int, chunk: int, device="cpu") -> str:
    """The hex SHA-256 of block ``block``'s outputs of ``fn``, evaluated
    ``chunk`` words at a time."""
    h = hashlib.sha256()
    base = block * BLOCK_WORDS
    for s in range(0, BLOCK_WORDS, chunk):
        h.update(canonical(fn(words(base + s, chunk, device))))
    return h.hexdigest()


def combine(block_digests) -> str:
    return hashlib.sha256(b"".join(bytes.fromhex(d) for d in block_digests)).hexdigest()


def atan2_block(block: int) -> tuple[np.ndarray, np.ndarray]:
    """Block ``block``'s seeded pairs (y, x) as float32 arrays."""
    rng = np.random.default_rng([ATAN2_SEED, block])
    w = rng.integers(0, 1 << 32, size=(2, ATAN2_BLOCK_PAIRS), dtype=np.uint64).astype(np.uint32)
    return w[0].view(np.float32), w[1].view(np.float32)


def atan2_grid() -> np.ndarray:
    """The grid's values (float32): every pair (y, x) of them is evaluated,
    y the slower index."""
    f32 = np.float32
    vals = [0.0, 1.0, 2.0, 0.5, 3.0, 1.5, 1e-30, 1e30, 2.0 ** -29, 2.0 ** 25, 2.0 ** 60,
            2.0 ** -60, 7 / 16, 11 / 16, 19 / 16, 39 / 16]
    vals += [2.0 ** e for e in range(-149, 128, 7)]
    pi4 = [f32(k * np.pi / 4) for k in range(1, 9)]
    near = []
    for v in vals + pi4:
        v = f32(v)
        near += [v, np.nextafter(v, f32(np.inf)), np.nextafter(v, f32(0))]
    special = np.array([0x00000001, 0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0x7F800000,
                        0x7FC00000], np.uint32).view(np.float32)
    g = np.concatenate([np.array(near, np.float32), special])
    g = np.unique(g.view(np.uint32)).view(np.float32)
    return np.concatenate([g, -g])


def grid_pairs() -> tuple[np.ndarray, np.ndarray]:
    g = atan2_grid()
    return np.repeat(g, g.size), np.tile(g, g.size)


def atan2_digest(fn, device="cpu", chunk=1 << 22, threads=1) -> str:
    """The digest of ``fn(y, x)`` over the seeded blocks and the grid."""
    def block(b):
        y, x = atan2_block(b) if b < BLOCKS else grid_pairs()
        h = hashlib.sha256()
        for s in range(0, y.size, chunk):
            out = fn(torch.from_numpy(y[s:s + chunk]).to(device),
                     torch.from_numpy(x[s:s + chunk]).to(device))
            h.update(canonical(out))
        return h.hexdigest()

    with ThreadPoolExecutor(threads) as pool:
        return combine(pool.map(block, range(BLOCKS + 1)))


def unary_digests(fn, device="cpu", chunk=1 << 22, threads=1, blocks=range(BLOCKS)) -> list:
    """The block digests of ``fn`` for ``blocks`` (:func:`combine` of all
    16 is the function's digest)."""
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(lambda b: unary_block(fn, b, chunk, device), blocks))
