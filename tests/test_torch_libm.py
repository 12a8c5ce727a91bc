"""The reference's math library in the port (``ops/libm.py``) against
jitted JAX on the CPU, bit for bit.

The jitted reference computes ``sin``, ``cos``, ``atan`` and ``atan2`` with
glibc's ``sinf``, ``cosf``, ``atanf`` and ``atan2f`` and ``exp`` and ``log``
with XLA's own polynomials, all under XLA's flushed denormals. The plain
versions follow those algorithms operation for operation. These tests
assume an x86-64 CPU with FMA: there glibc's ifunc gives ``sinf`` and
``cosf`` their FMA build, whose bits the port reproduces (another CPU's
libm gives the reference other bits). Inputs: 2^20 numpy-seeded float32
words (every binade) a function, values of ordinary size, and edge cases;
NaN outputs are compared as NaN (their sign and payload are not held). All
2^32 inputs: ``scripts/torch_port/libm_exhaustive.py --check`` against
``tests/data/libm_digests.json``.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import geometry as jgeo
from slam_constructor_tpu_torch.ops import kernels, libm
from slam_constructor_tpu_torch.utils import libm_digest as ld

torch.set_num_threads(1)

N = 1 << 20
F32 = np.float32


def _words(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)


def _edges():
    """±0, subnormals, the smallest and largest normals, ±inf, NaN, powers
    of two up to 2^127, multiples of pi/4 and of pi/2 up to 1e30 and their
    float neighbours, the branch points of atanf and of the sine's
    reductions (2^-12, pi/4, 120)."""
    special = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                        0x00800000, 0x80800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0xFFC00000, 0x7F800001], np.uint32).view(np.float32)
    vals = [2.0 ** e for e in range(-149, 128)]
    vals += [k * np.pi / 4 for k in range(1, 400)] + [k * np.pi / 2 * 10.0 ** e
                                                     for k in (1, 3, 7) for e in range(1, 31)]
    vals += [2.0 ** -12, np.pi / 4, 120.0, 7 / 16, 11 / 16, 19 / 16, 39 / 16, 2.0 ** 25,
             2.0 ** -29, 1e30, 88.7, -87.5, -87.9, 0.5, 1.0, 1.5]
    v = np.array(vals, np.float32)
    near = np.concatenate([v, np.nextafter(v, F32(np.inf)), np.nextafter(v, F32(0))])
    near = np.concatenate([near, -near, special])
    return np.unique(near.view(np.uint32)).view(np.float32)


def _assert_bits(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    g, w = ld.canonical(got), ld.canonical(want)
    bad = np.flatnonzero(g != w)
    assert bad.size == 0, (f"{what}: {bad.size} of {g.size} differ, e.g. "
                           f"{[(int(i), got[i], want[i]) for i in bad[:3]]}")


UNARY = {"sin": jnp.sin, "cos": jnp.cos, "atan": jnp.arctan, "exp": jnp.exp, "log": jnp.log,
         "sqrt": jnp.sqrt, "wrap_angle": jgeo.wrap_angle}


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_equals_jitted_reference(op):
    x = np.concatenate([_words(sorted(UNARY).index(op)), _edges(),
                        np.random.default_rng(1).uniform(-200, 200, 1 << 16).astype(np.float32)])
    want = np.asarray(jax.jit(UNARY[op])(x))
    got = getattr(libm, op)(torch.from_numpy(x))
    _assert_bits(got, want, op)
    # the wrapper of the card's kernel runs the plain version on a CPU tensor
    _assert_bits(kernels.libm_unary(op, torch.from_numpy(x)), want, f"kernels.libm_unary {op}")


def test_sincos_and_cossin_equal_sin_and_cos():
    x = np.concatenate([_words(7), _edges()])
    s, c = libm.sincos(torch.from_numpy(x))
    _assert_bits(s, jax.jit(jnp.sin)(x), "sincos sin")
    _assert_bits(c, jax.jit(jnp.cos)(x), "sincos cos")
    pairs = libm.cossin(torch.from_numpy(x))
    assert pairs.shape == (x.size, 2)
    _assert_bits(pairs[:, 0], c, "cossin cos")
    _assert_bits(pairs[:, 1], s, "cossin sin")


def test_atan2_equals_jitted_reference():
    # the grid: every pair of the edge cases of atan2's branches (zeros,
    # subnormals, infinities, NaN, powers of two, multiples of pi/4, 1)
    e = _edges()
    e = e[(np.abs(e) < 1e-30) | (np.abs(e) > 1e30) | ~np.isfinite(e) | (np.abs(e) == 1)
          | ((e.view(np.uint32) & 0x7FFFFF) == 0) | (np.arange(e.size) % 9 == 0)]
    grid_y, grid_x = np.repeat(e, e.size), np.tile(e, e.size)
    w = _words(3, 2 * N)
    y = np.concatenate([w[:N], grid_y, np.float32([0, -0.0, 0, -0.0, 1, -1, 1, -1])])
    x = np.concatenate([w[N:], grid_x, np.float32([-1, -1, 1, 1, 0, 0, -0.0, -0.0])])
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    _assert_bits(libm.atan2(torch.from_numpy(y), torch.from_numpy(x)), want, "atan2")
    # every quadrant of the ordinary sizes
    rng = np.random.default_rng(4)
    y2, x2 = (rng.uniform(-10, 10, (2, N)).astype(np.float32))
    _assert_bits(libm.atan2(torch.from_numpy(y2), torch.from_numpy(x2)),
                 jax.jit(jnp.arctan2)(y2, x2), "atan2 (ordinary sizes)")


def _exact_fma(a, b, c):
    return fractions.Fraction(a) * fractions.Fraction(b) + fractions.Fraction(c)


@pytest.mark.parametrize("width", ["f32", "f64"])
def test_fused_multiply_add_rounds_once(width):
    """fma32 and the float64 emulation (Dekker's product, a two-sum, the low
    parts rounded to odd) against the exact sum rounded once, on operands
    made so that the exact sum lies next to a rounding boundary."""
    rng = np.random.default_rng(5)
    n = 3000
    if width == "f32":
        a = rng.uniform(-4, 4, n).astype(np.float32)
        b = rng.uniform(-4, 4, n).astype(np.float32)
        # c cancels the product to a few bits, or sits half an ulp away
        c = (-(a.astype(np.float64) * b) * rng.choice([1.0, 1 + 2.0 ** -24, 1 - 2.0 ** -25], n)
             ).astype(np.float32)
        got = libm.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
        want = np.array([F32(float(_exact_fma(float(p), float(q), float(r))))
                         for p, q, r in zip(a, b, c)], np.float32)
    else:
        a = rng.uniform(-4, 4, n)
        b = rng.uniform(-4, 4, n)
        c = -(a * b) * rng.choice([1.0, 1 + 2.0 ** -53, 1 - 2.0 ** -54], n)
        got = libm.fma64(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
        want = np.array([float(_exact_fma(p, q, r)) for p, q, r in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.uint32 if width == "f32" else np.uint64),
                                  want.view(np.uint32 if width == "f32" else np.uint64))


def test_flushes_denormals_as_the_reference_does():
    """XLA's CPU code runs with denormals flushed: exp's subnormal results
    are 0, log and sqrt read a subnormal as 0, atan2's tiny quotients are 0."""
    sub = np.array([0x00000001, 0x00400000, 0x80000003], np.uint32).view(np.float32)
    for op in ("log", "sqrt"):
        _assert_bits(getattr(libm, op)(torch.from_numpy(sub)), jax.jit(UNARY[op])(sub), op)
    x = np.float32([-87.4, -87.6, -87.9, -88.5])
    _assert_bits(libm.exp(torch.from_numpy(x)), jax.jit(jnp.exp)(x), "exp")
    assert float(libm.exp(torch.tensor([-87.6]))[0]) == 0.0
    y, xx = np.float32([1e-30, -1e-30, 3e-39]), np.float32([1e10, 1e10, 1.0])
    _assert_bits(libm.atan2(torch.from_numpy(y), torch.from_numpy(xx)),
                 jax.jit(jnp.arctan2)(y, xx), "atan2 tiny quotient")


def test_logsumexp_rows_against_reference():
    """The row kernel's plain versions: the reference's logsumexp within
    1e-6 (its sum order is XLA's, trap k); the normalised rows, their
    softmax and the effective sample size consistent with it."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(64, 30)) * 20).astype(np.float32)
    x[0, 3] = -np.inf
    want = np.asarray(jax.jit(lambda v: jax.scipy.special.logsumexp(v, axis=-1))(x))
    t = torch.from_numpy(x)
    lse = libm.logsumexp(t)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(libm.normalize_log(t).numpy(), (t - lse[:, None]).numpy())
    w, lse2 = libm.softmax_lse(t)
    assert torch.equal(lse2, lse)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    ess = libm.effective_sample_size(t)
    np.testing.assert_allclose(ess.numpy(), 1.0 / (w.double() ** 2).sum(-1).numpy(), rtol=1e-4)


def test_committed_digests_name_every_function():
    """tests/data/libm_digests.json holds a digest of every unary function
    over all 2^32 inputs (16 block digests each, combined) and atan2's."""
    d = ld.load()
    assert set(d["unary"]) == set(ld.UNARY) and len(d["atan2"]) == 64
    for op, entry in d["unary"].items():
        assert len(entry["blocks"]) == ld.BLOCKS
        assert ld.combine(entry["blocks"]) == entry["digest"], op


def test_a_block_digest_is_the_hash_of_its_outputs():
    """The digest scheme on a slice: the canonical bytes of the reference's
    outputs and of the plain version's hash alike, NaNs written as one."""
    x = ld.words(0x7F7F0000, 1 << 16).numpy()
    for op in ("sqrt", "exp"):
        want = ld.canonical(np.asarray(jax.jit(UNARY[op])(x)))
        got = ld.canonical(getattr(libm, op)(torch.from_numpy(x)))
        assert got.tobytes() == want.tobytes()
