"""The port's threefry (``ops/prng.py``, the plain version of
``kernels.prng_draws``) against ``jax.random`` on the CPU, bit for bit.

``PRNGKey`` at edge seeds (with 64-bit types off a seed wraps mod 2^32),
``split`` at several ``n``, ``bits`` / ``uniform`` / ``normal`` at the
shapes the paths draw, the resampling comb's ``uniform(k, (), 0, 1/n)``,
general uniform bounds (XLA fuses the multiply-add), a batch of keys (the
reference's ``vmap``), the RBPF's and the engine's split trees, and the
normal transform over all 2^23 values its uniform can take, against JAX
jitted. A plan's records are decoded here as ``csrc/threefry.cu`` decodes
them (element index -> path indices -> hashes), in numpy, and must give the
plain version's outputs; the committed fixture (``tests/data/
prng_reference.npz``, written by ``scripts/torch_port/prng_fixture.py``)
must equal the plain version, as the card's run holds the kernel to it.
"""

import functools
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import gmapping as jgm
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.ops import kernels, prng

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "prng_reference.npz"
SEEDS = (0, 1, 42, -1, 2**31 + 5, 2**32 + 7)
KEYS = (0, 42, 2**32 + 7)
SHAPES = ((), (3,), (30, 3), (64, 3), (12, 64, 3))


def words(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def same_bits(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    np.testing.assert_array_equal(port.numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_is_prngkey(seed):
    k = prng.key(seed)
    assert k.dtype == torch.uint32 and k.shape == (2,)
    same_bits(k, jax.random.PRNGKey(seed))
    assert k.tolist() == [0, seed % 2**32]


@pytest.mark.parametrize("n", (1, 2, 4, 5, 12, 30, 1000))
def test_split(n):
    for s in KEYS:
        same_bits(prng.split(prng.key(s), n), jax.random.split(jax.random.PRNGKey(s), n))
    # a split's key i does not depend on n (the partitionable counters)
    k = prng.key(7)
    same_bits(prng.fold(k, n - 1), jax.random.split(jax.random.PRNGKey(7), n)[n - 1])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", ("bits", "uniform", "normal"))
def test_draws(kind, shape):
    for s in KEYS:
        jk, tk = jax.random.PRNGKey(s), prng.key(s)
        if kind == "bits":
            same_bits(prng.bits(tk, shape), jax.random.bits(jk, shape, dtype=jnp.uint32))
        elif kind == "uniform":
            same_bits(prng.uniform(tk, shape), jax.random.uniform(jk, shape))
        else:
            same_bits(prng.normal(tk, shape), jax.random.normal(jk, shape))


@pytest.mark.parametrize("n", (16, 30, 32))
def test_comb_offset(n):
    """The resampling comb's offset: ``uniform(key, (), 0, 1/n)``."""
    keys = jax.random.split(jax.random.PRNGKey(9), 64)
    want = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=1.0 / n))(keys)
    same_bits(prng.uniform(prng.split(prng.key(9), 64), (), 0.0, 1.0 / n), want)


def test_uniform_bounds_take_one_fused_multiply_add():
    """XLA fuses ``f * (max - min) + min``: other bounds than 0 differ in
    ~1/4 of the draws unless the port fuses too."""
    for lo, hi in ((0.3, 1.7), (-2.0, 3.1), (-0.5, 0.5)):
        same_bits(prng.uniform(prng.key(4), (4096,), lo, hi),
                  jax.random.uniform(jax.random.PRNGKey(4), (4096,), minval=lo, maxval=hi))


def test_batch_of_keys_is_the_reference_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = jax.vmap(lambda k: jax.random.normal(k, (4, 3)))(keys)
    got = prng.normal(prng.split(prng.key(3), 6), (4, 3))
    same_bits(got, want)
    same_bits(prng.split(prng.split(prng.key(3), 6), 5),
              jax.vmap(lambda k: jax.random.split(k, 5))(keys))


@functools.cache
def transform_table() -> torch.Tensor:
    """The plain version's normal over its 2^23 inputs, made once (on a few
    threads: ~70 float32 operations on 8 M values)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        return prng.transform_table((1 << 23,))
    finally:
        torch.set_num_threads(threads)


def test_normal_transform_over_every_input():
    """``normal``'s uniform takes 2^23 values; XLA's ``erf_inv`` (FMA Horner
    steps, its own ``log1p``) and the port's agree on every one of them."""
    table = transform_table()
    j = np.arange(1 << 23, dtype=np.uint32)
    f = (j | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.float32(prng.NORMAL_LO)
    u = np.maximum(lo, f * np.float32(2.0) + lo).astype(np.float32)
    want = jax.jit(lambda x: np.float32(np.sqrt(2)) * jax.lax.erf_inv(x))(u)
    same_bits(table, want)
    # and XLA's log1p on every -u^2 it takes
    v = (-u[::4]) * u[::4]
    same_bits(prng.log1p_xla(torch.from_numpy(v)), jax.jit(jnp.log1p)(v))


def test_torch_sqrt_is_not_the_transform_square_root():
    """Why the transform takes its square root through float64: the CPU's
    float32 ``torch.sqrt`` is not correctly rounded on every input."""
    x = np.random.default_rng(0).uniform(5, 17, 1 << 16).astype(np.float32)
    ieee = np.sqrt(x)
    via64 = torch.from_numpy(x).double().sqrt().float().numpy()
    np.testing.assert_array_equal(via64, ieee)


@functools.cache
def _reference_rbpf_draws(cfg):
    """The reference step's keys and draws (``gmapping.py:302-318``,
    ``:207-211``, ``:239``, ``resample.py:43``), jitted."""
    def fn(key):
        key, k_noise, k_match, k_res = jax.random.split(key, 4)
        keys = jax.random.split(k_match, cfg.n_particles)
        lo = np.nextafter(np.float32(-1), np.float32(0))
        out = {"key": key, "proposal": jax.lax.erf_inv(jax.random.uniform(
            k_noise, (cfg.n_particles, 3), minval=lo, maxval=1.0)),
               "u0": jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / cfg.n_particles)}
        if cfg.proposal == "improved":
            pairs = jax.vmap(jax.random.split)(keys)
            keys = pairs[:, 0]
            kj = jax.vmap(jax.random.split)(pairs[:, 1])
            out["probe"] = jax.vmap(lambda k: jax.random.normal(
                k, (cfg.proposal_samples, 3)))(kj[:, 0])
            out["sample"] = jax.vmap(lambda k: jax.random.normal(k, (3,)))(kj[:, 1])
        mc = cfg.matcher_cfg
        out["match_key"] = keys
        out["match"] = jax.vmap(lambda k: jax.vmap(lambda kr: jax.random.normal(
            kr, (mc.batch, 3)))(jax.random.split(k, mc.rounds)))(keys)
        return out

    return jax.jit(fn)


@pytest.mark.parametrize("proposal", ("odom", "improved"))
def test_rbpf_split_tree(proposal):
    """From ``split(key, 4)`` down to each particle's match rounds (and the
    improved proposal's probes and sample): ``gmapping.draw`` against the
    reference's tree, three steps along the key."""
    kw = dict(n_particles=6, map_height=64, map_width=64, proposal=proposal,
              proposal_samples=8)
    mc = dict(batch=10, rounds=3)
    jcfg = jgm.GMappingConfig(**kw, matcher_cfg=jmatch.MonteCarloConfig(**mc))
    tcfg = tgm.GMappingConfig(**kw, matcher_cfg=tgm.matcherslib.MonteCarloConfig(**mc))
    jkey, tkey = jax.random.PRNGKey(11), prng.key(11)
    for _ in range(3):
        want = _reference_rbpf_draws(jcfg)(jkey)
        tkey, d = tgm.draw(tcfg, tkey)
        same_bits(tkey, want["key"])
        # the proposal as the erf_inv(u) values that the reference's jitted
        # step multiplies by sqrt(2) sigma (gmapping.propose)
        same_bits(d.proposal.values, want["proposal"])
        for name in ("u0", "match_key") + (("probe", "sample") if proposal == "improved"
                                           else ()):
            same_bits(getattr(d, name), want[name])
        # the match draws its rounds from its particle's key (K5's prologue)
        same_bits(prng.draws_ref(d.match_key, tgm.matcherslib.noise_plan(tcfg.matcher_cfg))[0],
                  want["match"])
        assert d.match is None and d.refine is None
        assert (d.probe is None) == (proposal == "odom")
        jkey = want["key"]


def test_engine_step_split_tree():
    """``key, sub = split(key)``; the match's ``split(sub, rounds)``,
    ``normal(key_r, (batch, 3))`` a round (``engine.py:219``)."""
    cfg = ttiny.tiny_config(map_size=64, mc_batch=16, mc_rounds=5)
    jkey, tkey = jax.random.PRNGKey(2**31 + 5), prng.key(2**31 + 5)
    for _ in range(3):
        jkey, sub = jax.random.split(jkey)
        want = jax.vmap(lambda k: jax.random.normal(k, (16, 3)))(jax.random.split(sub, 5))
        tkey, noise, refine = teng.draw_step(cfg, tkey)
        same_bits(tkey, jkey)
        same_bits(noise, want)
        assert refine is None


def _kernel_decode(plan, key):
    """The plan's records (``kernels._prng_records``) evaluated as
    ``csrc/threefry.cu`` evaluates them, element by element, in numpy: an
    output a record."""
    rows, outputs, _ = kernels._prng_records(plan, tuple(key.shape[:-1]))
    table = np.asarray(rows, np.int32)
    roots = key.reshape(-1, 2).numpy().astype(np.int64)

    def tf(k0, k1, x0, x1):
        y0, y1 = prng.threefry2x32(*(torch.from_numpy(np.asarray(v, np.int64))
                                     for v in (k0, k1, x0, x1)))
        return y0.numpy(), y1.numpy()

    outs = []
    for rec, (shape, _) in zip(table, outputs):
        kind, _, elements, leaves, length = (int(v) for v in rec[:5])
        out = np.zeros(int(np.prod(shape)), np.uint32)
        e = np.arange(elements, dtype=np.int64)
        rest, leaf = e // leaves, e % leaves
        idx = [None] * length
        for j in range(length - 1, -1, -1):
            s = int(rec[8 + j])
            if s < 0:
                idx[j], rest = rest % -s, rest // -s
            else:
                idx[j] = np.full_like(e, s)
        k0, k1 = roots[rest, 0], roots[rest, 1]
        for j in range(length):
            k0, k1 = tf(k0, k1, np.zeros_like(e), idx[j])
        if kind == prng.KINDS.index("key"):
            out[2 * e], out[2 * e + 1] = k0, k1
            outs.append(out.reshape(shape))
            continue
        y0, y1 = tf(k0, k1, leaf >> 32, leaf & prng.MASK)
        b = (y0 ^ y1).astype(np.uint32)
        if kind == prng.KINDS.index("transform"):
            b = ((leaf & 0x7FFFFF) << 9).astype(np.uint32)
        if kind == prng.KINDS.index("bits"):
            outs.append(b.reshape(shape))
            continue
        lo, span = rec[5:6].view(np.float32)[0], rec[7:8].view(np.float32)[0]
        f = torch.from_numpy(((b >> 9) | 0x3F800000).view(np.float32) - np.float32(1))
        u = torch.maximum(torch.tensor(lo), prng._fma(f, torch.tensor(span), torch.tensor(lo)))
        v = (u if kind == prng.KINDS.index("uniform")
             else prng.erf_inv_xla(u) if kind == prng.KINDS.index("erfinv")
             else prng.normal_transform(u))
        outs.append(v.numpy().view(np.uint32).reshape(shape))
    return outs


def test_plan_records_decode_as_the_kernel_reads_them():
    """Every output of a step's plan (the engine's, the RBPF's with both
    proposals, the synthetic sequence's) at one key and at a batch of keys,
    read from the kernel's records as the kernel reads them, equals the
    plain version bit for bit."""
    plans = [teng.step_plan(ttiny.tiny_config(map_size=64, mc_batch=8, mc_rounds=3))]
    for proposal in ("odom", "improved"):
        cfg = tgm.GMappingConfig(n_particles=5, map_height=64, map_width=64, proposal=proposal,
                                 proposal_samples=4, matcher_cfg=tgm.matcherslib.MonteCarloConfig(
                                     batch=6, rounds=2))
        plans.append((tgm.NEXT_KEY, *(d for d in tgm.draw_plan(cfg) if d is not None)))
    plans.append((prng.Draw((7,), "normal", (7, 3)),
                  prng.Draw((prng.Each(7),), "normal", (12,)),
                  prng.Draw((), "bits", (5,)), prng.Draw((), "transform", (9,))))
    for key in (prng.key(-1), prng.split(prng.key(2), 3)):
        for plan in plans:
            for got, want in zip(_kernel_decode(plan, key), prng.draws_ref(key, plan)):
                np.testing.assert_array_equal(got, want.numpy().view(np.uint32))


def test_fixture_is_the_plain_version():
    """The committed draws of JAX (the card's check) equal the plain version
    on every case, and hash the transform's 2^23 outputs alike."""
    with np.load(FIXTURE) as f:
        manifest = json.loads(bytes(f["manifest"]).decode())
        for c, case in enumerate(manifest):
            root = torch.from_numpy(np.array(case["root"], np.uint32))
            outs = kernels.prng_draws(root, tuple(prng.draw_of(d) for d in case["plan"]))
            for o, got in enumerate(outs):
                same_bits(got, f[f"case_{c}_{o}"])
        sha = bytes(f["transform_sha256"]).decode()
    assert hashlib.sha256(transform_table().numpy().tobytes()).hexdigest() == sha
    assert len(manifest) >= 50


def test_cpu_draws_launch_nothing_and_keys_must_be_uint32():
    before = kernels.launch_counts()["prng_draws"]
    out = kernels.prng_draws(prng.key(1), (prng.Draw((), "normal", (3,)),))
    assert kernels.launch_counts()["prng_draws"] == before and out[0].dtype == torch.float32
    with pytest.raises(TypeError, match="uint32"):
        prng.normal(torch.tensor([0, 1]), (3,))
    with pytest.raises(ValueError, match="kind"):
        prng.Draw((), "gamma")
