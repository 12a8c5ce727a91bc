"""Port parity of the particle-filter primitives (``ops/resample.py``).

Seeded numpy log-weights, healthy (Neff near P) and degenerate (a few
particles hold the mass), go through the reference's functions and the
port's. The reference draws the comb's offset from its key inside
``systematic_resample``; the same ``uniform(key, (), 0, 1/n)`` is handed to
the port as ``u0``. Ancestor indices must be equal; the test first makes
sure no comb point lies within 1e-6 of a cumulative weight, where a
different order of the cumsum's additions (XLA on the CPU, torch on the
CPU, a scan on the card) could move it across. Log-weights and Neff agree
within 1e-6 (a logsumexp summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import resample as jres
from slam_constructor_tpu_torch.ops import prng as tprng
from slam_constructor_tpu_torch.ops import resample as tres

torch.set_num_threads(1)

TOL = 1e-6
CASES = [(6, "healthy", 0), (6, "degenerate", 1), (30, "healthy", 2), (30, "degenerate", 3),
         (30, "one particle", 4), (64, "degenerate", 5)]


def log_weights(p, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "healthy":
        logw = rng.normal(0.0, 0.1, p)
    elif kind == "degenerate":
        logw = rng.normal(0.0, 6.0, p)
    else:  # all the mass on one particle
        logw = np.full(p, -40.0)
        logw[rng.integers(p)] = 0.0
    return logw.astype(np.float32)


def comb_clear_of_cdf(logw, u0, n):
    w = np.exp(np.asarray(jres.normalize_log_weights(jnp.asarray(logw)), np.float64))
    comb = u0 + np.arange(n) / n
    return np.abs(comb[:, None] - np.cumsum(w)[None, :]).min() > 1e-6


@pytest.mark.parametrize("p,kind,seed", CASES)
def test_normalize_and_neff_match_reference(p, kind, seed):
    logw = log_weights(p, kind, seed)
    j = np.asarray(jres.normalize_log_weights(jnp.asarray(logw)))
    t = tres.normalize_log_weights(torch.from_numpy(logw)).numpy()
    np.testing.assert_allclose(t, j, atol=TOL, rtol=0)
    jn = float(jres.effective_sample_size(jnp.asarray(logw)))
    tn = float(tres.effective_sample_size(torch.from_numpy(logw)))
    np.testing.assert_allclose(tn, jn, atol=TOL * p, rtol=TOL)


@pytest.mark.parametrize("p,kind,seed", CASES)
def test_systematic_and_conditional_resample_match_reference(p, kind, seed):
    logw = log_weights(p, kind, seed)
    key = jax.random.PRNGKey(seed)
    u0 = np.float32(jax.random.uniform(key, (), minval=0.0, maxval=1.0 / p))
    assert comb_clear_of_cdf(logw, float(u0), p)
    j_idx = np.asarray(jres.systematic_resample(key, jnp.asarray(logw), p))
    t_idx = tres.systematic_resample(torch.tensor(u0), torch.from_numpy(logw), p).numpy()
    np.testing.assert_array_equal(t_idx, j_idx)

    j_idx, j_logw, j_do = jres.maybe_resample(key, jnp.asarray(logw), 0.5)
    t_idx, t_logw, t_do = tres.maybe_resample(torch.tensor(u0), torch.from_numpy(logw), 0.5)
    assert bool(t_do) == bool(j_do) == (kind != "healthy")
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_logw.numpy(), np.asarray(j_logw), atol=TOL, rtol=0)


def test_uniform_weights_are_the_f32_log():
    """-log(P) as the reference takes it, the f32 log of an f32 P."""
    for p in (6, 30, 64):
        np.testing.assert_array_equal(
            tres.log_uniform_weights(p).numpy(), np.full(p, -np.asarray(jnp.log(float(p)))))
    keys = tprng.split(tprng.key(0), 200)
    u = torch.stack([tres.uniform_offset(30, k) for k in keys])
    assert u.dtype == torch.float32 and bool((u >= 0).all()) and bool((u < 1 / 30).all())
    # the reference's draw from the same key
    want = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=1.0 / 30))(
        jax.random.split(jax.random.PRNGKey(0), 200))
    np.testing.assert_array_equal(u.numpy(), np.asarray(want))
