"""Port parity: the Transferable-Belief-Model cell of vinySLAM.

``TBMCell.update`` is a closed-form k-fold conjunctive update through
``exp(k * log(base))`` plus one partial round, conflict forgetting and a
renormalisation. The port computes the powers as the jitted reference
does (``exp`` and ``log`` are XLA's, each base one fused multiply-add);
the later combinations and the sum over the masses are not held, and k <=
40 multiplies their ulps: atol 1e-6 on masses in [0, 1]. The grid,
the fold and the state conversion are generic over the channel count; the
tests here run them with the cell's four channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.utils import convert

torch.set_num_threads(1)

ATOL = 1e-6

#: (quality, conflict_decay): viny's preset, the class defaults, q = 1
#: (base 0 under the log), no forgetting
PARAMS = [(0.5, 0.1), (0.4, 0.1), (1.0, 0.1), (0.7, 0.0)]


def _beliefs(rng, n):
    """Random masses: most a partition of unity, some fresh cells, some
    drifted off unit mass (the update renormalizes them)."""
    m = rng.dirichlet([0.7, 0.7, 0.7, 0.3], n).astype(np.float32)
    m[: n // 8] = (0.0, 0.0, 1.0, 0.0)
    m[n // 8 : n // 4] *= rng.uniform(0.9, 1.1, (n // 4 - n // 8, 1)).astype(np.float32)
    return m


def _weights(rng, n):
    """Observation weights in [0, 40]: unseen cells (0), integers (a cell
    crossed by k beams), fractions (blur ramps), and mixtures."""
    w = rng.uniform(0.0, 40.0, n)
    kind = rng.integers(0, 4, n)
    w = np.where(kind == 0, 0.0, w)
    w = np.where(kind == 1, np.floor(w), w)
    w = np.where(kind == 2, w % 1.0, w)
    return w.astype(np.float32)


def _pair(q, decay):
    return (jcells.TBMCell(quality=q, conflict_decay=decay),
            tcells.TBMCell(quality=q, conflict_decay=decay))


@pytest.mark.parametrize("q,decay", PARAMS)
def test_tbm_update_matches_reference(q, decay):
    jm, tm = _pair(q, decay)
    rng = np.random.default_rng(0)
    n = 4096
    belief, w = _beliefs(rng, n), _weights(rng, n)
    s = (w * rng.uniform(size=n) * (rng.uniform(size=n) < 0.7)).astype(np.float32)
    n_prev = rng.integers(0, 5, n).astype(np.float32)
    assert (w == 0).sum() > 500 and ((w > 0) & (w == np.floor(w))).sum() > 500
    # jitted, as the reference's engine runs it (XLA fuses the powers' bases)
    want = np.asarray(jax.jit(jm.update)(jnp.asarray(belief), jnp.asarray(n_prev), jnp.asarray(w),
                                         jnp.asarray(s)))
    got = tm.update(
        torch.from_numpy(belief), torch.from_numpy(n_prev), torch.from_numpy(w), torch.from_numpy(s)
    ).numpy()
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # unseen cells keep their masses bit for bit
    np.testing.assert_array_equal(got[w == 0], belief[w == 0])
    # seen cells come out as a partition of unity
    np.testing.assert_allclose(got[w > 0].sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        tm.occupancy(torch.from_numpy(got)).numpy(), np.asarray(jm.occupancy(jnp.asarray(got))),
        atol=ATOL,
    )


def test_tbm_integer_weight_equals_sequential_rounds():
    """The closed form at integer w is w conjunctive rounds at weight 1
    (with forgetting off, which acts once per update, not per round)."""
    tm = tcells.TBMCell(quality=0.5, conflict_decay=0.0)
    rng = np.random.default_rng(1)
    belief = torch.from_numpy(_beliefs(rng, 256))
    o = torch.from_numpy(rng.uniform(size=256).astype(np.float32))
    zero, one = torch.zeros(256), torch.ones(256)
    seq = belief
    for _ in range(5):
        seq = tm.update(seq, zero, one, o)
    once = tm.update(belief, zero, 5.0 * one, 5.0 * o)
    # the sequential form renormalizes five times, the closed form once
    torch.testing.assert_close(once, seq, atol=1e-5, rtol=0)


def test_tbm_registry_and_init_cell():
    assert set(tcells.CELL_MODELS) == set(jcells.CELL_MODELS)
    assert tcells.CELL_MODELS["tbm"] is tcells.TBMCell
    jm, tm = _pair(0.5, 0.1)
    assert tm.n_channels == jm.n_channels == 4
    np.testing.assert_array_equal(tcells.init_cell(tm).numpy(), np.asarray(jcells.init_cell(jm)))


def test_grid_and_fold_are_generic_over_channels():
    """``make_grid_map`` and ``apply_observations`` with the four-channel
    cell against the reference, two folds in a row."""
    jm, tm = _pair(0.5, 0.1)
    j = jgrid.make_grid_map(jm, 24, 40, 0.1)
    t = tgrid.make_grid_map(tm, 24, 40, 0.1)
    assert t.cells.shape == (24, 40, 5)
    np.testing.assert_array_equal(t.cells.numpy(), np.asarray(j.cells))
    rng = np.random.default_rng(2)
    for _ in range(2):
        w_obs = (_weights(rng, 24 * 40) / 8.0).reshape(24, 40)
        s_obs = (w_obs * rng.uniform(size=(24, 40)) * (rng.uniform(size=(24, 40)) < 0.5)).astype(np.float32)
        j = jgrid.apply_observations(j, jm, jnp.asarray(w_obs), jnp.asarray(s_obs))
        t = tgrid.apply_observations(t, tm, torch.from_numpy(w_obs), torch.from_numpy(s_obs))
    np.testing.assert_allclose(t.cells.numpy(), np.asarray(j.cells), atol=ATOL)
    np.testing.assert_allclose(
        tgrid.occupancy_plane(t, tm).numpy(), np.asarray(jgrid.occupancy_plane(j, jm)), atol=ATOL
    )
    np.testing.assert_array_equal(tgrid.known_mask(t).numpy(), np.asarray(jgrid.known_mask(j)))


def test_convert_carries_a_four_channel_state():
    tm = tcells.TBMCell(quality=0.5)
    cfg = teng.EngineConfig(cell_model=tm, map_height=16, map_width=24)
    state = teng.init_state(cfg, "cpu")
    rng = np.random.default_rng(3)
    state.gm.cells = torch.from_numpy(rng.uniform(size=(16, 24, 5)).astype(np.float32))
    tree = convert.state_to_numpy(state)
    assert tree["cells"].shape == (16, 24, 5)
    back = convert.state_from_numpy(tree, "cpu")
    assert torch.equal(back.gm.cells, state.gm.cells)
    assert torch.equal(back.gm.origin, state.gm.origin) and back.gm.scale == state.gm.scale
    assert torch.equal(back.pose, state.pose) and int(back.step) == 0
