"""Port parity: grid maps, Bayes cell folds and the config lockstep.

The folds are a few elementwise f32 ops per cell; atol 1e-6 covers a
last-ulp difference in ``pow`` or a division. Index math must be equal.
The lockstep test holds the port's mirrored config dataclasses to the
reference's field names and defaults (the card has no JAX, so the port
cannot import the reference's dataclasses).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.models import tiny as jtiny
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import matchers as tmatch
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops import scoring as tscore

torch.set_num_threads(1)

ATOL = 1e-6

MODELS = {
    "bayes_avg": (jcells.BayesAvgCell(), tcells.BayesAvgCell()),
    "bayes_base": (jcells.BayesBaseCell(quality=0.3), tcells.BayesBaseCell(quality=0.3)),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_make_grid_map_matches_reference(model):
    jm, tm = MODELS[model]
    j = jgrid.make_grid_map(jm, 40, 56, 0.1)
    t = tgrid.make_grid_map(tm, 40, 56, 0.1)
    np.testing.assert_array_equal(t.cells.numpy(), np.asarray(j.cells))
    np.testing.assert_array_equal(t.origin.numpy(), np.asarray(j.origin))
    assert t.scale == j.scale
    np.testing.assert_array_equal(tcells.init_cell(tm).numpy(), np.asarray(jcells.init_cell(jm)))


def test_world_to_cell_and_gather_plane_match_reference():
    rng = np.random.default_rng(0)
    j = jgrid.make_grid_map(jcells.BayesAvgCell(), 40, 56, 0.1)
    t = tgrid.make_grid_map(tcells.BayesAvgCell(), 40, 56, 0.1)
    pts = rng.uniform(-4.0, 4.0, (500, 2)).astype(np.float32)  # many off the map
    ji = np.asarray(jgrid.world_to_cell(j, jnp.asarray(pts)))
    ti = tgrid.world_to_cell(t, torch.from_numpy(pts))
    np.testing.assert_array_equal(ti.numpy(), ji)
    plane = rng.uniform(size=(40, 56)).astype(np.float32)
    want = np.asarray(jgrid.gather_plane(jnp.asarray(plane), jnp.asarray(ji), 0.25, 40, 56))
    got = tgrid.gather_plane(torch.from_numpy(plane), ti, 0.25, 40, 56).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_apply_observations_matches_reference(model):
    jm, tm = MODELS[model]
    rng = np.random.default_rng(1)
    h, w = 32, 48
    cells = np.concatenate(
        [rng.uniform(size=(h, w, 1)), rng.integers(0, 4, (h, w, 1)).astype(np.float64)], -1
    ).astype(np.float32)
    w_obs = (rng.integers(0, 3, (h, w)) + rng.uniform(size=(h, w)) * (rng.uniform(size=(h, w)) < 0.3)).astype(np.float32)
    s_obs = (w_obs * rng.uniform(size=(h, w))).astype(np.float32)
    jg = jgrid.GridMap(cells=jnp.asarray(cells), origin=jnp.zeros(2), scale=0.1)
    tg = tgrid.GridMap(cells=torch.from_numpy(cells), origin=torch.zeros(2), scale=0.1)
    j = jgrid.apply_observations(jg, jm, jnp.asarray(w_obs), jnp.asarray(s_obs))
    t = tgrid.apply_observations(tg, tm, torch.from_numpy(w_obs), torch.from_numpy(s_obs))
    np.testing.assert_allclose(t.cells.numpy(), np.asarray(j.cells), atol=ATOL)
    np.testing.assert_allclose(
        tgrid.occupancy_plane(t, tm).numpy(), np.asarray(jgrid.occupancy_plane(j, jm)), atol=ATOL
    )
    np.testing.assert_array_equal(tgrid.known_mask(t).numpy(), np.asarray(jgrid.known_mask(j)))


# --- config lockstep ---------------------------------------------------------

#: fields of the reference that only its TPU lowerings read; the port
#: leaves them out on purpose
TPU_ONLY = {
    "ScoringConfig": {"impl", "dtype"},
    "BeamConfig": {"scatter_impl"},
}

PAIRS = [
    (jscore.ScoringConfig, tscore.ScoringConfig),
    (jmatch.MonteCarloConfig, tmatch.MonteCarloConfig),
    (jray.BeamConfig, tray.BeamConfig),
    (jeng.EngineConfig, teng.EngineConfig),
    (jcells.BayesAvgCell, tcells.BayesAvgCell),
    (jcells.BayesBaseCell, tcells.BayesBaseCell),
]


def _as_tree(obj):
    """A config as nested (class name, {field: value}) for comparison."""
    if dataclasses.is_dataclass(obj):
        left_out = TPU_ONLY.get(type(obj).__name__, set())
        return type(obj).__name__, {
            f.name: _as_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.name not in left_out
        }
    return obj


@pytest.mark.parametrize("jcls,tcls", PAIRS, ids=[p[0].__name__ for p in PAIRS])
def test_config_lockstep(jcls, tcls):
    assert jcls.__name__ == tcls.__name__
    jnames = {f.name for f in dataclasses.fields(jcls)}
    tnames = {f.name for f in dataclasses.fields(tcls)}
    assert jnames - tnames == TPU_ONLY.get(jcls.__name__, set())
    assert tnames <= jnames
    assert _as_tree(tcls()) == _as_tree(jcls())


def test_tiny_config_lockstep():
    """Same preset values; the only difference is the pinned free fill
    (the reference's 'auto' resolves to 'dda' off the TPU)."""
    j = jtiny.tiny_config(cell="bayes_base", quality=0.4, map_size=128, mc_batch=16, mc_rounds=4)
    assert j.beam.free_impl == "auto" and j.beam.resolved_free_impl() == "dda"
    j = dataclasses.replace(j, beam=dataclasses.replace(j.beam, free_impl="dda"))
    t = ttiny.tiny_config(cell="bayes_base", quality=0.4, map_size=128, mc_batch=16, mc_rounds=4)
    assert _as_tree(t) == _as_tree(j)


@pytest.mark.parametrize(
    "make",
    [
        lambda: teng.EngineConfig(map_storage="tiled"),
        lambda: teng.EngineConfig(match_window=64),
        lambda: teng.EngineConfig(refine_matcher="hill_climbing"),
        lambda: teng.EngineConfig(use_angle_histogram=True),
        lambda: teng.EngineConfig(matcher="m3rsm"),
        lambda: tray.BeamConfig(free_impl="polar"),
        lambda: tray.BeamConfig(occupancy_estimator="area"),
    ],
)
def test_fields_of_later_slices_raise(make):
    with pytest.raises(NotImplementedError):
        make()


@pytest.mark.parametrize(
    "cfg",
    [tscore.ScoringConfig(), tscore.ScoringConfig(reducer="overlap", overlap_extent=1.6),
     tscore.ScoringConfig(reducer="overlap", window=0)],
)
def test_unported_scoring_raises(cfg):
    view = tscore.MapView(
        occ=torch.zeros(8, 8), known=torch.ones(8, 8, dtype=torch.bool),
        origin=torch.zeros(2), scale=0.1,
    )
    from slam_constructor_tpu_torch.ops.scan import make_scan

    scan = make_scan(torch.ones(4), torch.zeros(4))
    with pytest.raises(NotImplementedError):
        tscore.score_poses(view, scan, torch.zeros(1, 3), cfg)
