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
from slam_constructor_tpu.models import full as jfull
from slam_constructor_tpu.models import posegraph as jpg
from slam_constructor_tpu.models import tiny as jtiny
from slam_constructor_tpu.models import viny as jviny
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import m3rsm as jm3
from slam_constructor_tpu.ops import matchers as jmatch
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscore
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import full as tfull
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.models import posegraph as tpg
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.models import viny as tviny
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import m3rsm as tm3
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
#: leaves them out on purpose. Of the values of ``BeamConfig.free_impl``,
#: 'polar_pallas' is TPU-only too (the polar fill as a Pallas launch,
#: bitwise equal to 'polar'; the port has the one name 'polar'), and 'auto'
#: (an algorithm picked by backend) is refused.
TPU_ONLY = {
    "ScoringConfig": {"impl", "dtype"},
    "BeamConfig": {"scatter_impl"},
    # candidates a score dispatch; the port scores the whole grid in one call
    "BruteForceConfig": {"chunk"},
    # how many segments the reference queues between two fetches through its
    # device tunnel; the port fetches once a segment
    "FullConfig": {"sync_every"},
}

PAIRS = [
    (jscore.ScoringConfig, tscore.ScoringConfig),
    (jmatch.MonteCarloConfig, tmatch.MonteCarloConfig),
    (jray.BeamConfig, tray.BeamConfig),
    (jeng.EngineConfig, teng.EngineConfig),
    (jcells.BayesAvgCell, tcells.BayesAvgCell),
    (jcells.BayesBaseCell, tcells.BayesBaseCell),
    (jcells.TBMCell, tcells.TBMCell),
    (jmatch.BruteForceConfig, tmatch.BruteForceConfig),
    (jmatch.HillClimbingConfig, tmatch.HillClimbingConfig),
    (jm3.M3RSMConfig, tm3.M3RSMConfig),
    (jpg.PoseGraphConfig, tpg.PoseGraphConfig),
    (jfull.FullConfig, tfull.FullConfig),
]


def _as_tree(obj, resolve_auto=False):
    """A config as nested (class name, {field: value}) for comparison. With
    ``resolve_auto`` a reference ``BeamConfig`` whose free fill is 'auto'
    reads as what 'auto' resolves to off the TPU ('dda'), the algorithm the
    port's tiny presets name."""
    if dataclasses.is_dataclass(obj):
        left_out = TPU_ONLY.get(type(obj).__name__, set())
        tree = {
            f.name: _as_tree(getattr(obj, f.name), resolve_auto)
            for f in dataclasses.fields(obj)
            if f.name not in left_out
        }
        if resolve_auto and isinstance(obj, jray.BeamConfig) and obj.free_impl == "auto":
            tree["free_impl"] = obj.resolved_free_impl()
        return type(obj).__name__, tree
    return obj


@pytest.mark.parametrize("jcls,tcls", PAIRS, ids=[p[0].__name__ for p in PAIRS])
def test_config_lockstep(jcls, tcls):
    assert jcls.__name__ == tcls.__name__
    jnames = {f.name for f in dataclasses.fields(jcls)}
    tnames = {f.name for f in dataclasses.fields(tcls)}
    assert jnames - tnames == TPU_ONLY.get(jcls.__name__, set())
    assert tnames <= jnames
    assert _as_tree(tcls()) == _as_tree(jcls(), resolve_auto=True)


def test_tiny_config_lockstep():
    """Same preset values; the only difference is the pinned free fill
    (the reference's 'auto' resolves to 'dda' off the TPU)."""
    j = jtiny.tiny_config(cell="bayes_base", quality=0.4, map_size=128, mc_batch=16, mc_rounds=4)
    assert j.beam.free_impl == "auto" and j.beam.resolved_free_impl() == "dda"
    j = dataclasses.replace(j, beam=dataclasses.replace(j.beam, free_impl="dda"))
    t = ttiny.tiny_config(cell="bayes_base", quality=0.4, map_size=128, mc_batch=16, mc_rounds=4)
    assert _as_tree(t) == _as_tree(j)


def test_fast_config_lockstep():
    """Same window, range cap and stride; the free fill pinned as in
    ``tiny_config``. The bench's full-pipeline tracker is one of the cases."""
    for kwargs in (dict(map_size=256, stride=2, mc_rounds=12), dict(),
                   dict(map_size=128, usable_range=4.0, mc_batch=16, hole_width=0.2)):
        j = jtiny.fast_config(**kwargs)
        assert j.beam.free_impl == "auto" and j.beam.resolved_free_impl() == "dda"
        j = dataclasses.replace(j, beam=dataclasses.replace(j.beam, free_impl="dda"))
        t = ttiny.fast_config(**kwargs)
        assert _as_tree(t) == _as_tree(j)
    assert ttiny.fast_config(map_size=256, stride=2).match_window == 192


def test_viny_config_lockstep():
    """Same preset values; the only difference is the pinned free fill: the
    reference's 'auto' resolves to 'polar' on its accelerator (and to 'dda'
    on the CPU this test runs on)."""
    kwargs = dict(quality=0.4, conflict_decay=0.2, map_size=128, mc_batch=16, mc_rounds=4,
                  min_insert_prob=0.3, stride=3)
    j = jviny.viny_config(**kwargs)
    assert j.beam.free_impl == "auto" and j.beam.resolved_free_impl() == "dda"
    j = dataclasses.replace(j, beam=dataclasses.replace(j.beam, free_impl="polar"))
    t = tviny.viny_config(**kwargs)
    assert _as_tree(t) == _as_tree(j)
    assert _as_tree(tviny.viny_config()) == _as_tree(
        dataclasses.replace(jviny.viny_config(), beam=dataclasses.replace(
            jviny.viny_config().beam, free_impl="polar")))
    assert t.use_angle_histogram and t.matcher_cfg.rounds == 4 and t.matcher_cfg.scoring.stride == 3


def test_viny_m3rsm_config_lockstep():
    """The same tree as the reference's preset, at its defaults and at the
    sizes of the tests and of the smoke run (the free fill pinned to 'dda'
    on both sides)."""
    for kwargs in ({}, dict(map_size=128), dict(map_size=128, usable_range=3.0, levels=3)):
        assert _as_tree(tviny.viny_m3rsm_config(**kwargs)) == _as_tree(
            jviny.viny_m3rsm_config(**kwargs))
    cfg = tviny.viny_m3rsm_config()
    assert cfg.matcher == "m3rsm" and cfg.beam.free_impl == "dda"
    assert cfg.matcher_cfg.window == 160 and cfg.matcher_cfg.beam_width == 48


@pytest.mark.parametrize(
    "make",
    [
        # the tiled storage, the engine's refine and hill climbing as its
        # primary matcher are ported (test_torch_config.py), and so are the
        # RBPF's copy-on-write storage (test_torch_cow.py), its other
        # matchers (test_torch_matcher_slots.py) and the sharded preset
        # (test_torch_sharded_rbpf.py); what stays refused:
        # the reference's grid-pitch fallback for M3RSM is a known fault (trap e)
        lambda: tpg.PoseGraphConfig(loop_matcher_kind="m3rsm", loop_subcell_refine=True),
        # the reference hands its loop and joint-refine matcher no key, on
        # which its Monte-Carlo matcher raises (trap s)
        lambda: tpg.PoseGraphConfig(loop_matcher_kind="monte_carlo"),
        lambda: tpg.joint_refine(tpg.PoseGraphConfig(), tcells.BayesAvgCell(), None, None, None,
                                 matcher="monte_carlo"),
        lambda: tray.BeamConfig(free_impl="auto"),
        lambda: tray.BeamConfig(free_impl="polar_pallas"),
        # the reference's pipeline keeps the pyramid of the map from before a closure
        lambda: tfull.FullConfig(tracking=tviny.viny_m3rsm_config()),
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
    """The scores the port once refused (the default obstacle reducer, the
    overlap reducer at extent 1.6 and at window 0) now run, and agree with
    the reference's gather path within 2e-6 (tests/test_torch_reducers.py
    holds every reducer)."""
    from slam_constructor_tpu.ops.scan import make_scan as jmake_scan
    from slam_constructor_tpu_torch.ops.scan import make_scan

    rng = np.random.default_rng(4)
    occ = rng.uniform(0.0, 1.0, (8, 8)).astype(np.float32)
    known = rng.uniform(size=(8, 8)) < 0.7
    ranges = rng.uniform(0.05, 0.6, 4).astype(np.float32)
    bearings = np.linspace(-1.5, 1.5, 4, dtype=np.float32)
    poses = np.array([[0.4, 0.4, 0.0], [0.33, 0.47, 0.8], [0.05, 0.7, -2.0]], np.float32)
    view = tscore.MapView(occ=torch.from_numpy(occ), known=torch.from_numpy(known),
                          origin=torch.zeros(2), scale=0.1)
    scan = make_scan(torch.from_numpy(ranges), torch.from_numpy(bearings))
    got = tscore.score_poses(view, scan, torch.from_numpy(poses), cfg)
    jcfg = jscore.ScoringConfig(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(cfg)}, impl="gather")
    want = jscore.score_poses(
        jscore.MapView(occ=jnp.asarray(occ), known=jnp.asarray(known), origin=jnp.zeros(2),
                       scale=0.1),
        jmake_scan(jnp.asarray(ranges), jnp.asarray(bearings)), jnp.asarray(poses), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
