"""Port parity of the config loader: ``utils/config.py`` against the
reference's on every shipped ``.properties`` file.

Each config builds the same engine config on both sides, field by field,
nested configs included. The only fields the reference has beyond the
port's are those that choose a TPU lowering (``TPU_ONLY``); the port has
none beyond the reference's. ``tum_2d.properties`` sets one of them,
``scoring.dtype = bfloat16``: the reference reads it only on its matmul
path, which it takes only on a TPU, so on the CPU its scores with
``float32`` and ``bfloat16`` are equal bit for bit (tested below).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops import scoring as jscoring
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu.utils import config as jconfig
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.utils import config as tconfig
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.properties"))
#: reference fields that choose a TPU lowering, which the port does not have
TPU_ONLY = {"impl", "dtype", "scatter_impl", "chunk", "match_window_impl", "insert_impl"}


def assert_same_config(ref, port, path="cfg"):
    """Every field the two share is equal (nested dataclasses compared the
    same way); the reference's extra fields are TPU-only ones."""
    if dataclasses.is_dataclass(ref):
        assert dataclasses.is_dataclass(port), path
        assert type(ref).__name__ == type(port).__name__, path
        ref_f = {f.name for f in dataclasses.fields(ref)}
        port_f = {f.name for f in dataclasses.fields(port)}
        assert port_f <= ref_f, f"{path}: port-only fields {port_f - ref_f}"
        assert ref_f - port_f <= TPU_ONLY, f"{path}: missing fields {ref_f - port_f - TPU_ONLY}"
        for name in sorted(port_f):
            assert_same_config(getattr(ref, name), getattr(port, name), f"{path}.{name}")
    else:
        assert ref == port, f"{path}: {ref!r} != {port!r}"


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_shipped_config_builds_the_reference_config(path):
    props = jconfig.load_properties(str(path))
    assert tconfig.load_properties(str(path)) == props
    if "pf.particles" in props:
        ref, port = jconfig.gmapping_config_from(props), tconfig.gmapping_config_from(props)
    else:
        ref, port = jconfig.engine_config_from(props), tconfig.engine_config_from(props)
        # the port's engine accepts every shipped engine config
        teng.EngineConfig(**{f.name: getattr(port, f.name) for f in dataclasses.fields(port)})
    assert_same_config(ref, port)


def test_eight_configs_are_shipped():
    assert {p.stem for p in CONFIGS} == {
        "gmapping", "mit_csail", "mit_stata", "tiny", "tiny_refined", "tum_2d", "viny",
        "viny_m3rsm"}


def test_parse_properties_edge_cases():
    text = """
    # comment
    ; another comment
    // and another
      matcher.type =  hill_climbing
    weird.key = a = b
    no_equals_line
    engine.use_angle_histogram = YES
    cell.model=tbm
    cell.quality = 0.25
    refine.type = gradient
    refine.iterations = 3
    scoring.reducer = overlap
    scoring.dtype = bfloat16
    beam.wall_blur = on
    beam.scatter_impl = matmul
    unknown.key = 7
    """
    ref, port = jconfig.parse_properties(text), tconfig.parse_properties(text)
    assert port == ref
    assert port["weird.key"] == "a = b" and port["matcher.type"] == "hill_climbing"
    assert "no_equals_line" not in port
    rc, pc = jconfig.engine_config_from(port), tconfig.engine_config_from(port)
    assert_same_config(rc, pc)
    assert pc.use_angle_histogram and pc.beam.wall_blur
    assert pc.cell_model.quality == 0.25 and pc.refine_cfg.iterations == 3
    assert pc.refine_matcher == "gradient" and pc.matcher == "hill_climbing"
    # no refine.type: no refine stage, whatever refine.* says
    bare = tconfig.engine_config_from({"refine.iterations": "3"})
    assert bare.refine_matcher is None and bare.refine_cfg is None
    for v, want in (("1", True), ("true", True), ("on", True), ("0", False), ("no", False)):
        assert tconfig._coerce(v, False) is want
    assert tconfig._coerce("3", 1) == 3 and tconfig._coerce("3", 1.0) == 3.0


def test_fields_of_this_slice_are_accepted():
    """The tiled storage, an engine's refine stage and any registered
    matcher as the primary one: refused before this slice, ported now."""
    cfgs = [teng.EngineConfig(map_storage="tiled"), teng.EngineConfig(matcher="hill_climbing"),
            teng.EngineConfig(refine_matcher="hill_climbing"),
            teng.EngineConfig(matcher="gradient", refine_matcher="brute_force")]
    assert [c.map_storage for c in cfgs] == ["tiled", "dense", "dense", "dense"]
    with pytest.raises(ValueError):
        teng.EngineConfig(map_storage="cow")
    with pytest.raises(ValueError):
        teng.EngineConfig(refine_matcher="nope")


def test_unknown_matcher_and_preset_raise():
    with pytest.raises(KeyError):
        tconfig.engine_config_from({"matcher.type": "nope"})
    with pytest.raises(NotImplementedError):
        tconfig.preset("distributed")
    with pytest.raises(KeyError):
        tconfig.preset("nope")
    e = tconfig.preset("tiny")(device="cpu", map_size=32)
    assert e.cfg.map_height == 32 and e.device.type == "cpu"
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)


def test_reference_scores_ignore_bfloat16_on_the_cpu():
    occ, origin, scale = (np.asarray(a) if not isinstance(a, float) else a
                          for a in datagen.cecum_world())
    model = jcells.BayesAvgCell()
    gm = jgrid.make_grid_map(model, 160, 160, 0.1)
    bearings = np.asarray(datagen.default_bearings(96))
    pose = jnp.asarray([0.3, -1.55, 0.05], jnp.float32)
    scan = jax.jit(jray.cast_rays, static_argnums=2)(
        jnp.asarray(occ), jnp.asarray(origin), scale, pose, jnp.asarray(bearings))
    gm = jax.jit(jray.insert_scan, static_argnums=(1, 4))(
        gm, model, pose, scan, jray.BeamConfig(free_impl="dda"))
    view = jscoring.MapView.of(gm, model)
    poses = pose + jnp.asarray(np.random.default_rng(0).normal(0, 0.05, (32, 3)), jnp.float32)
    s = JScan(scan.ranges, scan.bearings, scan.valid)
    f32 = jscoring.score_poses(view, s, poses, jscoring.ScoringConfig(reducer="overlap"))
    bf16 = jscoring.score_poses(view, s, poses,
                                jscoring.ScoringConfig(reducer="overlap", dtype="bfloat16"))
    np.testing.assert_array_equal(np.asarray(f32), np.asarray(bf16))
