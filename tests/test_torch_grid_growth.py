"""Port parity of the unbounded dense map and the small leftovers:
``grid.grow_to_contain``, ``grid.rescale``, ``grid.cell_center``,
``grid.clip_index``, ``evaluate.map_quality``, ``datagen.loop_trajectory``,
``scan.OdomScan`` and ``Engine.auto_grow``, against the reference on the
CPU.

Growth copies cells and builds its origin in float64 from the integer
offsets, as the reference does: cells and origin equal bit for bit.
Coarsening sums ``k x k`` blocks over two axes; the port sums them in
PyTorch's order, the reference in XLA's: weights and beliefs within 2e-6
relative. Refining is exact. The auto-growing engine runs 8 scans of tiny
from a 48^2 map with the reference's matcher noise injected: the same
growth events (shape and origin bit for bit) and poses within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import engine as jeng
from slam_constructor_tpu.models import tiny as jtiny
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import grid as jgrid
from slam_constructor_tpu.ops import scan as jscanlib
from slam_constructor_tpu.utils import datagen as jdata
from slam_constructor_tpu.utils import evaluate as jeval
from slam_constructor_tpu_torch.models import engine as teng
from slam_constructor_tpu_torch.models import tiny as ttiny
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import grid as tgrid
from slam_constructor_tpu_torch.ops import scan as tscanlib
from slam_constructor_tpu_torch.utils import datagen
from slam_constructor_tpu_torch.utils import evaluate

torch.set_num_threads(1)

MODELS = {"bayes_avg": (jcells.BayesAvgCell(), tcells.BayesAvgCell()),
          "tbm": (jcells.TBMCell(), tcells.TBMCell())}


def random_map(model_pair, h, w, seed, origin=(-1.37, 2.11), scale=0.1):
    """The same random map on both sides: beliefs in [0, 1), weights with
    zeros (cells never seen)."""
    jm, _ = model_pair
    rng = np.random.default_rng(seed)
    c = jm.n_channels + 1
    cells = rng.random((h, w, c)).astype(np.float32)
    cells[..., -1] = np.where(rng.random((h, w)) < 0.3, 0.0, 3.0 * cells[..., -1])
    ref = jgrid.GridMap(cells=jnp.asarray(cells), origin=jnp.asarray(origin, jnp.float32),
                        scale=scale)
    port = tgrid.GridMap(cells=torch.from_numpy(cells),
                         origin=torch.tensor(origin, dtype=torch.float32), scale=scale)
    return ref, port


def test_cell_center_and_clip_index():
    ref, port = random_map(MODELS["bayes_avg"], 7, 9, 0)
    idx = np.array([[0, 0], [3, 8], [-2, 4], [6, 11], [-5, -5]], np.int32)
    np.testing.assert_array_equal(
        tgrid.cell_center(port, torch.from_numpy(idx)).numpy(),
        np.asarray(jgrid.cell_center(ref, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tgrid.clip_index(port, torch.from_numpy(idx)).numpy(),
        np.asarray(jgrid.clip_index(ref, jnp.asarray(idx))))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("pts", [
    [[0.5, 3.0], [-4.9, 2.2]],  # off the low columns
    [[1.0, 9.7], [12.3, -6.1]],  # off three sides
    [[0.0, 2.5]],  # inside: the map itself
])
def test_grow_to_contain(model, pts):
    ref, port = random_map(MODELS[model], 24, 30, 1)
    pts = np.asarray(pts, np.float32)
    want = jgrid.grow_to_contain(ref, MODELS[model][0], pts, margin_cells=5)
    got = tgrid.grow_to_contain(port, MODELS[model][1], torch.from_numpy(pts), margin_cells=5)
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert got.scale == want.scale
    assert bool(tgrid.contains(got, torch.from_numpy(pts)))
    if len(pts) == 1:
        assert got is port


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("factor", [2, 3, -2, -3])
def test_rescale(model, factor):
    jm, tm = MODELS[model]
    ref, port = random_map(MODELS[model], 12, 18, 2)
    want = jgrid.rescale(ref, jm, factor)
    got = tgrid.rescale(port, tm, factor)
    assert got.scale == want.scale and got.cells.shape == want.cells.shape
    if factor < 0:
        np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))
    else:
        np.testing.assert_allclose(got.cells.numpy(), np.asarray(want.cells), rtol=2e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    with pytest.raises(ValueError):
        tgrid.rescale(port, tm, 0)
    with pytest.raises(ValueError):
        tgrid.rescale(port, tm, 5)


def test_map_quality_loop_trajectory_odom_scan():
    rng = np.random.default_rng(4)
    est = rng.random((40, 50)).astype(np.float32)
    gt = (rng.random((40, 50)) < 0.2).astype(np.float32)
    want = jeval.map_quality(jnp.asarray(est), jnp.asarray(gt))
    got = evaluate.map_quality(torch.from_numpy(est), torch.from_numpy(gt))
    assert got == want
    for n, radius in ((120, 3.0), (37, 1.3)):
        got = datagen.loop_trajectory(n, radius, (0.5, -0.25)).numpy()
        want = np.asarray(jdata.loop_trajectory(n, radius, (0.5, -0.25)))
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        # the heading is an f32 atan2(sin, cos): XLA's and PyTorch's part by 2 ulps
        np.testing.assert_allclose(got[:, 2], want[:, 2], atol=5e-7, rtol=0)
    scan = tscanlib.make_scan([1.0, 2.0, np.inf], [0.0, 0.5, 1.0])
    o = tscanlib.OdomScan(scan, torch.tensor([0.1, 0.0, 0.02]), torch.tensor(0.8))
    names = [f.name for f in dataclasses.fields(o)]
    assert names == [f.name for f in dataclasses.fields(jscanlib.OdomScan)]
    assert o.to("cpu").scan.valid.tolist() == [True, True, False]


def test_auto_grow_engine_matches_reference():
    """8 scans through both engines' handle_scan with auto_grow from a 48^2
    map at 0.1 m (the cecum world is 14.4 m wide): the same growth, poses
    within 1e-4, cells within 1e-5."""
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.corridor_trajectory(60)[:8] + torch.tensor([0.013, 0.021, 0.0])
    scans, odom, gt = datagen.synth_sequence(occ, origin, scale, poses,
                                             datagen.default_bearings(96), rng=5)
    kw = dict(map_size=48, map_scale=0.1, mc_batch=8, mc_rounds=3)
    jcfg, tcfg = jtiny.tiny_config(**kw), ttiny.tiny_config(**kw)
    jcfg = dataclasses.replace(jcfg, beam=dataclasses.replace(jcfg.beam, free_impl="dda"))
    assert tcfg.beam.free_impl == "dda"
    je = jeng.Engine(jcfg)
    je.auto_grow = True
    je.state = je.state.replace(pose=jnp.asarray(gt[0].numpy()))
    te = teng.Engine(tcfg, device="cpu")
    te.auto_grow = True
    te.state.pose = gt[0].clone()
    key, shapes = jax.random.PRNGKey(0), {tuple(te.state.gm.cells.shape)}
    mc = jcfg.matcher_cfg
    for i in range(8):
        key, sub = jax.random.split(key)
        noise = np.stack([np.asarray(jax.random.normal(k, (mc.batch, 3)))
                          for k in jax.random.split(sub, mc.rounds)])
        js = jscanlib.LaserScan(jnp.asarray(scans.ranges[i].numpy()),
                                jnp.asarray(scans.bearings[i].numpy()),
                                jnp.asarray(scans.valid[i].numpy()))
        je.handle_scan(js, jnp.asarray(odom[i].numpy()))
        te.handle_scan(scans[i], odom[i], noise=torch.from_numpy(noise))
        assert tuple(te.state.gm.cells.shape) == je.state.gm.cells.shape
        np.testing.assert_array_equal(te.state.gm.origin.numpy(), np.asarray(je.state.gm.origin))
        np.testing.assert_allclose(te.state.pose.numpy(), np.asarray(je.state.pose), atol=1e-4,
                                   rtol=0)
        shapes.add(tuple(te.state.gm.cells.shape))
    assert len(shapes) > 1  # the map grew
    np.testing.assert_allclose(te.state.gm.cells.numpy(), np.asarray(je.state.gm.cells),
                               atol=1e-5, rtol=0)
