"""Port parity of the copy-on-write block-pool maps (``ops/cow.py``), K3 over
a block pool (``kernels.pool_touched`` / ``pool_insert``) and the RBPF on
them (``GMappingConfig(map_storage='cow')``).

Small shapes: pools of blocks of 8 or 16 cells, 4 to 6 particles, 96 to
120 beams, one thread. The table operations (``prepare_write``,
``resample``, ``grow_pool``, ``extract_window``) equal the reference's bit
for bit: tables, refcounts, the overflow latch and every live block. The
insert's twin equals ``kernels.pool_insert_ordered`` (the samples summed on
the host in order) bit for bit on every live slot with one thread, and the
reference's pool within 1e-6 (its scatter sums in its own order). The
RBPF's step runs from the reference's state with the reference's draws
(rebuilt from its key chain): poses 2e-6, log-weights 1e-5, tables and
refcounts exact, live blocks 1e-5.

Trap o: past the free slots the reference's ``prepare_write`` hands out
used slots; the port keeps those entries' tables and drops their writes.
The overflow test pins that difference and nothing else.
"""

import dataclasses
import functools
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_constructor_tpu.models import gmapping as jgm
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import cow as jcow
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.models import gmapping as tgm
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import cow as tcow
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops.scan import LaserScan
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen

torch.set_num_threads(1)

MODELS = {"bayes_avg": (jcells.BayesAvgCell(), tcells.BayesAvgCell()),
          "bayes_base": (jcells.BayesBaseCell(), tcells.BayesBaseCell()),
          "tbm": (jcells.TBMCell(), tcells.TBMCell())}
P, B, TILES, SCALE = 4, 8, 16, 0.1  # 128^2 cells at 0.1 m hold the cecum world
BEAM = dict(wall_blur=True, max_range=6.0)


def jtree(st):
    return {"pool": np.asarray(st.pool), "tables": np.asarray(st.tables),
            "refcnt": np.asarray(st.refcnt), "origin": np.asarray(st.origin),
            "scale": st.scale, "block": st.block, "overflow": bool(st.overflow)}


def to_jax(tree):
    return jcow.CowBlockMaps(
        pool=jnp.asarray(tree["pool"]), tables=jnp.asarray(tree["tables"]),
        refcnt=jnp.asarray(tree["refcnt"]), origin=jnp.asarray(tree["origin"]),
        scale=tree["scale"], block=tree["block"], overflow=jnp.asarray(tree["overflow"]))


def assert_same(ref, port, atol=0.0):
    """Tables, refcounts and overflow exact; the live blocks within atol."""
    r, t = jtree(ref), convert.cow_to_numpy(port)
    np.testing.assert_array_equal(t["tables"], r["tables"])
    np.testing.assert_array_equal(t["refcnt"], r["refcnt"])
    assert t["overflow"] == r["overflow"]
    live = r["refcnt"] > 0
    if atol:
        np.testing.assert_allclose(t["pool"][live], r["pool"][live], atol=atol, rtol=0)
    else:
        np.testing.assert_array_equal(t["pool"][live], r["pool"][live])


def random_state(model, rng, capacity=96):
    """A pool of random blocks, every particle's tables a mix of unmapped,
    own and shared tiles among the first 24 slots (refcounts recounted)."""
    st = jcow.make_cow_maps(model, P, 4, 4, capacity=capacity, block=B, scale=SCALE)
    tree = jtree(st)
    tree["pool"] = rng.random(tree["pool"].shape).astype(np.float32)
    tables = rng.integers(-1, 24, size=tree["tables"].shape).astype(np.int32)
    tables[rng.random(tables.shape) < 0.3] = -1
    tree["tables"] = tables
    tree["refcnt"] = np.bincount(tables[tables >= 0], minlength=capacity).astype(np.int32)
    return tree


@pytest.mark.parametrize("model", sorted(MODELS))
def test_make_cow_maps(model):
    jm, tm = MODELS[model]
    ref = jcow.make_cow_maps(jm, P, 3, 5, capacity=7, block=B, scale=SCALE)
    port = tcow.make_cow_maps(tm, P, 3, 5, capacity=7, block=B, scale=SCALE, device="cpu")
    assert_same(ref, port)
    np.testing.assert_array_equal(port.pool.numpy(), np.asarray(ref.pool))
    np.testing.assert_array_equal(port.origin.numpy(), np.asarray(ref.origin))
    assert (port.n_particles, port.capacity) == (ref.n_particles, ref.capacity)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepare_write_resample_distinct(seed):
    """Random states, touched masks and ancestors: prepare_write (block
    copies and resets included), resample and distinct_blocks bit for bit,
    four rounds chained."""
    jm, tm = MODELS["tbm"]
    rng = np.random.default_rng(seed)
    tree = random_state(jm, rng)
    ref, port = to_jax(tree), convert.cow_from_numpy(tree, device="cpu")
    for _ in range(4):
        touched = rng.random((P, 4, 4)) < 0.25
        ref = jcow.prepare_write(ref, jm, jnp.asarray(touched))
        port = tcow.prepare_write(port, tm, torch.from_numpy(touched))
        assert not bool(port.overflow)
        assert_same(ref, port)
        idx = rng.integers(0, P, size=P)
        ref = jcow.resample(ref, jnp.asarray(idx, jnp.int32))
        port = tcow.resample(port, torch.from_numpy(idx))
        assert_same(ref, port)
        assert int(tcow.distinct_blocks(port)) == int(jcow.distinct_blocks(ref))


def test_prepare_write_small_budget_latches_like_the_reference():
    """A budget below the demand: the first k_max needed pairs are served
    in the reference's order, the rest wait, and the latch is set."""
    jm, tm = MODELS["bayes_avg"]
    tree = random_state(jm, np.random.default_rng(5))
    touched = np.ones((P, 4, 4), bool)
    ref = jcow.prepare_write(to_jax(tree), jm, jnp.asarray(touched), max_writes=5)
    port = tcow.prepare_write(convert.cow_from_numpy(tree, device="cpu"), tm,
                              torch.from_numpy(touched), max_writes=5)
    assert bool(port.overflow)
    assert_same(ref, port)


def test_overflow_keeps_tables_where_the_reference_takes_used_slots():
    """Trap o: more new blocks than free slots. Entries served by a free
    slot equal the reference's; the reference gives the rest used slots,
    the port leaves their tables as they were; both latch."""
    jm, tm = MODELS["bayes_avg"]
    tree = random_state(jm, np.random.default_rng(3), capacity=40)
    touched = np.ones((P, 4, 4), bool)
    ref = jcow.prepare_write(to_jax(tree), jm, jnp.asarray(touched))
    port = tcow.prepare_write(convert.cow_from_numpy(tree, device="cpu"), tm,
                              torch.from_numpy(touched))
    assert bool(ref.overflow) and bool(port.overflow)
    old, rt, pt = tree["tables"], np.asarray(ref.tables), port.tables.numpy()
    was_free = tree["refcnt"] == 0
    moved = rt != old
    misdirected = moved & ~was_free[np.clip(rt, 0, None)]
    assert misdirected.any()
    np.testing.assert_array_equal(pt[~misdirected], rt[~misdirected])
    np.testing.assert_array_equal(pt[misdirected], old[misdirected])
    # every write the port can make is made, into a slot of its own
    free_taken = pt[moved & ~misdirected]
    assert len(np.unique(free_taken)) == len(free_taken)
    assert (port.refcnt.numpy()[free_taken] == 1).all()


def test_cow_sharing_after_convergence():
    """tests/test_cow.py:118 on the port: after resampling to one ancestor
    the blocks are shared, not copied."""
    jm, tm = MODELS["bayes_avg"]
    for side in ("ref", "port"):
        mod, model = (jcow, jm) if side == "ref" else (tcow, tm)
        kw = {} if side == "ref" else {"device": "cpu"}
        st = mod.make_cow_maps(model, 4, 4, 4, capacity=64, block=8, **kw)
        t = np.zeros((4, 4, 4), bool)
        t[:, 1, 1] = t[:, 2, 2] = True
        t = jnp.asarray(t) if side == "ref" else torch.from_numpy(t)
        st = mod.prepare_write(st, model, t)
        assert int(mod.distinct_blocks(st)) == 8
        zeros = jnp.zeros(4, jnp.int32) if side == "ref" else torch.zeros(4, dtype=torch.int64)
        st = mod.resample(st, zeros)
        assert int(mod.distinct_blocks(st)) == 2


def test_grow_pool_and_extract_window():
    jm, tm = MODELS["tbm"]
    tree = random_state(jm, np.random.default_rng(7))
    tree["overflow"] = True
    ref = jcow.grow_pool(to_jax(tree), jm, 128)
    port = tcow.grow_pool(convert.cow_from_numpy(tree, device="cpu"), tm, 128)
    assert_same(ref, port)
    np.testing.assert_array_equal(port.pool.numpy(), np.asarray(ref.pool))
    centers = np.array([[0.3, -1.2], [-3.1, 3.1], [50.0, -50.0], [1.7, 0.2]], np.float32)
    for th, tw in ((2, 2), (3, 5)):
        both = tcow.extract_window(port, tm, None, torch.from_numpy(centers), th, tw)
        window = jax.jit(lambda st, c: jax.vmap(lambda p, cp: jcow.extract_window(
            st, jm, p, cp, th, tw))(jnp.arange(P), c))
        wants = window(ref, jnp.asarray(centers))
        for p in range(P):
            want = jax.tree.map(lambda a: a[p], wants)
            one = tcow.extract_window(port, tm, p, torch.from_numpy(centers[p]), th, tw)
            for got in (one.cells, both.cells[p]):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want.cells))
            np.testing.assert_array_equal(both.origin[p].numpy(), np.asarray(want.origin))


@pytest.fixture(scope="module")
def scans():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.35)[:P] + torch.tensor([0.013, 0.021, 0.0])
    sc, _, gt = datagen.synth_sequence(occ, origin, scale, poses, datagen.default_bearings(96),
                                       rng=11)
    return sc, gt


def jscan(sc, i):
    return JScan(jnp.asarray(sc.ranges[i].numpy()), jnp.asarray(sc.bearings[i].numpy()),
                 jnp.asarray(sc.valid[i].numpy()))


def reference_touched(st, poses, sc, beam):
    """The reference's touched mask (its gmapping CoW branch)."""
    rows, cols, w, s = jax.vmap(lambda pose, r, b, v: jray.scan_sample_cells(
        st.origin, st.scale, pose, JScan(r, b, v), beam))(
        jnp.asarray(poses), jnp.asarray(sc.ranges.numpy()), jnp.asarray(sc.bearings.numpy()),
        jnp.asarray(sc.valid.numpy()))
    p = poses.shape[0]
    th, tw = st.tables.shape[1:]
    b = st.block
    pid = jnp.broadcast_to(jnp.arange(p)[:, None], rows.shape)
    ok = (w > 0) & (rows >= 0) & (rows < th * b) & (cols >= 0) & (cols < tw * b)
    touched = jnp.zeros((p, th, tw), bool).at[
        pid, jnp.clip(rows // b, 0, th - 1), jnp.clip(cols // b, 0, tw - 1)].max(ok, mode="drop")
    return touched, (pid, rows, cols, w, s)


@pytest.mark.parametrize("model,estimator", [("bayes_avg", "const"), ("tbm", "const"),
                                             ("bayes_base", "area")])
def test_scatter_observations_matches_reference(scans, model, estimator):
    """One scan a particle into the shared pool after prepare_write: the
    touched tiles exactly, the twin and the ordered host sums bit for bit
    on every live slot, the reference's pool within 1e-6."""
    sc, gt = scans
    jm, tm = MODELS[model]
    beam = dict(BEAM, occupancy_estimator=estimator)
    jbeam, tbeam = jray.BeamConfig(free_impl="dda", **beam), tray.BeamConfig(**beam)
    ref = jcow.make_cow_maps(jm, P, TILES, TILES, capacity=400, block=B, scale=SCALE)
    port = tcow.make_cow_maps(tm, P, TILES, TILES, capacity=400, block=B, scale=SCALE,
                              device="cpu")
    prepare = jax.jit(jcow.prepare_write, static_argnums=1)
    scatter = jax.jit(jcow.scatter_observations, static_argnums=1)
    # two rounds: the second writes over shared blocks (a resample between)
    for rnd in range(2):
        poses = gt.numpy() + np.float32(0.05 * rnd)
        touched, samples = reference_touched(ref, poses, sc, jbeam)
        got = tcow.touched_tiles(port, torch.from_numpy(poses), sc, tbeam)
        np.testing.assert_array_equal(got.numpy(), np.asarray(touched))
        ref = prepare(ref, jm, touched)
        port = tcow.prepare_write(port, tm, got)
        assert not bool(port.overflow)
        ordered = dataclasses.replace(port, pool=port.pool.clone())
        kernels.pool_insert_ordered(ordered.pool, port.tables, port.origin, port.scale, tm,
                                    torch.from_numpy(poses), sc, tbeam, got, refcnt=port.refcnt)
        ref = scatter(ref, jm, *(a.ravel() for a in samples))
        port = tcow.scatter_observations(port, tm, torch.from_numpy(poses), sc, tbeam, got)
        live = port.refcnt.numpy() > 0
        np.testing.assert_array_equal(port.pool.numpy()[live], ordered.pool.numpy()[live])
        # the area estimator's overlaps are computed in another order (2.4e-6)
        assert_same(ref, port, atol=1e-6 if estimator == "const" else 1e-5)
        ref = jcow.resample(ref, jnp.asarray([0, 0, 1, 2], jnp.int32))
        port = tcow.resample(port, torch.tensor([0, 0, 1, 2]))


def test_pool_insert_edge_cases(scans):
    """The twin against the ordered sums on the pool's edge cases: a beam
    along a tile boundary, samples past the table's edge, an exhausted
    pool (a touched tile without a block), a scan without a valid beam, a
    shared untouched block inside two particles' regions, q = 0."""
    sc, gt = scans
    jm, tm = MODELS["bayes_avg"]
    beam = tray.BeamConfig(**BEAM)
    st = tcow.make_cow_maps(tm, P, 6, 6, capacity=120, block=B, scale=SCALE, device="cpu")
    poses = gt.clone()
    poses[0, :2] = st.origin + 2 * B * SCALE  # on the corner of 4 tiles: beams along boundaries
    poses[0, 2] = 0.0
    poses[1, :2] = st.origin + 0.3  # near the table's corner: most samples fall off it
    valid = sc.valid.clone()
    valid[2] = False  # no valid beam
    scans_ = LaserScan(sc.ranges, sc.bearings, valid)
    touched = tcow.touched_tiles(st, poses, scans_, beam)
    assert not touched[2].any()
    st = tcow.prepare_write(st, tm, touched)
    assert not bool(st.overflow)
    tables = st.tables.clone()
    # a touched tile the exhausted pool could not give a block
    tr, tc = (int(v) for v in torch.nonzero(touched[3])[0])
    tables[3, tr, tc] = -1
    # a block shared by particles 2 and 3 that neither touches
    free = int(torch.nonzero(st.refcnt == 0)[0])
    tables[2, 5, 5] = tables[3, 5, 5] = free
    refcnt = tcow._counts(tables.reshape(-1), st.capacity)
    assert int(refcnt[free]) == 2 and not touched[2:, 5, 5].any()
    st = dataclasses.replace(st, tables=tables, refcnt=refcnt)
    st.pool[free] = torch.rand(st.pool.shape[1:], generator=torch.Generator().manual_seed(0))
    for q in (None, torch.tensor(1.0), torch.tensor(0.0)):
        a, b = st.pool.clone(), st.pool.clone()
        kernels.pool_insert(a, st.tables, st.origin, st.scale, tm, poses, scans_, beam, touched,
                            q, refcnt=st.refcnt)
        kernels.pool_insert_ordered(b, st.tables, st.origin, st.scale, tm, poses, scans_, beam,
                                    touched, q, refcnt=st.refcnt)
        live = st.refcnt.numpy() > 0
        np.testing.assert_array_equal(a.numpy()[live], b.numpy()[live])
        if q is not None and float(q) == 0.0:
            # no observation: the fold leaves every live block where it was
            # up to BayesAvg's (p n + 0) / n
            np.testing.assert_allclose(a.numpy()[live], st.pool.numpy()[live], rtol=2e-7, atol=0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fold_without_observation_keeps_the_init_cell(model):
    """Every cell model leaves the init cell bit for bit when it folds no
    observation (so the tiled map folds only its allocated slots), on both
    sides; a cell with weight may move (BayesAvg's (p n + 0) / n)."""
    jm, tm = MODELS[model]
    init = np.asarray(jcells.init_cell(jm))
    pool = np.broadcast_to(init, (3, 4, 4, init.shape[0])).copy()
    zeros = np.zeros((3, 4, 4), np.float32)
    got = tm.update(torch.from_numpy(pool[..., :-1]), torch.from_numpy(pool[..., -1]),
                    torch.from_numpy(zeros), torch.from_numpy(zeros))
    want = jm.update(jnp.asarray(pool[..., :-1]), jnp.asarray(pool[..., -1]),
                     jnp.asarray(zeros), jnp.asarray(zeros))
    np.testing.assert_array_equal(got.numpy(), pool[..., :-1])
    np.testing.assert_array_equal(np.asarray(want), pool[..., :-1])
    np.testing.assert_array_equal(tcells.init_cell(tm).numpy(), init)


# --- the RBPF on the copy-on-write maps ---------------------------------------

GP, GMAP, GSCALE, GBEAMS, GSTEPS = 6, 96, 0.2, 120, 3
FAST = dict(n_particles=GP, map_size=GMAP, map_scale=GSCALE, usable_range=2.5)
COW = dict(map_storage="cow", tile_block=16, window_tiles=4, tile_capacity=256)


def configs(proposal):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jgm.fast_config(proposal=proposal, **FAST)
        t = tgm.fast_config(proposal=proposal, **FAST)
    extra = dict(COW, min_match_prob=0.7) if proposal == "improved" else COW
    return dataclasses.replace(j, **extra), dataclasses.replace(t, **extra)


def reference_draws(key, cfg):
    """The reference step's random numbers from its key (``split(key, 4)``:
    proposal, match, resampling; a match key a particle, split again by the
    improved proposal), as the port's Draws (made in one jitted call)."""
    return _draws_fn(cfg)(key)


@functools.cache
def _draws_fn(cfg):
    return jax.jit(partial(_reference_draws, cfg=cfg))


def _reference_draws(key, cfg):
    key, k_noise, k_match, k_res = jax.random.split(key, 4)
    mc = cfg.matcher_cfg
    keys = jax.random.split(k_match, cfg.n_particles)
    improved = cfg.proposal == "improved"
    if improved:
        pairs = jax.vmap(jax.random.split)(keys)
        keys, kjs = pairs[:, 0], jax.vmap(jax.random.split)(pairs[:, 1])
    match = jax.vmap(lambda k: jax.vmap(lambda kr: jax.random.normal(kr, (mc.batch, 3)))(
        jax.random.split(k, mc.rounds)))(keys)

    return dict(
        proposal=jax.random.normal(k_noise, (cfg.n_particles, 3)),
        u0=jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / cfg.n_particles),
        match=match,
        probe=jax.vmap(lambda k: jax.random.normal(k, (cfg.proposal_samples, 3)))(kjs[:, 0])
        if improved else None,
        sample=jax.vmap(lambda k: jax.random.normal(k, (3,)))(kjs[:, 1]) if improved else None,
    )


@pytest.fixture(scope="module")
def gseq():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.12)[:GSTEPS]
    return datagen.synth_sequence(occ, origin, scale, poses, datagen.default_bearings(GBEAMS),
                                  rng=3, odom_noise_xy=0.02, odom_noise_theta=0.01)


def state_tree(st):
    return {**jtree(st.gm), "poses": np.asarray(st.poses),
            "log_weights": np.asarray(st.log_weights), "step": int(st.step)}


@pytest.mark.parametrize("proposal", ["odom", "improved"])
def test_gmapping_cow_step_matches_reference(gseq, proposal):
    """Each step from the reference's state, crossed by ``convert``, with
    the reference's draws: poses, log-weights, ancestors, tables and
    refcounts, and the live blocks."""
    scans, odom, gt = gseq
    jcfg, tcfg = configs(proposal)
    step = jax.jit(partial(jgm.gmapping_step, jcfg))
    st = jgm.init_state(jcfg, jax.random.PRNGKey(0))
    st = st.replace(poses=jnp.broadcast_to(jnp.asarray(gt[0].numpy()), (GP, 3)))
    for i in range(GSTEPS):
        draws = tgm.Draws(**{k: None if v is None else torch.from_numpy(np.array(v, np.float32))
                             for k, v in reference_draws(st.key, jcfg).items()})
        port = convert.gmapping_state_from_numpy(state_tree(st), device="cpu")
        port, anc = tgm.gmapping_step(tcfg, port, scans[i], odom[i], draws)
        st, janc = step(st, jscan(scans, i), jnp.asarray(odom[i].numpy()))
        np.testing.assert_array_equal(anc.numpy(), np.asarray(janc))
        d = port.poses.numpy().astype(np.float64) - np.asarray(st.poses)
        d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
        assert np.abs(d).max() <= 2e-6, (i, np.abs(d).max())
        np.testing.assert_allclose(port.log_weights.numpy(), np.asarray(st.log_weights),
                                   atol=1e-5, rtol=0)
        assert_same(st.gm, port.gm, atol=1e-5)
    assert int(tcow.distinct_blocks(port.gm)) > 0


def test_cow_engine_grows_its_pool_and_crosses_back(gseq):
    """handle_scan polls the overflow latch every few scans and doubles the
    pool, the live blocks kept; the state crosses to numpy and back."""
    scans, odom, gt = gseq
    _, tcfg = configs("odom")
    tcfg = dataclasses.replace(tcfg, tile_capacity=24)
    e = tgm.GMappingEngine(tcfg, device="cpu", seed=1)
    e.overflow_check_every = 2
    e.state.poses = gt[0].expand(GP, 3).clone()
    before = None
    for i in range(GSTEPS):
        if i == 1:
            before = e.state.gm
            assert bool(before.overflow)
        e.handle_scan(scans[i], odom[i])
        if i == 1:
            grown = e.state.gm
            assert grown.capacity == 48 and not bool(grown.overflow)
    assert e.occupancy.shape == (GMAP, GMAP)
    back = convert.gmapping_state_from_numpy(convert.gmapping_state_to_numpy(e.state), device="cpu")
    for name in ("pool", "tables", "refcnt"):
        assert torch.equal(getattr(back.gm, name), getattr(e.state.gm, name))
    assert bool(torch.isfinite(e.state.log_weights).all())
