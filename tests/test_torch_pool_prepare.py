"""The block pool's prepare step (``kernels.pool_prepare``) on the CPU.

On the card one launch marks the tiles each scan touches by where its beams
cross tile boundaries, then makes every touched tile own its block (the
copy-on-write compaction with its block copies, or the tiled map's
allocation) in place, and writes each slot's owner and the pool insert's
work list. Its plain versions are held here, at small shapes (pools of
blocks of 8 or 16 cells, 4 particles, 96 beams, one thread):

- ``kernels.pool_touched_crossings`` (the kernel's crossing walk, beam by
  beam in float32 on the host) equals ``kernels.pool_touched_ref`` (every
  sample counted by tile) exactly, on beams along tile boundaries, ends in
  the table, the free limit on a sample, q = 0, NaN poses, a particle at
  the table's corner and random scans; both equal the JAX reference's
  touched mask but for NaN poses (the reference casts a NaN cell to int 0
  and marks column 0; the port drops the sample, as its dense insert does);
- ``cow.prepare_insert`` on the CPU (``cow.prepare_insert_ref``, the twin
  the card is held to) gives the tables, refcounts, pool and overflow
  latch of ``cow.prepare_write`` and of the reference's ``prepare_write``
  bit for bit (a small budget, trap o, the first step), and
  ``blockmap.prepare_tiles`` the tiled map's table and ``n_alloc`` of
  ``blockmap.allocate_tiles`` and the reference's (an exhausted pool too);
  ``kernels.pool_prepare`` itself takes CUDA tensors only;
- the work list's owners equal ``kernels.pool_owners``, and its items name
  every live slot once, in the kernel's order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slam_constructor_tpu.ops import blockmap as jbm
from slam_constructor_tpu.ops import cells as jcells
from slam_constructor_tpu.ops import cow as jcow
from slam_constructor_tpu.ops import raycast as jray
from slam_constructor_tpu.ops.scan import LaserScan as JScan
from slam_constructor_tpu_torch.ops import blockmap as tbm
from slam_constructor_tpu_torch.ops import cells as tcells
from slam_constructor_tpu_torch.ops import cow as tcow
from slam_constructor_tpu_torch.ops import kernels
from slam_constructor_tpu_torch.ops import raycast as tray
from slam_constructor_tpu_torch.ops.scan import LaserScan
from slam_constructor_tpu_torch.utils import convert
from slam_constructor_tpu_torch.utils import datagen

import jax

torch.set_num_threads(1)

P, B, TILES, SCALE, BEAMS = 4, 8, 16, 0.1, 96
BEAM = dict(wall_blur=True, max_range=6.0)
JM, TM = jcells.BayesAvgCell(), tcells.BayesAvgCell()


@pytest.fixture(scope="module")
def scans():
    occ, origin, scale = datagen.cecum_world()
    poses = datagen.rectangle_trajectory(step=0.35)[:P] + torch.tensor([0.013, 0.021, 0.0])
    sc, _, gt = datagen.synth_sequence(occ, origin, scale, poses,
                                       datagen.default_bearings(BEAMS), rng=11)
    return sc, gt


def reference_touched(origin, poses, sc, beam, tiles, block, q=None):
    """The reference's touched mask: its samples (``scan_sample_cells``,
    vmapped over the scans) counted by tile where ``q w > 0``."""
    rows, cols, w, _ = jax.vmap(lambda pose, r, b, v: jray.scan_sample_cells(
        jnp.asarray(origin.numpy()), SCALE, pose, JScan(r, b, v), beam))(
        jnp.asarray(poses.numpy()), jnp.asarray(sc.ranges.numpy()),
        jnp.asarray(sc.bearings.numpy()), jnp.asarray(sc.valid.numpy()))
    rows, cols, w = np.asarray(rows), np.asarray(cols), np.asarray(w)
    if q is not None:
        w = np.float32(q) * w
    th, tw = tiles
    out = np.zeros((poses.shape[0], th, tw), bool)
    ok = (w > 0) & (rows >= 0) & (rows < th * block) & (cols >= 0) & (cols < tw * block)
    p, k = np.nonzero(ok)
    out[p, rows[p, k] // block, cols[p, k] // block] = True
    return out


def mark_case(sc, gt, origin, case):
    """(poses, scans, beam config kwargs, q) of one marking case."""
    poses, ranges, valid = gt.clone(), sc.ranges.clone(), sc.valid.clone()
    bearings = sc.bearings.clone()
    beam, q = dict(BEAM), None
    rng = np.random.default_rng(7)
    if case == "tile corner":  # beams at 0, 90, 180, 270 degrees along tile boundaries
        poses[:, :2] = origin + torch.tensor([[2, 3], [5, 5], [8, 1], [4, 9]]) * (B * SCALE)
        poses[:, 2] = torch.tensor([0.0, np.pi / 2, -np.pi / 2, np.pi], dtype=torch.float32)
    elif case == "table corner":
        poses[0, :2] = origin + 0.03
        poses[1, :2] = origin + torch.tensor([TILES * B * SCALE - 0.05, 0.04])
        poses[2, :2] = origin - 0.3  # off the table, beams entering it
    elif case == "free limit on a sample":
        step = np.float32(SCALE * 0.5)
        k = torch.from_numpy(rng.integers(1, 60, size=ranges.shape))
        ranges = ((k.to(torch.float32) + 0.5) * float(step)) + np.float32(0.15)
    elif case == "area":
        beam["occupancy_estimator"] = "area"
    elif case in ("q=0", "q=0.5"):
        q = torch.tensor(float(case[2:]))
    elif case == "nan pose":
        poses[1, 0] = float("nan")
        poses[3, 2] = float("nan")
    elif case == "random":
        poses[:, :2] = torch.from_numpy(rng.uniform(-7.0, 7.0, (P, 2)).astype(np.float32))
        poses[:, 2] = torch.from_numpy(rng.uniform(-np.pi, np.pi, P).astype(np.float32))
        ranges = torch.from_numpy(rng.uniform(0.0, 9.0, ranges.shape).astype(np.float32))
        valid = torch.from_numpy(rng.random(valid.shape) < 0.9)
        bearings = torch.from_numpy(np.sort(rng.uniform(-np.pi, np.pi, bearings.shape), -1)
                                    .astype(np.float32))
    return poses, LaserScan(ranges, bearings, valid), beam, q


MARK_CASES = ("bench", "tile corner", "table corner", "free limit on a sample", "area", "q=0",
              "q=0.5", "nan pose", "random")


@pytest.mark.parametrize("case", MARK_CASES)
def test_crossing_marks_equal_the_samples_marks(scans, case):
    """The crossing walk's marks, every sample's marks and the reference's
    mask: equal, on 16 x 16 tiles of 8 cells."""
    sc, gt = scans
    st = tcow.make_cow_maps(TM, P, TILES, TILES, capacity=8, block=B, scale=SCALE, device="cpu")
    poses, sc, beam, q = mark_case(sc, gt, st.origin, case)
    cfg = tray.BeamConfig(**beam)
    got = kernels.pool_touched_crossings((TILES, TILES), B, st.origin, SCALE, poses, sc, cfg, q)
    want = kernels.pool_touched_ref((TILES, TILES), B, st.origin, SCALE, poses, sc, cfg, q)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if case != "nan pose":  # the reference casts a NaN cell to int 0; the port drops it
        ref = reference_touched(st.origin, poses, sc, jray.BeamConfig(free_impl="dda", **beam),
                                (TILES, TILES), B, None if q is None else float(q))
        np.testing.assert_array_equal(want.numpy(), ref)
    if case == "q=0":
        assert not got.any()
    elif case != "nan pose":
        assert got.sum() >= P
    else:
        assert not got[1].any() and not got[3].any() and got[0].any()


@pytest.mark.parametrize("tiles,block", [((3, 5), 16), ((7, 4), 8), ((1, 1), 64)])
def test_crossing_marks_on_other_tables(scans, tiles, block):
    """Tables of other shapes and blocks: the walk's marks equal every
    sample's."""
    sc, gt = scans
    cfg = tray.BeamConfig(**BEAM)
    origin = torch.tensor([-5.2, -3.1])
    got = kernels.pool_touched_crossings(tiles, block, origin, SCALE, gt, sc, cfg)
    want = kernels.pool_touched_ref(tiles, block, origin, SCALE, gt, sc, cfg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.any()


def random_tree(rng, capacity, tiles=TILES):
    """A reference CoW state: random blocks, every particle's tables a mix
    of unmapped, own and shared tiles among the first 60 slots."""
    st = jcow.make_cow_maps(JM, P, tiles, tiles, capacity=capacity, block=B, scale=SCALE)
    tables = rng.integers(-1, 60, size=(P, tiles, tiles)).astype(np.int32)
    tables[rng.random(tables.shape) < 0.5] = -1
    return {"pool": rng.random(np.asarray(st.pool).shape).astype(np.float32), "tables": tables,
            "refcnt": np.bincount(tables[tables >= 0], minlength=capacity).astype(np.int32),
            "origin": np.asarray(st.origin), "scale": SCALE, "block": B, "overflow": False}


def to_jax(tree):
    return jcow.CowBlockMaps(
        pool=jnp.asarray(tree["pool"]), tables=jnp.asarray(tree["tables"]),
        refcnt=jnp.asarray(tree["refcnt"]), origin=jnp.asarray(tree["origin"]),
        scale=tree["scale"], block=tree["block"], overflow=jnp.asarray(tree["overflow"]))


def prepare_both(tree, poses, sc, cfg, max_writes=None):
    """The prepare twin on the state (in place), and cow.prepare_write on
    a copy with the twin's marks."""
    port = convert.cow_from_numpy(tree, device="cpu")
    plain = convert.cow_from_numpy(tree, device="cpu")
    touched, work = tcow.prepare_insert(port, TM, poses, sc, cfg, max_writes=max_writes)
    plain = tcow.prepare_write(plain, TM, touched, max_writes)
    return port, plain, touched, work


def assert_states_equal(a, b):
    for name in ("pool", "tables", "refcnt", "overflow"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("case", ["first step", "random state", "small budget", "trap o"])
def test_prepare_twin_equals_prepare_write_and_the_reference(scans, case):
    """The prepare twin's tables, refcounts, pool and latch: those of
    ``cow.prepare_write`` bit for bit, and of the reference's
    ``prepare_write`` (under trap o: where the reference takes a used slot,
    the port keeps the table)."""
    sc, gt = scans
    cfg = tray.BeamConfig(**BEAM)
    rng = np.random.default_rng(3)
    if case == "first step":
        st = jcow.make_cow_maps(JM, P, TILES, TILES, capacity=400, block=B, scale=SCALE)
        tree = {"pool": np.array(st.pool), "tables": np.array(st.tables),
                "refcnt": np.array(st.refcnt), "origin": np.asarray(st.origin),
                "scale": SCALE, "block": B, "overflow": False}
    else:
        tree = random_tree(rng, 90 if case == "trap o" else 400)
    budget = 5 if case == "small budget" else None
    port, plain, touched, work = prepare_both(tree, gt, sc, cfg, budget)
    assert_states_equal(port, plain)
    ref = jcow.prepare_write(to_jax(tree), JM, jnp.asarray(touched.numpy()), max_writes=budget)
    rt, pt = np.asarray(ref.tables), port.tables.numpy()
    assert bool(ref.overflow) == bool(port.overflow) == (case in ("small budget", "trap o"))
    misdirected = (rt != tree["tables"]) & ~(tree["refcnt"] == 0)[np.clip(rt, 0, None)]
    assert misdirected.any() == (case == "trap o")
    np.testing.assert_array_equal(pt[~misdirected], rt[~misdirected])
    np.testing.assert_array_equal(pt[misdirected], tree["tables"][misdirected])
    if case != "trap o":
        np.testing.assert_array_equal(port.refcnt.numpy(), np.asarray(ref.refcnt))
        live = port.refcnt.numpy() > 0
        np.testing.assert_array_equal(port.pool.numpy()[live], np.asarray(ref.pool)[live])
    new = int((port.tables != torch.from_numpy(tree["tables"])).sum())
    assert int(work.buf[4]) == new > 0
    if case == "small budget":
        assert new == 5


@pytest.mark.parametrize("capacity", [2048, 9])
def test_prepare_twin_allocates_like_allocate_tiles(scans, capacity):
    """The tiled map: the prepare twin's table and n_alloc equal
    ``blockmap.allocate_tiles`` and the reference's, an exhausted pool's
    excess tiles left without a block."""
    sc, gt = scans
    cfg = tray.BeamConfig(**BEAM)
    bm = tbm.make_block_map(TM, TILES, TILES, capacity, block=B, scale=SCALE, device="cpu")
    plain = tbm.make_block_map(TM, TILES, TILES, capacity, block=B, scale=SCALE, device="cpu")
    ref = jbm.make_block_map(JM, TILES, TILES, capacity, block=B, scale=SCALE)
    for i in range(2):
        pose, scan = gt[i:i + 1], LaserScan(sc.ranges[i:i + 1], sc.bearings[i:i + 1],
                                            sc.valid[i:i + 1])
        touched, work = tbm.prepare_tiles(bm, TM, pose, scan, cfg)
        plain = tbm.allocate_tiles(plain, touched[0])
        ref = jbm.allocate_tiles(ref, jnp.asarray(touched[0].numpy()))
        np.testing.assert_array_equal(bm.table.numpy(), plain.table.numpy())
        np.testing.assert_array_equal(bm.table.numpy(), np.asarray(ref.table))
        assert int(bm.n_alloc) == int(plain.n_alloc) == int(ref.n_alloc)
        owner = kernels.pool_owners(bm.table[None], touched, capacity)
        owner = torch.where(torch.arange(capacity) < bm.n_alloc, owner, -1)
        assert torch.equal(work.owner, owner)
    assert bool(bm.overflowed) == (capacity == 9)


@pytest.mark.parametrize("case", ["random state", "first step", "trap o"])
def test_work_list_names_every_live_slot_once(scans, case):
    """The work list: its owners are ``pool_owners``' on the prepared
    tables; its items are the robot tiles' bands (4 each), then the other
    owned slots, then the live unowned slots, each kind by increasing slot,
    every live slot in exactly one kind."""
    sc, gt = scans
    cfg = tray.BeamConfig(**BEAM)
    rng = np.random.default_rng(11)
    tree = random_tree(rng, 90 if case == "trap o" else 400)
    if case == "first step":
        tree["tables"][:] = -1
        tree["refcnt"][:] = 0
    port, _, touched, work = prepare_both(tree, gt, sc, cfg)
    n = port.capacity
    owner = kernels.pool_owners(port.tables, touched, n, port.refcnt)
    assert torch.equal(work.owner, owner)
    count, nb = int(work.buf[2]), int(work.buf[3])
    assert nb == kernels.POOL_ROBOT_BANDS
    items = work.items[:count]
    slot, code = items >> 4, items & 15
    kinds = torch.where(code < nb, 0, torch.where(code == 14, 1, 2))
    assert bool((kinds[1:] >= kinds[:-1]).all())
    for k in range(3):
        s = slot[kinds == k]
        assert bool((s[1:] >= s[:-1]).all())
    bands = slot[kinds == 0]
    banded = torch.unique(bands)
    assert bands.numel() == nb * banded.numel() and banded.numel() >= 1
    assert torch.equal(code[kinds == 0], torch.arange(nb).repeat(banded.numel()))
    live = torch.nonzero(port.refcnt > 0)[:, 0]
    assert torch.equal(torch.unique(slot), live)
    assert torch.equal(torch.sort(torch.cat([banded, slot[kinds > 0]]))[0], live)
    assert bool((owner[slot[kinds < 2]] >= 0).all()) and bool((owner[slot[kinds == 2]] < 0).all())
    # the banded tiles: each particle's robot's tile it owns, and (the list
    # being short: 4 particles) the owned tiles next to it
    e = owner[slot[kinds < 2]].to(torch.int64)
    cell = torch.floor((gt[e // (TILES * TILES), :2] - port.origin) / SCALE).to(torch.int64)
    rr, rc = cell[:, 1] // B, cell[:, 0] // B
    tr, tc = (e % (TILES * TILES)) // TILES, (e % (TILES * TILES)) % TILES
    near = ((tr - rr).abs() <= 1) & ((tc - rc).abs() <= 1)
    assert torch.equal(torch.sort(torch.unique(slot[kinds < 2][near]))[0], banded)


def test_pool_prepare_launches_on_the_card_only(scans):
    """``kernels.pool_prepare`` takes CUDA tensors only: on the CPU it
    raises and names the plain versions, which ``cow.prepare_insert`` and
    ``blockmap.prepare_tiles`` take there; the copy-on-write budget is
    ``cow.write_budget``'s, the reference's ``max(2048, 96 P)`` capped at
    the table entries."""
    sc, gt = scans
    cfg = tray.BeamConfig(**BEAM)
    st = tcow.make_cow_maps(TM, P, TILES, TILES, 64, block=B, scale=SCALE, device="cpu")
    with pytest.raises(ValueError, match="prepare_insert_ref"):
        kernels.pool_prepare(st.pool, st.tables, st.origin, SCALE, TM, gt, sc, cfg,
                             refcnt=st.refcnt, overflow=st.overflow, k_max=5)
    assert tcow.write_budget(P, TILES * TILES) == P * TILES * TILES
    assert tcow.write_budget(30, 4096) == 2880 and tcow.write_budget(4, 4096) == 2048
    assert tcow.write_budget(P, TILES * TILES, 5) == 5
