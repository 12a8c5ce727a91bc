"""Kernel wrappers and their plain PyTorch twins.

``overlap_score`` scores K candidate poses against a map plane. It replaces
the TPU kernel ``slam_constructor_tpu/ops/pallas_kernels.py::
sample_plane_bilinear`` (the overlap reducer at extent 1) fused with the
pose transform and weighted mean of ``scoring.score_poses``; with another
:class:`Reducer` (the obstacle, max and mean reducers, the overlap reducer
at any extent and window) it is the reference's gather path for them. Every
scoring wrapper below takes the reducer last (``BILINEAR`` by default) and
passes it to its kernel, which tests one uniform code before its beam loop.
``overlap_score_batched`` is the same kernel over M maps in one launch,
each with its own plane, poses, scan and origin: what the reference gets
from ``vmap`` over submaps when it closes loops, and over particles in the
RBPF's improved proposal and minimumScore gate.

``overlap_score_partial`` is the same score split by rows, for a plane
sharded over ranks (``parallel/halo.py``, ``parallel/blockshard.py``): a
rank holds a band of the plane's rows with a halo and sums, for each pose,
only the beams whose endpoint's centre row it owns, f32[K, 2] (num, den).

``overlap_score_grad`` is the same score with its gradient with respect
to each pose, in one pass (``csrc/overlap_score_grad.cu``), by any
reducer, for one map or M: the gradient matcher's ascent direction, which
the reference takes with ``jax.grad`` through its score (0 for the
piecewise-constant reducers, ``Reducer.flat``). ``clear_of_kinks`` picks
the beams where two implementations of that gradient can be compared.

``gradient_refine`` runs the gradient matcher's whole refine (the start
pose's score and gradient, then every iteration's step, score and
keep-or-shrink) in one launch (``csrc/gradient_refine.cu``), and
``hill_climb`` the hill-climbing matcher's whole climb, each by any
reducer, for one map or M in one launch (``csrc/hill_climb.cu``, the
climb of ``csrc/climb.cuh`` that ``m3rsm_search`` runs too).
``gradient_refine_rounds`` and ``hill_climb_rounds`` are the same refines
with ``overlap_score_grad`` or ``overlap_score`` launched once a pass, kept
as the yardsticks the fused kernels must equal bit for bit.

``mc_match`` runs one whole Monte-Carlo match (the first score, every
round's candidates, argmax, keep-if-better and the sigma anneal) in one
launch on a thread-block cluster (``csrc/mc_match.cu``); it is the same TPU
kernel's counterpart on the matcher's path, with the matcher's round loop
folded in. ``mc_match_batched`` is the same kernel over P matches at once,
a cluster each, each with its own plane, scan, prior and noise: the RBPF's
particles, each match with the bits of a single ``mc_match``.
``mc_match_windows`` is the same again, each particle's window of its map
read in place, with no window cut out first. ``mc_match_rounds`` is the same match with ``overlap_score`` launched once
a round, kept as the yardstick the fused kernels must equal bit for bit.

``m3rsm_pyramid`` builds M3RSM's max-pooled occupancy pyramid of one map
or of M maps in one launch (``csrc/m3rsm_pyramid.cu``, K4a), and
``m3rsm_pyramid_update`` refreshes one aligned region of it into new
planes in one launch, gated by a flag on the device. ``m3rsm_search`` runs
B whole M3RSM matches (the branch and bound over the pyramid, then the hill
climb) in one launch, a thread-block cluster a request
(``csrc/m3rsm_match.cu``, K4b); ``m3rsm_search_levels`` is the same match
with ``m3rsm_score_level`` (``csrc/m3rsm_level.cu``: one level's rects for
B requests) launched once a level and ``overlap_score_batched`` once a
hill-climb round, kept as the yardstick ``m3rsm_search`` must equal bit for
bit. The reference compiled all of it with XLA
(``slam_constructor_tpu/ops/m3rsm.py``: ``build_pyramid``,
``update_pyramid``, ``_score_level``, ``m3rsm_match``); no Pallas kernel
stood there but the hill climb's score.

``pool_insert`` is K3 over a block pool: P scans inserted into the tiles of
P block tables over one pool ``f32[N, B, B, C]`` (the tiled map is one
table, the copy-on-write RBPF maps P), folded, in place; a fixed grid takes
a work list's items (the tile around each particle's robot in row bands,
every other touched tile, every other live slot folded with no
observation, as the reference folds its whole pool:
``slam_constructor_tpu/ops/blockmap.py:117``, ``ops/cow.py:143``), a tile's
samples summed in the pool's scatter order. ``pool_prepare`` writes that
list in one launch of the same source, after what the reference does
before its scatter: the tiles each scan's samples touch (found by where
each beam crosses tile boundaries), then the copy-on-write compaction with
its block copies (``slam_constructor_tpu/ops/cow.py:82``) or the tiled
map's allocation (``blockmap.py:87``), in place. ``pool_touched`` is its
marking phase alone. ``pool_insert_ordered`` sums the same samples on the
host in order, the yardstick the insert equals bit for bit.

``polar_free_plane`` fills the dense polar free-space weight plane of one
scan. It replaces ``pallas_kernels.py::polar_free_lookup`` together with
the plane math that ``raycast._polar_free_plane_pallas`` computes around
it: the whole of ``raycast._polar_free_plane`` in one launch.

``scan_insert`` (K3) inserts a scan into one map, or P scans into P maps
each on a window around its pose read and written in place, and folds it
into the cells: the rasterisation (the DDA free trace, or K2's plane; the
const or area endpoint evidence and the wall blur, each cell's occupied
samples summed in sample order) and the cell model's fold, in one launch
(``csrc/scan_insert.cu``: a block a band of rows). ``scan_planes`` is the
same kernel without the fold: N scans rasterised into P planes, the scans
that share a plane summed in scan order (the loop closer's submaps, joint
refine and the regenerated map). They replace what the TPU ran as XLA
one-hot matmuls (``raycast.py::_scatter_matmul``) with
``grid.apply_observations``; ``scan_insert_ordered`` and
``scan_planes_ordered`` sum the same samples on the host in order, the
yardsticks they equal bit for bit.

On a CUDA tensor a wrapper launches its hand-written kernel (``csrc/*.cu``)
or raises; it never falls back. On a CPU tensor it runs the plain twin
(``*_ref``), which the CPU tests hold against the reference and which the
card's smoke run holds the kernel to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import constant
from . import _build, cells
from . import grid as gridlib
from .geometry import linspace, wrap_angle

Tensor = torch.Tensor

#: shared memory a block may use without opting in to more
_MAX_SHARED_BYTES = 48 * 1024

#: kernel launches of each wrapper since the counts were last set to 0. A
#: wrapper adds one where it launches its kernel (CUDA tensors only), under
#: its own name whatever name it was called by.
_LAUNCHES = dict.fromkeys(
    ("overlap_score", "overlap_score_batched", "overlap_score_partial", "overlap_score_grad",
     "gradient_refine",
     "hill_climb", "mc_match", "mc_match_batched", "polar_free_plane", "m3rsm_pyramid",
     "m3rsm_level", "m3rsm_search", "scan_insert", "scan_planes", "pool_touched",
     "pool_prepare", "pool_insert"), 0
)

#: how a beam's endpoint reads the plane, by the codes of
#: ``csrc/overlap_sample.cuh``: the bilinear taps (the overlap reducer at
#: extent 1 with a window of at least one cell), the obstacle reducer's one
#: cell, the max and the mean over the (2 radius + 1)^2 cells around it, and
#: the overlap reducer at any extent and window
REDUCER_KINDS = ("bilinear", "obstacle", "max", "mean", "overlap")

#: the scoring wrappers' launches by reducer, ``"<wrapper>/<kind>"``; a
#: launch adds one here and one to its wrapper's count
_REDUCER_LAUNCHES = dict.fromkeys(
    (f"{name}/{kind}" for name in ("overlap_score", "overlap_score_batched",
                                   "overlap_score_partial", "overlap_score_grad",
                                   "gradient_refine", "hill_climb", "mc_match",
                                   "mc_match_batched", "m3rsm_search")
     for kind in REDUCER_KINDS), 0)


def launch_counts() -> dict[str, int]:
    """Kernel launches of each wrapper since :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reducer_launch_counts() -> dict[str, int]:
    """The scoring wrappers' launches since :func:`reset_launch_counts`, by
    reducer: ``{"mc_match_batched/obstacle": n, ...}``."""
    return dict(_REDUCER_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    for name in _REDUCER_LAUNCHES:
        _REDUCER_LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Reducer:
    """How a beam's endpoint reads the plane ``where(known, occ, unknown)``
    (``scoring.reducer_of`` makes one from a ``ScoringConfig``): ``kind`` one
    of :data:`REDUCER_KINDS`, ``radius`` the window's radius in cells (max,
    mean, overlap), ``extent`` the side of the endpoint's square in cells
    (overlap)."""

    kind: str = "bilinear"
    radius: int = 0
    extent: float = 1.0

    def __post_init__(self):
        if self.kind not in REDUCER_KINDS:
            raise ValueError(f"unknown reducer {self.kind!r}")
        if not 0 <= self.radius <= 4096 or not 0.0 < self.extent < 1e30:
            raise ValueError(f"a reducer's radius must be 0 to 4096 cells and its extent "
                             f"positive: got {self}")

    @property
    def code(self) -> int:
        return REDUCER_KINDS.index(self.kind)

    @property
    def flat(self) -> bool:
        """Whether the score is piecewise constant in the pose (its
        gradient 0): the obstacle, max and mean reducers, and the overlap
        reducer at radius 0, whose square meets one cell and gives that
        cell's value (above the 1e-9 floor on the weights, which an extent
        of 1e-4 cells or more keeps)."""
        return self.kind in ("obstacle", "max", "mean") or (
            self.kind == "overlap" and self.radius == 0 and self.extent >= 1e-4)


BILINEAR = Reducer()


def _count(name: str, reducer: Reducer) -> None:
    _LAUNCHES[name] += 1
    _REDUCER_LAUNCHES[f"{name}/{reducer.kind}"] += 1


def _axis_taps(pos: Tensor, n: int):
    """Bilinear (overlap, extent 1) taps along one axis: weights of cells
    ``i0`` and ``i0 + 1``, zero where a cell lies off the map, and the
    tap indices clamped into the map (a NaN position to cell 0, as the
    kernels clamp it)."""
    f = torch.floor(pos - 0.5)
    w0 = (f + 1.5) - pos
    ok0 = (f >= 0) & (f < n)
    ok1 = (f + 1.0 >= 0) & (f + 1.0 < n)
    a0 = torch.where(ok0, w0, 0.0)
    a1 = torch.where(ok1, 1.0 - w0, 0.0)
    i0 = torch.where(f >= 0, torch.clamp(f, max=n - 1), 0.0).to(torch.int64)
    i1 = torch.where(f + 1.0 >= 0, torch.clamp(f + 1.0, max=n - 1), 0.0).to(torch.int64)
    return a0, a1, i0, i1


def _cells_ref(flat: Tensor, h: int, w: int, fy: Tensor, fx: Tensor, unknown: float) -> Tensor:
    """The planes ``flat`` f32[M, H * W] at the cells (fy, fx) f32[M, ...]
    (floats that hold integers, or NaN), ``unknown`` where a cell lies off
    the map: compared in float before the cast, as the kernels do."""
    ok = (fy >= 0) & (fy < h) & (fx >= 0) & (fx < w)
    idx = torch.where(ok, fy, 0.0).to(torch.int64) * w + torch.where(ok, fx, 0.0).to(torch.int64)
    got = torch.gather(flat, 1, idx.reshape(flat.shape[0], -1)).reshape(idx.shape)
    return torch.where(ok, got, unknown)


def _reduce_ref(flat: Tensor, h: int, w: int, x: Tensor, y: Tensor, unknown: float,
                red: Reducer) -> Tensor:
    """Per-beam probabilities at the cell positions (x, y) f32[M, K, R] by a
    reducer other than ``bilinear``, in the kernels' order: the reference's
    gather path (``scoring.py:336-376``) with the window's cells summed one
    after the other, rows outer and columns inner."""
    fx, fy = torch.floor(x), torch.floor(y)
    if red.kind == "obstacle":
        return _cells_ref(flat, h, w, fy, fx, unknown)
    offs = range(-red.radius, red.radius + 1)
    if red.kind == "overlap":
        half = torch.full((), 0.5 * red.extent, dtype=torch.float32, device=x.device)
        ex, ey = x - fx, y - fy
        num, wsum = torch.zeros_like(x), torch.zeros_like(x)
        for dr in offs:
            len_y = torch.clamp(torch.clamp(ey + half, max=dr + 1.0)
                                - torch.clamp(ey - half, min=float(dr)), min=0.0)
            for dc in offs:
                len_x = torch.clamp(torch.clamp(ex + half, max=dc + 1.0)
                                    - torch.clamp(ex - half, min=float(dc)), min=0.0)
                wgt = len_x * len_y
                if red.radius == 0:
                    # one cell: above the floor the score is its value, so
                    # the derivative is 0 (not the quotient's rounding noise)
                    wgt = torch.where(wgt >= 1e-9, wgt.detach(), wgt)
                wsum = wsum + wgt
                num = num + _cells_ref(flat, h, w, fy + dr, fx + dc, unknown) * wgt
        return num / torch.clamp(wsum, min=1e-9)
    acc = torch.full_like(x, -math.inf if red.kind == "max" else 0.0)
    for dr in offs:
        for dc in offs:
            v = _cells_ref(flat, h, w, fy + dr, fx + dc, unknown)
            acc = torch.maximum(acc, v) if red.kind == "max" else acc + v
    if red.kind == "max":
        return acc
    return acc / torch.full_like(acc, float(len(offs) ** 2))  # an IEEE division (trap h)


def _beam_probs_ref(v: Tensor, poses: Tensor, pts: Tensor, origin: Tensor, scale: float,
                    unknown: float, reducer: Reducer) -> Tensor:
    """Every beam's probability f32[M, K, R] on planes v f32[M, H, W] at
    poses f32[M, K, 3] (the kernels' arithmetic)."""
    n_m, h, w = v.shape
    c = torch.cos(poses[..., 2:3])
    s = torch.sin(poses[..., 2:3])
    qx, qy = pts[:, None, :, 0], pts[:, None, :, 1]  # [M, 1, R]
    wx = poses[..., 0:1] + c * qx - s * qy  # [M, K, R]
    wy = poses[..., 1:2] + s * qx + c * qy
    x = gridlib.div_scale(wx - origin[:, 0, None, None], scale)  # the kernel's division
    y = gridlib.div_scale(wy - origin[:, 1, None, None], scale)
    flat = v.reshape(n_m, -1)
    if reducer.kind != "bilinear":
        return _reduce_ref(flat, h, w, x, y, unknown, reducer)
    ay0, ay1, r0, r1 = _axis_taps(y, h)
    ax0, ax1, c0, c1 = _axis_taps(x, w)

    def tap(a, b, r, col):
        got = torch.gather(flat, 1, (r * w + col).reshape(n_m, -1)).reshape(r.shape)
        return torch.where((a != 0) & (b != 0), got, 0.0)

    v00 = tap(ay0, ax0, r0, c0)
    v10 = tap(ay1, ax0, r1, c0)
    v01 = tap(ay0, ax1, r0, c1)
    v11 = tap(ay1, ax1, r1, c1)
    ssum = (ay0 * v00 + ay1 * v10) * ax0 + (ay0 * v01 + ay1 * v11) * ax1
    coverage = (ay0 + ay1) * (ax0 + ax1)
    return ssum + (1.0 - coverage) * unknown


def overlap_score_ref(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
    reducer: Reducer = BILINEAR,
) -> Tensor:
    """Plain PyTorch version of the kernel, with the same arithmetic.

    v f32[H, W] (``where(known, occ, unknown)``), poses f32[K, 3], pts
    f32[R, 2] sensor-frame endpoints, beam_w f32[R] (validity x point
    weights), origin f32[2] -> f32[K] weighted mean of per-beam
    probabilities, each read by ``reducer`` (the bilinear overlap taps by
    default). With a leading map dimension on every tensor (v
    f32[M, H, W], poses f32[M, K, 3], pts f32[M, R, 2], beam_w f32[M, R],
    origin f32[M, 2]) -> f32[M, K]: map m scores its own poses and scan.
    """
    if v.dim() == 2:
        return overlap_score_ref(
            v[None], poses[None], pts[None], beam_w[None], origin[None], scale, unknown, reducer
        )[0]
    p = _beam_probs_ref(v, poses, pts, origin, scale, unknown, reducer)
    bw = beam_w[:, None, :]
    return (p * bw).sum(-1) / torch.clamp(bw.sum(-1), min=1e-9)


@functools.cache
def _overlap_score_fn():
    fn = _build.load().overlap_score_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # v, m, h, w
        ctypes.c_void_p, ctypes.c_int,  # poses, k
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # origin, scale, unknown
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # reducer, radius, extent
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(
    name: str, t: Tensor, shape: tuple, device: torch.device, dtype=torch.float32
) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cell_stride(name: str, occ: Tensor, device: torch.device) -> int:
    """The floats from one cell of ``occ`` f32[..., H, W] to the next:
    1 when it is contiguous, C when it is a channel of contiguous cells
    f32[..., H, W, C] (``BayesAvgCell``'s occupancy); raises otherwise."""
    if occ.dtype != torch.float32:
        raise TypeError(f"occ must be torch.float32, got {occ.dtype}")
    stride = occ.stride(-1)
    want = [stride]
    for n in reversed(occ.shape[1:]):
        want.insert(0, want[0] * n)
    if occ.device != device or stride < 1 or any(
            n > 1 and s != x for n, s, x in zip(occ.shape, occ.stride(), want)):
        raise ValueError(f"{name}: occ must be contiguous or a channel of contiguous cells, "
                         f"got strides {occ.stride()}")
    return stride


#: most maps one launch takes: they lie on the grid's y axis
_MAX_MAPS = 65535


def _overlap_score_launch(name, lead, v, poses, pts, beam_w, origin, scale, unknown, reducer):
    """Checks the inputs against the leading shape ``lead`` (``()`` or
    ``(M,)``), launches the kernel and adds one to the count of ``name``
    (and of its reducer); returns f32[*lead, K]. Nothing is launched or
    counted when there is nothing to score."""
    if v.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {v.device}")
    h, w = v.shape[-2:]
    k, r = poses.shape[-2], pts.shape[-2]
    _check("v", v, (*lead, h, w), v.device)
    _check("poses", poses, (*lead, k, 3), v.device)
    _check("pts", pts, (*lead, r, 2), v.device)
    _check("beam_w", beam_w, (*lead, r), v.device)
    _check("origin", origin, (*lead, 2), v.device)
    n_m = lead[0] if lead else 1
    if n_m > _MAX_MAPS:
        raise ValueError(f"{name}: {n_m} maps, more than {_MAX_MAPS} a launch")
    out = torch.empty((*lead, k), dtype=torch.float32, device=v.device)
    if k == 0 or n_m == 0:
        return out
    fn = _overlap_score_fn()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(
            v.data_ptr(), n_m, h, w, poses.data_ptr(), k, pts.data_ptr(),
            beam_w.data_ptr(), r, origin.data_ptr(), scale, unknown, reducer.code,
            reducer.radius, reducer.extent, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _count(name, reducer)
    return out


def overlap_score(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
    reducer: Reducer = BILINEAR,
) -> Tensor:
    """Score poses f32[K, 3] against plane v f32[H, W] -> f32[K]: the
    kernel's M = 1 case, a beam's endpoint read by ``reducer``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to the ``overlap_score`` count of
    :func:`launch_counts` (and to its reducer's of
    :func:`reducer_launch_counts`). It is counted apart from
    :func:`overlap_score_batched` so that a run through
    :func:`mc_match_rounds` (one launch a round) can be told from the loop
    closer's launches.
    """
    if v.device.type == "cpu":
        return overlap_score_ref(v, poses, pts, beam_w, origin, scale, unknown, reducer)
    return _overlap_score_launch(
        "overlap_score", (), v, poses, pts, beam_w, origin, scale, unknown, reducer
    )


def overlap_score_batched(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
    reducer: Reducer = BILINEAR,
) -> Tensor:
    """Score, for each of M maps, its own poses and scan: v f32[M, H, W],
    poses f32[M, K, 3], pts f32[M, R, 2], beam_w f32[M, R], origin
    f32[M, 2] -> f32[M, K], in one launch, a beam's endpoint read by
    ``reducer``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for the whole batch, and add one to the
    ``overlap_score_batched`` count of :func:`launch_counts`.
    """
    if v.dim() != 3:
        raise ValueError(f"v has shape {tuple(v.shape)}, expected (M, H, W)")
    if v.device.type == "cpu":
        return overlap_score_ref(v, poses, pts, beam_w, origin, scale, unknown, reducer)
    return _overlap_score_launch(
        "overlap_score_batched", (v.shape[0],), v, poses, pts, beam_w, origin, scale, unknown,
        reducer
    )


def _group_order_sum(terms: Tensor) -> Tensor:
    """Sums terms f32[..., R] over R in the order of the kernels' group of
    128 threads: group lane v adds beams v, v + 128, ... in order from
    +0.0, then the tree s[t] + s[t + 64], + s[t + 32], then strides 16 down
    to 1 (``csrc/overlap_sample.cuh`` ``group_reduce``) -> f32[...]."""
    t = torch.nn.functional.pad(terms, (0, -terms.shape[-1] % 128)).unflatten(-1, (-1, 128))
    acc = terms.new_zeros((*terms.shape[:-1], 128))
    for j in range(t.shape[-2]):
        acc = acc + t[..., j, :]
    for half in (64, 32, 16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    return acc[..., 0]


def overlap_score_ordered(v: Tensor, poses: Tensor, pts: Tensor, beam_w: Tensor, origin: Tensor,
                          scale: float, unknown: float, reducer: Reducer = BILINEAR) -> Tensor:
    """:func:`overlap_score` (v f32[H, W]) or :func:`overlap_score_batched`
    (v f32[M, H, W]) with the sums done by PyTorch ops in the kernels'
    order: every beam's probability from a launch that scores that beam
    alone at weight 1 (its score is the probability, bit for bit), the
    terms ``bw * p`` of the beams of nonzero weight and their weights summed
    by :func:`_group_order_sum`, then ``num / fmax(den, 1e-9)``. On the card
    these are the bits every overlap-score kernel gives, whatever its
    layout; R launches of the wrapper (each counted)."""
    score = overlap_score_batched if v.dim() == 3 else overlap_score
    one = torch.ones_like(beam_w[..., :1])
    p = torch.stack([score(v, poses, pts[..., i:i + 1, :].contiguous(), one, origin, scale,
                           unknown, reducer) for i in range(pts.shape[-2])], -1)  # [..., K, R]
    bw = beam_w[..., None, :]
    num = _group_order_sum(torch.where(bw != 0, bw * p, 0.0))
    den = _group_order_sum(torch.where(bw != 0, bw, 0.0).expand_as(p))
    return num / torch.fmax(den, torch.full_like(den, 1e-9))


def overlap_score_layout(pairs: int, r: int) -> int:
    """The layout an ``overlap_score(_batched)`` launch of ``pairs`` (pose,
    map) pairs and ``r`` beams runs, by the fixed rule of
    ``csrc/overlap_score.cu``: 0 a beam a thread, 1 a group of 128 threads
    a pair, 2 a warp a pair (every layout gives the same bits). Needs the
    built library."""
    fn = _build.load().overlap_score_layout
    fn.argtypes, fn.restype = [ctypes.c_longlong, ctypes.c_int], ctypes.c_int
    return int(fn(pairs, r))


def _partial_need(reducer: Reducer) -> int:
    """Rows above and below an endpoint's centre row that its taps read."""
    return 1 if reducer.kind == "bilinear" else reducer.radius


def _check_band(name: str, band: Tensor, g0: int, h: int, row0: int, row1: int,
                reducer: Reducer) -> None:
    need = _partial_need(reducer)
    he = band.shape[0]
    if not 0 <= row0 <= row1 <= h:
        raise ValueError(f"{name}: owned rows [{row0}, {row1}) are not inside [0, {h})")
    if g0 > max(row0 - need, 0) or g0 + he < min(row1 + need, h):
        raise ValueError(f"{name}: the band's rows [{g0}, {g0 + he}) do not hold the rows "
                         f"[{row0 - need}, {row1 + need}) that the owned beams' taps read")


def overlap_score_partial_ref(band: Tensor, g0: int, h: int, poses: Tensor, pts: Tensor,
                              beam_w: Tensor, origin: Tensor, scale: float, unknown: float,
                              row0: int, row1: int, reducer: Reducer = BILINEAR) -> Tensor:
    """Plain PyTorch version of :func:`overlap_score_partial`: the band
    placed in an h-row plane (rows outside it NaN: an owned beam never reads
    them), every beam scored as :func:`overlap_score_ref` scores it, and
    the beams whose centre row ``clamp(floor(y), 0, h - 1)`` lies in
    ``[row0, row1)`` summed -> f32[K, 2] (num, den)."""
    _check_band("overlap_score_partial_ref", band, g0, h, row0, row1, reducer)
    w = band.shape[1]
    plane = torch.full((h, w), math.nan, dtype=torch.float32, device=band.device)
    lo, hi = max(g0, 0), min(g0 + band.shape[0], h)
    plane[lo:hi] = band[lo - g0:hi - g0]
    p = _beam_probs_ref(plane[None], poses[None], pts[None], origin[None], scale, unknown,
                        reducer)[0]  # [K, R]
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    qx, qy = pts[None, :, 0], pts[None, :, 1]
    wy = poses[:, 1:2] + s * qx + c * qy
    fy = torch.floor(gridlib.div_scale(wy - origin[1], scale))
    own_row = torch.where(fy >= 0, torch.clamp(fy, max=float(h - 1)), 0.0)
    own = (own_row >= row0) & (own_row < row1) & (beam_w[None, :] != 0)
    bw = torch.where(own, beam_w[None, :], 0.0)
    num = torch.where(own, bw * p, 0.0).sum(-1)
    return torch.stack([num, bw.sum(-1)], dim=-1)


def overlap_score_partial_ordered(band: Tensor, g0: int, h: int, poses: Tensor, pts: Tensor,
                                  beam_w: Tensor, origin: Tensor, scale: float, unknown: float,
                                  row0: int, row1: int, reducer: Reducer = BILINEAR) -> Tensor:
    """:func:`overlap_score_partial`'s sums by PyTorch ops in the kernels'
    order, as :func:`overlap_score_ordered` does them: each beam's
    probability and ownership from a launch that scores it alone at weight
    1 (num p, den 1 where the band owns it, else (0, 0)), the owned beams of
    nonzero weight summed by :func:`_group_order_sum` -> f32[K, 2]."""
    one = torch.ones_like(beam_w[:1])
    pd = torch.stack([overlap_score_partial(band, g0, h, poses, pts[i:i + 1].contiguous(), one,
                                            origin, scale, unknown, row0, row1, reducer)
                      for i in range(pts.shape[0])], 1)  # [K, R, 2]
    take = (pd[..., 1] != 0) & (beam_w[None, :] != 0)
    num = _group_order_sum(torch.where(take, beam_w[None, :] * pd[..., 0], 0.0))
    den = _group_order_sum(torch.where(take, beam_w[None, :], 0.0))
    return torch.stack([num, den], -1)


@functools.cache
def _overlap_score_partial_fn():
    fn = _build.load().overlap_score_partial_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # band, g0, he, h, w
        ctypes.c_void_p, ctypes.c_int,  # poses, k
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # origin, scale, unknown
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # reducer, radius, extent
        ctypes.c_int, ctypes.c_int,  # row0, row1
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def overlap_score_partial(band: Tensor, g0: int, h: int, poses: Tensor, pts: Tensor,
                          beam_w: Tensor, origin: Tensor, scale: float, unknown: float,
                          row0: int, row1: int, reducer: Reducer = BILINEAR) -> Tensor:
    """A rank's share of the score of poses f32[K, 3] on an h-row plane
    sharded by rows: ``band`` f32[He, W] holds the plane's rows [g0, g0 +
    He), which must include every row that the taps of the beams it owns
    read (its owned rows [row0, row1) and ``max(radius, 1)`` rows around
    them, as far as the plane goes). Returns f32[K, 2]: for each pose the
    sums (num, den) over the beams whose endpoint's centre row lies in
    [row0, row1); ``num / max(den, 1e-9)`` after the ranks' sums are added
    is :func:`overlap_score`.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to the ``overlap_score_partial`` count."""
    if band.device.type == "cpu":
        return overlap_score_partial_ref(band, g0, h, poses, pts, beam_w, origin, scale, unknown,
                                         row0, row1, reducer)
    name = "overlap_score_partial"
    if band.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {band.device}")
    he, w = band.shape
    k, r = poses.shape[0], pts.shape[0]
    _check("band", band, (he, w), band.device)
    _check("poses", poses, (k, 3), band.device)
    _check("pts", pts, (r, 2), band.device)
    _check("beam_w", beam_w, (r,), band.device)
    _check("origin", origin, (2,), band.device)
    _check_band(name, band, g0, h, row0, row1, reducer)
    out = torch.empty((k, 2), dtype=torch.float32, device=band.device)
    if k == 0:
        return out
    fn = _overlap_score_partial_fn()
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream(band.device).cuda_stream
        err = fn(band.data_ptr(), g0, he, h, w, poses.data_ptr(), k, pts.data_ptr(),
                 beam_w.data_ptr(), r, origin.data_ptr(), scale, unknown, reducer.code,
                 reducer.radius, reducer.extent, row0, row1, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _count(name, reducer)
    return out


def overlap_score_grad_ref(v, poses, pts, beam_w, origin, scale, unknown, reducer=BILINEAR):
    """Plain version of ``overlap_score_grad``: autograd over
    :func:`overlap_score_ref` with ``reducer``, one plane or M. Returns
    (score f32[..., K], dscore f32[..., K, 3]), the derivative of each score
    by its own pose (0 for the piecewise-constant reducers)."""
    with torch.enable_grad():
        p = poses.detach().requires_grad_(True)
        score = overlap_score_ref(v, p, pts, beam_w, origin, scale, unknown, reducer)
        if not score.requires_grad:  # a cell lookup: nothing depends on the pose
            return score.detach(), torch.zeros_like(poses)
        (grad,) = torch.autograd.grad(score.sum(), p, allow_unused=True)
    return score.detach(), torch.zeros_like(poses) if grad is None else grad


def _kink_offsets(reducer: Reducer) -> tuple:
    """Where, in cells past an integer, a coordinate of an endpoint meets a
    kink of ``reducer``'s score: the bilinear taps change at every half
    cell; the general overlap's lengths where an edge of the square (the
    position +- extent / 2) meets a cell edge, and its window at every
    integer; the piecewise-constant reducers jump at every integer."""
    if reducer.kind == "bilinear":
        return (0.0, 0.5)
    if reducer.kind == "overlap" and reducer.radius > 0:
        h = 0.5 * reducer.extent
        return (0.0, h % 1.0, (-h) % 1.0)
    return (0.0,)


def clear_of_kinks(poses: Tensor, pts: Tensor, origin: Tensor, scale: float,
                   margin: float = 1e-4, reducer: Reducer = BILINEAR) -> Tensor:
    """bool[R]: the beams whose endpoint, from every pose f32[K, 3], lies
    at least ``margin`` cell from every kink of ``reducer``'s score on both
    axes (:func:`_kink_offsets`; the bilinear one's at a cell's centre and
    edge). There the score's derivative jumps (a tap, or the reference's
    window, changes), so a position one ulp apart takes the other side's
    derivative: two gradients compare on the clear beams only. With a
    leading map dimension (poses f32[M, K, 3], pts f32[M, R, 2], origin
    f32[M, 2]) -> bool[M, R]."""
    if poses.dim() == 3:
        return torch.stack([clear_of_kinks(poses[m], pts[m], origin[m], scale, margin, reducer)
                            for m in range(poses.shape[0])])
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    x = (poses[:, 0:1] + c * pts[:, 0] - s * pts[:, 1] - origin[0]) / scale
    y = (poses[:, 1:2] + s * pts[:, 0] + c * pts[:, 1] - origin[1]) / scale
    if reducer.kind == "bilinear":
        half = torch.stack([x, y]) * 2.0  # kinks every half cell
        return ((half - torch.round(half)).abs() >= 2 * margin).all(0).all(0)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for off in _kink_offsets(reducer):
        u = torch.stack([x, y]) - off
        ok &= ((u - torch.round(u)).abs() >= margin).all(0).all(0)
    return ok


@functools.cache
def _overlap_score_grad_fn():
    fn = _build.load().overlap_score_grad_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # v, m, h, w
        ctypes.c_void_p, ctypes.c_int,  # poses, k
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # origin, scale, unknown
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # reducer, radius, extent
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out, dout, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def overlap_score_grad(
    v: Tensor,
    poses: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    scale: float,
    unknown: float,
    reducer: Reducer = BILINEAR,
) -> tuple[Tensor, Tensor]:
    """Score poses f32[K, 3] against plane v f32[H, W], a beam read by
    ``reducer``, and differentiate each score by its pose: (score f32[K],
    dscore f32[K, 3]); with a leading map dimension on every tensor (v
    f32[M, H, W], poses f32[M, K, 3], pts f32[M, R, 2], beam_w f32[M, R],
    origin f32[M, 2]) map m scores its own poses and scan: f32[M, K],
    f32[M, K, 3]. The score has the bits of :func:`overlap_score` (of
    :func:`overlap_score_batched` for M maps). The obstacle, max and mean
    reducers and the overlap reducer at radius 0 are piecewise constant:
    their derivative is 0.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for all maps, and add one to the
    ``overlap_score_grad`` count (and to its reducer's)."""
    if v.device.type == "cpu":
        return overlap_score_grad_ref(v, poses, pts, beam_w, origin, scale, unknown, reducer)
    if v.device.type != "cuda":
        raise ValueError(f"overlap_score_grad: unsupported device {v.device}")
    lead = tuple(v.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"v has shape {tuple(v.shape)}, expected (H, W) or (M, H, W)")
    h, w = v.shape[-2:]
    k, r = poses.shape[-2], pts.shape[-2]
    _check("v", v, (*lead, h, w), v.device)
    _check("poses", poses, (*lead, k, 3), v.device)
    _check("pts", pts, (*lead, r, 2), v.device)
    _check("beam_w", beam_w, (*lead, r), v.device)
    _check("origin", origin, (*lead, 2), v.device)
    n_m = lead[0] if lead else 1
    if n_m > _MAX_MAPS:
        raise ValueError(f"overlap_score_grad: {n_m} maps, more than {_MAX_MAPS} a launch")
    out = torch.empty((*lead, k), dtype=torch.float32, device=v.device)
    dout = torch.empty((*lead, k, 3), dtype=torch.float32, device=v.device)
    if k == 0 or n_m == 0:
        return out, dout
    fn = _overlap_score_grad_fn()
    _launch("overlap_score_grad", v.device, lambda stream: fn(
        v.data_ptr(), n_m, h, w, poses.data_ptr(), k, pts.data_ptr(), beam_w.data_ptr(), r,
        origin.data_ptr(), scale, unknown, reducer.code, reducer.radius, reducer.extent,
        out.data_ptr(), dout.data_ptr(), stream))
    _count("overlap_score_grad", reducer)
    return out, dout


# --- the refines: gradient ascent and hill climbing --------------------------

#: most beams a refine launch stages in a block's shared memory (12 B each)
_REFINE_MAX_BEAMS = 16384


def _refine_checks(name: str, lead: tuple, plane: Tensor, pts: Tensor, beam_w: Tensor,
                   origin: Tensor, pose: Tensor, iterations: int) -> None:
    """Raises where a refine's inputs do not have the leading shape
    ``lead`` (``()`` or ``(M,)``) and one plane, scan, origin and pose
    each; on a CUDA plane also where one is not f32, contiguous and on the
    plane's device."""
    if plane.dim() != len(lead) + 2:
        raise ValueError(f"{name}: plane has shape {tuple(plane.shape)}, expected {lead} + (H, W)")
    r = pts.shape[-2] if pts.dim() >= 2 else -1
    want = {"plane": tuple(plane.shape), "pts": (*lead, r, 2), "beam_w": (*lead, r),
            "origin": (*lead, 2), "pose": (*lead, 3)}
    got = {"plane": plane, "pts": pts, "beam_w": beam_w, "origin": origin, "pose": pose}
    for what, t in got.items():
        if tuple(t.shape) != want[what]:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected {want[what]}")
    if iterations < 0:
        raise ValueError(f"{name}: {iterations} iterations")
    if plane.device.type == "cuda":
        for what, t in got.items():
            _check(what, t, want[what], plane.device)
        if r > _REFINE_MAX_BEAMS:
            raise ValueError(f"{name}: {r} beams, more than {_REFINE_MAX_BEAMS} a launch")
    elif plane.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {plane.device}")


def _flat_refine(score, plane, pts, beam_w, origin, pose, scale, unknown, iterations, reducer):
    """A refine on a piecewise-constant score (``reducer.flat``): the
    gradient is 0, so no step is taken and none can score better. The start
    pose, its score (one call of ``score``, a wrapper with
    :func:`overlap_score_grad`'s or :func:`overlap_score`'s signature, whose
    first output is the score) and a trace of that score: what the
    reference's ``gradient_match`` returns there."""
    got = score(plane, pose[..., None, :].contiguous(), pts, beam_w, origin, scale, unknown,
                reducer)
    prob = (got[0] if isinstance(got, tuple) else got)[..., 0]
    trace = prob[..., None].expand(*prob.shape, iterations).contiguous()
    return pose.clone(), prob, trace


def gradient_refine_loop(score_grad, plane, pts, beam_w, origin, pose, scale, unknown, step_xy,
                         step_theta, iterations, shrink, reducer=BILINEAR):
    """The gradient refine as a Python loop over device tensors with no
    host sync: score and differentiate the start pose, then each iteration
    steps ``steps * g / (|g| + 1e-12)`` from the kept pose (theta wrapped)
    and keeps the step if it scores strictly better, else multiplies every
    step by ``shrink``. ``score_grad`` has ``overlap_score_grad``'s
    signature and is called once for the start pose and once a candidate,
    for one map (pose f32[3]) or M (pose f32[M, 3], every tensor with a
    leading map dimension; each map's refine its own, elementwise). |g| is
    ``sqrt((gx^2 + gy^2) + gth^2)`` written out, the order the kernel sums
    in. A ``reducer.flat`` score takes :func:`_flat_refine` (one call).
    Returns pose f32[..., 3], prob f32[...], trace f32[..., iterations]."""
    if reducer.flat:
        return _flat_refine(score_grad, plane, pts, beam_w, origin, pose, scale, unknown,
                            iterations, reducer)
    dev = pose.device
    args = (pts, beam_w, origin, scale, unknown, reducer)

    def at(p):
        score, grad = score_grad(plane, p[..., None, :].contiguous(), *args)
        return score[..., 0], grad[..., 0, :]

    prob, g = at(pose)
    steps = constant((step_xy, step_xy, step_theta), torch.float32, dev)
    trace = []
    for _ in range(iterations):
        sq = g * g
        norm = torch.sqrt((sq[..., 0:1] + sq[..., 1:2]) + sq[..., 2:3])
        gn = g / (norm + 1e-12)
        cand = pose + steps * gn
        cand = torch.cat([cand[..., :2], wrap_angle(cand[..., 2:])], dim=-1)
        p_new, g_new = at(cand)
        better = p_new > prob
        pose = torch.where(better[..., None], cand, pose)
        prob = torch.where(better, p_new, prob)
        g = torch.where(better[..., None], g_new, g)
        steps = torch.where(better[..., None], steps, steps * shrink)
        trace.append(prob)
    trace = (torch.stack(trace, dim=-1) if trace
             else torch.empty((*prob.shape, 0), dtype=torch.float32, device=dev))
    return pose, prob, trace


def gradient_refine_ref(plane, pts, beam_w, origin, pose, scale, unknown, step_xy, step_theta,
                        iterations, shrink, reducer=BILINEAR):
    """Plain PyTorch version of :func:`gradient_refine`: the loop over
    :func:`overlap_score_grad_ref`."""
    return gradient_refine_loop(overlap_score_grad_ref, plane, pts, beam_w, origin, pose, scale,
                                unknown, step_xy, step_theta, iterations, shrink, reducer)


def gradient_refine_rounds(plane, pts, beam_w, origin, pose, scale, unknown, step_xy,
                           step_theta, iterations, shrink, reducer=BILINEAR):
    """The same refine with :func:`overlap_score_grad` launched once for the
    start pose and once a candidate (``1 + iterations`` launches on the
    card, for one map or all M; one for a ``reducer.flat`` score) and the
    rest of an iteration in PyTorch ops. Nothing on the main path calls it:
    it is what :func:`gradient_refine` is held to, bit for bit, on the
    card."""
    return gradient_refine_loop(overlap_score_grad, plane, pts, beam_w, origin, pose, scale,
                                unknown, step_xy, step_theta, iterations, shrink, reducer)


@functools.cache
def _gradient_refine_fn():
    fn = _build.load().gradient_refine_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plane, m, h, w
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # origin, pose, ...
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # steps, shrink, iterations
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # reducer, radius, extent
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def gradient_refine(plane, pts, beam_w, origin, pose, scale, unknown, step_xy, step_theta,
                    iterations, shrink, reducer=BILINEAR):
    """The gradient matcher's refine of ``pose`` f32[3] on plane f32[H, W]
    (``where(known, occ, unknown)``) with the scan's pts f32[R, 2] and
    beam_w f32[R], a beam read by ``reducer`` -> (pose f32[3], prob f32[],
    trace f32[iterations]): the arithmetic of :func:`gradient_refine_loop`,
    the score with :func:`overlap_score`'s bits. With a leading map
    dimension on plane, pts, beam_w, origin and pose, each of M poses is
    refined on its own map: pose f32[M, 3], prob f32[M], trace f32[M,
    iterations].

    CPU tensors take the plain twin. On CUDA tensors a ``reducer.flat``
    score (gradient 0: no step is taken) is one launch of
    :func:`overlap_score` (or :func:`overlap_score_batched` for M maps) at
    the start pose and a fill; any other launches the kernel once on the
    current stream (a block a map), with the bits of
    :func:`gradient_refine_rounds`, and adds one to the ``gradient_refine``
    count of :func:`launch_counts`. The pose stays on the device: nothing is
    read on the host."""
    lead = tuple(plane.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"gradient_refine: plane has shape {tuple(plane.shape)}, expected "
                         f"(H, W) or (M, H, W)")
    _refine_checks("gradient_refine", lead, plane, pts, beam_w, origin, pose, iterations)
    if plane.device.type == "cpu":
        return gradient_refine_ref(plane, pts, beam_w, origin, pose, scale, unknown, step_xy,
                                   step_theta, iterations, shrink, reducer)
    if reducer.flat:
        score = overlap_score_batched if lead else overlap_score
        return _flat_refine(score, plane, pts, beam_w, origin, pose, scale, unknown, iterations,
                            reducer)
    h, w = plane.shape[-2:]
    n_m = lead[0] if lead else 1
    dev = plane.device
    out_pose = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    out_prob = torch.empty(lead, dtype=torch.float32, device=dev)
    trace = torch.empty((*lead, iterations), dtype=torch.float32, device=dev)
    if n_m == 0:
        return out_pose, out_prob, trace
    fn = _gradient_refine_fn()
    _launch("gradient_refine", dev, lambda stream: fn(
        plane.data_ptr(), n_m, h, w, pts.data_ptr(), beam_w.data_ptr(), pts.shape[-2],
        origin.data_ptr(), pose.data_ptr(), scale, unknown, step_xy, step_theta, shrink,
        iterations, reducer.code, reducer.radius, reducer.extent, out_pose.data_ptr(),
        out_prob.data_ptr(), trace.data_ptr(), stream))
    _count("gradient_refine", reducer)
    return out_pose, out_prob, trace


# --- Monte-Carlo matches -------------------------------------------------------


def mc_match_loop(
    score,
    plane: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
    reducer: Reducer = BILINEAR,
):
    """The match as a Python loop over device tensors with no host sync:
    keep-if-better and the anneal are ``torch.where``. ``score`` has
    ``overlap_score``'s signature and is called, with ``reducer``, once for
    the first pose and once a round. With a leading match dimension on every tensor (plane
    f32[P, H, W], pts f32[P, R, 2], beam_w f32[P, R], origin f32[P, 2],
    init_pose f32[P, 3], noise f32[P, rounds, K, 3]) ``score`` must take it
    too, and every match runs its own state: pose f32[P, 3], prob f32[P],
    trace f32[P, rounds]."""
    dev = init_pose.device
    best_pose = init_pose
    best_prob = score(plane, init_pose[..., None, :].contiguous(), pts, beam_w, origin, scale,
                      unknown, reducer)[..., 0]
    # built from fills: assigning a Python float into a CUDA tensor syncs
    sigma = torch.cat([
        torch.full((2,), sigma_xy, dtype=torch.float32, device=dev),
        torch.full((1,), sigma_theta, dtype=torch.float32, device=dev),
    ])
    bad = torch.zeros(init_pose.shape[:-1], dtype=torch.int32, device=dev)
    trace = []
    for r in range(noise.shape[-3]):
        nz = noise[..., r, :, :] * sigma[..., None, :]
        cand = torch.cat(
            [best_pose[..., None, :2] + nz[..., :2], wrap_angle(best_pose[..., None, 2:] + nz[..., 2:])],
            dim=-1,
        )
        probs = score(plane, cand.contiguous(), pts, beam_w, origin, scale, unknown, reducer)
        # argmax ties go to the first index, as in the reference
        i = torch.argmax(probs, dim=-1, keepdim=True)
        p_i = probs.gather(-1, i)[..., 0]
        better = p_i > best_prob  # strict, and never true for a NaN score
        won = cand.gather(-2, i[..., None].expand(*i.shape, 3))[..., 0, :]
        best_pose = torch.where(better[..., None], won, best_pose)
        best_prob = torch.where(better, p_i, best_prob)
        bad = torch.where(better, 0, bad + 1)
        anneal = bad >= bad_rounds_before_anneal
        sigma = torch.where(anneal[..., None], sigma * 0.5, sigma)
        bad = torch.where(anneal, 0, bad)
        trace.append(p_i)
    if not trace:
        return best_pose, best_prob, torch.empty(
            (*init_pose.shape[:-1], 0), dtype=torch.float32, device=dev)
    return best_pose, best_prob, torch.stack(trace, dim=-1)


def mc_match_ref(
    plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy, sigma_theta,
    bad_rounds_before_anneal, reducer=BILINEAR,
):
    """Plain PyTorch version of :func:`mc_match` and, with a leading match
    dimension on every tensor, of :func:`mc_match_batched`: the round loop
    over ``overlap_score_ref``."""
    return mc_match_loop(
        overlap_score_ref, plane, pts, beam_w, origin, init_pose, noise, scale, unknown,
        sigma_xy, sigma_theta, bad_rounds_before_anneal, reducer,
    )


def mc_match_rounds(
    plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy, sigma_theta,
    bad_rounds_before_anneal, reducer=BILINEAR,
):
    """The same match with :func:`overlap_score` called once for the first
    pose and once a round (``1 + rounds`` launches on the card) and the rest
    of a round in PyTorch ops. Nothing on the main path calls it: it is what
    :func:`mc_match` is held to, bit for bit, on the card."""
    return mc_match_loop(
        overlap_score, plane, pts, beam_w, origin, init_pose, noise, scale, unknown,
        sigma_xy, sigma_theta, bad_rounds_before_anneal, reducer,
    )


@functools.cache
def _mc_match_fn():
    fn = _build.load().mc_match_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # occ, known, occ's cell stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P, the maps' H and W
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # row, col, h, w
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_void_p,  # origin, init_pose
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # noise, rounds, k
        ctypes.c_float, ctypes.c_float,  # scale, unknown
        ctypes.c_float, ctypes.c_float, ctypes.c_int,  # sigma_xy, sigma_theta, bad rounds
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # reducer, radius, extent
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pose, prob, trace
        ctypes.c_int, ctypes.c_void_p,  # dynamic shared bytes, stream
    ]
    fn.restype = ctypes.c_int
    return fn


#: groups (candidates scored at once) a block of the ``mc_match`` kernel,
#: and the most blocks a cluster (mc_match.cu)
_MC_GROUPS, _MC_MAX_CLUSTER_BLOCKS = 8, 8


def _mc_cluster_blocks(k: int) -> int:
    """Blocks of a match's cluster: ceil(K / 8), at least 1, at most 8."""
    return min(_MC_MAX_CLUSTER_BLOCKS, max(1, -(-k // _MC_GROUPS)))


def _mc_match_shared_bytes(r: int, k: int, rounds: int) -> int:
    """Dynamic shared memory a block of the ``mc_match`` kernel asks for:
    the scan (``pts`` and ``beam_w``, 12 B a beam), two buffers of this
    block's scores, 8 a pass, and the noise (12 B a candidate and round)."""
    passes = -(-k // (_MC_GROUPS * _mc_cluster_blocks(k)))
    return 12 * r + 2 * _MC_GROUPS * passes * 4 + 12 * rounds * k


#: what a block of the ``mc_match`` kernel may ask for: Hopper's 227 KB a
#: block less the kernel's static part (per-thread partial sums, 2 x 1024
#: floats, and the replicated match state)
_MC_MAX_DYNAMIC_SHARED_BYTES = 227 * 1024 - (2 * 1024 * 4 + 64)


def _mc_match_launch(name, lead, occ, window, pts, beam_w, origin, init_pose, noise, scale,
                     unknown, sigma_xy, sigma_theta, bad_rounds_before_anneal,
                     reducer=BILINEAR):
    """Checks the inputs against the leading shape ``lead`` (``()`` for one
    match, ``(P,)`` for P: occ f32[*lead, H, W], ..., noise f32[*lead,
    rounds, K, 3]), launches the kernel once and adds one to the count of
    ``name`` (and of its reducer); returns (pose f32[*lead, 3], prob f32[*lead], trace f32[*lead,
    rounds]). ``window`` is None when ``occ`` is the plane itself, else
    (known, row, col, sh, sw): the ``sh x sw`` window at ``row``, ``col``
    of each map ``where(known, occ, unknown)``, read in place."""
    dev = occ.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if occ.dim() != len(lead) + 2 or noise.dim() != len(lead) + 3:
        raise ValueError(f"{name}: plane {tuple(occ.shape)} and noise {tuple(noise.shape)} "
                         f"are not {(*lead, 'H', 'W')} and {(*lead, 'rounds', 'K', 3)}")
    h, w = occ.shape[-2:]
    r = pts.shape[-2]
    rounds, k = noise.shape[-3], noise.shape[-2]
    n_p = lead[0] if lead else 1
    if rounds > 0 and k < 1:
        raise ValueError(f"{name}: a round needs at least one candidate")
    if not 1 <= n_p <= _MAX_MAPS:
        raise ValueError(f"{name}: {n_p} matches, not between 1 and {_MAX_MAPS} a launch")
    shared = _mc_match_shared_bytes(r, k, rounds)
    if shared > _MC_MAX_DYNAMIC_SHARED_BYTES:
        raise ValueError(
            f"{name}: {r} beams and {rounds} rounds of {k} candidates need {shared} B of "
            f"dynamic shared memory, more than {_MC_MAX_DYNAMIC_SHARED_BYTES} B"
        )
    if window is None:
        _check("plane", occ, (*lead, h, w), dev)
        known = row = col = None
        stride, sh, sw = 1, h, w
    else:
        known, row, col, sh, sw = window
        if not (1 <= sh <= h and 1 <= sw <= w):
            raise ValueError(f"{name}: a {sh} x {sw} window of a {h} x {w} map")
        stride = _cell_stride(name, occ, dev)
        _check("known", known, (*lead, h, w), dev, torch.bool)
        _check("row", row, lead, dev, torch.int64)
        _check("col", col, lead, dev, torch.int64)
    _check("pts", pts, (*lead, r, 2), dev)
    _check("beam_w", beam_w, (*lead, r), dev)
    _check("origin", origin, (*lead, 2), dev)
    _check("init_pose", init_pose, (*lead, 3), dev)
    _check("noise", noise, (*lead, rounds, k, 3), dev)
    pose = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    prob = torch.empty(lead, dtype=torch.float32, device=dev)
    trace = torch.empty((*lead, rounds), dtype=torch.float32, device=dev)
    fn = _mc_match_fn()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            occ.data_ptr(), ptr(known), stride, n_p, h, w, ptr(row), ptr(col), sh, sw,
            pts.data_ptr(), beam_w.data_ptr(), r, origin.data_ptr(), init_pose.data_ptr(),
            noise.data_ptr(), rounds, k, scale, unknown, sigma_xy, sigma_theta,
            bad_rounds_before_anneal, reducer.code, reducer.radius, reducer.extent,
            pose.data_ptr(), prob.data_ptr(), trace.data_ptr(), shared, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _count(name, reducer)
    return pose, prob, trace


def mc_match(
    plane: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
    reducer: Reducer = BILINEAR,
):
    """One Monte-Carlo match -> (pose f32[3], prob f32[], trace f32[rounds]).

    plane f32[H, W] (``where(known, occ, unknown)``), pts f32[R, 2], beam_w
    f32[R], origin f32[2], init_pose f32[3], noise f32[rounds, K, 3]
    standard normals. Round r scores the K candidates ``best + noise[r] *
    sigma`` (theta wrapped), takes the best (ties to the first), keeps it if
    it is strictly better, and halves sigma after
    ``bad_rounds_before_anneal`` rounds without improvement. A beam's
    endpoint is read by ``reducer``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once (the P = 1 case of :func:`mc_match_batched`'s
    kernel, with the same bits), and add one to the ``mc_match`` count of
    :func:`launch_counts`.
    """
    args = (plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
            sigma_theta, bad_rounds_before_anneal, reducer)
    if plane.device.type == "cpu":
        return mc_match_ref(*args)
    return _mc_match_launch("mc_match", (), plane, None, *args[1:])


def mc_match_batched(
    plane: Tensor,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
    reducer: Reducer = BILINEAR,
):
    """P Monte-Carlo matches, each on its own plane with its own scan,
    origin, prior and noise, in one launch -> (pose f32[P, 3], prob f32[P],
    trace f32[P, rounds]).

    plane f32[P, H, W], pts f32[P, R, 2], beam_w f32[P, R], origin f32[P,
    2], init_pose f32[P, 3], noise f32[P, rounds, K, 3]: match p gives the
    bits of :func:`mc_match` on the p-th slices. The RBPF's particles, one
    scan matched against each particle's window cut out (the improved
    proposal and the gate) or whole map.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for all P, a cluster a match, and add one to the
    ``mc_match_batched`` count of :func:`launch_counts`.
    """
    args = (plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
            sigma_theta, bad_rounds_before_anneal, reducer)
    if plane.dim() != 3:
        raise ValueError(f"plane has shape {tuple(plane.shape)}, expected (P, H, W)")
    if plane.device.type == "cpu":
        return mc_match_ref(*args)
    return _mc_match_launch("mc_match_batched", (plane.shape[0],), plane, None, *args[1:])


def mc_match_windows_ref(occ, known, row, col, sh, sw, pts, beam_w, origin, init_pose, noise,
                         scale, unknown, sigma_xy, sigma_theta, bad_rounds_before_anneal,
                         reducer=BILINEAR):
    """Plain PyTorch version of :func:`mc_match_windows`: the windows cut
    out (``grid.take_window``), ``where(known, occ, unknown)``, then
    :func:`mc_match_ref`."""
    plane = torch.where(gridlib.take_window(known, row, col, sh, sw),
                        gridlib.take_window(occ, row, col, sh, sw), unknown)
    return mc_match_ref(plane, pts, beam_w, origin, init_pose, noise, scale, unknown, sigma_xy,
                        sigma_theta, bad_rounds_before_anneal, reducer)


def mc_match_windows(
    occ: Tensor,
    known: Tensor,
    row: Tensor,
    col: Tensor,
    sh: int,
    sw: int,
    pts: Tensor,
    beam_w: Tensor,
    origin: Tensor,
    init_pose: Tensor,
    noise: Tensor,
    scale: float,
    unknown: float,
    sigma_xy: float,
    sigma_theta: float,
    bad_rounds_before_anneal: int,
    reducer: Reducer = BILINEAR,
):
    """P Monte-Carlo matches, each on an ``sh x sw`` window of its own map
    read in place -> (pose f32[P, 3], prob f32[P], trace f32[P, rounds]).

    occ f32[P, H, W] (contiguous, or a channel of contiguous cells), known
    bool[P, H, W], row, col i64[P] (the window's first cell, as
    ``grid.window_corner`` gives it), origin f32[P, 2] (the window's world
    origin); pts, beam_w, init_pose and noise as for
    :func:`mc_match_batched`. Match p gives the bits of
    :func:`mc_match_batched` on the cut-out plane ``where(known, occ,
    unknown)[p, row:row + sh, col:col + sw]``, without the cut.

    CPU tensors take the plain twin :func:`mc_match_windows_ref`; CUDA
    tensors launch the kernel of :func:`mc_match_batched` on the current
    stream, once for all P, its taps reading each window in place, and add
    one to the ``mc_match_batched`` count of :func:`launch_counts` (the same
    kernel).
    """
    args = (occ, known, row, col, sh, sw, pts, beam_w, origin, init_pose, noise, scale, unknown,
            sigma_xy, sigma_theta, bad_rounds_before_anneal, reducer)
    if occ.device.type == "cpu":
        return mc_match_windows_ref(*args)
    if occ.dim() != 3:
        raise ValueError(f"occ has shape {tuple(occ.shape)}, expected (P, H, W)")
    return _mc_match_launch("mc_match_batched", (occ.shape[0],), occ, (known, row, col, sh, sw),
                            *args[6:])


# --- polar free-space fill ----------------------------------------------------


def polar_range_table(ranges: Tensor, valid: Tensor, bearings: Tensor):
    """(rng_eff f32[R], db f32[], full_circle bool[]) of one scan: the
    conservative range of each bearing bin, the bearing spacing, and whether
    the scan goes round the circle. No cell further than ``max(rng_eff)``
    from the sensor can be free."""
    r = ranges.shape[0]
    b0 = bearings[0]
    db = (bearings[-1] - b0) / torch.full_like(b0, float(max(r - 1, 1)))
    db = torch.where(torch.abs(db) < 1e-6, 1.0, db)
    full_circle = torch.abs(db) * r >= 2.0 * math.pi - 1.5 * torch.abs(db)
    # conservative range per bin: min over the beam and its neighbours.
    # Invalid beams give no free evidence themselves (0) but do not cut
    # their neighbours' sectors short (inf).
    rng_inf = torch.where(valid, ranges, math.inf)
    prev_r = torch.where(
        full_circle, torch.roll(rng_inf, 1), torch.cat([rng_inf[:1], rng_inf[:-1]])
    )
    next_r = torch.where(
        full_circle, torch.roll(rng_inf, -1), torch.cat([rng_inf[1:], rng_inf[-1:]])
    )
    rng_eff = torch.where(valid, torch.minimum(ranges, torch.minimum(prev_r, next_r)), 0.0)
    return rng_eff, db, full_circle


def polar_free_plane_ref(
    ranges: Tensor,
    valid: Tensor,
    bearings: Tensor,
    pose: Tensor,
    origin: Tensor,
    h: int,
    w: int,
    scale: float,
    hole_half: float,
    max_range: float,
) -> Tensor:
    """Plain PyTorch version of the kernel, with the same arithmetic in the
    reference's order.

    ranges f32[R], valid bool[R], bearings f32[R] (uniformly spaced), pose
    f32[3], origin f32[2] -> f32[H, W]: for every cell the expected number
    of beams crossing it, ``2 atan(scale / 2d) / spacing``, where the cell
    lies closer than ``min(range of its beam and the two neighbours) -
    hole_half`` and ``max_range`` and inside the field of view, else 0.
    Nothing of the scan is read on the host.

    The two divisions that involve a Python scalar are written tensor by
    tensor: PyTorch turns ``tensor / scalar`` into a product with the
    scalar's reciprocal on the card and ``scalar / tensor`` into
    ``reciprocal * scalar`` everywhere, one rounding more than the IEEE
    division that the reference and the kernel do.
    """
    dev = ranges.device
    r = ranges.shape[0]
    ys = origin[1] + (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * scale
    xs = origin[0] + (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * scale
    dy = ys[:, None] - pose[1]  # [H, 1]
    dx = xs[None, :] - pose[0]  # [1, W]
    d = torch.sqrt(dx * dx + dy * dy)  # [H, W]
    ang = torch.atan2(dy, dx) - pose[2]
    rng_eff, db, full_circle = polar_range_table(ranges, valid, bearings)
    binf = wrap_angle(ang - bearings[0]) / db
    bini = torch.round(binf).to(torch.int64)  # half to even, as jnp.round
    in_fov = (bini >= 0) & (bini <= r - 1)
    ok = in_fov | full_circle
    # remainder takes the divisor's sign: never negative
    bini = torch.where(full_circle, torch.remainder(bini, r), torch.clamp(bini, 0, r - 1))
    cell_range = rng_eff[bini]
    free = ok & (d < cell_range - hole_half) & (d < max_range)
    den = 2.0 * torch.clamp(d, min=scale * 0.5)
    wgt = 2.0 * torch.atan(torch.full_like(den, scale) / den) / torch.abs(db)
    return torch.where(free, wgt, 0.0)


@functools.cache
def _polar_free_fn():
    fn = _build.load().polar_free_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # ranges, valid, bearings, r
        ctypes.c_void_p, ctypes.c_void_p,  # pose, origin
        ctypes.c_int, ctypes.c_int,  # h, w
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # scale, hole_half, max_range
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def polar_free_plane(
    ranges: Tensor,
    valid: Tensor,
    bearings: Tensor,
    pose: Tensor,
    origin: Tensor,
    h: int,
    w: int,
    scale: float,
    hole_half: float,
    max_range: float,
) -> Tensor:
    """Dense polar free-space weights f32[H, W] of one scan seen from
    ``pose`` (see :func:`polar_free_plane_ref`).

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to the ``polar_free_plane`` count of
    :func:`launch_counts`.
    """
    if ranges.device.type == "cpu":
        return polar_free_plane_ref(
            ranges, valid, bearings, pose, origin, h, w, scale, hole_half, max_range
        )
    dev = ranges.device
    if dev.type != "cuda":
        raise ValueError(f"polar_free_plane: unsupported device {dev}")
    r = ranges.shape[0]
    if r < 1 or h < 1 or w < 1:
        raise ValueError(f"polar_free_plane: empty scan or plane (R={r}, H={h}, W={w})")
    # the range table, its maximum, and 32 B of static shared memory
    shared = (r + 1) * 4 + 32
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(
            f"polar_free_plane: {r} beams need {shared} B of shared memory, "
            f"more than {_MAX_SHARED_BYTES} B"
        )
    _check("ranges", ranges, (r,), dev)
    _check("valid", valid, (r,), dev, torch.bool)
    _check("bearings", bearings, (r,), dev)
    _check("pose", pose, (3,), dev)
    _check("origin", origin, (2,), dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    fn = _polar_free_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            ranges.data_ptr(), valid.data_ptr(), bearings.data_ptr(), r,
            pose.data_ptr(), origin.data_ptr(), h, w, scale, hole_half, max_range,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"polar_free_plane kernel launch failed: cudaError_t {err}")
    _LAUNCHES["polar_free_plane"] += 1
    return out


# --- K3: the scan insert with its cell fold, and the shared-plane rasteriser --

#: the cell models the fold kernel runs, by its codes (scan_insert.cu)
_CELL_MODEL_CODES = {cells.BayesBaseCell: 0, cells.BayesAvgCell: 1, cells.TBMCell: 2}

#: a band's rows for every K3 launch (0: the kernel chooses from the shape);
#: a measurement script may set it to compare band heights
_BAND_ROWS = 0


def scan_insert_ref(gm, model, pose: Tensor, scan, cfg, q: Tensor | None = None,
                    window: int = 0) -> Tensor:
    """Plain PyTorch version of :func:`scan_insert`: the rasterisation
    (``raycast.scan_observation_planes``, or :func:`scan_planes_ref` on
    the P windows) scaled by ``q``, then ``grid.apply_observations``;
    returns the new cells. On the card it sums the occupied evidence with
    ``index_put_``, whose order within a long run of one cell is the card's
    (PERF.md); the kernel sums in sample order."""
    from . import raycast

    if gm.cells.dim() == 3:
        w_obs, s_obs = raycast.scan_observation_planes(gm, pose, scan, cfg)
        if q is not None:
            w_obs, s_obs = q * w_obs, q * s_obs
        return gridlib.apply_observations(gm, model, w_obs, s_obs).cells
    h, w = gm.height, gm.width
    sh, sw = (min(window, h, w),) * 2 if window else (h, w)
    row, col, origin = gridlib.window_corner(gm.origin, pose[:, :2], gm.scale, sh, sw, h, w)
    sub = gridlib.GridMap(cells=gridlib.take_window(gm.cells, row, col, sh, sw), origin=origin,
                          scale=gm.scale)
    w_obs, s_obs = scan_planes_ref(origin, sh, sw, gm.scale, pose, scan, cfg)
    if q is not None:
        w_obs, s_obs = q * w_obs, q * s_obs
    sub = gridlib.apply_observations(sub, model, w_obs, s_obs)
    return gridlib.put_window(gm.cells, sub.cells, row, col)


def _insert_frames(gm, pose: Tensor, scan, window: int):
    """(sh, sw, origins [P, 2], poses [P, 3], scans) of an insert: one map
    as P = 1, or each map's window (its own origin)."""
    h, w = gm.height, gm.width
    if gm.cells.dim() == 3:
        return h, w, gm.origin[None], pose[None], [scan]
    sh, sw = (min(window, h, w),) * 2 if window else (h, w)
    origins = gridlib.window_corner(gm.origin, pose[:, :2], gm.scale, sh, sw, h, w)[2]
    return sh, sw, origins, pose, [scan[p] for p in range(pose.shape[0])]


def _ordered_planes(origins, sh: int, sw: int, scale: float, poses, scans, cfg, plane_ids,
                    n_planes: int, w_free=None):
    """(w_obs, s_obs) f32[n_planes, sh, sw] numpy: each scan's samples
    (``raycast.scan_sample_cells`` on the poses' device) added to its plane
    ``plane_ids[i]`` with ``np.add.at`` (unbuffered, one after the other),
    scan after scan: the free trace's counts (unless ``w_free``, the polar
    fill, is given), then the occupied evidence in sample order."""
    from . import raycast

    free_given = w_free is not None
    if not free_given:
        w_free = np.zeros((n_planes, sh, sw), np.float32)
    w_occ, s_occ = np.zeros((2, n_planes, sh, sw), np.float32)
    for origin, p, sc, plane in zip(origins, poses, scans, plane_ids):
        rows, cols, w_s, s_s = (t.cpu().numpy() for t in raycast.scan_sample_cells(
            origin, scale, p, sc, cfg))
        n_free = sc.ranges.shape[0] * cfg.n_free_samples(scale)
        on = (rows >= 0) & (rows < sh) & (cols >= 0) & (cols < sw)
        free, occ = on.copy(), on.copy()
        free[n_free:], occ[:n_free] = False, False
        if not free_given:
            np.add.at(w_free[plane], (rows[free], cols[free]), w_s[free])
        np.add.at(w_occ[plane], (rows[occ], cols[occ]), w_s[occ])
        np.add.at(s_occ[plane], (rows[occ], cols[occ]), s_s[occ])
    return w_free + w_occ, s_occ


def scan_insert_ordered(gm, model, pose: Tensor, scan, cfg, q: Tensor | None = None,
                        window: int = 0) -> Tensor:
    """:func:`scan_insert` with the planes summed on the host: each map's
    samples (``raycast.scan_sample_cells`` on the map's device, the free
    trace's counts then the occupied evidence, in sample order) added with
    ``np.add.at`` (unbuffered, one after the other), the polar fill from
    :func:`polar_free_plane`, then ``q`` and ``grid.apply_observations`` on
    the device. The yardstick the kernel is held to bit for bit; it reads
    the samples back to the host, so nothing on a main path calls it."""
    dev, single = gm.cells.device, gm.cells.dim() == 3
    sh, sw, origins, poses, scans = _insert_frames(gm, pose, scan, window)
    w_free = None
    if cfg.free_impl == "polar":
        w_free = np.stack([polar_free_plane(
            sc.ranges.contiguous(), sc.valid.contiguous(), sc.bearings.contiguous(),
            p.contiguous(), origin.contiguous(), sh, sw, gm.scale, cfg.hole_width / 2.0,
            cfg.max_range).cpu().numpy() for origin, p, sc in zip(origins, poses, scans)])
    w_np, s_np = _ordered_planes(origins, sh, sw, gm.scale, poses, scans, cfg,
                                 range(len(scans)), len(scans), w_free)
    w_obs, s_obs = torch.from_numpy(w_np).to(dev), torch.from_numpy(s_np).to(dev)
    if q is not None:
        w_obs, s_obs = q * w_obs, q * s_obs
    if single:
        return gridlib.apply_observations(gm, model, w_obs[0], s_obs[0]).cells
    h, w = gm.height, gm.width
    row, col, _ = gridlib.window_corner(gm.origin, pose[:, :2], gm.scale, sh, sw, h, w)
    sub = gridlib.GridMap(cells=gridlib.take_window(gm.cells, row, col, sh, sw), origin=origins,
                          scale=gm.scale)
    sub = gridlib.apply_observations(sub, model, w_obs, s_obs)
    return gridlib.put_window(gm.cells, sub.cells, row, col)


def _occupied_valid(sc, cfg, w_s):
    """The twin's validity of a scan's occupied samples (``scan_sample_cells``'
    list past the free trace): an endpoint sample's weight is > 0 where it
    is valid; a blur sample is valid where its beam carries evidence, before
    the tail."""
    valid = w_s > 0
    if cfg.wall_blur:
        ep = sc.valid & (sc.ranges <= cfg.max_range)
        tb = sc.ranges[:, None] + cfg.hole_width / 2.0 * _blur_table(
            cfg.blur_samples, sc.ranges.device)[0]
        valid[-tb.numel():] = (ep[:, None] & (tb > 0)).reshape(-1)
    return valid


def scan_insert_runs(gm, pose: Tensor, scan, cfg, window: int = 0) -> Tensor:
    """How many samples of the twin's occupied-evidence list
    (``index_put_``'s indices in :func:`scan_insert_ref`) each cell of each
    map's window gets: the valid ones on the window in their cells, the
    others in cell 0; i64[P, sh, sw] (P = 1 for one map). The card's
    ``index_put_`` sums a run of 32 or more by a warp, in another order than
    the kernel's (PERF.md), so these are the cells where the two may part."""
    from . import raycast

    sh, sw, origins, poses, scans = _insert_frames(gm, pose, scan, window)
    runs = []
    for origin, p, sc in zip(origins, poses, scans):
        rows, cols, w_s, _ = raycast.scan_sample_cells(origin, gm.scale, p, sc, cfg)
        n_free = sc.ranges.shape[0] * cfg.n_free_samples(gm.scale)
        rows, cols, w_s = rows[n_free:], cols[n_free:], w_s[n_free:]
        ok = (_occupied_valid(sc, cfg, w_s) & (rows >= 0) & (rows < sh) & (cols >= 0)
              & (cols < sw))
        runs.append(torch.bincount(torch.where(ok, rows * sw + cols, 0),
                                   minlength=sh * sw).reshape(sh, sw))
    return torch.stack(runs)


def _plane_args(origins: Tensor, poses: Tensor, plane_of, n_planes):
    """(origins [N, 2], plane_of i64[N], n_planes) with the defaults filled
    in: one origin for every scan, a plane a scan."""
    n = poses.shape[0]
    if plane_of is None:
        plane_of, n_planes = torch.arange(n, device=poses.device), n
    elif n_planes is None:
        raise ValueError("scan_planes: plane_of needs n_planes")
    if origins.dim() == 1:
        origins = origins[None, :].expand(n, 2)
    return origins, plane_of, n_planes


def _polar_planes(origins: Tensor, h: int, w: int, scale: float, poses: Tensor, scans, cfg,
                  plane_of: Tensor, n_planes: int) -> Tensor:
    """The polar fill of N scans summed into their planes: one
    :func:`polar_free_plane` launch a scan, then ``index_add_`` (one scan a
    plane: each plane the scan's own bits)."""
    n = poses.shape[0]
    dev = poses.device
    planes = torch.stack([
        polar_free_plane(scans.ranges[i].contiguous(), scans.valid[i].contiguous(),
                         scans.bearings[i].contiguous(), poses[i].contiguous(),
                         origins[i].contiguous(), h, w, scale, cfg.hole_width / 2.0,
                         cfg.max_range)
        for i in range(n)
    ]) if n else torch.zeros((0, h, w), dtype=torch.float32, device=dev)
    w_free = torch.zeros((n_planes, h, w), dtype=torch.float32, device=dev)
    return w_free.index_add_(0, plane_of, planes)


def scan_planes_ref(origins: Tensor, h: int, w: int, scale: float, poses: Tensor, scans, cfg,
                    plane_of: Tensor | None = None, n_planes: int | None = None):
    """Plain PyTorch version of :func:`scan_planes`: the free trace counted
    with ``scatter_add_`` (or the polar fill), the occupied evidence added
    on flat indices with ``index_put_(accumulate=True)``, scan-major (each
    scan's samples in ``raycast.scan_observation_planes``' order), the
    planes stacked along the rows."""
    from . import raycast

    dev = poses.device
    n = poses.shape[0]
    origins, plane_of, n_planes = _plane_args(origins, poses, plane_of, n_planes)
    angles = poses[:, 2:3] + scans.bearings  # [N, R]
    dirs = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)  # [N, R, 2]
    start = poses[:, None, :2]  # [N, 1, 2]
    # the planes are stacked along the rows: plane p holds rows p*h .. p*h + h - 1
    shape = (n_planes * h, w)
    row0 = plane_of * h  # [N]

    def on_map(rows, cols):
        return (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)

    if cfg.free_impl == "polar":
        w_free = _polar_planes(origins, h, w, scale, poses, scans, cfg, plane_of,
                               n_planes).reshape(shape)
    else:
        n_s = cfg.n_free_samples(scale)
        step = scale * cfg.step_fraction
        t = (torch.arange(n_s, dtype=torch.float32, device=dev) + 0.5) * step  # [S]
        pts = start[:, :, None, :] + t[None, None, :, None] * dirs[:, :, None, :]  # [N, R, S, 2]
        rows, cols = raycast._cells_of(pts, origins[:, None, None, :], scale)  # [N, R, S]
        free_limit = scans.ranges - cfg.hole_width / 2.0
        valid = scans.valid[..., None] & (t < free_limit[..., None])
        same = (rows[..., 1:] == rows[..., :-1]) & (cols[..., 1:] == cols[..., :-1])
        first = torch.ones((*rows.shape[:2], 1), dtype=torch.bool, device=dev)
        valid = valid & torch.cat([first, ~same], dim=-1) & on_map(rows, cols)
        w_free = raycast._flat_count(shape, rows + row0[:, None, None], cols, valid)

    ep_valid = scans.valid & (scans.ranges <= cfg.max_range)
    endpoints = start + scans.ranges[..., None] * dirs  # [N, R, 2]
    o3 = origins[:, None, :]
    if cfg.occupancy_estimator == "area":
        r9, c9, wgt = raycast._endpoint_area_obs(o3, scale, endpoints, ep_valid, cfg.hole_width)
        occ = [(r9, c9, wgt, wgt, wgt > 0)]
    else:
        er, ec = raycast._cells_of(endpoints, o3, scale)
        ones = torch.ones(er.shape, device=dev)
        occ = [(er, ec, ones, ones, ep_valid)]
    if cfg.wall_blur:
        bt = linspace(-1.0, 1.0, cfg.blur_samples, dev)  # [B] in hole units
        tb = scans.ranges[..., None] + cfg.hole_width / 2.0 * bt  # [N, R, B]
        pb = start[:, :, None, :] + tb[..., None] * dirs[:, :, None, :]
        br, bc = raycast._cells_of(pb, origins[:, None, None, :], scale)
        ramp = (1.0 - torch.abs(bt)).expand(tb.shape)
        occ.append((br, bc, ramp, ramp**2, ep_valid[..., None] & (tb > 0)))

    def flat(parts):  # scan-major, as the single-scan rasteriser orders its samples
        return torch.cat([p.reshape(n, -1) for p in parts], dim=1)

    rows_a = flat([o[0] for o in occ])
    cols_a = flat([o[1] for o in occ])
    v_a = flat([o[4] for o in occ]) & on_map(rows_a, cols_a)
    rows_a = rows_a + row0[:, None]
    w_occ = raycast._flat_scatter_add(shape, rows_a, cols_a, flat([o[2] for o in occ]), v_a)
    s_occ = raycast._flat_scatter_add(shape, rows_a, cols_a, flat([o[3] for o in occ]), v_a)
    return (w_free + w_occ).reshape(n_planes, h, w), s_occ.reshape(n_planes, h, w)


def scan_planes_ordered(origins: Tensor, h: int, w: int, scale: float, poses: Tensor, scans,
                        cfg, plane_of: Tensor | None = None, n_planes: int | None = None):
    """:func:`scan_planes` with each plane's samples summed on the host:
    scan after scan in increasing index among those of the plane, each
    scan's free counts and occupied evidence in sample order, with
    ``np.add.at`` (as :func:`scan_insert_ordered`); the polar fill as the
    wrapper sums it. The yardstick the kernel is held to bit for bit;
    nothing on a main path calls it."""
    dev = poses.device
    origins, plane_of, n_planes = _plane_args(origins, poses, plane_of, n_planes)
    w_free = None
    if cfg.free_impl == "polar":
        w_free = _polar_planes(origins, h, w, scale, poses, scans, cfg, plane_of,
                               n_planes).cpu().numpy()
    scan_list = [scans[i] for i in range(poses.shape[0])]
    w_np, s_np = _ordered_planes(origins, h, w, scale, poses, scan_list, cfg,
                                 plane_of.cpu().tolist(), n_planes, w_free)
    return torch.from_numpy(w_np).to(dev), torch.from_numpy(s_np).to(dev)


def scan_planes_runs(origins: Tensor, h: int, w: int, scale: float, poses: Tensor, scans, cfg,
                     plane_of: Tensor | None = None, n_planes: int | None = None) -> Tensor:
    """How many samples of :func:`scan_planes_ref`'s occupied-evidence list
    each cell of each plane gets: i64[n_planes, h, w], the valid ones on a
    plane in their cells, every other one in plane 0's cell 0 (the twin's
    flat index 0). The cells whose run is 32 or more are where the card's
    ``index_put_`` may sum in another order than the kernel."""
    from . import raycast

    origins, plane_of, n_planes = _plane_args(origins, poses, plane_of, n_planes)
    lin = []
    for i in range(poses.shape[0]):
        sc = scans[i]
        rows, cols, w_s, _ = raycast.scan_sample_cells(origins[i], scale, poses[i], sc, cfg)
        n_free = sc.ranges.shape[0] * cfg.n_free_samples(scale)
        rows, cols, w_s = rows[n_free:], cols[n_free:], w_s[n_free:]
        ok = (_occupied_valid(sc, cfg, w_s) & (rows >= 0) & (rows < h) & (cols >= 0)
              & (cols < w))
        lin.append(torch.where(ok, (plane_of[i] * h + rows) * w + cols, 0))
    flat = torch.cat(lin) if lin else torch.zeros((0,), dtype=torch.int64, device=poses.device)
    return torch.bincount(flat, minlength=n_planes * h * w).reshape(n_planes, h, w)


@functools.lru_cache(maxsize=None)
def _blur_table(b: int, device: torch.device) -> Tensor:
    """f32[3, B]: the wall blur's offsets ``bt`` (in hole units), its ramp
    ``1 - |bt|`` and the ramp squared, made on ``device`` by the twin's own
    ops, once a process."""
    bt = linspace(-1.0, 1.0, b, device)
    ramp = 1.0 - torch.abs(bt)
    return torch.stack([bt, ramp, ramp**2])


def _scan_rows(who: str, name: str, t: Tensor, lead: tuple, r: int, dev,
               dtype=torch.float32):
    """``t`` [R] or [N, R] as the kernel reads it, and the elements from one
    scan's row to the next (0 where a row is broadcast)."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != (*lead, r):
        raise ValueError(f"{who}: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"expected {dtype} {(*lead, r)} on {dev}")
    if lead and (t.stride(-1) != 1 or t.stride(0) not in (0, r)):
        t = t.contiguous()
    elif not lead and t.stride(-1) != 1:
        t = t.contiguous()
    return t, (t.stride(0) if lead else 0)


def _scan_args(who: str, scan, lead: tuple, dev, cfg, scale: float):
    """The scan's rows and the beam configuration's numbers as both K3
    entry points take them: (ranges, its stride, bearings, its stride,
    valid, its stride, R, n_free, step, hole/2, max_range, area, B, blur
    table or None)."""
    r = scan.ranges.shape[-1]
    if r < 1:
        raise ValueError(f"{who}: a scan without beams")
    ranges, r_stride = _scan_rows(who, "ranges", scan.ranges, lead, r, dev)
    bearings, b_stride = _scan_rows(who, "bearings", scan.bearings, lead, r, dev)
    valid, v_stride = _scan_rows(who, "valid", scan.valid, lead, r, dev, torch.bool)
    blur = cfg.blur_samples if cfg.wall_blur else 0
    table = _blur_table(blur, dev) if blur else None
    return (ranges, r_stride, bearings, b_stride, valid, v_stride, r,
            cfg.n_free_samples(scale), scale * cfg.step_fraction, cfg.hole_width / 2.0,
            cfg.max_range, int(cfg.occupancy_estimator == "area"), blur, table)


def _ptr(t):
    return None if t is None else t.data_ptr()


#: the scan's arguments of both entry points: pose, ranges, bearings, valid
#: (each with its row stride), r, n_free, step, hole_half, max_range, area,
#: blur, blur table, free plane
_SCAN_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _scan_insert_fn():
    fn = _build.load().scan_insert_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, p, i, i, i, i,  # cells, out, p, h, w, c
        i, p, i, i, f, f,  # windowed, origin, sh, sw, scale, scale^2
        *_SCAN_ARGTYPES,
        p, i, f, f, f, f, f,  # q, model, quality, base, decay, keep, eps
        i, p,  # rows, stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scan_planes_fn():
    fn = _build.load().scan_planes_launch
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [
        p, p, i, i, i,  # w_out, s_out, n_planes, sh, sw
        p, ll, f, f, i, p,  # origin, its stride, scale, scale^2, n_scans, plane_of
        *_SCAN_ARGTYPES,
        i, p,  # rows, stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _band_rows_fn():
    fn = _build.load().scan_insert_band_rows
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


def band_rows(p: int, sh: int, sw: int, c: int) -> int:
    """The rows of a band that K3 takes for P maps (planes: ``c`` 0) of
    ``sh x sw`` cells of ``c`` channels (the kernel's own choice)."""
    return _BAND_ROWS or _band_rows_fn()(p, sh, sw, c)


def scan_insert(gm, model, pose: Tensor, scan, cfg, q: Tensor | None = None,
                window: int = 0) -> Tensor:
    """K3: insert a scan seen from ``pose`` into the map and fold it into
    the cells (``raycast.BeamConfig`` ``cfg``, one of ``cells.CELL_MODELS``);
    returns the new cells, a fresh tensor.

    One map: ``gm.cells`` f32[H, W, C], ``pose`` f32[3], ``scan`` [R]. P
    maps: f32[P, H, W, C] with ``gm.origin`` f32[P, 2], ``pose`` f32[P, 3],
    ``scan`` [P, R] (rows may be broadcast), each scan inserted into its own
    map on the ``window x window`` window around its pose (clamped into the
    map; 0: the whole map), read and written in place; the cells outside
    the windows are copied. ``q`` f32[] scales the observation (the
    engine's gate times the scan's quality); None is 1.

    CPU tensors take the plain twin :func:`scan_insert_ref`. CUDA tensors
    launch ``csrc/scan_insert.cu`` on the current stream (one launch: the
    rasterisation with the occupied evidence summed in sample order and the
    fold, a block a band of a window's rows; with ``free_impl='polar'``
    after one ``polar_free_plane`` launch a map) and add one to the
    ``scan_insert`` count of :func:`launch_counts`. Nothing is read on the
    host, and any number of beams is taken.
    """
    cells_in = gm.cells
    if cells_in.device.type == "cpu":
        return scan_insert_ref(gm, model, pose, scan, cfg, q, window)
    dev = cells_in.device
    if dev.type != "cuda":
        raise ValueError(f"scan_insert: unsupported device {dev}")
    code = _CELL_MODEL_CODES.get(type(model))
    if code is None:
        raise ValueError(f"scan_insert: no fold for the cell model {type(model).__name__}")
    single = cells_in.dim() == 3
    if cells_in.dim() not in (3, 4):
        raise ValueError(f"scan_insert: cells {tuple(cells_in.shape)} are not (H, W, C) or "
                         f"(P, H, W, C)")
    lead = () if single else (cells_in.shape[0],)
    n_p = 1 if single else lead[0]
    h, w, c = cells_in.shape[-3:]
    if c != model.n_channels + 1:
        raise ValueError(f"scan_insert: {c} channels, {type(model).__name__} stores "
                         f"{model.n_channels + 1}")
    if not 1 <= n_p <= _MAX_MAPS:
        raise ValueError(f"scan_insert: {n_p} maps, not between 1 and {_MAX_MAPS} a launch")
    cells_in, pose, map_origin = (t if t.is_contiguous() else t.contiguous()
                                  for t in (cells_in, pose, gm.origin))
    _check("cells", cells_in, tuple(cells_in.shape), dev)
    if cells_in.data_ptr() % 16:  # the band's cells move in 16-byte runs
        cells_in = cells_in.clone()
    _check("pose", pose, (*lead, 3), dev)
    _check("origin", map_origin, (*lead, 2), dev)
    args = _scan_args("scan_insert", scan, lead, dev, cfg, gm.scale)
    # the kernel finds each window's corner itself (grid.window_corner's
    # arithmetic); the polar fill needs the windows' origins here
    sh, sw = (min(window, h, w),) * 2 if window and not single else (h, w)
    free_plane = None
    if cfg.free_impl == "polar":
        ranges, bearings, valid = args[0], args[2], args[4]
        origin = map_origin if single else gridlib.window_corner(
            map_origin, pose[:, :2], gm.scale, sh, sw, h, w)[2]
        planes = [polar_free_plane(
            ranges[i] if lead else ranges, valid[i] if lead else valid,
            bearings[i] if lead else bearings, pose[i] if lead else pose,
            origin[i] if lead else origin, sh, sw, gm.scale, cfg.hole_width / 2.0, cfg.max_range)
            for i in range(n_p)]
        free_plane = planes[0] if single else torch.stack(planes)
    if q is not None and not isinstance(q, Tensor):
        q = torch.full((), float(q), dtype=torch.float32, device=dev)
    if q is not None:
        _check("q", q, (), dev)
    out = torch.empty_like(cells_in)
    quality = getattr(model, "quality", 0.0)
    decay = getattr(model, "conflict_decay", 0.0)
    fn = _scan_insert_fn()
    _launch("scan_insert", dev, lambda stream: fn(
        cells_in.data_ptr(), out.data_ptr(), n_p, h, w, c, int(not single),
        map_origin.data_ptr(), sh, sw, gm.scale, gm.scale * gm.scale, pose.data_ptr(),
        *(_ptr(a) if isinstance(a, Tensor) or a is None else a for a in args),
        _ptr(free_plane), _ptr(q), code, quality, 1.0 - quality, decay, 1.0 - decay, cells._EPS,
        _BAND_ROWS, stream))
    _LAUNCHES["scan_insert"] += 1
    return out


def scan_planes(origins: Tensor, h: int, w: int, scale: float, poses: Tensor, scans, cfg,
                plane_of: Tensor | None = None, n_planes: int | None = None):
    """K3 without the fold: rasterise N scans (``scans`` [N, R], rows may
    be broadcast) from ``poses`` f32[N, 3] into ``h x w`` planes at
    ``scale``: ``(w_obs, s_obs)`` f32[P, H, W] each, ``w_obs`` the free
    counts (or polar fill) plus the occupied weight, ``s_obs`` the occupied
    sum, what ``grid.apply_observations`` folds.

    ``origins`` f32[N, 2] is the world corner of the plane each scan goes
    into (f32[2]: one for all). ``plane_of`` i64[N] names the plane, of
    ``n_planes``, that a scan's evidence is added to (read on the device,
    in any order); by default every scan has its own (P = N). A plane's
    occupied samples are summed in scan-major sample order (scan i before
    scan i + 1, each scan's in ``raycast.scan_observation_planes``' order),
    the free counts are integers (exact in any order).

    CPU tensors take the plain twin :func:`scan_planes_ref`. CUDA tensors
    launch ``csrc/scan_insert.cu`` once on the current stream (with
    ``free_impl='polar'`` after one ``polar_free_plane`` launch a scan and
    an ``index_add_``) and add one to the ``scan_planes`` count. Nothing is
    read on the host, and a plane takes any number of samples.
    """
    dev = poses.device
    if dev.type == "cpu":
        return scan_planes_ref(origins, h, w, scale, poses, scans, cfg, plane_of, n_planes)
    if dev.type != "cuda":
        raise ValueError(f"scan_planes: unsupported device {dev}")
    n = poses.shape[0]
    shared = plane_of is not None
    origins, plane_of, n_planes = _plane_args(origins, poses, plane_of, n_planes)
    poses = poses if poses.is_contiguous() else poses.contiguous()
    _check("poses", poses, (n, 3), dev)
    if origins.device != dev or origins.dtype != torch.float32 or tuple(origins.shape) != (n, 2):
        raise ValueError(f"scan_planes: origins {tuple(origins.shape)} {origins.dtype} on "
                         f"{origins.device}, expected f32[2] or f32[{n}, 2] on {dev}")
    if origins.stride(-1) != 1 or origins.stride(0) not in (0, 2):
        origins = origins.contiguous()
    if shared:
        plane_of = plane_of if plane_of.is_contiguous() else plane_of.contiguous()
        _check("plane_of", plane_of, (n,), dev, torch.int64)
    w_out = torch.empty((n_planes, h, w), dtype=torch.float32, device=dev)
    s_out = torch.empty_like(w_out)
    if n_planes == 0:
        return w_out, s_out
    args = _scan_args("scan_planes", scans, (n,), dev, cfg, scale)
    free_plane = None
    if cfg.free_impl == "polar":
        free_plane = _polar_planes(origins, h, w, scale, poses, scans, cfg, plane_of, n_planes)
    fn = _scan_planes_fn()
    _launch("scan_planes", dev, lambda stream: fn(
        w_out.data_ptr(), s_out.data_ptr(), n_planes, h, w, origins.data_ptr(),
        origins.stride(0), scale, scale * scale, n, plane_of.data_ptr() if shared else None,
        poses.data_ptr(), *(_ptr(a) if isinstance(a, Tensor) or a is None else a for a in args),
        _ptr(free_plane), _BAND_ROWS, stream))
    _LAUNCHES["scan_planes"] += 1
    return w_out, s_out


# --- K3 over a block pool: the tiled and the copy-on-write maps ---------------


def _pool_samples(origin: Tensor, scale: float, poses: Tensor, scans, cfg, q):
    """Every scan's samples (``raycast.scan_sample_cells``), scan-major:
    (scan index, rows, cols, w, s), ``w`` and ``s`` scaled by ``q``."""
    from . import raycast

    parts = [raycast.scan_sample_cells(origin, scale, poses[i], scans[i], cfg)
             for i in range(poses.shape[0])]
    pid = torch.cat([torch.full_like(r, i) for i, (r, *_) in enumerate(parts)])
    rows, cols, w, sv = (torch.cat([pt[k] for pt in parts]) for k in range(4))
    if q is not None:
        w, sv = q * w, q * sv
    return pid, rows, cols, w, sv


def pool_touched_ref(tiles: tuple, block: int, origin: Tensor, scale: float, poses: Tensor,
                     scans, cfg, q: Tensor | None = None) -> Tensor:
    """Plain PyTorch version of :func:`pool_touched`: each scan's samples
    counted by tile with ``scatter_add_``."""
    th, tw = tiles
    p = poses.shape[0]
    pid, rows, cols, w, _ = _pool_samples(origin, scale, poses, scans, cfg, q)
    valid = (w > 0) & (rows >= 0) & (rows < th * block) & (cols >= 0) & (cols < tw * block)
    tile = (pid * th + (rows // block).clamp(0, th - 1)) * tw + (cols // block).clamp(0, tw - 1)
    counts = torch.zeros(p * th * tw, dtype=torch.int32, device=poses.device)
    counts.scatter_add_(0, tile, valid.to(torch.int32))
    return counts.reshape(p, th, tw) > 0


def pool_owners(tables: Tensor, touched: Tensor, n_slots: int,
                refcnt: Tensor | None = None) -> Tensor:
    """i32[n_slots]: the ``p * TH * TW + tile`` of table p's touched tile
    that owns each slot alone (refcount 1 where ``refcnt`` is given), -1
    for every other slot. Index ops on the device, nothing read back."""
    p, th, tw = tables.shape
    flat = tables.reshape(-1).to(torch.int64)
    ok = touched.reshape(-1) & (flat >= 0)
    if refcnt is not None:
        ok = ok & (refcnt.index_select(0, flat.clamp(min=0)) == 1)
    owner = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=tables.device)
    # a slot has one owner at most; every other entry goes to the spare slot
    owner.index_put_((torch.where(ok, flat, n_slots),),
                     torch.arange(p * th * tw, dtype=torch.int32, device=tables.device))
    return owner[:n_slots]


def _pool_keep(pool: Tensor, tables: Tensor, touched: Tensor, refcnt, pid, rows, cols, w):
    """(keep, flat index into the pool) of each sample: on its table, of
    weight > 0, in a slot its tile owns (:func:`pool_owners`)."""
    n, b = pool.shape[0], pool.shape[1]
    _, th, tw = tables.shape
    tr, tc = rows // b, cols // b
    on = (w > 0) & (tr >= 0) & (tr < th) & (tc >= 0) & (tc < tw)
    tile = (pid * th + tr.clamp(0, th - 1)) * tw + tc.clamp(0, tw - 1)
    slot = tables.reshape(-1)[tile].to(torch.int64)
    owner = pool_owners(tables, touched, n, refcnt)
    keep = on & (slot >= 0) & (owner[slot.clamp(min=0)] == tile)
    return keep, slot * (b * b) + (rows % b) * b + cols % b


def _fold_pool(pool: Tensor, model, w_obs: Tensor, s_obs: Tensor) -> Tensor:
    """The cell model's fold over every slot (the reference's), into
    ``pool`` in place."""
    n_prev = pool[..., -1]
    belief = model.update(pool[..., :-1], n_prev, w_obs, s_obs)
    return pool.copy_(torch.cat([belief, (n_prev + w_obs)[..., None]], dim=-1))


def pool_insert_ref(pool: Tensor, tables: Tensor, origin: Tensor, scale: float, model,
                    poses: Tensor, scans, cfg, touched: Tensor, q: Tensor | None = None,
                    refcnt: Tensor | None = None, n_live: Tensor | None = None) -> Tensor:
    """Plain PyTorch version of :func:`pool_insert`: the samples of every
    scan added on flat pool indices with ``index_put_(accumulate=True)``
    (scan-major, each scan's in ``scan_sample_cells``' order), then the
    fold over the whole pool, as the reference computes it. A sample whose
    tile has no slot or does not own its slot alone is dropped. On the card
    ``index_put_`` sums a cell's run of 32 samples or more in its own order
    (PERF.md); the kernel sums in sample order."""
    del n_live  # every slot is folded; an unallocated one holds the init cell, which stays
    n, b = pool.shape[0], pool.shape[1]
    pid, rows, cols, w, sv = _pool_samples(origin, scale, poses, scans, cfg, q)
    keep, lin = _pool_keep(pool, tables, touched, refcnt, pid, rows, cols, w)
    # a dropped sample adds 0.0 to a cell spread by its position, so that
    # dropped samples do not pile up on one address of the sorted scatter
    spread = torch.arange(keep.numel(), device=pool.device) % (n * b * b)
    lin = torch.where(keep, lin, spread)
    w_flat = torch.zeros(n * b * b, dtype=torch.float32, device=pool.device)
    s_flat = torch.zeros_like(w_flat)
    w_flat.index_put_((lin,), torch.where(keep, w, 0.0), accumulate=True)
    s_flat.index_put_((lin,), torch.where(keep, sv, 0.0), accumulate=True)
    return _fold_pool(pool, model, w_flat.reshape(n, b, b), s_flat.reshape(n, b, b))


def pool_insert_ordered(pool: Tensor, tables: Tensor, origin: Tensor, scale: float, model,
                        poses: Tensor, scans, cfg, touched: Tensor, q: Tensor | None = None,
                        refcnt: Tensor | None = None, n_live: Tensor | None = None) -> Tensor:
    """:func:`pool_insert` with the sums made on the host: the kept samples
    (:func:`pool_insert_ref`'s) added with ``np.add.at`` in sample order,
    then the fold on the pool's device, in place. Asserts that no slot
    takes the samples of two touched tiles (a slot shared by tables takes
    none: its refcount is above 1). The yardstick the kernel is held to
    bit for bit on every live slot; it reads the samples back to the host,
    so nothing on a main path calls it."""
    del n_live
    n, b = pool.shape[0], pool.shape[1]
    flat = tables.reshape(-1)
    hit = flat[touched.reshape(-1) & (flat >= 0)].cpu().numpy()
    if refcnt is not None:  # a shared slot takes no write: count only the owned ones
        hit = hit[refcnt.cpu().numpy()[hit] == 1]
    if len(np.unique(hit)) != len(hit):
        raise AssertionError("pool_insert_ordered: two touched tiles share a slot")
    pid, rows, cols, w, sv = _pool_samples(origin, scale, poses, scans, cfg, q)
    keep, lin = _pool_keep(pool, tables, touched, refcnt, pid, rows, cols, w)
    keep, lin = keep.cpu().numpy(), lin.cpu().numpy()
    w_np = np.zeros(n * b * b, np.float32)
    s_np = np.zeros(n * b * b, np.float32)
    np.add.at(w_np, lin[keep], w.cpu().numpy()[keep])
    np.add.at(s_np, lin[keep], sv.cpu().numpy()[keep])
    dev = pool.device
    return _fold_pool(pool, model, torch.from_numpy(w_np).to(dev).reshape(n, b, b),
                      torch.from_numpy(s_np).to(dev).reshape(n, b, b))


def pool_insert_runs(pool: Tensor, tables: Tensor, origin: Tensor, scale: float, poses: Tensor,
                     scans, cfg, touched: Tensor, q: Tensor | None = None,
                     refcnt: Tensor | None = None) -> Tensor:
    """i64[N, B, B]: the samples that :func:`pool_insert_ref` adds into each
    cell (its free and occupied ones: one ``index_put_``). The card's
    ``index_put_`` sums a run of 32 or more by a warp, in another order than
    the kernel's, so these are the cells where the two may part."""
    n, b = pool.shape[0], pool.shape[1]
    pid, rows, cols, w, _ = _pool_samples(origin, scale, poses, scans, cfg, q)
    keep, lin = _pool_keep(pool, tables, touched, refcnt, pid, rows, cols, w)
    return torch.bincount(lin[keep], minlength=n * b * b).reshape(n, b, b)


#: row bands of a banded tile in ``pool_insert``'s work list (each a block
#: of its own): the tile that holds a particle's robot (every beam starts
#: there) and, where the list then stays within ``_POOL_GRID`` items, its
#: neighbours
POOL_ROBOT_BANDS = 4

#: the pool insert's blocks (``csrc/scan_insert.cu``'s kTargetBlocks)
_POOL_GRID = 264

#: the work list's header (``csrc/scan_insert.cu``: the take and done
#: counters, the items' count, the bands, the copied blocks)
_WORK_HEAD = 8
_WORK_COUNT, _WORK_BANDS, _WORK_COPIES = 2, 3, 4
_ITEM_TILE, _ITEM_FOLD = 14, 15

_PREP_TOUCH, _PREP_GIVEN, _PREP_COW, _PREP_TILED = 0, 1, 2, 3

#: table entries a prepare launch marks at most (a bit each in a block's
#: shared memory)
_MAX_POOL_ENTRIES = 32 * 8192


@dataclasses.dataclass(frozen=True)
class PoolWork:
    """What :func:`pool_prepare` hands :func:`pool_insert`: ``buf`` i32,
    ``csrc/scan_insert.cu``'s work list for P tables over N slots with the
    banded tiles in ``n_bands`` row bands: a header of 8 (the items' count
    at 2, the bands at 3, the copied blocks at 4), ``max(P n_bands, 264) +
    N`` items (``slot << 4 | code``: code < 8 a band of a banded tile, 14 a
    touched tile, 15 a live slot folded with no observation; in that order,
    each kind by increasing slot), the prepare's scratch, then each slot's
    owner (:func:`pool_owners`' meaning). The banded tiles are those that
    hold a particle's robot and, where the list then has at most 264 bands
    and tiles, the owned tiles next to them."""

    buf: Tensor
    n_tables: int
    n_slots: int
    n_bands: int

    @property
    def owner(self) -> Tensor:
        return self.buf[self.buf.shape[0] - self.n_slots:]

    @property
    def items(self) -> Tensor:
        """Every item slot of the list; the first ``buf[2]`` are in use."""
        return self.buf[_WORK_HEAD:self._scratch]

    @property
    def src(self) -> Tensor:
        """The new blocks' copy sources (-1: reset to the init cell), in the
        order of their entries; the first ``buf[4]`` are in use (the
        copy-on-write prepare's on the card only)."""
        return self.buf[self._scratch + 2 * self.n_slots:self._scratch + 3 * self.n_slots]

    @property
    def _scratch(self) -> int:
        return _WORK_HEAD + _items_max(self.n_tables, self.n_slots, self.n_bands)


def _items_max(p: int, n: int, n_bands: int) -> int:
    return max(p * n_bands, _POOL_GRID) + n


def _work_ints(p: int, n: int, n_bands: int) -> int:
    """The ints of ``csrc/scan_insert.cu``'s work list: the header, the
    items (``pool_items_max``), three scratch lists, the owners."""
    return _WORK_HEAD + _items_max(p, n, n_bands) + 4 * n


def _robot_tiles(poses: Tensor, origin: Tensor, scale: float, block: int, th: int,
                 tw: int) -> Tensor:
    """i64[P]: the tile that holds each pose, -1 off the table (the
    kernel's arithmetic: an IEEE division, then floor)."""
    rel = torch.floor(gridlib.div_scale(poses[:, :2] - origin, scale))
    col, row = rel[:, 0], rel[:, 1]
    on = (row >= 0) & (row < th * block) & (col >= 0) & (col < tw * block)
    tile = (row.clamp(0, th * block - 1).to(torch.int64) // block) * tw + \
        col.clamp(0, tw * block - 1).to(torch.int64) // block
    return torch.where(on, tile, -1)


def pool_work_ref(tables: Tensor, touched: Tensor, n_slots: int, poses: Tensor, origin: Tensor,
                  scale: float, block: int, refcnt: Tensor | None = None,
                  n_live: Tensor | None = None, n_bands: int = POOL_ROBOT_BANDS,
                  copies: Tensor | int = 0) -> PoolWork:
    """Plain PyTorch version of the work list that :func:`pool_prepare`
    writes (its owners are :func:`pool_owners`' over the live slots), on
    the tables after the prepare; ``copies`` goes to the header."""
    p, th, tw = tables.shape
    n, dev = n_slots, tables.device
    slots = torch.arange(n, device=dev)
    live = refcnt > 0 if refcnt is not None else slots < n_live
    owner = pool_owners(tables, touched, n, refcnt)
    owner = torch.where(live, owner, -1)
    own = owner.to(torch.int64)
    t = th * tw
    tile = own % t
    rt = _robot_tiles(poses, origin, scale, block, th, tw)[(own // t).clamp(0, p - 1)]
    robot = (own >= 0) & (tile == rt)
    near = ((own >= 0) & ~robot & (rt >= 0) & ((tile // tw - rt // tw).abs() <= 1)
            & ((tile % tw - rt % tw).abs() <= 1))
    if int(robot.sum() + near.sum()) * n_bands + int(((own >= 0) & ~robot & ~near).sum()) \
            <= _POOL_GRID:  # the robots' neighbours banded too: the list stays short
        robot = robot | near
    band_slots = slots[robot]
    bands = ((band_slots[:, None] << 4) | torch.arange(n_bands, device=dev)).reshape(-1)
    tiles = (slots[(own >= 0) & ~robot] << 4) | _ITEM_TILE
    folds = (slots[(own < 0) & live] << 4) | _ITEM_FOLD
    items = torch.cat([bands, tiles, folds]).to(torch.int32)
    buf = torch.full((_work_ints(p, n, n_bands),), -1, dtype=torch.int32, device=dev)
    buf[:_WORK_HEAD] = 0
    buf[_WORK_COUNT] = items.shape[0]
    buf[_WORK_BANDS] = n_bands
    buf[_WORK_COPIES] = copies
    buf[_WORK_HEAD:_WORK_HEAD + items.shape[0]] = items
    buf[buf.shape[0] - n:] = owner
    return PoolWork(buf, p, n, n_bands)


def _first_true(lo: int, hi: int, guess, pred) -> int:
    """``csrc/scan_insert.cu``'s ``first_true``: the first i in [lo, hi)
    where ``pred(i)`` holds (pred false ... true), else hi, searched from
    ``guess``."""
    if lo >= hi:
        return hi
    gf = min(max(guess, lo), hi - 1) if guess == guess else lo
    g = int(gf)

    def lower_bound(a, z):
        while a < z:
            mid = a + (z - a) // 2
            if pred(mid):
                z = mid
            else:
                a = mid + 1
        return a

    if pred(g):
        at, d = g, 1
        while at - d >= lo and pred(at - d):
            at -= d
            d <<= 1
        return lower_bound(max(lo, at - d + 1), at)
    f, d = g, 1
    while f + d < hi and not pred(f + d):
        f += d
        d <<= 1
    return lower_bound(f + 1, min(hi, f + d))


def _boundaries(a, z, bk: int, n_bk: int, extent):
    """``csrc/scan_insert.cu``'s ``boundaries``: the tile boundaries ``m bk``
    (0 <= m <= n_bk) that a coordinate monotone along the beam passes from
    ``a`` to ``z``, in the order it passes them."""
    lo, hi = (a, z) if a <= z else (z, a)
    m_lo = 0 if lo < 0 else (n_bk + 1 if lo >= extent else int(lo) // bk + 1)
    m_hi = -1 if hi < 0 else (n_bk if hi >= extent else int(hi) // bk)
    ms = range(m_lo, m_hi + 1)
    return list(ms) if a <= z else list(reversed(ms))


def pool_touched_crossings(tiles: tuple, block: int, origin: Tensor, scale: float,
                           poses: Tensor, scans, cfg, q: Tensor | None = None) -> Tensor:
    """The marking phase of :func:`pool_prepare`'s kernel, in plain Python
    on the host, beam by beam, with the kernel's float32 arithmetic: the
    free trace's tiles are the first sample's and, for each tile boundary
    that the beam's row or column passes, the tile of the first sample past
    it (a search from where the real line crosses); then the occupied
    samples' tiles one by one (``raycast.scan_sample_cells``'). It equals
    :func:`pool_touched_ref`; the tests hold the crossing search to it."""
    from . import raycast

    th, tw = tiles
    p = poses.shape[0]
    f32 = np.float32
    bk = int(block)
    rows_f, cols_f = f32(th * bk), f32(tw * bk)
    qv = f32(1.0) if q is None else f32(float(q))
    ox, oy = (f32(v) for v in origin.detach().cpu().numpy())
    sc = f32(scale)
    step, half = f32(scale * cfg.step_fraction), f32(cfg.hole_width / 2.0)
    n_free = cfg.n_free_samples(scale)
    r = scans.ranges.shape[-1]
    ranges = scans.ranges.expand(p, r).cpu()
    valid = scans.valid.expand(p, r).cpu().numpy()
    angles = poses[:, 2:3].cpu() + scans.bearings.expand(p, r).cpu()
    dx, dy = torch.cos(angles).numpy(), torch.sin(angles).numpy()
    pose = poses.detach().cpu().numpy().astype(np.float32)
    marks = np.zeros((p, th * tw), bool)

    def mark(s, fr, fc):
        if 0 <= fr < rows_f and 0 <= fc < cols_f:
            marks[s, (int(fr) // bk) * tw + int(fc) // bk] = True

    with np.errstate(all="ignore"):
        for s in range(p):
            px, py = pose[s, 0], pose[s, 1]
            for j in range(r):
                if not valid[s, j] or not qv > 0:
                    continue
                bx, by = dx[s, j], dy[s, j]
                limit = f32(ranges[s, j].item()) - half

                def t_of(i):
                    return (f32(i) + f32(0.5)) * step

                def row(i):
                    return np.floor(((py + t_of(i) * by) - oy) / sc)

                def col(i):
                    return np.floor(((px + t_of(i) * bx) - ox) / sc)

                def cross_r(a):
                    return np.ceil(((a * sc + oy) - py) / (by * step) - f32(0.5))

                def cross_c(a):
                    return np.ceil(((a * sc + ox) - px) / (bx * step) - f32(0.5))

                n = _first_true(0, n_free, np.ceil(limit / step - f32(0.5)),
                                lambda i: not (t_of(i) < limit))
                if n == 0:
                    continue
                ra, rz, ca, cz = row(0), row(n - 1), col(0), col(n - 1)
                if any(v != v for v in (ra, rz, ca, cz)):
                    continue
                # the first sample's tile, and the tile of the first sample
                # past each tile boundary that the row or the column passes
                mark(s, ra, ca)
                for coord, cross, a0, z0, n_bk, extent in ((row, cross_r, ra, rz, th, rows_f),
                                                           (col, cross_c, ca, cz, tw, cols_f)):
                    for m in _boundaries(a0, z0, bk, n_bk, extent):
                        a = f32(m * bk)
                        up = a0 <= z0
                        i = _first_true(1, n, cross(a), (lambda j, a=a: coord(j) >= a) if up
                                        else (lambda j, a=a: coord(j) < a))
                        mark(s, row(i), col(i))
    # the occupied samples, one by one
    for s in range(p):
        sr, scl, w, _ = raycast.scan_sample_cells(origin.cpu(), scale, poses[s].cpu(),
                                                  type(scans)(ranges[s], scans.bearings.expand(
                                                      p, r)[s].cpu(), scans.valid.expand(
                                                      p, r)[s].cpu()), cfg)
        occ = slice(r * n_free, None)
        keep = (qv * w[occ].numpy() > 0)
        for fr, fc in zip(sr[occ].numpy()[keep], scl[occ].numpy()[keep]):
            mark(s, fr, fc)
    return torch.from_numpy(marks.reshape(p, th, tw)).to(poses.device)


def _pool_scan_checks(who: str, tables_shape: tuple, origin: Tensor, poses: Tensor, dev):
    p = tables_shape[0]
    if not 1 <= p <= _MAX_MAPS:
        raise ValueError(f"{who}: {p} tables, not between 1 and {_MAX_MAPS} a launch")
    poses = poses if poses.is_contiguous() else poses.contiguous()
    origin = origin if origin.is_contiguous() else origin.contiguous()
    _check("poses", poses, (p, 3), dev)
    _check("origin", origin, (2,), dev)
    return poses, origin


def _q_arg(q, dev):
    if q is not None and not isinstance(q, Tensor):
        q = torch.full((), float(q), dtype=torch.float32, device=dev)
    if q is not None:
        _check("q", q, (), dev)
    return q


@functools.cache
def _pool_prepare_fn():
    fn = _build.load().pool_prepare_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        i, p, p, p, p, p,  # mode, touched, tables, refcnt, overflow, n_alloc
        p, i, i, i, p, i, i, p,  # pool, n_slots, block, c, init, k_max, n_bands, work
        i, i, i, p, f, f,  # p, th, tw, origin, scale, scale^2
        *_SCAN_ARGTYPES[:-1], p, p,  # ..., q, stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _pool_insert_fn():
    fn = _build.load().pool_insert_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, i, i, i, p, i,  # pool, n_slots, block, c, work, n_bands
        i, i, i, p, f, f,  # p, th, tw, origin, scale, scale^2
        *_SCAN_ARGTYPES[:-1],
        p, i, f, f, f, f, f,  # q, model, quality, base, decay, keep, eps
        p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _prepare_launch(who: str, mode: int, touched: Tensor, tables, refcnt, overflow, n_alloc,
                    pool, model, k_max: int, work, origin, scale, block, poses, scans, cfg, q,
                    dev) -> None:
    """One launch of the prepare kernel in ``mode``, counted under ``who``."""
    p, th, tw = touched.shape
    if p * th * tw > _MAX_POOL_ENTRIES:
        raise ValueError(f"{who}: {p} tables of {th} x {tw} tiles: more than "
                         f"{_MAX_POOL_ENTRIES} entries a launch")
    poses, origin = _pool_scan_checks(who, (p,), origin, poses, dev)
    args = _scan_args(who, scans, (p,), dev, cfg, scale)
    q = _q_arg(q, dev)
    init = (constant((*model.init_belief(), 0.0), torch.float32, dev)
            if mode == _PREP_COW else None)
    n, c = (pool.shape[0], pool.shape[3]) if pool is not None else (0, 0)
    fn = _pool_prepare_fn()
    _launch(who, dev, lambda stream: fn(
        mode, touched.data_ptr(), _ptr(tables), _ptr(refcnt), _ptr(overflow), _ptr(n_alloc),
        _ptr(pool), n, block, c, _ptr(init), k_max, 1 if work is None else work.n_bands,
        None if work is None else work.buf.data_ptr(), p, th, tw, origin.data_ptr(), scale,
        scale * scale, poses.data_ptr(),
        *(_ptr(a) if isinstance(a, Tensor) or a is None else a for a in args), _ptr(q), stream))
    _LAUNCHES[who] += 1


def pool_touched(tiles: tuple, block: int, origin: Tensor, scale: float, poses: Tensor, scans,
                 cfg, q: Tensor | None = None) -> Tensor:
    """bool[P, TH, TW]: the tiles (``tiles`` = (TH, TW) of ``block`` cells
    a side, world corner ``origin`` f32[2]) in which scan p (``poses``
    f32[P, 3], ``scans`` [P, R], rows may be broadcast) puts a sample of
    weight ``q w > 0``: what allocation and copy-on-write must give a block
    before :func:`pool_insert`. Its samples are ``scan_sample_cells``'.

    CPU tensors take :func:`pool_touched_ref`; CUDA tensors launch the
    marking phase of :func:`pool_prepare`'s kernel alone (one cluster: the
    free trace's tiles from where each beam crosses tile boundaries) and
    add one to the ``pool_touched`` count."""
    dev = poses.device
    if dev.type == "cpu":
        return pool_touched_ref(tiles, block, origin, scale, poses, scans, cfg, q)
    if dev.type != "cuda":
        raise ValueError(f"pool_touched: unsupported device {dev}")
    th, tw = tiles
    out = torch.empty((poses.shape[0], th, tw), dtype=torch.bool, device=dev)
    _prepare_launch("pool_touched", _PREP_TOUCH, out, None, None, None, None, None, None, 0,
                    None, origin, scale, block, poses, scans, cfg, q, dev)
    return out


def _pool_checks(who: str, pool: Tensor, tables: Tensor, refcnt, n_alloc, dev, model=None):
    n, b, b2, c = pool.shape
    if model is not None and (b2 != b or c != model.n_channels + 1):
        raise ValueError(f"{who}: pool {tuple(pool.shape)} is not (N, B, B, "
                         f"{model.n_channels + 1})")
    if not pool.is_contiguous() or pool.data_ptr() % 16:
        raise ValueError(f"{who}: the pool must be contiguous and 16-byte aligned "
                         "(it is updated in place)")
    _check("pool", pool, tuple(pool.shape), dev)
    p, th, tw = tables.shape
    _check("tables", tables, (p, th, tw), dev, torch.int32)
    if (refcnt is None) == (n_alloc is None):
        raise ValueError(f"{who}: name the live slots by refcnt or by n_live/n_alloc, one of them")
    if refcnt is None and p != 1:
        raise ValueError(f"{who}: P tables share slots: their refcounts are needed")
    if refcnt is not None:
        _check("refcnt", refcnt, (n,), dev, torch.int32)
    else:
        _check("n_alloc", n_alloc, (), dev, torch.int32)


def pool_prepare(pool: Tensor, tables: Tensor, origin: Tensor, scale: float, model,
                 poses: Tensor, scans, cfg, q: Tensor | None = None,
                 refcnt: Tensor | None = None, overflow: Tensor | None = None,
                 n_alloc: Tensor | None = None, k_max: int = 0) -> tuple[Tensor, PoolWork]:
    """Everything a pool insert needs before it, in place: the tiles that
    scan p touches (:func:`pool_touched`'s marks, returned), then, for the
    copy-on-write pool (``refcnt`` i32[N] and ``overflow`` bool[] given),
    ``cow.prepare_write``'s compaction (at most ``k_max`` new blocks; the
    free slots in increasing order; trap o) with the new blocks copied or
    reset in ``pool``, or for the tiled map (``n_alloc`` i32[] given, one
    table) ``blockmap.allocate_tiles``; ``tables``, ``refcnt``,
    ``overflow`` and ``n_alloc`` are updated in place. Returns (touched
    bool[P, TH, TW], the :class:`PoolWork` for :func:`pool_insert`).

    CUDA tensors only: one launch of ``csrc/scan_insert.cu``'s prepare
    kernel (one thread-block cluster: the marks by crossings in shared
    memory, the compaction by block prefix sums, the copies, the owners and
    the work list), counted under ``pool_prepare``; nothing is read on the
    host. Its plain versions belong to the storages that own the policy:
    ``cow.prepare_insert_ref`` and ``blockmap.prepare_tiles_ref``, which
    ``cow.prepare_insert`` and ``blockmap.prepare_tiles`` take on the
    CPU."""
    p, th, tw = tables.shape
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"pool_prepare: unsupported device {dev} (the CPU's plain versions "
                         "are cow.prepare_insert_ref and blockmap.prepare_tiles_ref)")
    if refcnt is not None and not 0 <= k_max <= p * th * tw:
        raise ValueError(f"pool_prepare: k_max {k_max} is not within [0, {p * th * tw}]")
    _pool_checks("pool_prepare", pool, tables, refcnt, n_alloc, dev, model)
    if refcnt is not None:
        _check("overflow", overflow, (), dev, torch.bool)
    n = pool.shape[0]
    touched = torch.empty((p, th, tw), dtype=torch.bool, device=dev)
    work = PoolWork(torch.empty((_work_ints(p, n, POOL_ROBOT_BANDS),), dtype=torch.int32,
                                device=dev), p, n, POOL_ROBOT_BANDS)
    _prepare_launch("pool_prepare", _PREP_COW if refcnt is not None else _PREP_TILED, touched,
                    tables, refcnt, overflow, n_alloc, pool, model, k_max, work, origin, scale,
                    pool.shape[1], poses, scans, cfg, q, dev)
    return touched, work


def pool_work(pool: Tensor, tables: Tensor, origin: Tensor, scale: float, poses: Tensor, scans,
              cfg, touched: Tensor, refcnt: Tensor | None = None,
              n_live: Tensor | None = None) -> PoolWork:
    """The work list of :func:`pool_insert` for tables that are already
    prepared, from the given marks ``touched``: live slots those of
    ``refcnt > 0`` or below ``n_live``. CPU tensors take
    :func:`pool_work_ref`; CUDA tensors launch the prepare kernel once on
    the given marks (nothing marked, allocated or copied), counted under
    ``pool_prepare``."""
    dev = pool.device
    n, b = pool.shape[0], pool.shape[1]
    p = tables.shape[0]
    if dev.type == "cpu":
        return pool_work_ref(tables, touched, n, poses, origin, scale, b, refcnt, n_live)
    if dev.type != "cuda":
        raise ValueError(f"pool_work: unsupported device {dev}")
    _pool_checks("pool_work", pool, tables, refcnt, n_live, dev)
    _check("touched", touched, tuple(tables.shape), dev, torch.bool)
    work = PoolWork(torch.empty((_work_ints(p, n, POOL_ROBOT_BANDS),), dtype=torch.int32,
                                device=dev), p, n, POOL_ROBOT_BANDS)
    _prepare_launch("pool_prepare", _PREP_GIVEN, touched, tables, refcnt, None, n_live, pool,
                    None, 0, work, origin, scale, b, poses, scans, cfg, None, dev)
    return work


def pool_insert(pool: Tensor, tables: Tensor, origin: Tensor, scale: float, model,
                poses: Tensor, scans, cfg, touched: Tensor, q: Tensor | None = None,
                refcnt: Tensor | None = None, n_live: Tensor | None = None,
                work: PoolWork | None = None) -> Tensor:
    """K3 over a block pool: scan p (``poses`` f32[P, 3], ``scans`` [P, R],
    rows may be broadcast) inserted into the tiles of table p (``tables``
    i32[P, TH, TW], slots of ``pool`` f32[N, B, B, C], world corner
    ``origin`` f32[2] of tile (0, 0)) and folded with the cell model, in
    place; returns ``pool``. ``touched`` bool[P, TH, TW] is
    :func:`pool_touched`'s. A sample goes into its tile's slot where the
    tile owns it alone (a slot of refcount 1 when ``refcnt`` i32[N] is
    given, as after ``cow.prepare_write``), else it is dropped (an
    unallocated tile of an exhausted pool, a write the CoW pool could not
    make exclusive). Every live slot is folded once, with its tile's
    samples or with none (the reference folds the whole pool; a fold with
    no observation may move a Bayes average by an ulp): live is ``refcnt >
    0``, or below ``n_live`` i32[] (the tiled map's ``n_alloc``; its other
    slots hold the init cell, which the fold leaves as it is). ``q`` f32[]
    scales each sample (None: 1); the free counts enter as ``q`` times the
    count, the samples' sum in order where ``q`` is 0 or 1. ``work`` is
    :func:`pool_prepare`'s for these tables.

    CPU tensors take the plain twin :func:`pool_insert_ref` (``work``
    unused). CUDA tensors launch ``csrc/scan_insert.cu``'s pool kernel once
    (a fixed grid taking ``work``'s items from a counter: the bands of the
    tile around each particle's robot, every other touched tile, every
    other live slot folded; a tile's samples summed in sample order, free
    ones first, as the reference's one scatter adds them) and add one to
    the ``pool_insert`` count. Without ``work``, :func:`pool_work` writes it
    first (one launch more, counted under ``pool_prepare``). Nothing is read
    on the host; the DDA free trace only (the reference's
    ``scan_sample_cells``)."""
    dev = pool.device
    if dev.type == "cpu":
        return pool_insert_ref(pool, tables, origin, scale, model, poses, scans, cfg, touched,
                               q, refcnt, n_live)
    if dev.type != "cuda":
        raise ValueError(f"pool_insert: unsupported device {dev}")
    code = _CELL_MODEL_CODES.get(type(model))
    if code is None:
        raise ValueError(f"pool_insert: no fold for the cell model {type(model).__name__}")
    _pool_checks("pool_insert", pool, tables, refcnt, n_live, dev, model)
    n, b, _, c = pool.shape
    p, th, tw = tables.shape
    _check("touched", touched, (p, th, tw), dev, torch.bool)
    if work is None:
        work = pool_work(pool, tables, origin, scale, poses, scans, cfg, touched, refcnt, n_live)
    elif (work.n_tables, work.n_slots) != (p, n) or work.buf.device != dev:
        raise ValueError(f"pool_insert: a work list for {work.n_tables} tables over "
                         f"{work.n_slots} slots, not {p} over {n}")
    poses, origin = _pool_scan_checks("pool_insert", (p,), origin, poses, dev)
    args = _scan_args("pool_insert", scans, (p,), dev, cfg, scale)
    q = _q_arg(q, dev)
    quality = getattr(model, "quality", 0.0)
    decay = getattr(model, "conflict_decay", 0.0)
    fn = _pool_insert_fn()
    _launch("pool_insert", dev, lambda stream: fn(
        pool.data_ptr(), n, b, c, work.buf.data_ptr(), work.n_bands, p, th, tw,
        origin.data_ptr(), scale, scale * scale, poses.data_ptr(),
        *(_ptr(a) if isinstance(a, Tensor) or a is None else a for a in args),
        _ptr(q), code, quality, 1.0 - quality, decay, 1.0 - decay, cells._EPS, stream))
    _LAUNCHES["pool_insert"] += 1
    return pool


# --- M3RSM: the pyramid (K4a) and the whole match (K4b) ----------------------

#: most levels above the finest that ``m3rsm_pyramid`` builds: a block pools
#: a tile of 2^levels x 2^levels cells in shared memory (m3rsm_pyramid.cu)
M3RSM_MAX_LEVELS = 6


@functools.lru_cache(maxsize=None)
def pyramid_shapes(h: int, w: int, levels: int) -> tuple[tuple[int, int], ...]:
    """(rows, cols) of each level: a level halves the one below, an odd
    side padded first."""
    shapes = [(h, w)]
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return tuple(shapes)


def _max_pool2(p: Tensor, unknown: float) -> Tensor:
    """The 2 x 2 max of ``p`` f32[..., H, W], an odd side padded with
    ``unknown`` first; NaN propagates."""
    h, w = p.shape[-2:]
    p = torch.nn.functional.pad(p, (0, w % 2, 0, h % 2), value=unknown)
    h2, w2 = p.shape[-2] // 2, p.shape[-1] // 2
    return p.reshape(*p.shape[:-2], h2, 2, w2, 2).amax(dim=(-3, -1))


def m3rsm_pyramid_ref(occ: Tensor, known: Tensor, levels: int, unknown: float) -> tuple:
    """Plain PyTorch version of :func:`m3rsm_pyramid`: level 0
    ``where(known, occ, unknown)``, each level above the 2 x 2 max of the
    one below (``_max_pool2``)."""
    planes = [torch.where(known, occ, unknown)]
    for _ in range(levels):
        planes.append(_max_pool2(planes[-1], unknown))
    return tuple(planes)


def _update_region(center_rc: Tensor, size: int, h: int, w: int, step: int):
    """The refreshed region's first cell of each map (rows, cols i64[M]):
    ``clip(center - size // 2, 0, dim - size)`` aligned down to ``step``."""
    r0 = torch.clamp(center_rc[..., 0].to(torch.int64) - size // 2, 0, h - size)
    c0 = torch.clamp(center_rc[..., 1].to(torch.int64) - size // 2, 0, w - size)
    return (r0 // step * step).reshape(-1), (c0 // step * step).reshape(-1)


def m3rsm_pyramid_update_ref(planes: tuple, occ: Tensor, known: Tensor, center_rc: Tensor,
                             size: int, unknown: float, gate: Tensor | None = None) -> tuple:
    """Plain PyTorch version of :func:`m3rsm_pyramid_update`: a copy of the
    planes, the region cut out, pooled level by level and written into the
    copy, map by map (the region's corner is read on the host). ``planes``
    stay as they were."""
    planes = tuple(p.clone() for p in planes)
    levels = len(planes) - 1
    h, w = planes[0].shape[-2:]
    flat = [p.view(-1, *p.shape[-2:]) for p in planes]
    occ = occ.reshape(-1, h, w)
    known = known.reshape(-1, h, w)
    rows, cols = _update_region(center_rc, size, h, w, 1 << levels)
    gates = None if gate is None else gate.reshape(-1)
    for m in range(flat[0].shape[0]):
        if gates is not None and not bool(gates[m] > 0):
            continue
        r0, c0 = int(rows[m]), int(cols[m])
        reg = torch.where(known[m, r0:r0 + size, c0:c0 + size],
                          occ[m, r0:r0 + size, c0:c0 + size], unknown)
        for lvl, plane in enumerate(flat):
            if lvl:
                reg, r0, c0 = _max_pool2(reg, unknown), r0 // 2, c0 // 2
            plane[m, r0:r0 + reg.shape[0], c0:c0 + reg.shape[1]] = reg
    return planes


@functools.lru_cache(maxsize=None)
def _pyramid_layout(lead: tuple, h: int, w: int, levels: int):
    """Each plane's shape (``lead`` + level shape), its floats, its
    contiguous strides and where it starts: a pyramid lives in one buffer,
    level l right after level l - 1."""
    n = math.prod(lead)
    shapes = tuple((*lead, hl, wl) for hl, wl in pyramid_shapes(h, w, levels))
    sizes = tuple(n * hl * wl for hl, wl in pyramid_shapes(h, w, levels))
    strides = tuple(((hl * wl,) if lead else ()) + (wl, 1)
                    for hl, wl in pyramid_shapes(h, w, levels))
    starts = tuple(sum(sizes[:lvl]) for lvl in range(levels + 1))
    return shapes, sizes, strides, starts


def _new_pyramid(lead: tuple, h: int, w: int, levels: int, device) -> tuple[Tensor, tuple]:
    """An empty pyramid's buffer and its planes (views into it), in as few
    ATen calls as a tuple of planes allows: one allocation, a view a plane."""
    shapes, sizes, strides, starts = _pyramid_layout(lead, h, w, levels)
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=device)
    return buf, tuple(buf.as_strided(shape, stride, start)
                      for shape, stride, start in zip(shapes, strides, starts))


def _pyramid_buffer(name: str, planes: tuple, lead: tuple, h: int, w: int,
                    device: torch.device) -> Tensor:
    """The buffer that holds ``planes`` in the kernels' layout: their own
    when they are views into one (a pyramid of :func:`m3rsm_pyramid` or
    :func:`m3rsm_pyramid_update`), else a copy of them laid out so."""
    shapes, _, _, starts = _pyramid_layout(lead, h, w, len(planes) - 1)
    base = planes[0].data_ptr()
    for p, shape, start in zip(planes, shapes, starts):
        if (p.dtype != torch.float32 or p.shape != shape or not p.is_contiguous()
                or p.data_ptr() != base + 4 * start or p.device != device):
            break
    else:
        return planes[0]
    for lvl, (p, shape) in enumerate(zip(planes, shapes)):
        _check(f"{name}: plane {lvl}", p, shape, device)
    return torch.cat([p.reshape(-1) for p in planes])


def _launch(name: str, device: torch.device, call) -> None:
    """Runs ``call(stream)`` (a ctypes launch onto ``device``'s current
    stream, given as an int) with ``device`` the current device, and raises
    if the launch failed. The device is switched only when it is not the
    current one already."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        err = call(torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = call(torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


@functools.cache
def _m3rsm_pyramid_fn():
    fn = _build.load().m3rsm_pyramid_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # occ, its cell stride, known
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # m, h, w, levels
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,  # unknown, out, old
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # center, size, gate
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _m3rsm_pyramid_launch(occ, known, levels, unknown, old=None, center_rc=None, size=0,
                          gate=None):
    """Checks the inputs (occ and known [H, W] or [M, H, W]; ``old``: a
    pyramid of the same leading shape to refresh), launches the kernel once
    into a new pyramid and adds one to the ``m3rsm_pyramid`` count; returns
    the new planes."""
    dev = occ.device
    if dev.type != "cuda":
        raise ValueError(f"m3rsm_pyramid: unsupported device {dev}")
    lead, (h, w) = tuple(occ.shape[:-2]), occ.shape[-2:]
    if len(lead) > 1:
        raise ValueError(f"m3rsm_pyramid: occ {tuple(occ.shape)} is not (H, W) or (M, H, W)")
    if not 0 <= levels <= M3RSM_MAX_LEVELS:
        raise ValueError(f"m3rsm_pyramid: {levels} levels, at most {M3RSM_MAX_LEVELS}")
    n_m = lead[0] if lead else 1
    if not 1 <= n_m <= _MAX_MAPS:
        raise ValueError(f"m3rsm_pyramid: {n_m} maps, not between 1 and {_MAX_MAPS} a launch")
    stride = _cell_stride("m3rsm_pyramid", occ, dev)
    _check("known", known, (*lead, h, w), dev, torch.bool)
    old_ptr = center_ptr = gate_ptr = None
    if old is not None:
        old_ptr = _pyramid_buffer("m3rsm_pyramid_update", old, lead, h, w, dev).data_ptr()
        _check("center_rc", center_rc, (*lead, 2), dev, torch.int64)
        center_ptr = center_rc.data_ptr()
        if gate is not None:
            _check("gate", gate, lead, dev)
            gate_ptr = gate.data_ptr()
    buf, planes = _new_pyramid(lead, h, w, levels, dev)
    fn = _m3rsm_pyramid_fn()
    _launch("m3rsm_pyramid", dev, lambda stream: fn(
        occ.data_ptr(), stride, known.data_ptr(), n_m, h, w, levels, unknown, buf.data_ptr(),
        old_ptr, center_ptr, size, gate_ptr, stream))
    _LAUNCHES["m3rsm_pyramid"] += 1
    return planes


def m3rsm_pyramid(occ: Tensor, known: Tensor, levels: int, unknown: float) -> tuple:
    """M3RSM's max-occupancy pyramid: ``levels + 1`` planes, level 0
    ``where(known, occ, unknown)`` f32[..., H, W], level l f32[..., ceil(H /
    2^l), ceil(W / 2^l)] the 2 x 2 max of level l - 1 with an odd side
    padded with ``unknown``. occ f32[H, W] or f32[M, H, W] (contiguous, or a
    channel of contiguous cells), known bool of the same shape: M maps in
    one launch. On the card the planes are views into one buffer.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream and add one to the ``m3rsm_pyramid`` count of
    :func:`launch_counts`.
    """
    if occ.device.type == "cpu":
        return m3rsm_pyramid_ref(occ, known, levels, unknown)
    return _m3rsm_pyramid_launch(occ, known, levels, unknown)


def m3rsm_pyramid_update(planes: tuple, occ: Tensor, known: Tensor, center_rc: Tensor,
                         size: int, unknown: float, gate: Tensor | None = None) -> tuple:
    """``planes`` (a pyramid of :func:`m3rsm_pyramid`'s shapes) refreshed
    over the ``size x size`` region around ``center_rc`` i64[2] (row, col;
    i64[M, 2] for M maps), as new planes: its first cell ``clip(center -
    size // 2, 0, dim - size)`` aligned down to ``2^levels``, as the
    reference's ``update_pyramid`` places it, the rest of every level
    copied. The map's sides and ``size`` must be multiples of
    ``2^levels``. Where ``gate`` f32[] (f32[M]) is given, only the maps
    whose gate is above 0 are refreshed (the others copied); it is read on
    the device. ``planes`` stay as they were.

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream (one launch writes every level of the new planes) and
    add one to the ``m3rsm_pyramid`` count of :func:`launch_counts`.
    """
    h, w = planes[0].shape[-2:]
    step = 1 << (len(planes) - 1)
    if h % step or w % step or size % step or not 0 < size <= min(h, w):
        raise ValueError(f"m3rsm_pyramid_update: a {h} x {w} map and a {size}-cell region "
                         f"must be multiples of 2^levels = {step}, the region inside the map")
    if occ.device.type == "cpu":
        return m3rsm_pyramid_update_ref(planes, occ, known, center_rc, size, unknown, gate)
    return _m3rsm_pyramid_launch(occ, known, len(planes) - 1, unknown, planes, center_rc, size,
                                 gate)


def m3rsm_score_level_ref(plane: Tensor, corner: Tensor, level: int, wh: int, ww: int,
                          c0: Tensor, cands: Tensor, mask: Tensor, unknown: float) -> Tensor:
    """Plain PyTorch version of :func:`m3rsm_score_level`: the reference's
    ``_score_level`` (``grid.gather_plane`` on the window, the max over the
    rect's corner cells, the weighted mean) on every request at once."""
    n_b = c0.shape[0]
    dev = c0.device
    b = torch.arange(n_b, device=dev)
    base = c0[b[:, None], cands[..., 0].long()]  # [B, K, R, 2]
    fine = base + cands[:, :, None, 1:]
    e = (1 << level) - 1
    corners = torch.tensor([[0, 0]] if e == 0 else [[0, 0], [0, e], [e, 0], [e, e]],
                           dtype=torch.int32, device=dev)
    idx = (fine[..., None, :] + corners) >> level  # [B, K, R, C, 2]
    # the window is cut out first in the reference: a cell off it reads unknown
    wh = torch.clamp(plane.shape[-2] - (corner[:, 0] >> level), max=wh)
    ww = torch.clamp(plane.shape[-1] - (corner[:, 1] >> level), max=ww)
    shape = (n_b, 1, 1, 1)
    ok = ((idx[..., 0] >= 0) & (idx[..., 0] < wh.reshape(shape))
          & (idx[..., 1] >= 0) & (idx[..., 1] < ww.reshape(shape)))
    rows = torch.clamp(idx[..., 0] + (corner[:, 0] >> level).reshape(shape), 0,
                       plane.shape[-2] - 1)
    cols = torch.clamp(idx[..., 1] + (corner[:, 1] >> level).reshape(shape), 0,
                       plane.shape[-1] - 1)
    pm = b.reshape(shape) if plane.shape[0] > 1 else torch.zeros_like(b).reshape(shape)
    vals = torch.where(ok, plane[pm, rows.long(), cols.long()], unknown).amax(-1)
    return (vals * mask[:, None, :]).sum(-1) / torch.clamp(mask.sum(-1, keepdim=True), min=1e-9)


@functools.cache
def _m3rsm_level_fn():
    fn = _build.load().m3rsm_level_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plane, planes, hp, wp
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # corner, level, wh, ww
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # c0, n_t, r
        ctypes.c_void_p, ctypes.c_int,  # cands, k
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # mask, b, unknown
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def m3rsm_score_level(plane: Tensor, corner: Tensor, level: int, wh: int, ww: int,
                      c0: Tensor, cands: Tensor, mask: Tensor, unknown: float) -> Tensor:
    """Score the rects ``cands`` i32[B, K, 3] (theta index, row and col
    offset in level-0 cells) of B requests at pyramid level ``level`` ->
    f32[B, K]: for every beam the max of the level plane over the rect's
    corner cells ``(c0[b, t] + (ty, tx) + d) >> level``, then the
    ``mask``-weighted mean over the beams.

    plane f32[1, Hp, Wp] (shared by the requests) or f32[B, Hp, Wp], read in
    place; corner i32[B, 2] the level-0 cell at which request b's window
    starts (``corner >> level`` at this level) and ``wh x ww`` its extent at
    this level: a cell off the window reads ``unknown``; c0 i32[B, T, R, 2]
    the endpoint cells (row, col) at each theta, relative to the window;
    mask f32[B, R].

    CPU tensors take the plain twin; CUDA tensors launch the kernel on the
    current stream, once for all B, and add one to the ``m3rsm_level``
    count of :func:`launch_counts`. The match's main path does not call
    it: :func:`m3rsm_search_levels` does, as the yardstick of
    :func:`m3rsm_search`.
    """
    if plane.device.type == "cpu":
        return m3rsm_score_level_ref(plane, corner, level, wh, ww, c0, cands, mask, unknown)
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"m3rsm_score_level: unsupported device {dev}")
    n_b, n_t, r = c0.shape[:3]
    k = cands.shape[1]
    n_p, hp, wp = plane.shape
    if n_p not in (1, n_b) or not 1 <= n_b <= _MAX_MAPS:
        raise ValueError(f"m3rsm_score_level: {n_p} planes for {n_b} requests")
    _check("plane", plane, (n_p, hp, wp), dev)
    _check("corner", corner, (n_b, 2), dev, torch.int32)
    _check("c0", c0, (n_b, n_t, r, 2), dev, torch.int32)
    _check("cands", cands, (n_b, k, 3), dev, torch.int32)
    _check("mask", mask, (n_b, r), dev)
    out = torch.empty((n_b, k), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    fn = _m3rsm_level_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(plane.data_ptr(), n_p, hp, wp, corner.data_ptr(), level, wh, ww, c0.data_ptr(),
                 n_t, r, cands.data_ptr(), k, mask.data_ptr(), n_b, unknown, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"m3rsm_score_level kernel launch failed: cudaError_t {err}")
    _LAUNCHES["m3rsm_level"] += 1
    return out


#: the six axis steps of a hill-climbing round, in the reference's order
HILL_CLIMB_STEPS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def hill_climb_loop(score, plane, pts, beam_w, origin, pose, scale, unknown, step_xy,
                    step_theta, iterations, shrink, reducer=BILINEAR):
    """The hill climb as a Python loop over device tensors with no host
    sync: each round scores the six poses one step along each axis (theta
    wrapped), moves to the best (ties to the first) if it is strictly
    better, else multiplies every step by ``shrink``. ``score`` has
    ``overlap_score``'s signature and is called, with ``reducer``, once for
    the first pose and once a round. With a leading map dimension on every tensor (plane
    f32[M, H, W], pts f32[M, R, 2], beam_w f32[M, R], origin f32[M, 2], pose
    f32[M, 3]) ``score`` must take it too: pose f32[M, 3], prob f32[M],
    trace f32[M, iterations]."""
    dev = pose.device
    prob = score(plane, pose[..., None, :].contiguous(), pts, beam_w, origin, scale,
                 unknown, reducer)[..., 0]
    units = constant(HILL_CLIMB_STEPS, torch.float32, dev)
    steps = constant((step_xy, step_xy, step_theta), torch.float32, dev)
    steps = steps.expand(*pose.shape[:-1], 3)
    trace = []
    for _ in range(iterations):
        cand = pose[..., None, :] + units * steps[..., None, :]
        cand = torch.cat([cand[..., :2], wrap_angle(cand[..., 2:])], dim=-1)
        probs = score(plane, cand.contiguous(), pts, beam_w, origin, scale, unknown, reducer)
        i = torch.argmax(probs, dim=-1, keepdim=True)  # ties -> first index
        p_i = probs.gather(-1, i)[..., 0]
        better = p_i > prob
        won = cand.gather(-2, i[..., None].expand(*i.shape, 3))[..., 0, :]
        pose = torch.where(better[..., None], won, pose)
        prob = torch.where(better, p_i, prob)
        steps = torch.where(better[..., None], steps, steps * shrink)
        trace.append(prob)
    trace = (torch.stack(trace, dim=-1) if trace
             else torch.empty((*pose.shape[:-1], 0), dtype=torch.float32, device=dev))
    return pose, prob, trace


def hill_climb_ref(plane, pts, beam_w, origin, pose, scale, unknown, step_xy, step_theta,
                   iterations, shrink, reducer=BILINEAR):
    """Plain PyTorch version of :func:`hill_climb`: :func:`hill_climb_loop`
    over :func:`overlap_score_ref`, for one map or M."""
    return hill_climb_loop(overlap_score_ref, plane, pts, beam_w, origin, pose, scale, unknown,
                           step_xy, step_theta, iterations, shrink, reducer)


def hill_climb_rounds(plane, pts, beam_w, origin, pose, scale, unknown, step_xy, step_theta,
                      iterations, shrink, reducer=BILINEAR):
    """The same climb with :func:`overlap_score` (one map) or
    :func:`overlap_score_batched` (M maps) launched once for the first pose
    and once a round (``1 + iterations`` launches on the card) and the rest
    of a round in PyTorch ops. Nothing on the main path calls it: it is
    what :func:`hill_climb` is held to, bit for bit, on the card."""
    score = overlap_score_batched if plane.dim() == 3 else overlap_score
    return hill_climb_loop(score, plane, pts, beam_w, origin, pose, scale, unknown, step_xy,
                           step_theta, iterations, shrink, reducer)


@functools.cache
def _hill_climb_fn():
    fn = _build.load().hill_climb_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plane, m, h, w
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pts, beam_w, r
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # origin, pose, ...
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # steps, shrink, iterations
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # reducer, radius, extent
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def hill_climb(plane, pts, beam_w, origin, pose, scale, unknown, step_xy, step_theta,
               iterations, shrink, reducer=BILINEAR):
    """The hill-climbing matcher's refine of ``pose`` f32[3] on plane
    f32[H, W] (``where(known, occ, unknown)``) with the scan's pts f32[R, 2]
    and beam_w f32[R] -> (pose f32[3], prob f32[], trace f32[iterations]):
    the arithmetic of :func:`hill_climb_loop` over :func:`overlap_score`, a
    beam's endpoint read by ``reducer``. With a leading map dimension on every tensor (plane f32[M, H, W], pts
    f32[M, R, 2], beam_w f32[M, R], origin f32[M, 2], pose f32[M, 3]) every
    map climbs from its own pose: pose f32[M, 3], prob f32[M], trace
    f32[M, iterations].

    CPU tensors take the plain twin; CUDA tensors launch the kernel once on
    the current stream (a block a map), with the bits of
    :func:`hill_climb_rounds`, and add one to the ``hill_climb`` count of
    :func:`launch_counts`."""
    lead = tuple(plane.shape[:-2])
    _refine_checks("hill_climb", lead, plane, pts, beam_w, origin, pose, iterations)
    if plane.device.type == "cpu":
        return hill_climb_ref(plane, pts, beam_w, origin, pose, scale, unknown, step_xy,
                              step_theta, iterations, shrink, reducer)
    h, w = plane.shape[-2:]
    n_m = lead[0] if lead else 1
    dev = plane.device
    out_pose = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    out_prob = torch.empty(lead, dtype=torch.float32, device=dev)
    trace = torch.empty((*lead, iterations), dtype=torch.float32, device=dev)
    if n_m == 0:
        return out_pose, out_prob, trace
    fn = _hill_climb_fn()
    _launch("hill_climb", dev, lambda stream: fn(
        plane.data_ptr(), n_m, h, w, pts.data_ptr(), beam_w.data_ptr(), pts.shape[-2],
        origin.data_ptr(), pose.data_ptr(), scale, unknown, step_xy, step_theta, shrink,
        iterations, reducer.code, reducer.radius, reducer.extent, out_pose.data_ptr(),
        out_prob.data_ptr(), trace.data_ptr(), stream))
    _count("hill_climb", reducer)
    return out_pose, out_prob, trace


@dataclasses.dataclass
class M3RSMSearch:
    """Everything one M3RSM match of B requests reads: the branch and bound
    over a max-occupancy pyramid, then the hill climb.

    The maps: ``planes`` the pyramid, levels + 1 planes f32[Hl, Wl] (one
    map, shared by the requests) or f32[B, Hl, Wl] (a map a request), as
    ``m3rsm_pyramid`` gives them; ``occ`` f32 (contiguous, or a channel of
    contiguous cells) and ``known`` bool of the planes' leading shape and
    level-0 size; ``origin`` f32[B, 2] the maps' world origins. ``window``:
    the side (a multiple of 2^levels) of each request's prior-centred
    window, aligned to 2^levels and clipped into the map (0: the whole map);
    every level is read on its window (a cell off it reads ``unknown``), the
    hill climb on its level-0 window.

    The requests: ``pts`` f32[B, R, 2] every beam's endpoint in the sensor
    frame, ``mask`` f32[B, R] the level scores' beam weights (zero off every
    ``stride``-th beam: the hill climb scores beams ``::stride`` with these
    weights, as ``scoring.prepare`` gives them); ``prior`` f32[B, 3];
    ``top`` i32[K0, 3] the top level's rects (theta index, row and col
    offset); ``thetas`` f32[T]; ``beam_width`` rects kept a level;
    ``iterations`` hill-climb rounds (0: none) with the steps ``step_xy``,
    ``step_theta`` and ``shrink``, its score read by ``reducer``."""

    planes: tuple
    occ: Tensor
    known: Tensor
    origin: Tensor
    window: int
    pts: Tensor
    mask: Tensor
    stride: int
    prior: Tensor
    top: Tensor
    thetas: Tensor
    scale: float
    beam_width: int
    unknown: float
    step_xy: float
    step_theta: float
    iterations: int
    shrink: float = 0.5
    reducer: Reducer = BILINEAR


def m3rsm_frontiers(k0: int, beam_width: int, levels: int) -> list[int]:
    """Rects the search scores at each level, top first: the top level's
    ``k0``, then four children of each of the best ``min(beam_width, K)``."""
    ks = [k0]
    for _ in range(levels):
        ks.append(4 * min(beam_width, ks[-1]))
    return ks


def m3rsm_tiebreak(cands: Tensor, n_theta: int) -> Tensor:
    """-1e-6 x (|ty| + |tx| + |t - n_theta // 2|): between equal scores the
    rect nearest the prior wins (a flat, unmapped region must not pull the
    pose to the window's corner)."""
    d = (cands[..., 1].abs() + cands[..., 2].abs() + (cands[..., 0] - n_theta // 2).abs())
    return d.to(torch.float32) * -1e-6


def m3rsm_ranks_ref(scores: Tensor) -> Tensor:
    """Each score's place in the stable descending sort of its row, as the
    ``m3rsm_search`` kernel selects the frontier: scores f32[B, K] -> i64[B,
    K], the count of scores that come before it (a larger order key, or an
    equal key at a lower index). The key orders NaN first (every NaN
    alike) and -0.0 as 0.0, as ``torch.sort(descending=True,
    stable=True)`` does."""
    bits = torch.where(scores == 0, 0.0, scores).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits | 0x80000000)
    key = torch.where(torch.isnan(scores), 0xFFFFFFFF, key)
    k = scores.shape[-1]
    idx = torch.arange(k, device=scores.device)
    before = (key[..., None, :] > key[..., :, None]) | (
        (key[..., None, :] == key[..., :, None]) & (idx[None, :] < idx[:, None]))
    return before.sum(-1)


def m3rsm_window_cells(s: M3RSMSearch):
    """The search's geometry, in the reference's f32 arithmetic (the
    kernel computes the same values itself): each request's window, its
    first level-0 cell ``corner`` i32[B, 2] (row, col) and extent (rows,
    cols), its world ``origin`` f32[B, 2], and ``c0`` i32[B, T, R, 2] every
    theta's endpoint cells (row, col) at zero translation, relative to the
    window."""
    n_b = s.prior.shape[0]
    h0, w0 = s.occ.shape[-2:]
    step_top = 1 << (len(s.planes) - 1)
    origin = s.origin.expand(n_b, 2)
    poses = s.prior
    if s.window > 0:
        side = s.window
        rel = (poses[:, :2] - origin) / torch.full_like(origin, s.scale)
        cell = torch.floor(rel).to(torch.int32)
        c0w = torch.clamp(cell[:, 0] - side // 2, 0, w0 - side) // step_top * step_top
        r0w = torch.clamp(cell[:, 1] - side // 2, 0, h0 - side) // step_top * step_top
        corner = torch.stack([r0w, c0w], dim=-1)
        origin = origin + torch.stack([c0w, r0w], dim=-1).to(torch.float32) * s.scale
        extent = (side, side)
    else:
        corner = torch.zeros((n_b, 2), dtype=torch.int32, device=poses.device)
        extent = (h0, w0)
    ang = poses[:, 2:3] + s.thetas  # [B, T]
    c, s_ = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px, py = s.pts[:, None, :, 0], s.pts[:, None, :, 1]
    ex = (poses[:, 0, None, None] + c * px) - s_ * py  # [B, T, R]
    ey = (poses[:, 1, None, None] + s_ * px) + c * py
    rel_x = gridlib.div_scale(ex - origin[:, 0, None, None], s.scale)
    rel_y = gridlib.div_scale(ey - origin[:, 1, None, None], s.scale)
    c0 = torch.stack([torch.floor(rel_y).to(torch.int32), torch.floor(rel_x).to(torch.int32)],
                     dim=-1).contiguous()
    return corner, extent, origin, c0


def m3rsm_search_loop(score_level, score, s: M3RSMSearch):
    """The match as a Python loop over device tensors with no host sync:
    the window and endpoint cells (:func:`m3rsm_window_cells`), the top
    level's rects scored with ``score_level`` (``m3rsm_score_level``'s
    signature) plus the tie-break, then level by level the best
    ``beam_width`` by a stable descending sort (equal scores keep index
    order, as the reference's ``top_k``), their children scored one level
    down; the argmax of level 0 (ties to the first) and its pose; then
    :func:`hill_climb_loop` with ``score`` (``overlap_score``'s signature,
    called with the leading request dimension) on the level-0 window cut
    out. Returns pose f32[B, 3], prob f32[B], trace f32[B, iterations]."""
    n_b = s.prior.shape[0]
    n_t = s.thetas.shape[0]
    levels = len(s.planes) - 1
    dev = s.prior.device
    planes = [p if p.dim() == 3 else p[None] for p in s.planes]
    corner, (wh, ww), origin, c0 = m3rsm_window_cells(s)
    mask = s.mask.contiguous()

    def level_scores(level, cands):
        side = 1 << level
        return score_level(planes[level], corner, level, -(-wh // side), -(-ww // side), c0,
                           cands, mask, s.unknown) + m3rsm_tiebreak(cands, n_t)

    cands = s.top.expand(n_b, -1, 3).contiguous()
    scores = level_scores(levels, cands)
    for level in range(levels - 1, -1, -1):
        # keep the best beam_width rects, split each into its 4 children
        take_n = min(s.beam_width, cands.shape[1])
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :take_n]
        parents = torch.gather(cands, 1, order[..., None].expand(-1, -1, 3))
        child = constant(((0, 0, 0), (0, 1 << level, 0), (0, 0, 1 << level),
                          (0, 1 << level, 1 << level)), torch.int32, dev)
        cands = (parents[:, :, None, :] + child).reshape(n_b, -1, 3)
        scores = level_scores(level, cands)

    best = torch.argmax(scores, dim=-1, keepdim=True)  # ties -> first index
    win = torch.gather(cands, 1, best[..., None].expand(-1, -1, 3))[:, 0]  # [B, 3]
    pose = torch.stack([
        s.prior[:, 0] + win[:, 2].to(torch.float32) * s.scale,
        s.prior[:, 1] + win[:, 1].to(torch.float32) * s.scale,
        wrap_angle(s.prior[:, 2] + s.thetas[win[:, 0].long()]),
    ], dim=-1)
    prob = torch.gather(scores, 1, best)[:, 0]
    if s.iterations == 0:
        return pose, prob, torch.empty((n_b, 0), dtype=torch.float32, device=dev)
    occ = s.occ if s.occ.dim() == 3 else s.occ[None]
    known = s.known if s.known.dim() == 3 else s.known[None]
    if occ.shape[0] != n_b:  # B requests on one map
        occ, known = occ.expand(n_b, -1, -1), known.expand(n_b, -1, -1)
    row, col = corner[:, 0].long(), corner[:, 1].long()
    plane = torch.where(gridlib.take_window(known, row, col, wh, ww),
                        gridlib.take_window(occ, row, col, wh, ww), s.unknown).contiguous()
    pts = s.pts[:, ::s.stride].contiguous()
    beam_w = s.mask[:, ::s.stride].contiguous()
    return hill_climb_loop(score, plane, pts, beam_w, origin.contiguous(), pose, s.scale,
                           s.unknown, s.step_xy, s.step_theta, s.iterations, s.shrink, s.reducer)


def m3rsm_search_ref(s: M3RSMSearch):
    """Plain PyTorch version of :func:`m3rsm_search`: the loop over the
    level score's and the overlap score's plain twins."""
    return m3rsm_search_loop(m3rsm_score_level_ref, overlap_score_ref, s)


def m3rsm_search_levels(s: M3RSMSearch):
    """The same match with :func:`m3rsm_score_level` launched once a level
    and :func:`overlap_score_batched` once a hill-climb round, the rest in
    PyTorch ops between them. Nothing on a main path calls it: it is what
    :func:`m3rsm_search` is held to, bit for bit, on the card."""
    return m3rsm_search_loop(m3rsm_score_level, overlap_score_batched, s)


@functools.lru_cache(maxsize=None)
def _m3rsm_search_shared(index: int, *sizes: int) -> tuple[int, int]:
    """The dynamic shared memory a launch of the ``m3rsm_search`` kernel
    with these sizes (h, w, window, levels, n_t, r, stride, iterations,
    k_max) asks for, and what a block of it may ask for on card ``index``,
    in bytes, as ``m3rsm_match.cu`` lays its shared memory out."""
    fn = _build.load().m3rsm_match_shared_bytes
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)] * 2
    fn.restype = ctypes.c_int
    need, cap = ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(index):
        err = fn(*sizes, ctypes.byref(need), ctypes.byref(cap))
    if err != 0:
        raise RuntimeError(f"m3rsm_search: shared memory query failed: cudaError_t {err}")
    return need.value, cap.value


@functools.cache
def _m3rsm_search_fn():
    fn = _build.load().m3rsm_match_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pyramid
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # occ, known, occ's cell stride
        ctypes.c_void_p, ctypes.c_int,  # origin, window
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # pts, mask, r, stride
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # prior, b, top, k0
        ctypes.c_void_p, ctypes.c_int,  # thetas, n_t
        ctypes.c_int, ctypes.c_float, ctypes.c_float,  # beam width, scale, unknown
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # steps, shrink, iterations
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # reducer, radius, extent
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pose, prob, trace
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # k_max, dynamic shared bytes, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _m3rsm_search_launch(s: M3RSMSearch):
    """Checks the inputs, launches the kernel once for all B requests and
    adds one to the ``m3rsm_search`` count."""
    dev = s.prior.device
    if dev.type != "cuda":
        raise ValueError(f"m3rsm_search: unsupported device {dev}")
    occ = s.occ
    lead, (h, w) = tuple(occ.shape[:-2]), occ.shape[-2:]
    n_b = s.prior.shape[0]
    n_p = lead[0] if lead else 1
    levels = len(s.planes) - 1
    n_t, r, k0 = s.thetas.shape[0], s.mask.shape[-1], s.top.shape[0]
    if len(lead) > 1 or n_p not in (1, n_b) or not 1 <= n_b <= _MAX_MAPS:
        raise ValueError(f"m3rsm_search: maps {tuple(occ.shape)} for {n_b} requests")
    step = 1 << levels
    if (not 0 <= levels <= 8 or k0 < 1 or s.beam_width < 1 or s.stride < 1
            or s.window < 0 or s.window % step or s.window > min(h, w)
            or (s.window and (h % step or w % step))):
        raise ValueError(f"m3rsm_search: {levels} levels, a {s.window}-cell window of {h} x {w}, "
                         f"{k0} top rects, beam width {s.beam_width}, stride {s.stride}")
    k_max = max(m3rsm_frontiers(k0, s.beam_width, levels))
    index = torch._C._cuda_getDevice() if dev.index is None else dev.index
    shared, cap = _m3rsm_search_shared(index, h, w, s.window, levels, n_t, r, s.stride,
                                       s.iterations, k_max)
    if shared > cap:
        raise ValueError(f"m3rsm_search: {n_t} thetas, {r} beams and a frontier of {k_max} rects "
                         f"need {shared} B of shared memory a block, more than the kernel's cap "
                         f"of {cap} B on this card")
    stride = _cell_stride("m3rsm_search", occ, dev)
    _check("known", s.known, (*lead, h, w), dev, torch.bool)
    pyramid = _pyramid_buffer("m3rsm_search", s.planes, lead, h, w, dev)
    _check("origin", s.origin, (n_b, 2), dev)
    _check("pts", s.pts, (n_b, r, 2), dev)
    _check("mask", s.mask, (n_b, r), dev)
    _check("prior", s.prior, (n_b, 3), dev)
    _check("top", s.top, (k0, 3), dev, torch.int32)
    _check("thetas", s.thetas, (n_t,), dev)
    pose = torch.empty((n_b, 3), dtype=torch.float32, device=dev)
    prob = torch.empty((n_b,), dtype=torch.float32, device=dev)
    trace = torch.empty((n_b, s.iterations), dtype=torch.float32, device=dev)
    fn = _m3rsm_search_fn()
    _launch("m3rsm_search", dev, lambda stream: fn(
        pyramid.data_ptr(), n_p, h, w, levels, occ.data_ptr(), s.known.data_ptr(), stride,
        s.origin.data_ptr(), s.window, s.pts.data_ptr(), s.mask.data_ptr(), r, s.stride,
        s.prior.data_ptr(), n_b, s.top.data_ptr(), k0, s.thetas.data_ptr(), n_t, s.beam_width,
        s.scale, s.unknown, s.step_xy, s.step_theta, s.shrink, s.iterations, s.reducer.code,
        s.reducer.radius, s.reducer.extent, pose.data_ptr(), prob.data_ptr(), trace.data_ptr(),
        k_max, shared, stream))
    _count("m3rsm_search", s.reducer)
    return pose, prob, trace


def m3rsm_search(s: M3RSMSearch):
    """B whole M3RSM matches (see :class:`M3RSMSearch`) -> (pose f32[B, 3],
    prob f32[B], trace f32[B, iterations]): the branch and bound, its
    winner's pose and score, then the hill climb (prob and trace its own).

    CPU tensors take the plain twin :func:`m3rsm_search_ref`; CUDA tensors
    launch the kernel on the current stream, once for all B (a cluster a
    request), with the bits of :func:`m3rsm_search_levels`, and add one to
    the ``m3rsm_search`` count of :func:`launch_counts`. Raises where the
    frontier, the beams and the thetas do not fit a block's shared memory.
    """
    if s.prior.device.type == "cpu":
        return m3rsm_search_ref(s)
    return _m3rsm_search_launch(s)
