"""CARMEN log reader (port of ``slam_constructor_tpu.utils.dataset``).

Reads the FLASER and ROBOTLASER1 records of a CARMEN log (the MIT Stata
and CSAIL 2D-lidar format) with their PARAM and TRUEPOS lines, and turns a
log into the (scan, odometry) sequence an engine runs: ranges filtered and
masked to a fixed width as the reference's ``LaserScanObserver`` does,
odometry as body-frame increments between scans.

The parser is the port's copy of the reference's native C++ parser
(``native/carmen_parser.cpp``, built with ``g++`` into ``build/native/`` at
first use and loaded by ``ctypes``), or, where it cannot be built or is not
wanted, the reference's Python parser, which gives the same arrays.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..ops.geometry import between
from ..ops.scan import LaserScan, make_scan
from . import _native

PARSER_SOURCE = Path(__file__).resolve().parents[1] / "native" / "carmen_parser.cpp"


@dataclass
class CarmenLog:
    """A parsed log: per-scan ranges and the odometry pose at scan time."""

    ranges: np.ndarray  # f32[T, R]
    odom_poses: np.ndarray  # f64[T, 3]
    timestamps: np.ndarray  # f64[T]
    start_angle: float = -math.pi / 2
    fov: float = math.pi
    max_range: float = 80.0
    #: PARAM records (raw strings, e.g. 'laser_front_laser_resolution')
    params: dict | None = None
    #: TRUEPOS ground-truth records, f64[N, 4] = (ts, x, y, theta), or None
    true_poses: np.ndarray | None = None

    @property
    def bearings(self) -> np.ndarray:
        r = self.ranges.shape[1]
        return (self.start_angle + self.fov * np.arange(r) / max(r - 1, 1)).astype(np.float32)

    def gt_at_scans(self) -> np.ndarray | None:
        """TRUEPOS ground truth at the scans' timestamps (the nearest
        record) as f32[T, 3], or None when the log has none."""
        if self.true_poses is None or len(self.true_poses) == 0:
            return None
        ts = self.true_poses[:, 0]
        idx = np.clip(np.searchsorted(ts, self.timestamps), 0, len(ts) - 1)
        prev = np.maximum(idx - 1, 0)
        take_prev = np.abs(ts[prev] - self.timestamps) < np.abs(ts[idx] - self.timestamps)
        idx = np.where(take_prev, prev, idx)
        return self.true_poses[idx, 1:4].astype(np.float32)


def _parse_aux_lines(lines) -> tuple[dict, np.ndarray | None]:
    """The PARAM key/values and the TRUEPOS ground truth of ``lines``."""
    params: dict = {}
    true_rows: list = []
    for line in lines:
        if line.startswith("PARAM"):
            t = line.split()
            if len(t) >= 3:
                params[t[1]] = t[2]
        elif line.startswith("TRUEPOS"):
            # TRUEPOS true_x true_y true_theta odom_x odom_y odom_theta
            #   ipc_ts host logger_ts
            t = line.split()
            if len(t) >= 8:
                true_rows.append([float(t[7]), float(t[1]), float(t[2]), float(t[3])])
    tp = np.asarray(true_rows, np.float64) if true_rows else None
    return params, tp


@functools.cache
def native_lib() -> ctypes.CDLL | None:
    """The native parser's library, built if needed; None without ``g++``."""
    lib = _native.load(PARSER_SOURCE, "slamio")
    if lib is None:
        return None
    lib.slamio_parse_carmen.restype = ctypes.c_void_p
    lib.slamio_parse_carmen.argtypes = [ctypes.c_char_p]
    lib.slamio_n_scans.argtypes = [ctypes.c_void_p]
    lib.slamio_n_beams.argtypes = [ctypes.c_void_p]
    lib.slamio_ranges.restype = ctypes.POINTER(ctypes.c_float)
    lib.slamio_ranges.argtypes = [ctypes.c_void_p]
    lib.slamio_odom.restype = ctypes.POINTER(ctypes.c_double)
    lib.slamio_odom.argtypes = [ctypes.c_void_p]
    lib.slamio_stamps.restype = ctypes.POINTER(ctypes.c_double)
    lib.slamio_stamps.argtypes = [ctypes.c_void_p]
    lib.slamio_meta.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.slamio_aux.restype = ctypes.c_char_p
    lib.slamio_aux.argtypes = [ctypes.c_void_p]
    lib.slamio_free.argtypes = [ctypes.c_void_p]
    return lib


def read_carmen(path: str, prefer_native: bool = True) -> CarmenLog:
    """Parse the FLASER/ROBOTLASER1 records of a CARMEN log file: the
    native parser when ``prefer_native`` and it builds, else the Python
    parser (and for a log in which the native one finds no scan), as the
    reference chooses."""
    lib = native_lib() if prefer_native else None
    if lib is not None:
        h = lib.slamio_parse_carmen(str(path).encode())
        if h:
            try:
                t, r = lib.slamio_n_scans(h), lib.slamio_n_beams(h)
                if t > 0:
                    ranges = np.ctypeslib.as_array(lib.slamio_ranges(h), shape=(t, r)).copy()
                    odom = np.ctypeslib.as_array(lib.slamio_odom(h), shape=(t, 3)).copy()
                    ts = np.ctypeslib.as_array(lib.slamio_stamps(h), shape=(t,)).copy()
                    meta = (ctypes.c_double * 3)()
                    log = CarmenLog(ranges, odom, ts)
                    has_meta = bool(lib.slamio_meta(h, meta))
                    if has_meta:
                        log.start_angle, log.fov, log.max_range = meta[0], meta[1], meta[2]
                    aux = lib.slamio_aux(h).decode(errors="replace")
                    log.params, log.true_poses = _parse_aux_lines(aux.splitlines())
                    _apply_params(log, geometry_from_records=has_meta)
                    return log
            finally:
                lib.slamio_free(h)
    return _read_carmen_py(path)


def _apply_params(log: CarmenLog, geometry_from_records: bool) -> None:
    """Fold the PARAM laser geometry into the log. FLASER records carry no
    geometry (classic logs declare it in PARAM lines); ROBOTLASER1 records
    carry start angle, field of view and max range, which win."""
    p = log.params or {}
    try:
        if geometry_from_records:
            return
        if "robot_front_laser_max" in p:
            log.max_range = float(p["robot_front_laser_max"])
        if "laser_front_laser_resolution" in p:
            res = math.radians(float(p["laser_front_laser_resolution"]))
            r = log.ranges.shape[1]
            fov = res * (r - 1)
            if 0 < fov <= 2 * math.pi:
                log.fov = fov
                log.start_angle = -fov / 2
    except ValueError:
        pass


def _read_carmen_py(path: str) -> CarmenLog:
    ranges, odom, ts = [], [], []
    meta = None
    n_beams = 0
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "FLASER":
                n = int(t[1])
                if n_beams == 0:
                    n_beams = n
                if n != n_beams or len(t) < 2 + n + 6:
                    continue
                ranges.append([float(v) for v in t[2 : 2 + n]])
                base = 2 + n
                odom.append([float(t[base + 3]), float(t[base + 4]), float(t[base + 5])])
                ts.append(float(t[base + 6]) if len(t) > base + 6 else len(ts))
            elif t[0] == "ROBOTLASER1":
                n = int(t[8])
                if n_beams == 0:
                    n_beams = n
                    meta = (float(t[2]), float(t[3]), float(t[5]))
                if n != n_beams or len(t) < 9 + n + 1:
                    continue
                nrem = int(t[9 + n])
                base = 9 + n + 1 + nrem
                if len(t) < base + 6:
                    continue
                ranges.append([float(v) for v in t[9 : 9 + n]])
                odom.append([float(t[base + 3]), float(t[base + 4]), float(t[base + 5])])
                ts.append(float(t[base + 11]) if len(t) > base + 11 else len(ts))
    log = CarmenLog(
        np.asarray(ranges, np.float32), np.asarray(odom, np.float64), np.asarray(ts, np.float64)
    )
    if meta:
        log.start_angle, log.fov, log.max_range = meta
    with open(path) as f:
        log.params, log.true_poses = _parse_aux_lines(f)
    _apply_params(log, geometry_from_records=meta is not None)
    return log


def to_sequence(
    log: CarmenLog,
    min_range: float = 0.05,
    max_range: float | None = None,
    beam_stride: int = 1,
    scan_stride: int = 1,
    device=None,
) -> tuple[LaserScan, torch.Tensor, np.ndarray]:
    """CarmenLog -> (LaserScan [T, R], odometry deltas f32[T, 3],
    timestamps f64[T]) with the tensors on ``device`` (the CPU when none is
    named). An odometry delta is the body-frame increment from the scan
    before (the reference's TransformedLaserScan pose delta); the first is
    0."""
    max_range = max_range if max_range is not None else min(log.max_range, 40.0)
    ranges = np.ascontiguousarray(log.ranges[::scan_stride, ::beam_stride])
    bearings = np.ascontiguousarray(log.bearings[::beam_stride])
    odom_poses = torch.as_tensor(log.odom_poses[::scan_stride].astype(np.float32), device=device)
    r = torch.as_tensor(ranges, device=device)
    scans = make_scan(
        r, torch.as_tensor(bearings, device=device).expand(r.shape).contiguous(), min_range,
        max_range,
    )
    deltas = between(odom_poses[:-1], odom_poses[1:])
    odom = torch.cat([torch.zeros((1, 3), device=odom_poses.device), deltas], dim=0)
    return scans, odom.to(torch.float32), log.timestamps[::scan_stride]
