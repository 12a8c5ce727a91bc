"""ctypes loader for the native cross-validation oracle (port of
``slam_constructor_tpu.utils.native_oracle``).

The oracle is an independent scalar C++ re-derivation of the obstacle
reducer's score and of SE(2) composition (``native/score_oracle.cpp``, the
port's own copy). It is built with ``g++`` on first use into ``build/native/``
at the root of the checkout (named after a hash of the source), and loaded
with ``ctypes``; nothing is built at import, and nothing is read from or
written to another package's directory. Test-facing: the functions return
None where no C++ toolchain is found.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "score_oracle.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libslamscore-{h.hexdigest()[:16]}.so"


@functools.cache
def lib() -> ctypes.CDLL | None:
    """The oracle's library, built if needed; None without ``g++``."""
    out = library_path()
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True)
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        except (OSError, subprocess.CalledProcessError):
            return None
        finally:
            tmp.unlink(missing_ok=True)
    try:
        l = ctypes.CDLL(str(out))
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    l.slamscore_obstacle.restype = ctypes.c_float
    l.slamscore_obstacle.argtypes = [
        f32p, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, f32p, u8p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ]
    l.slamscore_compose.argtypes = [f32p, f32p, f32p]
    return l


def _host(t, dtype) -> np.ndarray:
    """A tensor or array as a C-contiguous numpy array on the host."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(t), dtype)


def score_obstacle(view, scan, pose, unknown_prob: float = 0.5, stride: int = 1):
    """The oracle's score (obstacle reducer) of ``scan`` at ``pose`` f32[3]
    on ``view`` (a ``scoring.MapView`` of one map); None without the
    library."""
    l = lib()
    if l is None:
        return None
    occ = _host(view.occ, np.float32)
    origin = _host(view.origin, np.float32)
    p = _host(pose, np.float32)
    ranges = _host(scan.ranges, np.float32)
    return float(l.slamscore_obstacle(
        occ, _host(view.known, np.uint8), occ.shape[0], occ.shape[1],
        float(origin[0]), float(origin[1]), float(view.scale), float(unknown_prob),
        ranges, _host(scan.bearings, np.float32), _host(scan.valid, np.uint8), len(ranges),
        int(stride), float(p[0]), float(p[1]), float(p[2]),
    ))


def compose(a, b):
    """The oracle's SE(2) composition of a and b f32[3]; None without the
    library."""
    l = lib()
    if l is None:
        return None
    out = np.zeros(3, np.float32)
    l.slamscore_compose(_host(a, np.float32), _host(b, np.float32), out)
    return out
