"""Build and load the port's host C++ sources (``native/*.cpp``) with
``g++`` into ``build/native/`` at the root of the checkout, named after a
hash of the source and the flags, at first use; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC")


def library_path(source: Path, stem: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + source.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def load(source: Path, stem: str) -> ctypes.CDLL | None:
    """The library of ``source``, built if needed; None without ``g++`` or
    where it does not build or load."""
    out = library_path(source, stem)
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(source)], check=True,
                           capture_output=True)
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        except (OSError, subprocess.CalledProcessError):
            return None
        finally:
            tmp.unlink(missing_ok=True)
    try:
        return ctypes.CDLL(str(out))
    except OSError:
        return None
