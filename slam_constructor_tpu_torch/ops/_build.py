"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``build/torch_kernels/`` at the root of the checkout, named after a hash of
the sources, headers (``csrc/*.cuh``) and flags, so it is built on first
CUDA use and rebuilt when one of them changes. Importing this module runs nothing; a machine without
``nvcc`` imports the package and runs the CPU path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
LIB_NAME = "slam_torch_kernels"

#: Hopper only: `sm_90a` (the `a` keeps wgmma/setmaxnreg available).
#: No --use_fast_math, and --fmad=false: products and sums round on their
#: own, as in the plain PyTorch twins the kernels are checked against.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (register and shared-memory use per kernel)
    #: each source's nvcc wall seconds, from the common start (empty when
    #: the library was already built)
    source_seconds: dict = dataclasses.field(default_factory=dict)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of slam_constructor_tpu_torch are built from source on first use"
    )


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path(extra_flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + extra_flags + LINK_FLAGS).encode())
    # the headers too: a source includes them from its own directory
    for src in (*_sources(), *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{LIB_NAME}-{h.hexdigest()[:16]}.so"


def build(extra_flags: tuple[str, ...] = ()) -> BuildResult:
    """Compile the sources unless a library for their hash exists.
    ``extra_flags`` go to every nvcc compile (``kernel_probe.py``'s stamp
    build: ``-DSLAM_KERNEL_PROBE``); the package's own build passes none."""
    out = library_path(extra_flags)
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    cmds = [
        [nvcc, *COMPILE_FLAGS, *extra_flags, "-o", str(obj), str(src)]
        for src, obj in zip(_sources(), objs)
    ]
    t0 = time.perf_counter()
    logs = [obj.with_name(f"{obj.name}.log") for obj in objs]
    try:
        # one nvcc a source, all started together, each writing its own log
        procs = []
        for c, lf in zip(cmds, logs):
            with open(lf, "w") as f:
                procs.append(subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT, text=True))
        ends = {}
        while len(ends) < len(procs):
            for src, proc in zip(_sources(), procs):
                if src.name not in ends and proc.poll() is not None:
                    ends[src.name] = time.perf_counter() - t0
            time.sleep(0.02)
        log = ""
        for cmd, proc, lf in zip(cmds, procs, logs):
            text = lf.read_text()
            log += text
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        done = subprocess.run(link, capture_output=True, text=True)
        log += done.stdout + done.stderr
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed ({done.returncode}): {' '.join(link)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for f in (tmp, *objs, *logs):
            f.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0, log, ends)


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    return ctypes.CDLL(str(build().path))
