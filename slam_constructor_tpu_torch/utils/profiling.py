"""Timing and speed-of-light reports on the card (port of
``slam_constructor_tpu.utils.profiling``).

- :func:`device_specs`: the card's name, power limit and peak rates. The
  H100's are the published figures that PERF.md's bounds use: 3.35 TB/s
  of HBM and 67 TFLOP/s of float32 outside the tensor cores (989 TFLOP/s
  bf16 dense), for a card at its full 700 W; the name, the memory and the
  SM count are read from ``torch.cuda.get_device_properties``, the power
  limit from ``nvidia-smi``.
- :func:`timed`: the time of a call on CUDA events, after a warm-up.
- :func:`sol_report`: a measured time against the larger of the bytes and
  the operations bound.
- :func:`trace`: ``torch.profiler`` around a block, its trace exported.
- :class:`StepTimer`: host time of steps that end in a synchronise.

Every measurement needs the card: without one these raise, they do not
time the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import shutil
import subprocess
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeviceSpecs:
    name: str
    power_limit: str  # as nvidia-smi gives it, e.g. "700.00 W"
    sms: int
    memory_bytes: int
    peak_flops_bf16: float  # FLOP/s
    peak_flops_f32: float
    hbm_bandwidth: float  # B/s

    def label(self) -> str:
        return f"{self.name}, {self.power_limit}"


#: published peaks (NVIDIA's H100 SXM data sheet, dense): bf16, f32, HBM
_H100_PEAKS = (989e12, 67e12, 3.35e12)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it ("not read"
    where it is not there)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not read"
    out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


@functools.cache
def device_specs() -> DeviceSpecs:
    """The attached H100's specs; raises without a card, or for another
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_specs: no CUDA device")
    props = torch.cuda.get_device_properties(0)
    if "H100" not in props.name:
        raise RuntimeError(f"device_specs: no published peaks for {props.name}")
    return DeviceSpecs(props.name, power_limit(), props.multi_processor_count,
                       props.total_memory, *_H100_PEAKS)


def sync(_=None) -> None:
    """Wait for the card (the argument is ignored: PyTorch orders work on
    its stream)."""
    torch.cuda.synchronize()


def timed(f, *args, iters: int = 20, warmup: int = 2) -> float:
    """Seconds a call of ``f(*args)``: CUDA events around ``iters`` calls
    after ``warmup`` calls, divided by ``iters``."""
    for _ in range(warmup):
        f(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        f(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def sol_report(name: str, measured_s: float, flops: float = 0.0, bytes_accessed: float = 0.0,
               dtype: str = "f32") -> dict:
    """A measured time against the least time the card could take: the
    larger of ``flops`` over the peak rate of ``dtype`` and
    ``bytes_accessed`` over the HBM rate."""
    spec = device_specs()
    peak = spec.peak_flops_bf16 if dtype == "bf16" else spec.peak_flops_f32
    t_ops = flops / peak
    t_bytes = bytes_accessed / spec.hbm_bandwidth
    t_sol = max(t_ops, t_bytes, 1e-12)
    return {
        "kernel": name,
        "device": spec.label(),
        "measured_ms": measured_s * 1e3,
        "bound_ms": t_sol * 1e3,
        "sol_fraction": t_sol / measured_s if measured_s > 0 else 0.0,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


@contextlib.contextmanager
def trace(path: str):
    """``torch.profiler`` (CPU and CUDA activities) around a block; the
    Chrome trace is written to ``path``. Yields the profiler, whose
    ``key_averages()`` sum the kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    """Host time of steps, each ended by a synchronise of the card:

        timer = StepTimer()
        with timer:
            step()
        timer.summary()
    """

    def __init__(self):
        self.samples: list[float] = []
        self._t0 = None

    def __enter__(self):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.samples.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = np.asarray(self.samples)
        return {
            "steps": len(s),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p95_ms": float(np.percentile(s, 95) * 1e3),
            "steps_per_sec": float(1.0 / s.mean()),
        }
