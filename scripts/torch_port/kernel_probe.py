"""Short first look at the port's CUDA kernels on a card: build, compiler
report, instruction mix, one launch of each new kernel against its twin,
and back-to-back launch times.

    python3 scripts/torch_port/kernel_probe.py

Prints ptxas' registers and shared memory for every kernel; for every
kernel in the built library the count of SASS instructions by opcode
(``cuobjdump -sass``; the straight-line length of a kernel is what
``chip_smoke.py``'s operation counts for the roofline bound are checked
against); ``polar_free_plane`` against ``polar_free_plane_ref`` at 256^2
cells and 360 beams; and the time of 200 launches queued back to back
between one pair of CUDA events, divided by 200, for both kernels (a
launch's cost with the queue kept full, beside ``chip_smoke.py``'s time of
a single call between its own events). Imports no JAX.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root

FP_OPS = ("FADD", "FMUL", "FFMA", "MUFU", "FSETP", "FMNMX", "FSEL", "F2I", "I2F", "FRND", "FCHK",
          "F2F", "FSET")


def sass_mix(lib: Path) -> None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        print(f"sass: cuobjdump not usable ({e})")
        return
    name, mix = None, collections.Counter()

    def flush():
        if name:
            fp = sum(mix[o] for o in FP_OPS) + mix["FFMA"]  # an FFMA is two operations
            top = ", ".join(f"{o} {n}" for o, n in mix.most_common(14))
            print(f"sass [{name}]: {sum(mix.values())} instructions, {fp} f32 operations "
                  f"if every one ran once; {top}")

    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            name, mix = m.group(1), collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m:
            mix[m.group(1)] += 1
    flush()


def chained_ms(fn, n: int = 200) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from slam_constructor_tpu_torch.models import tiny, viny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import _build, kernels, raycast, scoring
    from slam_constructor_tpu_torch.utils import datagen

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    res = _build.build()
    print(f"build: {res.seconds:.2f} s")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load()
    sass_mix(res.path)

    occ, origin, scale = datagen.cecum_world(device=dev)
    pose = torch.tensor([0.3, -1.45, 0.7], device=dev)
    scan = raycast.cast_rays(occ, origin, scale, pose, datagen.default_bearings(360, device=dev))
    beam = viny.viny_config().beam
    args = (scan.ranges, scan.valid, scan.bearings, pose,
            torch.tensor([-12.8, -12.8], device=dev), 256, 256, 0.1, beam.hole_width / 2.0,
            beam.max_range)
    got, want = kernels.polar_free_plane(*args), kernels.polar_free_plane_ref(*args)
    torch.cuda.synchronize()
    both = (got > 0) & (want > 0)
    print(f"polar_free_plane vs twin: free {int(both.sum())}, flipped "
          f"{int(((got > 0) != (want > 0)).sum())}, max |diff| {float((got - want).abs().max()):.3e}, "
          f"bitwise equal {torch.equal(got, want)}")

    cfg = tiny.tiny_config(map_size=256)
    gm = raycast.insert_scan(init_state(cfg, dev).gm, cfg.cell_model, pose, scan, cfg.beam)
    prep = scoring.prepare(scoring.MapView.of(gm, cfg.cell_model), scan, cfg.matcher_cfg.scoring)
    cand = pose + 0.05 * torch.randn((64, 3), device=dev)
    sargs = (prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    for name, fn in (
        ("polar_free_plane", lambda: kernels.polar_free_plane(*args)),
        ("polar_free_plane_ref", lambda: kernels.polar_free_plane_ref(*args)),
        ("overlap_score K=64 R=360", lambda: kernels.overlap_score(*sargs)),
        ("torch.empty((256, 256)) alone", lambda: torch.empty((256, 256), device=dev)),
    ):
        print(f"chained [{name}]: {chained_ms(fn):.5f} ms a launch (200 back to back)")


if __name__ == "__main__":
    main()
