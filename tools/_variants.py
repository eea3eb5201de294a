"""Helpers of the kernel-variant scripts: build a source into its own
library with ``-Xptxas -v``, and time a launch with CUDA events."""

from __future__ import annotations

import statistics
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def build(name: str, src: str, work: Path, nvcc: str, flags) -> tuple:
    """Compile ``src`` to ``work/<name>.so``; returns (path, the
    ``-Xptxas -v`` register line of each kernel, by mangled name)."""
    cu = work / f"{name}.cu"
    cu.write_text(src)
    lib = work / f"{name}.so"
    p = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-I",
                        str(ROOT / "src/repro_torch/csrc"), "-shared", "-o",
                        str(lib), str(cu)], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{p.stdout}{p.stderr}")
    regs, entry = [], ""
    for ln in p.stderr.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln:
            regs.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
    return lib, regs


def time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Median device time of one call over ``trials`` runs of ``reps``
    back-to-back calls, the stream held by a spin while they enqueue."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e7))       # ~10 ms: the host enqueues ahead
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)
