#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, from the repository's root:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, the device's busy
seconds over the traced window and a breakdown.  The last line of
standard output is the result; the numbers that decided ``correct``
close standard error, each beside its limit.  It refuses to run, and
prints no result, without as many CUDA devices as the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown",
        "checks")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed places inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from bench.harness import run_cell
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    print(json.dumps({"card": card_line(), "window": res["window"],
                      "timings": res["timings"],
                      "readings": res["readings"]}), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({k: res[k] for k in KEYS if k in res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
