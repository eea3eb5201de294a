#!/usr/bin/env python3
"""Readings that the limits in ``bench/limits/<cell>.json`` are set from.

    python3 bench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...] [--out <file>]

Runs the cell once a seed in one process, as ``bench/run.py`` does, and
writes a JSON line a seed: the window's counts and every number the
check can compare (``check.readings``).  For the control seeds it also
runs the control, the reference in float8 put in the program's place,
and gives its numbers under ``control``.  The limit of a number lies
above what sound runs read and below what the control reads.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.harness import run_cell
    from bench.spec import load_cell
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    seeds = args.seeds + [s for s in args.control_seeds
                          if s not in args.seeds]
    for seed in seeds:
        t0 = time.perf_counter()
        res = run_cell(cell, seed, args.seconds, False, "cuda", t0,
                       control=seed in args.control_seeds)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": res["correct"],
                           "window": res["window"],
                           "timings": res["timings"],
                           "metrics": res["metrics"],
                           "readings": res["readings"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        del res
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
