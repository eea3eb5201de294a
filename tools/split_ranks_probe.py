#!/usr/bin/env python3
"""The split step in one process against the same step across two ranks,
in turns within one call, on one card.

    python3 tools/split_ranks_probe.py [--rounds 2]

codeqwen1.5-7b at published width and depth (bf16, random weights from
seed 0), split 16 + 16, the packed transport with a per-tensor N=4
codec clipping at (-2.2, 2.9) (the range ``tools/codec_call_time.py``
takes), 4 sequences fed seeded tokens for 16 decode steps.  Runs the
one-process step, then ``chip_smoke.py`` phase 11's two gloo ranks in a
(pod, data, model) = (2, 1, 1) mesh, ``--rounds`` times, then the
one-process step once more, each timed as phase 11 times it (its
``traced_steps`` and ``step_parts``), and prints the median ms of each
part of a step: the two compared on one host clock within one call,
whose spread is smaller than that across calls.  Prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH, BATCH, STEPS, MAX_SEQ = "codeqwen1.5-7b", 4, 16, 32
RANGE = (-2.2, 2.9)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_ranks_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.compression import split_runtime as SR
    from repro_torch.configs import get_config
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()            # built once, before any timed step
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    codec = calibrate(CodecConfig(n_levels=4, clip_mode="manual",
                                  manual_cmin=RANGE[0], manual_cmax=RANGE[1],
                                  backend="cuda"))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, BATCH)))
    sp = SR.split_params(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        edge_device=dev, cloud_device=dev)
    job = {"arch": ARCH, "overrides": {}, "mesh": (2, 1, 1),
           "in_turn": False, "max_seq": MAX_SEQ,
           "runs": [("probe", "packed", codec, tokens)]}

    def one_process(label):
        parts = CS.one_process_parts(cfg, codec, sp, tokens.to(dev), dev)
        print(f"{label}:", json.dumps({k: round(v, 3)
                                       for k, v in parts.items()}))

    (ROOT / "build").mkdir(exist_ok=True)
    for _ in range(args.rounds):
        one_process("one process")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            edge, cloud = CS.spawn_split_ranks(2, job, tmp)
        parts = CS.step_parts(edge["probe"]["steps"], cloud["probe"]["steps"])
        print("two ranks:", json.dumps({k: round(v, 3)
                                        for k, v in parts.items()}))
    one_process("one process")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
