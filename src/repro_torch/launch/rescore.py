"""Re-price saved dry-run cells from their op tables (no new meta pass).

The port's counterpart of ``repro.launch.rescore``.  Used whenever the
cost model (``launch.cost_analysis``) or the hardware model
(``launch.dryrun.H100``) changes: re-reads each cell's ``.ops.json.gz``,
recomputes its ``ops`` and ``roofline`` and rewrites its JSON.

    PYTHONPATH=src python -m repro_torch.launch.rescore [PATTERN]
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys

from ..configs import SHAPES, get_config
from .dryrun import OUT_DIR, score


def rescore_record(rec: dict, table: dict) -> dict:
    """``rec`` with ``ops``, ``model_flops_global`` and ``roofline``
    recomputed from its cell's op table."""
    cfg = get_config(rec["arch"])
    return score(rec, table, cfg, SHAPES[rec["shape"]])


def main(pattern: str = "*.json", base: str = OUT_DIR):
    for jpath in sorted(glob.glob(os.path.join(base, pattern))):
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or "ops_path" not in rec:
            continue
        opath = rec["ops_path"]
        if not os.path.exists(opath):
            opath = os.path.join(base, os.path.basename(opath))
        if not os.path.exists(opath):
            print(f"[rescore] missing op table for {jpath}")
            continue
        with gzip.open(opath, "rt") as f:
            rec = rescore_record(rec, json.load(f))
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        rl = rec["roofline"]
        print(f"[rescore] {rec['arch']:24s} {rec['shape']:12s}"
              f" {rec['mesh']:11s} bound={rl['bound']:10s}"
              f" eager_roofline={rl['step_time_lower_bound_s']:.3f}s"
              f" mfu_bound={rl['mfu_bound']:.4f}")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
