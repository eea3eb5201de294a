"""Accuracy scenario-matrix CLI: the paper's <1% claim, end to end.

Runs real split inference (``models.forward_head`` -> FeatureCodec
round trip -> ``models.forward_from_boundary``) over a declarative
scenario matrix and reports task-metric degradation against the
measured wire rate.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.eval_accuracy \
        [--matrix default|all|name,name,...|file.json] \
        [--backend cuda|torch] [--device cuda|cpu] \
        [--select [--budget 0.01]] [--out report.json]

``--matrix`` accepts the pinned default mini-matrix, every registered
scenario, a comma-separated list of registry names, or a JSON file of
scenario dicts (see ``repro_torch.eval.scenarios.Scenario``).
``--select`` runs the auto split-point selector instead of a plain
sweep: for each scenario it sweeps every legal boundary tap and reports
the cheapest (matrix-product FLOPs of the head) tap whose worst-case
degradation stays within ``--budget``.  The model runs on ``--device``
(default ``cuda``; there is no silent CPU fallback), and the codec's
quantizer on the CUDA kernels unless ``--backend torch`` asks for the
torch formulas on the CPU.  The loopback-transport scenario
(``transformer-loopback``) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..eval import load_matrix, run_scenario, select_split_point


def _print_report(rep) -> None:
    print(f"scenario={rep.scenario.name} split_after={rep.split_after} "
          f"n_tokens={rep.n_tokens} "
          f"n_decisive={rep.cases[0].n_decisive} "
          f"elapsed_s={rep.elapsed_s:.1f}")
    for c in rep.cases:
        print(f"  {c.clip_mode:10s} N={c.rung:5d} "
              f"bpe={c.bits_per_elem:7.3f} deg={c.degradation:.4f} "
              f"raw_deg={c.raw_degradation:.4f} "
              f"logit_rmse={c.logit_rmse:.4f} bytes={c.coded_bytes}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="accuracy scenario matrix over real split inference")
    ap.add_argument("--matrix", default="default",
                    help="'default', 'all', comma-separated scenario "
                         "names, or a .json scenario file")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="the codec's quantizer backend: the CUDA kernels "
                         "(default) or the torch formulas on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on")
    ap.add_argument("--split-after", type=int, default=None,
                    help="override every scenario's boundary tap")
    ap.add_argument("--select", action="store_true",
                    help="run the auto split-point selector per scenario "
                         "instead of a plain sweep")
    ap.add_argument("--budget", type=float, default=0.01,
                    help="degradation budget for --select (default: the "
                         "paper's 1%%)")
    ap.add_argument("--out", default=None,
                    help="write the full JSON report here")
    args = ap.parse_args(argv)

    scenarios = load_matrix(args.matrix)
    out: dict = {"matrix": [sc.name for sc in scenarios]}
    if args.select:
        out["budget"] = args.budget
        out["selections"] = {}
        for sc in scenarios:
            sel = select_split_point(sc, budget=args.budget,
                                     backend=args.backend,
                                     device=args.device)
            out["selections"][sc.name] = sel.to_dict()
            chosen = (f"split_after={sel.chosen.split_after} "
                      f"(head_flops={sel.chosen.head_flops:.3g}, "
                      f"worst_deg={sel.chosen.worst_degradation:.4f})"
                      if sel.chosen is not None
                      else "NONE (no tap meets the budget)")
            print(f"scenario={sc.name} budget={args.budget}: {chosen}")
            for c in sel.candidates:
                print(f"  sa={c.split_after} flops={c.head_flops:.3g} "
                      f"worst_deg={c.worst_degradation:.4f} "
                      f"meets={c.meets_budget}")
    else:
        out["reports"] = {}
        for sc in scenarios:
            rep = run_scenario(sc, split_after=args.split_after,
                               backend=args.backend, device=args.device)
            out["reports"][sc.name] = rep.to_dict()
            _print_report(rep)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
