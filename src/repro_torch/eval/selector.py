"""Auto split-point selection (arXiv:1802.03931 via the accuracy sweep).

The edge wants to run as little of the network as possible; the paper's
constraint is that compression at the boundary must not cost task
accuracy.  :func:`select_split_point` sweeps every legal boundary tap of
a scenario through the same accuracy harness, prices each tap's *edge*
cost as the matrix-product FLOPs of the port's ``forward_head``
(counted by ``torch.utils.flop_counter.FlopCounterMode`` over one call,
not a layer-count proxy), and returns the cheapest tap whose worst-case
degradation across the scenario's codec matrix stays within the budget.

Everything is deterministic: the harness's token batches and parameter
init are seeded by the scenario, and the FLOPs are a property of the
shapes, so repeated selection returns the same tap.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import models
from .harness import ScenarioReport, run_scenario
from .scenarios import Scenario

__all__ = ["SplitCandidate", "SplitSelection", "head_flops",
           "select_split_point"]


@dataclasses.dataclass(frozen=True)
class SplitCandidate:
    split_after: int
    head_flops: float
    worst_degradation: float     # max over the scenario's codec matrix
    meets_budget: bool
    report: ScenarioReport

    def to_dict(self) -> dict[str, Any]:
        return {"split_after": self.split_after,
                "head_flops": self.head_flops,
                "worst_degradation": self.worst_degradation,
                "meets_budget": self.meets_budget}


@dataclasses.dataclass(frozen=True)
class SplitSelection:
    scenario: str
    budget: float
    chosen: SplitCandidate | None    # None: no tap meets the budget
    candidates: tuple[SplitCandidate, ...]

    def to_dict(self) -> dict[str, Any]:
        return {"scenario": self.scenario, "budget": self.budget,
                "chosen": (self.chosen.to_dict()
                           if self.chosen is not None else None),
                "candidates": [c.to_dict() for c in self.candidates]}


def head_flops(sc: Scenario, split_after: int, *, device="cuda") -> float:
    """Edge-side cost of one boundary tap: the FLOPs of every matrix
    product (``mm``/``bmm``, einsums included) of one ``forward_head``
    call on zero tokens of the scenario's batch shape, on ``device``."""
    device = models.resolve_device(device)
    cfg = sc.model_config()
    gen = torch.Generator(device=device).manual_seed(sc.seed)
    params = models.init_params(cfg, gen, device=device)
    tokens = torch.zeros((sc.batch, sc.seq_len), dtype=torch.int32,
                         device=device)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        models.forward_head(cfg, params, tokens, split_after=split_after)
    return float(counter.get_total_flops())


def select_split_point(sc: Scenario, *, budget: float = 0.01,
                       backend: str | None = None,
                       device="cuda") -> SplitSelection:
    """Cheapest boundary tap meeting the degradation budget.

    Sweeps ``split_after`` in 1..n_periods-1, runs the scenario's full
    codec matrix at each tap, and picks the tap with the lowest
    edge-side FLOPs among those whose *worst* case degradation is
    <= ``budget``.  Ties (identical FLOPs) break toward the shallower
    tap.  Returns every candidate so callers can inspect the frontier.
    """
    candidates = []
    for sa in sc.split_points:
        report = run_scenario(sc, split_after=sa, backend=backend,
                              device=device)
        worst = max(c.degradation for c in report.cases)
        candidates.append(SplitCandidate(
            split_after=sa, head_flops=head_flops(sc, sa, device=device),
            worst_degradation=worst, meets_budget=worst <= budget,
            report=report))
    eligible = [c for c in candidates if c.meets_budget]
    chosen = (min(eligible, key=lambda c: (c.head_flops, c.split_after))
              if eligible else None)
    return SplitSelection(scenario=sc.name, budget=budget, chosen=chosen,
                          candidates=tuple(candidates))
