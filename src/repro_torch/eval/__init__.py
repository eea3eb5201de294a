"""Accuracy-grounded evaluation: scenarios, harness, split-point selector.

The subsystem that closes the paper's headline claim (<1% task-accuracy
loss at 0.6-0.8 bits/element) on real split inference instead of
synthetic-blob MSE.  See DESIGN.md, "Accuracy scenario matrix".
"""

from .harness import (CaseResult, ScenarioReport, codec_config_for,
                      run_matrix, run_scenario)
from .scenarios import (CLIP_MODES, DEFAULT_MATRIX, GRANULARITIES,
                        SCENARIOS, TRANSPORTS, Scenario, get_scenario,
                        load_matrix)
from .selector import (SplitCandidate, SplitSelection, head_flops,
                       select_split_point)

__all__ = ["CLIP_MODES", "CaseResult", "DEFAULT_MATRIX", "GRANULARITIES",
           "SCENARIOS", "Scenario", "ScenarioReport", "SplitCandidate",
           "SplitSelection", "TRANSPORTS", "codec_config_for",
           "get_scenario", "head_flops", "load_matrix", "run_matrix",
           "run_scenario", "select_split_point"]
