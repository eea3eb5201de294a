"""Declarative, schema-validated accuracy scenarios.

The port's copy of the JAX package's ``repro.eval.scenarios`` (configs
and JSON only): the same fields, checks, registry and matrix specs, over
the port's own ``configs``.

A :class:`Scenario` names one end-to-end split-inference configuration:
which model family to cut, where to cut it, and the codec matrix
(rate rungs x clip modes x granularity) to sweep at that boundary.
Scenarios follow the dataclass-config-factory idiom (ludwig's schema
layer): every field is validated at construction, instances are frozen
and hashable, and each round-trips through JSON so a sweep is fully
described by one declarative blob -- no imperative setup hides in the
harness.

The named registry (:data:`SCENARIOS`) pins the default matrix used by
``launch/eval_accuracy.py`` and ``chip_smoke.py``: one scenario per
activation family the paper's claim must cover (transformer boundary,
MoE expert outputs, rwkv6 / rglru recurrent-state streams), plus
tiled-granularity variants.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from ..configs.base import ModelConfig, reduced
from ..configs.registry import ARCHS, get_config

GRANULARITIES = ("tensor", "channel", "tile", "tile2d")
CLIP_MODES = ("model", "empirical", "aciq", "minmax")
TRANSPORTS = ("inproc", "loopback")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative accuracy-sweep configuration.

    The model is the registry arch shrunk to ``period * n_periods``
    layers at ``d_model`` width (``configs.base.reduced``), so every
    family keeps its real layer pattern -- an rglru scenario still
    interleaves rglru/attention periods -- while staying smoke-test
    sized.  ``split_after`` taps the boundary after that many full
    periods (None = the config's default mid-point).
    """

    name: str
    arch: str
    n_periods: int = 4
    split_after: int | None = None
    d_model: int = 64
    seq_len: int = 32
    batch: int = 2
    n_eval_batches: int = 2
    rungs: tuple[int, ...] = (256, 16, 4)
    clip_modes: tuple[str, ...] = ("minmax", "empirical")
    granularity: str = "tensor"
    channel_group_size: int = 1
    spatial_block_size: int = 0          # 'tile': elements per block
    spatial_block_hw: tuple[int, int] | None = None  # 'tile2d': (bh, bw)
    use_ecsq: bool = False
    calib_sample_cap: int = 0
    transport: str = "inproc"
    # task-metric stability: degradation is scored over tokens whose
    # reference top-2 logit margin exceeds this (near-tie argmax of a
    # smoke-scale random-init model flips under infinitesimal
    # perturbation -- sampling noise, not task signal; real codec
    # failures shift logits far past any such margin).  Raw agreement
    # over every token is reported alongside.
    decisive_margin: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if not self.name:
            raise ValueError("scenario needs a name")
        cfg = get_config(self.arch)      # raises KeyError on unknown arch
        if cfg.input_mode != "tokens":
            raise ValueError(
                f"{self.name}: arch {self.arch!r} takes "
                f"{cfg.input_mode!r} input; accuracy scenarios need a "
                "token-in model (the embedding frontends are stubs)")
        if self.n_periods < 2:
            raise ValueError(
                f"{self.name}: n_periods={self.n_periods} < 2 -- the "
                "split boundary needs at least one period on each side")
        if self.split_after is not None \
                and not 1 <= self.split_after <= self.n_periods - 1:
            raise ValueError(
                f"{self.name}: split_after={self.split_after} out of "
                f"range for n_periods={self.n_periods}")
        if self.seq_len < 1 or self.batch < 1 or self.n_eval_batches < 1:
            raise ValueError(f"{self.name}: seq_len/batch/n_eval_batches "
                             "must be positive")
        if not self.rungs:
            raise ValueError(f"{self.name}: empty rung ladder")
        if any(r < 2 for r in self.rungs):
            raise ValueError(f"{self.name}: every rung needs >= 2 levels, "
                             f"got {self.rungs}")
        if len(set(self.rungs)) != len(self.rungs):
            raise ValueError(f"{self.name}: duplicate rungs {self.rungs}")
        if tuple(sorted(self.rungs, reverse=True)) != tuple(self.rungs):
            raise ValueError(
                f"{self.name}: rungs must be sorted high-to-low (the "
                f"monotone-degradation gate reads them as a ladder), "
                f"got {self.rungs}")
        if not self.clip_modes:
            raise ValueError(f"{self.name}: empty clip_modes")
        bad = set(self.clip_modes) - set(CLIP_MODES)
        if bad:
            raise ValueError(f"{self.name}: unknown clip modes {sorted(bad)}"
                             f"; allowed: {CLIP_MODES}")
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"{self.name}: unknown granularity "
                             f"{self.granularity!r}; allowed: "
                             f"{GRANULARITIES}")
        if self.granularity == "tile2d" and self.spatial_block_hw is None:
            raise ValueError(f"{self.name}: tile2d granularity needs "
                             "spatial_block_hw=(bh, bw)")
        if self.granularity != "tile2d" and self.spatial_block_hw is not None:
            raise ValueError(f"{self.name}: spatial_block_hw is a tile2d "
                             "setting")
        if self.transport not in TRANSPORTS:
            raise ValueError(f"{self.name}: unknown transport "
                             f"{self.transport!r}; allowed: {TRANSPORTS}")
        if self.calib_sample_cap < 0:
            raise ValueError(f"{self.name}: calib_sample_cap must be >= 0")

    # -- derived ---------------------------------------------------------------

    def model_config(self) -> ModelConfig:
        """The shrunk :class:`ModelConfig` this scenario evaluates.

        ``layers = period * n_periods`` is explicit: ``reduced``'s
        default layer count gives only ONE full period for multi-period
        patterns (rglru's period-3 pattern), which has no interior split
        boundary at all.
        """
        base = get_config(self.arch)
        return reduced(base, layers=base.period * self.n_periods,
                       d_model=self.d_model, seq_len_cap=self.seq_len)

    @property
    def split_points(self) -> tuple[int, ...]:
        """Every legal boundary tap for this scenario's depth."""
        return tuple(range(1, self.n_periods))

    # -- serialization ---------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str | dict[str, Any]) -> "Scenario":
        d = json.loads(blob) if isinstance(blob, str) else dict(blob)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown scenario fields {sorted(unknown)}")
        for k in ("rungs", "clip_modes"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        if d.get("spatial_block_hw") is not None:
            d["spatial_block_hw"] = tuple(d["spatial_block_hw"])
        return cls(**d)


# ---------------------------------------------------------------------------
# named registry
# ---------------------------------------------------------------------------

def _default_scenarios() -> dict[str, Scenario]:
    mk = Scenario
    return {s.name: s for s in [
        # the three activation families the paper's <1% claim must cover
        mk(name="transformer-tensor", arch="codeqwen1.5-7b"),
        mk(name="moe-expert", arch="dbrx-132b"),
        mk(name="rwkv-state", arch="rwkv6-3b"),
        # recurrentgemma interleaves 2x rglru + 1x attn per period: the
        # boundary tensor is a recurrent-state stream, not attention
        mk(name="rglru-state", arch="recurrentgemma-2b", n_periods=2),
        # granularity variants on the transformer boundary
        mk(name="transformer-channel", arch="codeqwen1.5-7b",
           granularity="channel", channel_group_size=8),
        mk(name="transformer-tile", arch="codeqwen1.5-7b",
           granularity="tile", channel_group_size=8,
           spatial_block_size=32),
        mk(name="transformer-tile2d", arch="codeqwen1.5-7b",
           granularity="tile2d", channel_group_size=8,
           spatial_block_hw=(2, 8)),
        # ACIQ baseline column (pins cmin = 0, the paper's comparison)
        mk(name="transformer-aciq", arch="codeqwen1.5-7b",
           clip_modes=("minmax", "aciq")),
        # the real-wire variant: every boundary tensor crosses a socket
        mk(name="transformer-loopback", arch="codeqwen1.5-7b",
           transport="loopback", n_eval_batches=1),
    ]}


SCENARIOS: dict[str, Scenario] = _default_scenarios()

#: the pinned CI mini-matrix: one scenario per family, small enough for
#: the accuracy_smoke job, broad enough for the >= 3 families x >= 3
#: rungs x >= 2 clip-modes acceptance bar
DEFAULT_MATRIX = ("transformer-tensor", "moe-expert", "rwkv-state",
                  "rglru-state")


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{sorted(SCENARIOS)}")
    return SCENARIOS[name]


def load_matrix(spec: str | None = None) -> list[Scenario]:
    """Resolve a CLI matrix spec: ``None``/"default" -> the pinned
    mini-matrix, "all" -> every registered scenario, a comma-separated
    name list -> those, a path ending in .json -> a JSON array of
    scenario dicts."""
    if spec is None or spec == "default":
        return [SCENARIOS[n] for n in DEFAULT_MATRIX]
    if spec == "all":
        return [SCENARIOS[n] for n in sorted(SCENARIOS)]
    if spec.endswith(".json"):
        with open(spec) as f:
            return [Scenario.from_json(d) for d in json.load(f)]
    return [get_scenario(n.strip()) for n in spec.split(",") if n.strip()]


__all__ = ["ARCHS", "CLIP_MODES", "DEFAULT_MATRIX", "GRANULARITIES",
           "SCENARIOS", "TRANSPORTS", "Scenario", "get_scenario",
           "load_matrix"]
