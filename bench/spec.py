"""Find a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are ``bench/configs/<config>.json``, ``bench/mixes/<traffic>.json``
and ``bench/limits/<cell>.json``, each per-layer metric is read by
``bench/metrics/<metric>.py``, and each layer kind is computed and
counted by ``bench/layers/<kind>.py``.  Adding a cell is adding files
and a ``workloads`` entry: nothing here names a cell.  A configuration
that sets an option no module of its layers reads is refused here,
before any weights are made.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

from .layers import check_options

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict         # bench/configs/<config>.json
    mix: dict            # bench/mixes/<traffic>.json
    limits: dict         # bench/limits/<cell>.json
    end_to_end: list     # the metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path | None = None) -> Cell:
    spec = load_json(benchmark or ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in spec['workloads']]}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf["file"])
    from .reference.model import OPTIONS
    check_options(config["model"], conf["file"], OPTIONS)
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        mix=load_json(BENCH / "mixes" / f"{entry['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """``read(ctx)`` of ``bench/metrics/<name>.py``: the metric's value,
    or None where the run gave it nothing to read."""
    return importlib.import_module(f"bench.metrics.{name}").read


def model_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file's ``model``
    section (``pattern`` as a list of layer-spec dicts)."""
    from repro_torch.configs.base import LayerSpec, ModelConfig
    fields = dict(config["model"])
    if "pattern" in fields:
        fields["pattern"] = tuple(LayerSpec(**p) for p in fields["pattern"])
    return ModelConfig(**fields)
