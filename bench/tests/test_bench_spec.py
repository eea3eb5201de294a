"""Every cell of BENCHMARK.json finds its files by name, and the file
keeps to the benchmark's contract."""

import json
import re

import pytest

from bench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["model"]["vocab_size"] > 0
    assert c.mix["slots"] > 0 and c.mix["requests"] > c.mix["slots"]
    assert set(c.limits["checks"]) >= {"quant_mismatch"}
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_mix_names_the_source_of_its_lengths(cell):
    mix = spec.load_cell(cell).mix
    assert mix["source"] and "arXiv" in mix["source"]
    for key in ("prompt_len", "output_len"):
        assert set(mix[key]) == {"dist", "median", "sigma", "min", "max"}
    assert set(mix["fitted"]) >= {"median", "sigma", "max"}
    assert mix["requests"] % mix["slots"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_config_builds_the_ports_model_config(cell):
    c = spec.load_cell(cell)
    cfg = spec.model_config(c.config)
    m = c.config["model"]
    assert cfg.d_model == m["d_model"] and cfg.num_layers == m["num_layers"]
    assert cfg.split_after_period == m["split_after_period"]


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert (spec.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
