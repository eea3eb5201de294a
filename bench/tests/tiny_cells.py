"""A cell cut to a size the CPU runs in a second: the shipped cell's
files with every width and count made small, in float32."""

import copy
import dataclasses

from bench.spec import BENCH, ROOT, load_cell, load_json

# cells whose configuration and mix are kept under bench/ but which
# BENCHMARK.json does not hold (PERF.md says why): on the CPU they are
# judged by the limits of the benchmark's first cell
HELD_OUT = {"dbrx-132b-s8.moe-decode": ("dbrx-132b-s8", "moe-decode")}


def _cell(name: str):
    if name not in HELD_OUT:
        return load_cell(name)
    config, traffic = HELD_OUT[name]
    first = load_json(ROOT / "BENCHMARK.json")["workloads"][0]["name"]
    return dataclasses.replace(
        load_cell(first), name=name,
        config=load_json(BENCH / "configs" / f"{config}.json"),
        mix=load_json(BENCH / "mixes" / f"{traffic}.json"))


def tiny_cell(name: str, **model):
    cell = copy.deepcopy(_cell(name))
    m = cell.config["model"]
    m.update(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=96, vocab_size=512, split_after_period=1,
             dtype="float32")
    if "num_experts" in m:
        m.update(num_experts=8, experts_per_token=2, moe_d_ff=64)
    m.update(model)
    mix = cell.mix
    mix.update(requests=256, slots=4, max_seq=96)
    mix["prompt_len"].update(median=12, min=4, max=24)
    mix["output_len"].update(median=8, min=4, max=16)
    mix["calibration"].update(batch=2, seq_len=16)
    # a sample of some 200 tokens, so the window's timing on the CPU does
    # not decide what the check reads
    mix["check"].update(served_tokens=200)
    return cell
