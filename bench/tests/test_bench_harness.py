"""A whole run of each cell on the CPU at a tiny size (the look for a
card skipped): sound, it comes out correct; with the timed path broken
underneath, or the control in the program's place, it does not."""

import json
import subprocess
import sys
import time

import pytest
import torch

from bench import check as CHK
from bench import harness, spec
from tiny_cells import tiny_cell

CELLS = ["codeqwen1.5-7b.long-decode", "dbrx-132b-s8.moe-decode"]


def _run(cell, seed=2**31 + 17, **kw):
    return harness.run_cell(tiny_cell(cell), seed, 0.5, False, "cpu",
                            time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == list(tiny_cell(cell).limits["checks"])
    assert res["readings"]["positions"] > 0
    assert set(res["metrics"]) == {"tokens_per_s", "itl_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["window"]["decode_steps"] > 2


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_host_side_metrics(cell):
    res = harness.run_cell(tiny_cell(cell), 5, 0.5, True, "cpu",
                           time.perf_counter())
    # no card: the profiler's metrics have nothing to read
    assert set(res["metrics"]) == {"prefill_share", "step_mfu"}
    assert 0 < res["metrics"]["prefill_share"]["value"] <= 100


def _altered_tokens(monkeypatch):
    """Every token the head produces is the worst one."""
    from repro_torch.models import transformer
    orig = transformer._logits_out
    monkeypatch.setattr(transformer, "_logits_out",
                        lambda *a: -orig(*a))


def _codec_skipped(monkeypatch):
    """The boundary passes through unquantized."""
    from repro_torch.core.codec import FeatureCodec
    orig = FeatureCodec.apply_with_rate
    monkeypatch.setattr(FeatureCodec, "apply_with_rate",
                        lambda self, x: (x, orig(self, x)[1]))


def _cache_not_written(monkeypatch):
    """A step leaves its state unchanged: keys and values reach the
    cache as zeros."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "_kv_enc",
                        lambda cfg, t: torch.zeros_like(t))


@pytest.mark.parametrize("fault", [_altered_tokens, _codec_skipped,
                                   _cache_not_written])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["readings"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    # the reference in float8 in the program's place fails a limit that
    # the sound run keeps
    r = _run(cell, control=True)["readings"]
    limits = tiny_cell(cell).limits
    control = CHK.judge(dict(r, **r["control"]), limits)
    assert any(c["value"] > c["limit"] for c in control.values()), control
    assert all(c["value"] <= c["limit"]
               for c in CHK.judge(r, limits).values())


def test_an_expert_cell_that_drops_is_refused():
    # a capacity below the dispatch's tokens couples the rows of a batch
    cell = tiny_cell(CELLS[1], capacity_factor=1.25)
    with pytest.raises(NotImplementedError):
        harness.run_cell(cell, 3, 0.3, False, "cpu", time.perf_counter())


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert harness.forbidden_modules() == [] or "repro_torch_extra" \
        not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path[:0] = [{root!r}, {src!r}, {tests!r}]\n"
        "from bench import harness\n"
        "from tiny_cells import tiny_cell\n"
        "harness.run_cell(tiny_cell('codeqwen1.5-7b.long-decode'), 3, 0.3,"
        " False, 'cpu', time.perf_counter())\n"
        "tops = {{m.split('.')[0] for m in sys.modules}}\n"
        "print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'repro'}}))\n"
        "print('repro_torch' in tops)\n").format(
            root=str(spec.ROOT), src=str(spec.ROOT / "src"),
            tests=str(spec.BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout.split()
    assert out[-2:] == ["[]", "True"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{root!r}]\n"
            "import bench.check, bench.reference.model\n"
            "tops = {{m.split('.')[0] for m in sys.modules}}\n"
            "print(sorted(tops & {{'jax', 'repro', 'repro_torch'}}))\n"
            ).format(root=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout.split()
    assert out[-1] == "[]"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "2147483700", "--seconds", "12", "--trace", "0"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
