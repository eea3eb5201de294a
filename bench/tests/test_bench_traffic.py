"""The traffic generator: the same seed gives the same requests, another
seed another order of the same lengths."""

import numpy as np
import pytest

from bench import spec, traffic

MIXES = sorted(p.stem for p in (spec.BENCH / "mixes").glob("*.json"))


def _mix(name):
    return spec.load_json(spec.BENCH / "mixes" / f"{name}.json")


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = _mix(mix)
    a = traffic.requests(m, 92416, 2**31 + 5)
    b = traffic.requests(m, 92416, 2**31 + 5)
    assert len(a) == m["requests"]
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_reorder_the_same_lengths(mix):
    m = _mix(mix)
    a = traffic.requests(m, 92416, 7)
    b = traffic.requests(m, 92416, 8)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert sorted(o for _, o in a) == sorted(o for _, o in b)
    assert not np.array_equal(a[0][0][:16], b[0][0][:16])


@pytest.mark.parametrize("mix", MIXES)
def test_every_block_holds_the_same_lengths(mix):
    m = _mix(mix)
    b = m["slots"]
    for seed in (1, 2**31 + 9):
        reqs = traffic.requests(m, 1000, seed)
        for k in range(0, len(reqs), b):
            block = reqs[k:k + b]
            assert sorted(len(p) for p, _ in block) \
                == sorted(traffic.lengths(m["prompt_len"], b))
            assert sorted(o for _, o in block) \
                == sorted(traffic.lengths(m["output_len"], b))


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_keep_to_the_mix(mix):
    m = _mix(mix)
    reqs = traffic.requests(m, 100, 3)
    p = np.array([len(x) for x, _ in reqs])
    o = np.array([n for _, n in reqs])
    assert p.min() >= m["prompt_len"]["min"]
    assert p.max() <= m["prompt_len"]["max"]
    assert o.min() >= m["output_len"]["min"]
    assert o.max() <= m["output_len"]["max"]
    assert abs(np.median(p) - m["prompt_len"]["median"]) <= 1
    assert abs(np.median(o) - m["output_len"]["median"]) <= 1
    assert m["requests"] % m["slots"] == 0
    # every request fits the engine's cache
    assert (p + o).max() <= m["max_seq"]
    assert all(x.min() >= 1 and x.max() < 100 for x, _ in reqs)


def test_lengths_are_quantiles():
    d = {"dist": "lognormal", "median": 100, "sigma": 0.5, "min": 1,
         "max": 10_000}
    got = traffic.lengths(d, 3)
    # quantiles 1/6, 1/2, 5/6 of the lognormal: 100 exp(0.5 z)
    assert list(got) == [round(100 * np.exp(0.5 * -0.9674215661017014)),
                         100, round(100 * np.exp(0.5 * 0.9674215661017014))]


def test_calibration_tokens_from_the_seed():
    m = _mix(MIXES[0])
    a = traffic.calibration_tokens(m, 1000, 11)
    assert a.shape == (m["calibration"]["batch"],
                       m["calibration"]["seq_len"])
    assert np.array_equal(a, traffic.calibration_tokens(m, 1000, 11))
    assert not np.array_equal(a, traffic.calibration_tokens(m, 1000, 12))
