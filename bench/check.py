"""Decide ``correct``: the window's outputs against the plain reference.

Three kinds of number, each with a limit in ``bench/limits/<cell>.json``:

- ``quant_mismatch``: boundary calls of the window, sampled from the
  seed, whose reconstruction differs in any element from the reference
  quantizer's on the same input at the port's calibrated range (an
  exact comparison).
- ``clip_mismatch``: how far the port's clip range lies from the one
  the frozen calibration works out again from the samples the port
  calibrated on (its boundary activations of the calibration batch):
  an exact comparison of the calibration's arithmetic.
- ``gap_over_half``: the share of compared positions whose served token
  the reference ranks more than half a logit below its best (read beside
  it: the mean gap, the widest, and the share where the two differ at
  all).  The reference runs every layer from the same tokens, with the
  boundary quantized at the range it calibrates itself on its own
  boundary activations of the calibration batch (how far that range lies
  from the port's is ``clip_gap``).

The engine computes each row of a batch alone (the quantizer is
elementwise at a fixed range, and no expert drops an assignment), so the
reference runs a sample of finished requests, drawn from the seed with
the longest one in it, one by one over their padded prompts and served
tokens: every decode step and the prefill (a refill or an epoch's) that
gave each of their tokens.  An expert layer that drops assignments
beyond its capacity would couple the rows of a dispatch; such a cell is
refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import traffic
from .reference import calibration as CAL
from .reference import codec as QC
from .reference.model import Item, Reference
from .roofline import layer_specs


@dataclasses.dataclass
class Served:
    """What a request was served: its prompt, the length the engine
    padded it to, its tokens, and whether it finished."""
    prompt: np.ndarray
    padded_len: int
    out: list
    done: bool


def served(admitted: list) -> list[Served]:
    return [Served(np.asarray(r.prompt), r.padded_len, list(r.out_tokens),
                   bool(r.done)) for r in admitted]


def quantizer_mismatches(kept: list, cmin: float, cmax: float,
                         n: int) -> int:
    """Calls of ``kept`` ((input, reconstruction) pairs) whose
    reconstruction differs from the reference quantizer's."""
    bad = 0
    for x, y in kept:
        ref = QC.fake_quant(x, cmin, cmax, n).to(y.dtype)
        bad += int(not torch.equal(ref, y))
    return bad


def drops(model: dict) -> bool:
    """Can an expert layer drop assignments (its capacity below the
    tokens of a dispatch)?"""
    moe = any(s["moe"] for s in layer_specs(model))
    return moe and model["capacity_factor"] * model["experts_per_token"] \
        < model["num_experts"]


def _row(s: Served, n_out: int) -> np.ndarray:
    pad = np.zeros(s.padded_len - len(s.prompt), np.int64)
    return np.concatenate([pad, s.prompt, np.asarray(s.out[:n_out],
                                                     np.int64)])


def _items(cell, served_: list[Served], rng: np.random.Generator):
    """(items, targets): the reference's inputs, and per item the served
    token at each kept position."""
    done = [s for s in served_ if s.done]
    if not done:
        raise RuntimeError("no request finished in the window: it is "
                           "shorter than the mix's shortest output")
    longest = max(done, key=lambda s: (len(s.out), s.padded_len))
    rest = [s for s in done if s is not longest]
    sample, n = [longest], len(longest.out)
    for i in rng.permutation(len(rest)):
        if n >= cell.mix["check"]["served_tokens"]:
            break
        sample.append(rest[i])
        n += len(rest[i].out)
    items, targets = [], []
    for s in sample:
        items.append(Item(torch.as_tensor(_row(s, len(s.out) - 1))[None],
                          first=s.padded_len - 1))
        targets.append(torch.as_tensor(s.out)[None])
    return items, targets


def _calibration_item(cell, seed: int) -> Item:
    vocab = cell.config["model"]["vocab_size"]
    return Item(torch.as_tensor(traffic.calibration_tokens(
        cell.mix, vocab, seed)), edge_only=True)


def _boundary(cell):
    c = cell.mix["codec"]

    def fit(edge: list[Item]):
        samples = torch.cat([it.boundary.reshape(-1) for it in edge])
        cmin, cmax = CAL.clip_range(
            samples.cpu().numpy(), c["n_levels"], kappa=c["kappa"],
            slope=c["leaky_slope"], cmin_zero=c["constrain_cmin_zero"])
        return cmin, cmax, c["n_levels"]
    return fit


def _gap_numbers(gaps: torch.Tensor) -> dict:
    return {"gap_over_half": float((gaps > 0.5).float().mean()),
            "gap_mean": float(gaps.mean()), "gap_max": float(gaps.max()),
            "flip_share": float((gaps > 0).float().mean()),
            "positions": int(gaps.numel())}


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far below each row's best logit the given token's lies."""
    best = logits.max(-1).values
    got = logits.gather(-1, tokens.to(logits.device)[..., None].long())
    return (best - got[..., 0]).reshape(-1)


def _clip_gap(qrange, ref) -> float:
    width = ref[1] - ref[0]
    return max(abs(qrange[0] - ref[0]), abs(qrange[1] - ref[1])) / width


def clip_mismatch(cell, samples, qrange) -> float:
    """The port's range against the frozen calibration's on the same
    samples (0 where they agree to the bit)."""
    c = cell.mix["codec"]
    ref = CAL.clip_range(samples, c["n_levels"], kappa=c["kappa"],
                         slope=c["leaky_slope"],
                         cmin_zero=c["constrain_cmin_zero"])
    return max(abs(qrange[0] - ref[0]), abs(qrange[1] - ref[1]))


def readings(cell, seed: int, device, served_: list[Served], qrange,
             quant: int, samples, control: bool = False) -> dict:
    """Every number the check can compare, from the reference run once
    the program's state is freed.  ``control``: also the numbers of the
    reference in float8 put in the program's place, under ``control``."""
    rng = np.random.Generator(np.random.PCG64([seed, 3]))
    items, targets = _items(cell, served_, rng)
    ref = Reference(cell.config, seed, device)
    rrange = ref.run(items + [_calibration_item(cell, seed)],
                     _boundary(cell))
    gaps = torch.cat([_gaps(it.logits, t) for it, t in zip(items, targets)])
    out = {"quant_mismatch": quant,
           "clip_mismatch": clip_mismatch(cell, samples, qrange),
           "clip_gap": _clip_gap(qrange, rrange[:2]),
           "distinct_served": int(torch.cat([t.reshape(-1)
                                             for t in targets]).unique()
                                  .numel()),
           "ref_range": list(rrange[:2]), "port_range": list(qrange),
           **_gap_numbers(gaps)}
    if control:
        low = [Item(it.tokens, it.first) for it in items]
        crange = Reference(cell.config, seed, device, lowp=True).run(
            low + [_calibration_item(cell, seed)], _boundary(cell))
        cgaps = torch.cat([_gaps(it.logits, lo.logits.argmax(-1))
                           for it, lo in zip(items, low)])
        out["control"] = {"clip_gap": _clip_gap(crange[:2], rrange[:2]),
                          **_gap_numbers(cgaps)}
    return out


def judge(readings_: dict, limits: dict) -> dict:
    """Each compared number beside its limit, in the limits file's order."""
    return {name: {"value": readings_[name], "limit": lim["limit"]}
            for name, lim in limits["checks"].items()}
