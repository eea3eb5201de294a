"""End-to-end driver (the paper's kind: split inference serving), the
port of the reference's ``examples/split_inference.py``.

Serves a small LM with batched requests where the network is split at the
collaborative-intelligence boundary: the 'edge' half runs, the boundary
activations go through the paper's codec (clip + coarse quantize + TU +
CABAC -- here the in-graph fake-quant with exact rate accounting), and the
'cloud' half finishes.  Reports, per quantization level and calibration
granularity (per-tensor vs per-channel over d_model):

  * bits/element crossing the edge->cloud link (vs 16-bit raw),
  * greedy-token agreement vs the uncompressed model (accuracy proxy).

The model is briefly trained first so the comparison is not random-weight
noise; its checkpoints go to a fresh temporary directory, removed at
the end.  On the card the codec is the CUDA kernels' (the engine's
``codec=`` hookup).

Run:  python -m repro_torch.examples.split_inference [--device cpu]
"""

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from ..configs import get_config, reduced
from ..core import CodecConfig, calibrate
from ..core.stats import RunningStats
from ..data import DataConfig, stream
from ..models import forward, resolve_device
from ..serving import Request, ServeEngine
from ..train import Trainer, TrainerConfig
from . import codec_backend

GRAINS, LEVELS = ("tensor", "channel"), (2, 3, 4, 8)


def model_config():
    return dataclasses.replace(reduced(get_config("codeqwen1.5-7b")),
                               num_layers=4, vocab_size=256)


def data_config(cfg, batch: int = 8, seq_len: int = 32) -> DataConfig:
    return DataConfig(vocab_size=cfg.vocab_size, batch=batch,
                      seq_len=seq_len)


def train(cfg, dcfg, device):
    """The reference's 30-step training run from the seed; its
    parameters.  Checkpoints go to a temporary directory removed after."""
    print("=== training a small model (so split fidelity is meaningful) ===")
    with tempfile.TemporaryDirectory(prefix="repro_split_ckpt_") as ckpt_dir:
        tr = Trainer(cfg, TrainerConfig(steps=30, ckpt_every=30,
                                        ckpt_dir=ckpt_dir, warmup_steps=5),
                     dcfg, device=device)
        state = tr.run(resume=False)
    print(f"  loss: {tr.metrics_log[0]['loss']:.3f} -> "
          f"{tr.metrics_log[-1]['loss']:.3f}")
    return state["params"]


def split_activations(cfg, params, dcfg, device, batches: int = 4):
    """(RunningStats, (n, d_model) samples) of the split layer's
    activations over ``batches`` of the data stream."""
    print("\n=== calibrating codec on split-layer activations ===")
    stats = RunningStats()
    probe = {}
    probe_samples = []

    def probe_fn(x):
        probe["x"] = x
        return x, 0.0

    for _, batch in zip(range(batches), stream(dcfg)):
        forward(cfg, params, torch.as_tensor(batch["tokens"], device=device),
                codec_fn=probe_fn)
        arr = probe["x"].to(torch.float32).cpu().numpy()
        stats.update(arr)
        probe_samples.append(arr.reshape(-1, arr.shape[-1]))
    samples = np.concatenate(probe_samples)  # (n, d_model): d_model = channels
    print(f"  split activations: mean={stats.mean:.4f} var={stats.var:.4f} "
          f"({int(stats.count)} samples, {samples.shape[-1]} channels)")
    return stats, samples


def split_codec(granularity: str, n: int, stats, samples, device):
    """The codec of one row of the table, calibrated as the reference
    calibrates it."""
    ccfg = CodecConfig(n_levels=n, clip_mode="model",
                       constrain_cmin_zero=False, granularity=granularity,
                       channel_axis=-1, channel_group_size=8,
                       backend=codec_backend(device))
    if granularity == "tensor":
        return calibrate(ccfg, sample_mean=stats.mean, sample_var=stats.var)
    return calibrate(ccfg, samples=samples)


def serve(cfg, params, stats, samples, device, n_prompts: int = 6,
          prompt_len: int = 12, new_tokens: int = 12) -> list[dict]:
    """Serve the seeded prompts without a codec, then through each
    codec; prints the table and returns its rows."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len)
               .astype(np.int32) for _ in range(n_prompts)]

    def run_engine(codec=None):
        eng = ServeEngine(cfg, params, slots=3, max_seq=64, codec=codec,
                          device=device)
        reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
                for p in prompts]
        eng.generate(reqs)
        return [r.out_tokens for r in reqs], eng.rate_log

    ref_tokens, _ = run_engine(None)
    print("\n=== split serving: accuracy vs rate (paper Fig. 8 analogue) ===")
    print(f"  {'grain':>8} {'N':>3} {'bits/elem':>10} {'vs bf16':>9} "
          f"{'token agreement':>16}")
    rows = []
    for granularity in GRAINS:
        for n in LEVELS:
            toks, rates = run_engine(split_codec(granularity, n, stats,
                                                 samples, device))
            agree = np.mean([np.mean(np.array(a) == np.array(b))
                             for a, b in zip(toks, ref_tokens)])
            bpe = float(np.mean(rates))
            print(f"  {granularity:>8} {n:>3} {bpe:>10.3f} "
                  f"{16 / max(bpe, 1e-9):>8.1f}x {agree:>15.1%}")
            rows.append({"granularity": granularity, "n_levels": n,
                         "bits_per_elem": bpe, "agreement": float(agree),
                         "rates": list(rates)})
    print("\n(clipping ranges are model-based, calibrated from a few"
          " hundred samples -- no retraining, as in the paper; per-channel"
          " ranges follow the companion paper's tiled coding)")
    return rows


def run(device="cuda") -> list[dict]:
    device = resolve_device(device)
    cfg = model_config()
    dcfg = data_config(cfg)
    params = train(cfg, dcfg, device)
    stats, samples = split_activations(cfg, params, dcfg, device)
    return serve(cfg, params, stats, samples, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and codec run on")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
