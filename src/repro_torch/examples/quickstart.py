"""Quickstart: the paper's lightweight codec end to end on synthetic
split-layer features (the port of the reference's
``examples/quickstart.py``).

Reproduces the core results offline:
  1. fit the asymmetric-Laplace + leaky-ReLU model from sample stats
     (paper eq. 6-7) -- lands on the paper's lambda/mu for ResNet-50 L21;
  2. compute optimal clipping ranges per N (paper Table I model columns);
  3. encode/decode a feature tensor through clip -> quantize -> TU ->
     CABAC and report bits/element (paper Fig. 8);
  4. compare uniform vs modified entropy-constrained quantization
     (paper Figs. 9-10).

The codec's quantizer runs on ``--device``'s backend (the CUDA kernels
on the card); the numbers printed are the same on either.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np

from ..core import CodecConfig, calibrate
from ..core.clipping import optimal_cmax
from ..core.distributions import resnet50_layer21_model
from ..models import resolve_device
from . import codec_backend


def run(device="cuda") -> None:
    """Print the four sections for 100,000 sampled features."""
    backend = codec_backend(resolve_device(device))

    print("=== 1. analytic model fit (paper Sec. III-B) ===")
    model = resnet50_layer21_model()
    print(f"  lambda = {model.lam:.7f}   (paper: 0.7716595)")
    print(f"  mu     = {model.mu:.7f}  (paper: -1.4350621)")

    print("\n=== 2. optimal clipping ranges (paper Table I) ===")
    for n in (2, 4, 8):
        print(f"  N={n}: c_max = {optimal_cmax(model, n):.3f}"
              f"   (paper: {dict([(2, 5.184), (4, 9.036), (8, 12.492)])[n]})")

    print("\n=== 3. full codec round trip ===")
    feats = model.sample(100_000, np.random.default_rng(0)) \
        .astype(np.float32)
    for n in (2, 4, 8):
        codec = calibrate(CodecConfig(n_levels=n, clip_mode="model",
                                      backend=backend), samples=feats)
        blob = codec.encode(feats)
        recon = codec.decode(blob)
        bpe = 8 * len(blob) / feats.size
        mse = float(np.mean((np.clip(feats, codec.cmin, codec.cmax)
                             - recon) ** 2))
        print(f"  N={n}: {bpe:.3f} bits/elem (32-bit floats -> "
              f"{32 / bpe:.0f}x smaller), msre={mse:.4f}")

    print("\n=== 4. modified ECSQ vs uniform (paper Figs. 9-10) ===")
    for pinned in (True, False):
        codec = calibrate(CodecConfig(n_levels=4, clip_mode="model",
                                      use_ecsq=True, ecsq_lagrangian=0.05,
                                      ecsq_pin_boundaries=pinned,
                                      backend=backend), samples=feats)
        blob = codec.encode(feats)
        span = codec.ecsq.levels[-1] - codec.ecsq.levels[0]
        print(f"  ECSQ ({'pinned' if pinned else 'conventional'}): "
              f"{8 * len(blob) / feats.size:.3f} bits/elem, "
              f"reconstruction span {span:.3f} "
              f"({'full' if pinned else 'shrunken'} clipping range)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the codec's quantizer runs on")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
