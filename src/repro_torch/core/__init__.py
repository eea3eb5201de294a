"""Core library: the paper's lightweight feature-compression technique.

Modules:
  distributions -- asymmetric-Laplace + leaky-ReLU analytic feature model
  clipping      -- closed-form e_quant/e_clip and optimal clipping ranges
  aciq          -- ACIQ comparison baseline (eq. 13)
  uniform       -- pinned-boundary uniform quantizer (eq. 1)
  ecsq          -- modified entropy-constrained quantizer design (Alg. 1)
  binarization  -- truncated-unary bit planes
  cabac         -- adaptive binary arithmetic codec (host, exact round trip)
  rate_model    -- on-device entropy rate estimation
  rans          -- vectorized (numpy-batched) rANS plane coder
  stats         -- streaming calibration statistics
  tiling        -- TilePlan geometry (channel-group x spatial-block tiles)
  backend       -- QuantBackend dispatch (CUDA kernels, CPU torch reference)
  codec         -- FeatureCodec facade tying it all together
"""

from .backend import QuantSpec, get_backend
from .codec import (ChunkStreamDecoder, CodecConfig, FeatureCodec,
                    ParsedHeader, calibrate, parse_header,
                    reconstruct_indices)
from .distributions import FeatureModel, resnet50_layer21_model, yolov3_layer12_model
from .tiling import TileECSQ, TilePlan

__all__ = [
    "CodecConfig", "FeatureCodec", "calibrate", "FeatureModel",
    "QuantSpec", "get_backend", "TilePlan", "TileECSQ",
    "ChunkStreamDecoder", "ParsedHeader", "parse_header",
    "reconstruct_indices",
    "resnet50_layer21_model", "yolov3_layer12_model",
]
