"""Compression beyond the feature codec's stream: the packed split
runtime (:mod:`.split_runtime`) and error-feedback gradient quantization
(:mod:`.grad_compression`)."""

from . import split_runtime
from .grad_compression import (GradCompressionConfig, compress_grads,
                               init_error_feedback, wire_bytes_ratio)

__all__ = ["GradCompressionConfig", "compress_grads", "init_error_feedback",
           "split_runtime", "wire_bytes_ratio"]
