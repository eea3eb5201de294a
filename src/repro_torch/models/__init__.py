from .convert import params_from_numpy, split_params_from_numpy
from .transformer import (build_groups, decode_from_boundary, decode_step,
                          decode_to_boundary, forward, forward_from_boundary,
                          forward_head, init_cache, init_params, prefill,
                          prefill_from_boundary, prefill_to_boundary,
                          resolve_device)

__all__ = ["build_groups", "decode_from_boundary", "decode_step",
           "decode_to_boundary", "forward", "forward_from_boundary",
           "forward_head", "init_cache", "init_params", "params_from_numpy",
           "prefill", "prefill_from_boundary", "prefill_to_boundary",
           "resolve_device", "split_params_from_numpy"]
