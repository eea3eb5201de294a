from .context import DistContext
from .convert import (params_from_numpy, shard_experts,
                      split_params_from_numpy, train_state_from_numpy,
                      train_state_to_numpy)
from .transformer import (build_groups, decode_from_boundary, decode_step,
                          decode_to_boundary, forward, forward_from_boundary,
                          forward_head, init_cache, init_params,
                          loss_and_grads, loss_fn, prefill,
                          prefill_from_boundary, prefill_to_boundary,
                          resolve_device, sharded_xent)

__all__ = ["DistContext", "build_groups", "decode_from_boundary",
           "decode_step", "decode_to_boundary", "forward",
           "forward_from_boundary", "forward_head", "init_cache",
           "init_params", "loss_and_grads", "loss_fn", "params_from_numpy",
           "prefill", "prefill_from_boundary", "prefill_to_boundary",
           "resolve_device", "shard_experts", "sharded_xent",
           "split_params_from_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]
