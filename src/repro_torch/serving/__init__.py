from .batcher import (DecodeBatcher, TickConfig, TickStats, encode_tick,
                      split_coded, split_coded_device, stack_group)
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine", "TickConfig", "TickStats",
           "DecodeBatcher", "encode_tick", "stack_group", "split_coded",
           "split_coded_device"]
