from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state
from .schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "warmup_cosine"]
