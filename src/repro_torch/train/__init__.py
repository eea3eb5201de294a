from . import checkpoint
from .trainer import Trainer, TrainerConfig

__all__ = ["checkpoint", "Trainer", "TrainerConfig"]
