from .pipeline import DataConfig, stream

__all__ = ["DataConfig", "stream"]
