from .pipeline import DataConfig, PrefetchingLoader, stream

__all__ = ["DataConfig", "PrefetchingLoader", "stream"]
