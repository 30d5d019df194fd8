from .serving import ContinuousBatchingEngine, PagePool

__all__ = ["ContinuousBatchingEngine", "PagePool"]
