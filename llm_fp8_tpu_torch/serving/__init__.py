"""Continuous-batching serving engines: the slot arena and the paged pool."""
from .engine import Engine, EngineConfig, Request, SamplingParams
from .paged_engine import PagedEngine, PagedEngineConfig

__all__ = ["Engine", "EngineConfig", "PagedEngine", "PagedEngineConfig", "Request",
           "SamplingParams"]
