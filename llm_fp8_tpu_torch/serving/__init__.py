"""Continuous-batching serving engines: the slot arena, the paged pool and
speculative decoding."""
from .engine import Engine, EngineConfig, Request, SamplingParams
from .paged_engine import PagedEngine, PagedEngineConfig
from .spec_engine import SpecEngine
from .speculative import SpeculativeDecoder, spec_verify

__all__ = ["Engine", "EngineConfig", "PagedEngine", "PagedEngineConfig", "Request",
           "SamplingParams", "SpecEngine", "SpeculativeDecoder", "spec_verify"]
