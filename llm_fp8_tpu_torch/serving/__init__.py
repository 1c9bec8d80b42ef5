"""Continuous-batching serving engine."""
from .engine import Engine, EngineConfig, Request, SamplingParams

__all__ = ["Engine", "EngineConfig", "Request", "SamplingParams"]
