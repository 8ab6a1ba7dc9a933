"""LLM serving of the port: the continuous-batching engine (engine.py)."""

from .engine import LLMEngine, SamplingParams

__all__ = ["LLMEngine", "SamplingParams"]
