"""LLM serving of the port: the continuous-batching engine (engine.py), the
serving replica and its open-loop harness (serving.py), the batch stage
(batch.py) and the byte-level tokenizer (openai_api.py)."""

from .batch import ProcessorConfig, build_llm_processor
from .engine import LLMEngine, SamplingParams
from .openai_api import ByteTokenizer
from .serving import EngineReplica, run_open_loop

__all__ = ["LLMEngine", "SamplingParams", "ProcessorConfig",
           "ByteTokenizer", "build_llm_processor", "EngineReplica",
           "run_open_loop"]
