"""LLM serving of the port: the continuous-batching engine (engine.py), the
serving replica and its open-loop harness (serving.py), the batch stage
(batch.py), the OpenAI-compatible server (openai_api.py) and the serving
patterns over the replica (serve_patterns.py): the data-parallel apps, P/D
disaggregation and long-context serving, each replica on a ``Hosted``
event loop of its own."""

from .batch import ProcessorConfig, build_llm_processor
from .engine import LLMEngine, SamplingParams
from .openai_api import ByteTokenizer, OpenAIServer, build_openai_app
from .serve_patterns import (CompiledPDApp, Hosted, LongContextApp,
                             build_dp_deployment, build_llm_app,
                             run_long_context_app, run_pd_app,
                             run_pd_compiled)
from .serving import EngineReplica, run_open_loop

__all__ = ["LLMEngine", "SamplingParams", "ProcessorConfig",
           "ByteTokenizer", "OpenAIServer", "build_openai_app",
           "build_llm_processor", "build_dp_deployment",
           "build_llm_app", "run_pd_app", "EngineReplica",
           "run_open_loop", "LongContextApp", "run_long_context_app",
           "CompiledPDApp", "run_pd_compiled", "Hosted"]
