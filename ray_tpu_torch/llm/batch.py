"""Batch LLM inference over data pipelines, from ray_tpu/llm/batch.py.

``build_llm_processor`` maps a dataset through an engine stage: any object
with the reference's ``map_batches`` (an actor pool of ``_EngineStage``
instances, each holding one engine, reused across batches). The port
imports nothing of the runtime that provides such datasets.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..models import PRESETS
from .engine import LLMEngine, SamplingParams


@dataclasses.dataclass
class ProcessorConfig:
    """Engine shape for the batch stage (reference:
    vLLMEngineProcessorConfig)."""
    preset: str = "tiny"
    max_batch: int = 4
    max_len: int = 128
    max_tokens: int = 16
    temperature: float = 0.0
    eos_id: Optional[int] = None
    concurrency: int = 1
    batch_size: int = 8
    seed: int = 0
    prompt_column: str = "prompt_tokens"
    length_column: str = "prompt_len"
    output_column: str = "generated_tokens"


class _EngineStage:
    """Actor-pool callable: one engine per actor, reused across batches.
    ``params`` and ``device`` are the port's engine's (params default to
    ``init_params`` from the config's seed; the device to ``"cuda"``)."""

    def __init__(self, cfg_blob: dict, params=None, *,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = ProcessorConfig(**cfg_blob)
        self.engine = LLMEngine(PRESETS[self.cfg.preset], params,
                                max_batch=self.cfg.max_batch,
                                max_len=self.cfg.max_len,
                                seed=self.cfg.seed, device=device)
        self.sampling = SamplingParams(max_tokens=self.cfg.max_tokens,
                                       temperature=self.cfg.temperature,
                                       eos_id=self.cfg.eos_id)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        prompts_padded = batch[self.cfg.prompt_column]
        lens = batch[self.cfg.length_column].astype(np.int64)
        prompts = [list(map(int, prompts_padded[i, :lens[i]]))
                   for i in range(len(lens))]
        outs = self.engine.generate(prompts, self.sampling)
        width = max((len(o) for o in outs), default=0)
        padded = np.zeros((len(outs), max(width, 1)), np.int32)
        out_lens = np.zeros(len(outs), np.int32)
        for i, o in enumerate(outs):
            padded[i, :len(o)] = o
            out_lens[i] = len(o)
        out = dict(batch)
        out[self.cfg.output_column] = padded
        out[self.cfg.output_column + "_len"] = out_lens
        return out


def build_llm_processor(config: ProcessorConfig, params=None, *,
                        device: Union[str, torch.device] = "cuda"):
    """Returns dataset -> dataset (reference: ray.data.llm
    build_llm_processor): ``ds.map_batches`` over an actor pool of
    ``_EngineStage``, each built with ``params`` and ``device``."""
    blob = dataclasses.asdict(config)

    def apply(ds):
        return ds.map_batches(
            _EngineStage,
            batch_size=config.batch_size,
            fn_constructor_args=(blob,),
            fn_constructor_kwargs={"params": params, "device": device},
            concurrency=config.concurrency,
            num_cpus=1.0)

    return apply
