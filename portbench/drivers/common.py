"""What the traffic drivers share: the program's config from a
configuration's sizes, and percentiles."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..model_config import Sizes


def port_config(s: Sizes, max_len: int, **kw):
    """The program's ``TransformerConfig`` for these sizes, in bf16 unless
    ``dtype`` says otherwise."""
    import torch
    from ray_tpu_torch.models.transformer import TransformerConfig
    kw.setdefault("dtype", torch.bfloat16)
    return TransformerConfig(
        vocab_size=s.vocab, hidden_size=s.hidden,
        intermediate_size=s.intermediate, num_layers=s.layers,
        num_heads=s.heads, num_kv_heads=s.kv_heads, head_dim=s.head_dim,
        max_seq_len=max_len, rope_theta=s.rope_theta, rms_norm_eps=s.eps,
        **kw)


def pctl(xs: Sequence[float], p: float) -> float:
    """The p-th percentile, NaN for no samples (the harness then leaves
    the metric out)."""
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))
