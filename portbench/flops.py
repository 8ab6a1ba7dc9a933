"""The benchmark's own arithmetic of model FLOPs and attention work.

Frozen here so that no change to the program can move the yardstick.

- A forward token costs 2 N_mm FLOPs in matmuls (``Sizes.matmul_params``:
  every parameter but the input embedding and the norm scales), the head
  counted only where logits are needed.
- Attention costs 4 Hq D FLOPs per layer and live (query, key) pair: QK^T
  and PV. Causal: a query at position i sees i + 1 keys.
- Tokens served from the prefix cache cost nothing.
- A training step is three forwards (forward, backward); a recomputed
  forward is not work.
"""

from __future__ import annotations

from .model_config import Sizes


def causal_pairs(new: int, before: int = 0) -> int:
    """Live (query, key) pairs of ``new`` queries at positions
    before .. before + new - 1, each seeing every key up to itself."""
    return new * before + new * (new + 1) // 2


def attention_flops(s: Sizes, pairs: int) -> float:
    """QK^T and PV over ``pairs`` live pairs, every layer and head."""
    return 4.0 * s.layers * s.heads * s.head_dim * pairs


def body_flops(s: Sizes, tokens: int) -> float:
    """The layers' matmuls for ``tokens`` tokens (no head)."""
    return 2.0 * s.layers * s.layer_matmul_params() * tokens


def head_flops(s: Sizes, rows: int) -> float:
    return 2.0 * s.hidden * s.vocab * rows


def prefill_flops(s: Sizes, tokens: int, cached: int) -> float:
    """A prefill of ``tokens`` prompt tokens, ``cached`` of them from the
    prefix cache: the rest through the layers, one row of logits."""
    new = tokens - cached
    return (body_flops(s, new) + attention_flops(s, causal_pairs(new, cached))
            + head_flops(s, 1))


def decode_flops(s: Sizes, context: int) -> float:
    """One decoded token whose query sees ``context`` keys (itself too)."""
    return (body_flops(s, 1) + attention_flops(s, context)
            + head_flops(s, 1))


def train_step_flops(s: Sizes, batch: int, seq: int) -> float:
    """One step on ``batch`` rows of ``seq`` trained tokens: forward and
    backward, three forwards, every row's logits."""
    fwd = (body_flops(s, batch * seq) + head_flops(s, batch * seq)
           + attention_flops(s, batch * causal_pairs(seq)))
    return 3.0 * fwd


def flash_forward_work(s: Sizes, batch: int, seq: int):
    """(FLOPs, bytes) of kernel 1 over every layer for ``batch`` causal
    sequences of ``seq`` real tokens: QK^T and PV over the live pairs; q,
    k, v read once and o written once, in bf16."""
    flops = attention_flops(s, batch * causal_pairs(seq))
    elems = batch * seq * s.head_dim * (2 * s.heads + 2 * s.kv_heads)
    return flops, 2.0 * s.layers * elems


def flash_train_work(s: Sizes, batch: int, seq: int):
    """(FLOPs, bytes) of kernels 1-3 for one forward and one backward:
    3x the forward's FLOPs (dV, dP, dQ, dK beside QK^T and PV; the
    backward's recomputed scores and the remat's second forward are time,
    not work). Bytes: the forward reads q, k, v and writes o; the backward
    reads q, k, v, o, dO and writes dQ, dK, dV; bf16."""
    flops = 3.0 * attention_flops(s, batch * causal_pairs(seq))
    q = batch * seq * s.heads * s.head_dim
    kv = batch * seq * s.kv_heads * s.head_dim
    elems = (q + 2 * kv + q) + (q + 2 * kv + 2 * q + q + 2 * kv)
    return flops, 2.0 * s.layers * elems
