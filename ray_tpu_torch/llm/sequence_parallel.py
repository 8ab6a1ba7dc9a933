"""Streamed paged-KV attention in PyTorch.

Port of the second half of ray_tpu/llm/sequence_parallel.py:
``_stream_block_fn`` and ``StreamAttn``, attention over KV *parts* that are
never resident in the engine's page pool. Each part is an (L, span, KV, D)
stripe held wherever its producer put it (host memory, another engine's
device). The engine loops layers outer and parts inner and merges one part
at a time by online softmax, so the device's working set for attention is
one part, whatever the length of the context.

The reference jit-compiles each piece and caches the compilations by shape;
here each piece is a plain function over tensors, run eagerly. Scores and
P.V are taken in f32 from the working dtype's values (the reference's
``preferred_element_type=float32``): the operands are upcast, so with TF32
off the products are exact and the sums f32. The scale multiplies by
``1 / sqrt(D)`` in f32, as ``StreamAttn`` does (the engine's suffix prefill
divides by sqrt(D) rounded to the dtype instead).

Not ported yet: the sequence-parallel prefill (``sp_prefill_fn``,
``sp_suffix_prefill_fn``, ring and Ulysses), which comes with the port of
``ops/ring_attention.py``.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models.transformer import (TransformerConfig, _layer_qkv, _mlp,
                                  apply_rope, layer_params, rms_norm,
                                  rope_angles)

__all__ = ["StreamAttn"]


def _stream_block_fn(q, k_blk, v_blk, k_valid: int, q_pos0: int, k_pos0: int,
                     m, l, acc, *, scale: float):
    """Online-softmax merge of ONE KV block into a running (m, l, acc).

    q (Sq, Hq, D): rope'd queries at absolute positions q_pos0 + i.
    k_blk/v_blk (Sk, KV, D): rope'd keys and values at k_pos0 + j; key j
    counts iff j < k_valid and k_pos0 + j <= q_pos0 + i (causality by
    absolute position: a block wholly before the queries is all valid, the
    self block is triangular, a later block adds nothing). m/l (KV, G, Sq,
    1) and acc (KV, G, Sq, D) are f32; the log-sum-exp merge is
    associative, so the order of the blocks does not change the result
    beyond f32 rounding."""
    Sq, Hq, D = q.shape
    Sk, Hkv, _ = k_blk.shape
    k_valid, q_pos0, k_pos0 = int(k_valid), int(q_pos0), int(k_pos0)
    dev = q.device
    qg = q.reshape(Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("skgd,tkd->kgst", qg, k_blk.float()) * scale
    j = torch.arange(Sk, device=dev)
    i = torch.arange(Sq, device=dev)
    valid = (j[None, :] < k_valid) & ((k_pos0 + j)[None, :]
                                      <= (q_pos0 + i)[:, None])
    s = s.masked_fill(~valid, -1e30)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    # Explicit re-mask of p: a fully masked block leaves m at -1e30, and
    # exp(-1e30 - -1e30) would otherwise add 1.0 per masked key.
    p = torch.exp(s - m_new).masked_fill(~valid, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(-1, keepdim=True)
    # p rounds to the values' dtype, as in the reference, then P.V in f32.
    pv = torch.einsum("kgst,tkd->kgsd", p.to(v_blk.dtype).float(),
                      v_blk.float())
    return m_new, l_new, alpha * acc + pv


class StreamAttn:
    """The pieces of attention over streamed KV parts. The engine drives
    them layers outer, parts inner:

        x = sa.embed(params, tokens)
        for li in range(L):
            q, k, v = sa.qkv(params["layers"], li, x, pos0)
            m, l, acc = sa.init(Sq)
            for each KV block (an external part, the pool tail, the self
            block):
                m, l, acc = _stream_block_fn(q, kb, vb, valid, q0, k0,
                                             m, l, acc, scale=sa.scale)
            x = sa.finish(params["layers"], li, x, l, acc)
        logits = sa.logits(params, x, last_idx)

    Only one block is read per ``_stream_block_fn`` call, so the
    attention's device working set is one part, not the context."""

    def __init__(self, cfg: TransformerConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scale = 1.0 / math.sqrt(cfg.head_dim_)

    def init(self, sq: int) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """m = -1e30, l = 0, acc = 0, in f32: (KV, G, Sq, 1) and
        (KV, G, Sq, D)."""
        cfg = self.cfg
        shape = (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, sq)
        m = torch.full(shape + (1,), -1e30, dtype=torch.float32,
                       device=self.device)
        l = torch.zeros(shape + (1,), dtype=torch.float32, device=self.device)
        acc = torch.zeros(shape + (cfg.head_dim_,), dtype=torch.float32,
                          device=self.device)
        return m, l, acc

    def embed(self, params, tokens) -> torch.Tensor:
        """tokens (1, S) ints (numpy or a tensor) -> (1, S, E)."""
        t = torch.as_tensor(np.asarray(tokens), device=self.device).long()
        return params["embed"].to(self.cfg.dtype)[t]

    def qkv(self, layers, li: int, x, pos0: int):
        """-> (q (Sq, Hq, D), k, v (Sq, KV, D)), rope'd at pos0 + i."""
        cfg = self.cfg
        lp = layer_params({"layers": layers}, li)
        h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
        q, k, v = _layer_qkv(lp, h, cfg)
        cos, sin = rope_angles(x.shape[1], cfg.head_dim_, cfg.rope_theta,
                               offset=pos0, device=x.device)
        return apply_rope(q, cos, sin)[0], apply_rope(k, cos, sin)[0], v[0]

    def finish(self, layers, li: int, x, l, acc) -> torch.Tensor:
        """Normalise the merged attention, then wo, the residual and the
        MLP: the layer's output (1, Sq, E)."""
        cfg = self.cfg
        lp = layer_params({"layers": layers}, li)
        o = acc / l.clamp_min(1e-30)                     # (KV, G, Sq, D)
        Sq = x.shape[1]
        o = o.permute(2, 0, 1, 3).reshape(1, Sq, -1, cfg.head_dim_).to(
            cfg.dtype)
        o = torch.einsum("bshd,hde->bse", o, lp["attn"]["wo"].to(cfg.dtype))
        return _mlp(lp, x + o, cfg)

    def logits(self, params, x, idx: int) -> torch.Tensor:
        """f32 logits (V,) at sequence index ``idx``: the final norm, then
        the head's product of the dtype's values taken in f32."""
        cfg = self.cfg
        last = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)[0, idx]
        return last.float() @ params["lm_head"].to(cfg.dtype).float()
