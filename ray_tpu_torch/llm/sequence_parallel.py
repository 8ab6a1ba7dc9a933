"""Sequence-parallel prefill and streamed paged-KV attention in PyTorch.

Port of ray_tpu/llm/sequence_parallel.py, in its two halves:

1. **SP prefill** (``sp_prefill_fn``, ``sp_suffix_prefill_fn``): the
   engine's prefill with the sequence split over the ``sp`` positions of a
   ``parallel.mesh.Mesh``. Each shard runs embed, RMSNorm, QKV and RoPE at
   its absolute positions on its own device; each layer's attention is
   ring attention or Ulysses over all shards (``ops/ring_attention.py``,
   plain PyTorch, as in the reference: no flash kernel); then ``wo`` and
   SwiGLU per shard. The reference runs this as one jitted program whose
   arrays ``shard_map`` splits; here one process launches each shard's
   work on its device in turn, the single-controller model of the JAX
   engine, and the suffix variant seeds the ring's accumulator with the
   pool-resident prefix, so prefix-cache hits keep skipping the shared
   pages' prefill under SP.

2. **Streamed paged-KV attention** (``_stream_block_fn``, ``StreamAttn``):
   attention over KV *parts* that are never resident in the engine's page
   pool. Each part is an (L, span, KV, D) stripe held wherever its
   producer put it (host memory, another engine's device). The engine
   loops layers outer and parts inner and merges one part at a time by
   online softmax, so the device's working set for attention is one part,
   whatever the length of the context.

The reference jit-compiles each piece and caches the compilations by shape;
here each piece is a plain function over tensors, run eagerly. Scores and
P.V are taken in f32 from the working dtype's values (the reference's
``preferred_element_type=float32``): the operands are upcast, so with TF32
off the products are exact and the sums f32. The scale multiplies by
``1 / sqrt(D)`` in f32, as the reference's SP functions and ``StreamAttn``
do (the engine's suffix prefill divides by sqrt(D) rounded to the dtype
instead).

The reference's ``_seq_sharding`` (a NamedSharding for
``with_sharding_constraint``) has no counterpart: the split is explicit.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models.transformer import (TransformerConfig, _layer_qkv,
                                  apply_rope, embed_tokens, head_logits,
                                  layer_params, rms_norm, rope_angles,
                                  sp_layer)
from ..ops.ring_attention import (_empty_state, _grouped, _merge,
                                  _ring_shards, _split, _ulysses_shards)
from ..parallel.mesh import Mesh, MeshSpec, _cuda_devices, build_mesh
from ..parallel.pipeline import stage_send

__all__ = ["sp_mesh", "sp_prefill_fn", "sp_suffix_prefill_fn",
           "sp_stripe_pages", "replicate_params", "StreamAttn",
           "validate_sp"]


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def sp_mesh(degree: int, devices=None) -> Mesh:
    """Build a local ``sp``-axis mesh over the first `degree` devices
    (default: the visible CUDA devices, raising where there is none)."""
    devices = list(devices if devices is not None else _cuda_devices())
    if degree > len(devices):
        raise ValueError(
            f"sp_degree={degree} exceeds the {len(devices)} visible "
            f"devices (CPU tests: XLA_FLAGS=--xla_force_host_platform_"
            f"device_count)")
    return build_mesh(MeshSpec(sp=degree), devices=devices[:degree])


def validate_sp(cfg, degree: int, strategy: str, tp: int = 1) -> None:
    """Fail fast on layouts the shard bodies cannot express: Ulysses
    splits each tp position's kv heads (num_kv_heads / tp) over the sp
    shards."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp strategy {strategy!r}")
    if degree < 2:
        return
    heads = f"num_kv_heads ({cfg.num_kv_heads})" + (
        f" / tp ({tp})" if tp > 1 else "")
    if strategy == "ulysses" and (cfg.num_kv_heads // tp) % degree:
        raise ValueError(
            f"ulysses needs {heads} divisible by sp_degree ({degree}); use "
            f"strategy='ring'")


def sp_stripe_pages(pages, S: int, n_shards: int, page: int,
                    padded: Optional[int] = None) -> list:
    """Partition the pages an SP pass installed over the sp shards:
    shard i owns the pages whose FIRST token falls in its sequence
    stripe.  This is the install/handoff accounting the cross-host path
    consumes — each shard's stripe of a prefill is published/owned
    separately.

    `padded` is the PADDED sequence length (the pow-2 bucket): the split
    is even over the padded axis, so shard i computed tokens
    [i·padded/n, (i+1)·padded/n) — boundaries from the real length S
    would mis-attribute pages near the padded tail.  `pages` must be
    exactly the pages the pass wrote (for a prefix-cache-hit suffix
    pass: the NEW pages, not the shared prefix's)."""
    Sb = padded or S
    per = Sb // n_shards        # pow-2 bucket / pow-2 degree: exact
    n_pages = math.ceil(S / page)
    stripes = [[] for _ in range(n_shards)]
    for p in range(n_pages):
        shard = min((p * page) // per, n_shards - 1)
        stripes[shard].append(int(pages[p]))
    return stripes


def _tree_to(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    return node.to(device)


def replicate_params(params: Dict[str, Any], mesh: Mesh
                     ) -> Dict[torch.device, Dict[str, Any]]:
    """{device: params on it} for each distinct device of ``mesh``, the
    form the SP functions take (the reference's params are one global
    array that jit replicates). ``.to`` returns the same tensors where
    they already are, so the device that holds ``params``, or one that
    the mesh names several times, holds no second copy."""
    return {d: _tree_to(params, d) for d in mesh.distinct_devices()}


# ---------------------------------------------------------------------------
# SP prefill (ring / Ulysses over the sequence shards)
# ---------------------------------------------------------------------------

def _sp_grid(params, mesh: Mesh):
    """(params[s][j][t], devices[s][j][t]): pipeline stage s's sp shard
    j's tp position t's params and device. ``params`` is
    ``replicate_params``'s {device: params} (sp alone), or the
    per-position list of ``models.transformer.tp_shards`` on an sp mesh
    with tp or pp, in ``mesh.coords()`` order."""
    pp, tp = mesh.shape["pp"], mesh.shape["tp"]
    idx = [[list(row) for row in zip(*(mesh.sp_positions(tp=t, stage=s)
                                        for t in range(tp)))]
           for s in range(pp)]
    devices = [[[mesh.devices.flat[i] for i in row] for row in st]
               for st in idx]
    if isinstance(params, dict):
        if tp > 1 or pp > 1:
            raise ValueError("an sp mesh with tp or pp takes the "
                             "per-position params of tp_shards(params, "
                             "mesh)")
        return [[[params[row[0]]] for row in devices[0]]], devices
    return [[[params[i] for i in row] for row in st] for st in idx], devices


def _run_sp(params, tokens, length: int, cfg: TransformerConfig, mesh: Mesh,
            pos0: int, attend):
    """The body both SP functions share. tokens (1, Sb) split into n
    shards, RoPE at pos0 + absolute index; stage by stage, each shard runs
    embed (the first stage), QKV and RoPE on its tp positions
    (``models.transformer.sp_layer``), and ``attend(lj, k, qs, ks, vs,
    devices)`` gives the attention output of tp position t of the stage's
    local layer lj for each shard, over its heads (k = s * tp + t, the
    position's index among the first shard's); then each shard's wo and
    MLP with their all-reduces over its tp positions. A shard's hidden
    state goes on to the next stage's devices by ``.to()``
    (``pipeline.stage_send``). Returns (last_logits (V,) f32 on tokens'
    device, ks, vs): per stage and tp position (L/pp, Sb, KV_t, D) on its
    first shard's device, or, with neither tp nor pp, one (L, Sb, KV, D)
    pair on tokens' device."""
    grid, devss = _sp_grid(params, mesh)
    pp, n, tp = len(devss), len(devss[0]), len(devss[0][0])
    B, S = tokens.shape
    Sl = S // n
    D = cfg.head_dim_
    L = grid[0][0][0]["layers"]["attn"]["wq"].shape[0]
    dt = cfg.dtype
    home = tokens.device
    xs = [embed_tokens(grid[0][j], devss[0][j], t, cfg)
          for j, t in enumerate(_split(tokens, [r[0] for r in devss[0]]))]
    ropes = [{d: rope_angles(Sl, D, cfg.rope_theta, offset=pos0 + j * Sl,
                             device=d)
              for d in dict.fromkeys(d for st in devss for d in st[j])}
             for j in range(n)]
    where = ([home] if isinstance(params, dict)
             else [d for st in devss for d in st[0]])
    firsts = [p for st in grid for p in st[0]]
    ks = [torch.empty((L, S, p["layers"]["attn"]["wk"].shape[2], D),
                      dtype=dt, device=d) for p, d in zip(firsts, where)]
    vs = [torch.empty_like(k) for k in ks]
    for s in range(pp):
        if s:
            xs = [stage_send(next(iter(x.values())), devss[s][j])
                  for j, x in enumerate(xs)]
        for lj in range(L):
            lpss = [[layer_params(p, lj) for p in row] for row in grid[s]]

            def attend_all(hs, s=s, lj=lj, lpss=lpss):
                qkv = [[None] * tp for _ in range(n)]
                for j in range(n):
                    for t, (lp, d) in enumerate(zip(lpss[j], devss[s][j])):
                        cos, sin = ropes[j][d]
                        q, k, v = _layer_qkv(lp, hs[j][d], cfg)
                        qkv[j][t] = (apply_rope(q, cos, sin),
                                     apply_rope(k, cos, sin), v)
                        ks[s * tp + t][lj, j * Sl:(j + 1) * Sl] = \
                            qkv[j][t][1][0]
                        vs[s * tp + t][lj, j * Sl:(j + 1) * Sl] = v[0]
                outs = [attend(lj, s * tp + t,
                               *zip(*(qkv[j][t] for j in range(n))),
                               [devss[s][j][t] for j in range(n)])
                        for t in range(tp)]
                return [[o[j] for o in outs] for j in range(n)]
            xs = sp_layer(cfg, xs, lpss, devss[s], attend_all)
    j = (length - 1) // Sl                  # the shard of the last token
    logits = head_logits(grid[-1][j], devss[-1][j], xs[j],
                         (0, length - 1 - j * Sl), cfg).to(home)
    if isinstance(params, dict):
        return logits, ks[0], vs[0]
    return logits, ks, vs


def sp_prefill_fn(params, tokens, length: int, cfg: TransformerConfig,
                  mesh: Mesh, strategy: str = "ring"):
    """Sequence-parallel twin of engine._prefill_fn: same contract —
    tokens (1, Sb) padded prompt → (last_logits (V,), ks, vs
    (L, Sb, KV, D)) on tokens' device — with the attention split over the
    mesh's ``sp`` axis: shard i holds tokens [i·Sb/n, (i+1)·Sb/n). Sb
    must be divisible by the sp size (pow-2 buckets are). ``params`` is
    ``replicate_params(params, mesh)``, or on an sp mesh with tp or pp
    the per-position params of ``tp_shards(params, mesh)``: then each tp
    position runs the ring or Ulysses over its sp positions at its heads
    (the reference's ``heads_axis="tp"``), each stage over its layers,
    and ks, vs are one (L/pp, Sb, KV/tp, D) per stage and tp position, as
    ``_run_sp`` says."""
    scale = 1.0 / math.sqrt(cfg.head_dim_)
    body = _ring_shards if strategy == "ring" else _ulysses_shards

    def attend(lj, k, qs, ks, vs, devices):
        return body(qs, ks, vs, devices, causal=True, scale=scale)
    return _run_sp(params, tokens, length, cfg, mesh, 0, attend)


def sp_suffix_prefill_fn(params, pool_k, pool_v, pages, tokens,
                         prefix_len: int, length: int, cfg: TransformerConfig,
                         page: int, mesh: Mesh):
    """Sequence-parallel twin of engine._suffix_prefill_fn (prefix-cache
    hit suffix prefill): suffix queries split over ``sp`` at RoPE
    positions prefix_len + i, the resident prefix pages (``pages``, a
    full page-table row; keys t < prefix_len count) read whole by every
    shard and merged first into its accumulator
    (``_sp_suffix_shard``'s seed, with p re-masked), then the ring over
    the suffix KV. Always ring — Ulysses would have to split the
    resident prefix's KV heads across shards, which buys nothing for a
    memory-resident prefix. ``params`` as in ``sp_prefill_fn``; on an sp
    mesh with tp or pp ``pool_k``/``pool_v`` are the pools of the stages'
    tp positions (stage-major), each read by its own position, else one
    pool."""
    if isinstance(pool_k, torch.Tensor):
        pool_k, pool_v = [pool_k], [pool_v]
    T = pages.shape[0] * page
    D = cfg.head_dim_
    scale = 1.0 / math.sqrt(D)
    pvalid = torch.arange(T, device=pages.device)[None] < prefix_len

    def attend(lj, k, qs, ks, vs, devices):
        KV = pool_k[k].shape[-2]
        pg = pages.to(pool_k[k].device)
        ck = pool_k[k][lj][pg].reshape(1, T, KV, D)
        cv = pool_v[k][lj][pg].reshape(1, T, KV, D)
        on = {d: (ck.to(d), cv.to(d), pvalid.to(d))
              for d in dict.fromkeys(devices)}
        states = []
        for q, d in zip(qs, devices):
            qg = _grouped(q, KV)
            states.append(_merge(qg, *on[d], *_empty_state(qg), scale))
        return _ring_shards(qs, ks, vs, devices, causal=True, scale=scale,
                            states=states)
    return _run_sp(params, tokens, length, cfg, mesh, prefix_len, attend)


# ---------------------------------------------------------------------------
# Streamed paged-KV attention
# ---------------------------------------------------------------------------

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
    them layers outer, tp positions and parts inner
    (``LLMEngine._stream_layers``; one position without tp):

        x = sa.embed(params, tokens)
        for li in range(L):
            def attend(h):                   # h: the normed layer input
                for each position i (its layer params lp_i, its device):
                    q, k, v = sa.rope_qkv(lp_i, h, pos0)
                    m, l, acc = sa.init(Sq, KV_i, device_i)
                    for each KV block (an external part, the pool tail,
                    the self block), position i's kv heads of it:
                        m, l, acc = _stream_block_fn(q, kb, vb, valid, q0,
                                                     k0, m, l, acc,
                                                     scale=sa.scale)
                    o_i = sa.heads(l, acc)
                return [o_0, o_1, ...]
            x = tp_layer(cfg, x, lps, devices, attend)
        logits = sa.logits(params, x, last_idx)

    ``tp_layer`` does wo, the all-reduces, the residuals and the MLP. Only
    one block is read per ``_stream_block_fn`` call, so the attention's
    device working set is one part, not the context."""

    def __init__(self, cfg: TransformerConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scale = 1.0 / math.sqrt(cfg.head_dim_)

    def init(self, sq: int, kv_heads: Optional[int] = None,
             device: Optional[torch.device] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """m = -1e30, l = 0, acc = 0, in f32: (KV, G, Sq, 1) and
        (KV, G, Sq, D); ``kv_heads`` (default all) and ``device`` (default
        the engine's) for a tp position's share."""
        cfg = self.cfg
        kv = kv_heads or cfg.num_kv_heads
        dev = device or self.device
        shape = (kv, cfg.num_heads // cfg.num_kv_heads, sq)
        m = torch.full(shape + (1,), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros(shape + (1,), dtype=torch.float32, device=dev)
        acc = torch.zeros(shape + (cfg.head_dim_,), dtype=torch.float32,
                          device=dev)
        return m, l, acc

    def embed(self, params, tokens) -> torch.Tensor:
        """tokens (1, S) ints (numpy or a tensor) -> (1, S, E)."""
        t = torch.as_tensor(np.asarray(tokens), device=self.device).long()
        return params["embed"].to(self.cfg.dtype)[t]

    def rope_qkv(self, lp, h, pos0: int):
        """-> (q (Sq, H_i, D), k, v (Sq, KV_i, D)) from the normed input h
        (1, Sq, E) and one layer's params (a tp position's, for its heads),
        rope'd at pos0 + i."""
        cfg = self.cfg
        q, k, v = _layer_qkv(lp, h, cfg)
        cos, sin = rope_angles(h.shape[1], cfg.head_dim_, cfg.rope_theta,
                               offset=pos0, device=h.device)
        return apply_rope(q, cos, sin)[0], apply_rope(k, cos, sin)[0], v[0]

    def heads(self, l, acc) -> torch.Tensor:
        """The merged attention normalised: (1, Sq, H, D) in the dtype."""
        o = acc / l.clamp_min(1e-30)                     # (KV, G, Sq, D)
        return o.permute(2, 0, 1, 3).reshape(
            1, o.shape[2], -1, self.cfg.head_dim_).to(self.cfg.dtype)

    def logits(self, params, x, idx: int) -> torch.Tensor:
        """f32 logits (V,) at sequence index ``idx``: the final norm, then
        the head's product of the dtype's values taken in f32."""
        cfg = self.cfg
        last = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)[0, idx]
        return last.float() @ params["lm_head"].to(cfg.dtype).float()
