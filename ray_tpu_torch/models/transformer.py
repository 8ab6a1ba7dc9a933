"""Llama-style decoder-only transformer in PyTorch.

Port of ray_tpu/models/transformer.py. Params are a plain dict with the
JAX package's keys and layouts (``wq (L,E,H,D)``, ``wo (L,H,D,E)``, ...),
so ``from_jax_params`` is a plain copy. bf16 activations and weights, f32
RMSNorm math and f32 logits, GQA, RoPE and SwiGLU, as in the reference.
The layers run as a Python loop in place of ``lax.scan``; with ``remat``
each layer is checkpointed when a gradient is needed
(``torch.utils.checkpoint`` in place of ``jax.checkpoint``), so inference
is unchanged by it.

``params["layers"]`` comes in two forms. Every entry point takes the
stacked JAX form, one (L, ...) tensor per weight. ``layer_params`` also
takes a list of per-layer dicts, which only ``train_step`` builds (views of
the stacked storage, so that autograd gives each layer its own gradient
tensor); no other caller should grow a third form. (``PositionView``,
the engine's view of a position's params under another rule table, is
the stacked form to its readers: indexing a stacked leaf builds that
layer's tensor.)

``forward`` and ``loss_fn`` take a ``mesh`` (``parallel.mesh.Mesh``):

- sp alone: with ``attention_impl="ring"`` each layer's attention runs
  ``ops.ring_attention.ring_attention`` over it, and every other op runs on
  ``device``, whose values the reference's sharding constraints do not
  change.
- any of dp, fsdp and tp, beside sp or not (training's layouts, and
  tensor-parallel ``forward``): the params are stored over the mesh's
  positions as ``rules`` say (``LogicalAxisRules.default()``: batch over
  dp x fsdp, embed over fsdp, heads, kv heads, MLP and vocabulary over
  tp, no param over sp; ``megatron_rules()``; or any other table), and
  ``params`` may be the full tree or the per-position list that
  ``parallel.sharding.shard_params`` returns under the same rules. The
  model computes in one layout whatever the table (``compute_rules``):
  heads, kv heads and MLP units over tp, the layer stack over pp, the
  vocabulary over tp where the table splits it there, every other dim
  whole. Each position builds a layer's weights in that layout from the
  stored slices when it runs the layer (``_ParamPlan``, over
  ``parallel.sharding.reshard``: under the default table, its tp slice
  gathered across the fsdp positions), and autograd takes each gradient
  back to the stored slices. The batch groups (``Mesh.batch_groups``:
  the table's batch axes among dp and fsdp; one group per (dp, fsdp)
  pair under the default table) run in turn; positions off the groups
  (fsdp under ``("batch", "dp")``) compute nothing and only hold their
  slices, so each piece of work runs once. A group's sequence is split
  over its sp positions where the table splits the sequence over sp
  (``Mesh.sequence_shards``), shard j holding tokens [j S/sp, (j+1)
  S/sp) (the reference's ``seq`` constraint), and each shard's layer
  runs as ``sp_layer``, ``tp_layer`` per shard. Attention is the one step
  that crosses shards: per tp position, under ``attention_impl="ring"``
  the ring over its sp positions at its heads, under "xla" and "flash"
  the sequence gathered on its first sp position, attended whole and
  split back (GSPMD's gather around the reference's attention; "flash"
  runs the kernel there). Where the vocabulary is split, the embedding
  is looked up per vocabulary slice and summed (``all_reduce``), the
  logits stay split over tp, and the cross-entropy reads them slice by
  slice (``vocab_parallel_nll``). The values are those of the unsharded
  model, under every table; where the reference's GSPMD departs from its
  own unsharded model (``("embed", ("fsdp", "tp"))`` on dp=2 x fsdp=2 x
  tp=2, ROADMAP Queue 3), the port follows the unsharded model.
- pp beside any of those (pipeline stages): stage s's positions compute
  layers [s L/pp, (s+1) L/pp) (the default rules also store them there;
  a table that stores the stack otherwise, ``("layer", None)``, gives
  each stage its layers at use), and each stage is a dp x fsdp x sp x tp
  layout of its own.
  A batch group's rows are split into ``num_microbatches`` (default pp)
  microbatches that run the GPipe schedule (``parallel.pipeline``): the
  embedding on stage 0, each stage's layers on its positions as above,
  the hand-off of each sequence shard to the next stage's devices by
  ``.to()`` (``pipeline.stage_send``), ``ln_f``, ``lm_head`` and the
  cross-entropy on the last stage. JAX splits the global batch into
  microbatches before its dp x fsdp split; here each group's contiguous
  rows are split. The token-weighted loss is a sum over rows either way,
  so the two agree. Inside its pipeline JAX elides the ring (plain
  attention); the port runs each stage's ring, the same values.
- a mesh over several processes (``parallel.mesh``: one process per GPU,
  any axis across ranks, any table): every rank is given the whole batch
  and runs only its own positions, in rounds (``_Layout``: round k runs
  each rank's k-th batch group, in the same order on every rank). A
  position builds its compute params from the stored slices as in one
  process (``_ParamPlan``); a block that only other ranks hold comes
  through one all-gather per leaf and event of each rank's slices over
  the process group of the ranks that read and hold it
  (``parallel.sharding.exchange``, in ``_Layout.fetch``), whose backward
  reduce-scatters the gradient back. A rank that holds slices others
  read but computes nothing with them there (no batch group under
  ``("batch", "dp")``, no sequence shard under ``("seq", None)``, no
  head where the vocabulary is whole) still runs those events, per
  layer and in the recompute too (``_mock_stage``, the head's hidden
  state). A tp group across ranks sums its partials by ``all_reduce``
  over its process group (``_AllReduce``: an f32 all-reduce, rounded
  once; its backward sums the copies' gradients, the counterpart of the
  ``.to()`` copies' backward), the vocabulary-split embedding and
  cross-entropy likewise. Each rank keeps its own copy of the residual stream, whose
  gradient is that copy's share, and a tensor replicated over tp (the
  norm scales; under ``megatron_rules()`` the embedding and head) takes
  a partial gradient on each rank, which the train step's replica
  all-reduce sums. An sp group across ranks rotates the ring by P2P or
  gathers the sequence on its first shard's rank (``_sp_attention``);
  stages across ranks hand off by send/recv
  (``parallel.pipeline.Handoffs``), the backward ordered per
  microbatch. The loss is summed over the world (``world_sum``), and
  ``forward`` sums the ranks' pieces of the logits.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.flash_attention import flash_attention, reference_attention
from ..ops.ring_attention import (_ring_shards, ring_attention, ring_shift,
                                  seq_gather, seq_scatter)
from ..parallel.pipeline import (Handoffs, check_microbatches, gpipe_ticks,
                                 stage_send)
from ..parallel.sharding import (LogicalAxisRules, PartitionSpec,
                                 _dim_axes, exchange, exchange_slots,
                                 from_runs, prefer_rank, reshard,
                                 reshard_plan, shard_params, shard_slices,
                                 tie, tree_specs)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Checkpoint each layer when a gradient is needed: its activations are
    # recomputed in the backward (the reference's jax.checkpoint).
    remat: bool = True
    # "xla" = plain PyTorch attention (reference_attention);
    # "flash" = the hand-written CUDA kernel (ops/flash_attention.py);
    # "ring" = ring attention over the mesh's sp axis (ops/ring_attention.py;
    # plain attention where forward is given no mesh).
    attention_impl: str = "xla"
    # Sequence-parallel degree of the LLM engine's prefill attention
    # (llm/sequence_parallel.py): >1 splits prefill over an ``sp`` mesh
    # axis (ring attention or Ulysses). A power of two; 1 = off.
    sp_degree: int = 1

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Approximate train FLOPs/token (fwd+bwd = 6*N + attention term)."""
        s = seq_len or self.max_seq_len
        attn = 12 * self.num_layers * self.hidden_size * s
        return 6 * self.param_count() + attn

    def param_count(self) -> int:
        h, v, l = self.hidden_size, self.vocab_size, self.num_layers
        d = self.head_dim_
        qkv = h * (self.num_heads * d) + 2 * h * (self.num_kv_heads * d)
        o = self.num_heads * d * h
        mlp = 3 * h * self.intermediate_size
        return v * h + l * (qkv + o + mlp + 2 * h) + h + v * h


PRESETS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
        num_heads=8, num_kv_heads=4, max_seq_len=256, dtype=torch.float32),
    "nano": TransformerConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=512, num_layers=4,
        num_heads=8, num_kv_heads=8, max_seq_len=512),
    "1b": TransformerConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5504,
        num_layers=22, num_heads=16, num_kv_heads=16, max_seq_len=2048),
    # Llama-2-7B dims
    "7b": TransformerConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, max_seq_len=4096),
    # Llama-3-8B-style GQA config
    "8b-gqa": TransformerConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
        rope_theta=500000.0),
}


# ---------------------------------------------------------------------------
# Logical axis annotations (consumed by parallel.sharding)
# ---------------------------------------------------------------------------

def param_logical_axes(cfg: Optional[TransformerConfig]):
    """Tree (same structure as init params) of logical-axis tuples; the
    same for every config."""
    layer = {
        "attn": {
            "wq": ("layer", "embed", "heads", "head_dim"),
            "wk": ("layer", "embed", "kv_heads", "head_dim"),
            "wv": ("layer", "embed", "kv_heads", "head_dim"),
            "wo": ("layer", "heads", "head_dim", "embed"),
        },
        "mlp": {
            "w_gate": ("layer", "embed", "mlp"),
            "w_up": ("layer", "embed", "mlp"),
            "w_down": ("layer", "mlp", "embed"),
        },
        "ln_attn": ("layer", "norm"),
        "ln_mlp": ("layer", "norm"),
    }
    return {
        "embed": ("vocab", "embed"),
        "layers": layer,
        "ln_f": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def param_shapes(cfg: TransformerConfig):
    """Tree (same structure as init params) of (shape, dtype): what
    ``init_params`` allocates, without allocating it."""
    h, d, m, L = (cfg.hidden_size, cfg.head_dim_, cfg.intermediate_size,
                  cfg.num_layers)
    nh, nkv, v, dt = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size, \
        cfg.dtype
    f32 = torch.float32
    return {
        "embed": ((v, h), dt),
        "layers": {
            "attn": {"wq": ((L, h, nh, d), dt), "wk": ((L, h, nkv, d), dt),
                     "wv": ((L, h, nkv, d), dt), "wo": ((L, nh, d, h), dt)},
            "mlp": {"w_gate": ((L, h, m), dt), "w_up": ((L, h, m), dt),
                    "w_down": ((L, m, h), dt)},
            "ln_attn": ((L, h), f32),
            "ln_mlp": ((L, h), f32),
        },
        "ln_f": ((h,), f32),
        "lm_head": ((h, v), dt),
    }


def megatron_rules() -> LogicalAxisRules:
    """The rules of the JAX engine's tensor-parallel serving
    (ray_tpu/llm/engine.py:714-715): the default table with the vocabulary
    and the embedding dim replicated, so that heads, kv heads and the MLP's
    hidden units are the only dims split over ``tp``."""
    return LogicalAxisRules.default().with_overrides(("vocab", None),
                                                     ("embed", None))


def tp_shards(params: Dict[str, Any], mesh, rules=None) -> list:
    """Each position's params for the engine, in grid order: its slices
    under ``rules`` (default ``megatron_rules()``, the JAX engine's), as
    ``shard_params`` cuts them. Under the Megatron table a position's
    slices are what its layer computes with (``tp_layer``: heads, kv heads
    and MLP units over tp, the layer stack over pp); under any other table
    the engine reads them through ``position_views``."""
    return shard_params(params, mesh, rules or megatron_rules(),
                        param_logical_axes(None))


def _flat(tree, fn, prefix="") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, fn, prefix + k + "."))
        else:
            out[prefix + k] = fn(v)
    return out


# ---------------------------------------------------------------------------
# Init and conversion
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random params in the JAX layouts, drawn from ``generator`` (default:
    seeded 0) on ``device``. The draws differ from ``jax.random``'s; tests
    that compare with the JAX package carry its params over instead
    (``from_jax_params``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    h, d = cfg.hidden_size, cfg.head_dim_
    nh, nkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    m = cfg.intermediate_size

    def dense(shape, fan_in, stacked=False):
        # Stacked (L, ...) weights are drawn one layer at a time so the f32
        # draw never holds a whole stack.
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        parts = out if stacked else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev) / math.sqrt(fan_in))
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    return {
        "embed": dense((cfg.vocab_size, h), h),
        "layers": {
            "attn": {
                "wq": dense((L, h, nh, d), h, True),
                "wk": dense((L, h, nkv, d), h, True),
                "wv": dense((L, h, nkv, d), h, True),
                "wo": dense((L, nh, d, h), nh * d, True),
            },
            "mlp": {
                "w_gate": dense((L, h, m), h, True),
                "w_up": dense((L, h, m), h, True),
                "w_down": dense((L, m, h), m, True),
            },
            "ln_attn": ones(L, h),
            "ln_mlp": ones(L, h),
        },
        "ln_f": ones(h),
        "lm_head": dense((h, cfg.vocab_size), h),
    }


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # JAX hands bf16 over as ml_dtypes' numpy bfloat16, which
        # torch.from_numpy rejects: reinterpret the bits, exactly.
        t = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(np_tree, cfg: TransformerConfig,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, Any]:
    """Carry JAX params across: ``np_tree`` is the JAX pytree as numpy
    arrays (``jax.tree.map(np.asarray, params)``). The layouts match, so
    this is a bit-exact copy onto ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(np.asarray(node), dev)

    params = conv(np_tree)
    got = tuple(params["layers"]["attn"]["wq"].shape)
    want = (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim_)
    if got != want:
        raise ValueError(f"wq is {got}, the config wants {want}")
    return params


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked (L, ...) layer params, or its
    entry where ``params["layers"]`` is already a per-layer list (as the
    train step builds it, so that autograd sees one leaf per layer)."""
    if isinstance(params["layers"], (list, tuple)):
        return params["layers"][i]

    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params["layers"])


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_angles(seq_len: int, head_dim: int, theta: float, offset: int = 0,
                device: Union[str, torch.device] = "cpu"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * freqs[None, :]           # (S, D/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); rotate-half formulation."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention(cfg: TransformerConfig, q, k, v, mesh=None):
    if cfg.attention_impl == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attention_impl == "ring" and mesh is not None:
        return ring_attention(q, k, v, mesh, axis_name="sp", causal=True)
    if cfg.attention_impl not in ("xla", "ring"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    return reference_attention(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_qkv(lp, h, cfg: TransformerConfig):
    """A layer's q (B, S, H, D), k and v (B, S, KV, D) from the normed
    input h, before RoPE."""
    dt = cfg.dtype
    q = torch.einsum("bse,ehd->bshd", h, lp["attn"]["wq"].to(dt))
    k = torch.einsum("bse,ekd->bskd", h, lp["attn"]["wk"].to(dt))
    v = torch.einsum("bse,ekd->bskd", h, lp["attn"]["wv"].to(dt))
    return q, k, v


def _mlp_down(lp, h, cfg: TransformerConfig):
    """SwiGLU of the normed input h: w_down(silu(h w_gate) * (h w_up)); a
    tp position's partial sum where ``lp`` holds its hidden units."""
    dt = cfg.dtype
    g = torch.einsum("bse,em->bsm", h, lp["mlp"]["w_gate"].to(dt))
    u = torch.einsum("bse,em->bsm", h, lp["mlp"]["w_up"].to(dt))
    return torch.einsum("bsm,me->bse", F.silu(g) * u,
                        lp["mlp"]["w_down"].to(dt))


def on_each(t: torch.Tensor, devices) -> Dict[torch.device, torch.Tensor]:
    """``t`` on each distinct device of ``devices`` (no copy where it is)."""
    return {d: t.to(d) for d in dict.fromkeys(devices)}


def all_reduce(parts, devices, group=None
               ) -> Dict[torch.device, torch.Tensor]:
    """The sum of one partial per tp position (``parts[i]`` on
    ``devices[i]``), on each distinct device: {device: sum}.

    Each partial goes to the first position's device, where they are added
    in f32 in position order and the sum is rounded to the partials' dtype
    once; the sum then goes to every other distinct device. Against the
    unsharded product, whose one matmul accumulates every term in f32 and
    rounds once, each partial here was rounded once more: a bf16 sum is
    within a few bf16 ulps of it, an f32 one within f32 rounding. (XLA's
    all-reduce does not fix an order.) On one device nothing is copied.

    ``group``: ``parts`` are this rank's positions' partials, and the
    other ranks of ``group`` hold the rest of the tp group's; the f32 sum
    of this rank's is summed over the group (``_AllReduce``) before the
    one rounding."""
    if len(parts) == 1 and group is None:
        total = parts[0]
    else:
        home = devices[0]
        total = parts[0].to(torch.float32, copy=True)
        for p in parts[1:]:
            total += p.to(home)
        if group is not None:
            total = _AllReduce.apply(total, group)
        total = total.to(parts[0].dtype)
    return on_each(total, devices)


class _AllReduce(torch.autograd.Function):
    """A tensor summed over the ranks of ``group`` (in place, one
    ``dist.all_reduce``). The backward is the same sum of the gradients:
    each rank's copy of the sum took its own share of the gradient, as the
    ``.to()`` copies of a single controller's sum do, and each partial
    takes their total."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        ctx.mark_dirty(t)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def tp_layer(cfg: TransformerConfig, xs, lps, devices, attend):
    """One decoder layer over the tp positions (Megatron): ``xs`` is the
    layer's input {device: (B, S, E)}, the same values on each distinct
    device; ``lps[i]`` position i's layer params on ``devices[i]``, which
    hold its heads, kv heads and MLP hidden units (a single position holds
    all of them: the plain layer).

    The norms and residuals run once per distinct device. ``attend(h)``
    gets the normed input {device: (B, S, E)} and returns each position's
    attention output over its own heads, (B, S, H_i, D) on its device (QKV,
    RoPE and the attention are the caller's). Each position's partial
    ``wo`` product is summed by ``all_reduce``; then each position's share
    of the MLP and a second all-reduce. Returns the layer's output
    {device: (B, S, E)}."""
    return sp_layer(cfg, [xs], [lps], [devices],
                    lambda hs: [attend(hs[0])])[0]


def sp_layer(cfg: TransformerConfig, xss, lpss, devss, attend, groups=None):
    """``tp_layer`` over sequence shards: shard j's input ``xss[j]``
    {device: (B, S_j, E)} runs on its tp positions ``devss[j]``, which
    hold ``lpss[j]``. ``attend(hs)`` gets every shard's normed input and
    returns ``outs[j][i]``, shard j's tp position i's attention output
    (B, S_j, H_i, D) on its device: attention is the only step that
    crosses shards. Each shard's ``wo``, all-reduces, MLP and residuals
    are its own. Returns each shard's output {device: (B, S_j, E)}.

    ``groups[j]``: the process group of the ranks that hold shard j's tp
    positions where they span several (None: this rank holds them all).
    ``devss[j]``, ``lpss[j]`` and ``xss[j]`` then hold this rank's
    positions only, and are empty (the output ``{}``) on a rank that holds
    none of the shard's."""
    eps, dt = cfg.rms_norm_eps, cfg.dtype
    groups = groups or [None] * len(xss)
    firsts = []
    for devices in devss:
        first = {}
        for i, d in enumerate(devices):
            first.setdefault(d, i)
        firsts.append(first)
    hs = [{d: rms_norm(xs[d], lps[i]["ln_attn"], eps)
           for d, i in first.items()}
          for xs, lps, first in zip(xss, lpss, firsts)]
    outs = attend(hs)
    result = []
    for xs, lps, devices, first, o_j, group in zip(xss, lpss, devss, firsts,
                                                   outs, groups):
        if not devices:
            result.append({})
            continue
        parts = [torch.einsum("bshd,hde->bse", o, lp["attn"]["wo"].to(dt))
                 for o, lp in zip(o_j, lps)]
        o = all_reduce(parts, devices, group)
        xs = {d: xs[d] + o[d] for d in first}
        h = {d: rms_norm(xs[d], lps[i]["ln_mlp"], eps)
             for d, i in first.items()}
        m = all_reduce([_mlp_down(lp, h[d], cfg)
                        for lp, d in zip(lps, devices)], devices, group)
        result.append({d: xs[d] + m[d] for d in first})
    return result


def _layer(cfg: TransformerConfig, x, lp, cos, sin, mesh=None):
    def attend(h):
        q, k, v = _layer_qkv(lp, h[x.device], cfg)
        return [_attention(cfg, apply_rope(q, cos, sin),
                           apply_rope(k, cos, sin), v, mesh)]
    return tp_layer(cfg, {x.device: x}, [lp], [x.device], attend)[x.device]


# ---------------------------------------------------------------------------
# Meshes with dp, fsdp or tp: the sharded layout
# ---------------------------------------------------------------------------

def mesh_rules(mesh, rules: Optional[LogicalAxisRules] = None
               ) -> LogicalAxisRules:
    """``rules`` (default ``LogicalAxisRules.default()``): any table, on a
    mesh that one process drives or over several processes. The params
    are stored as it says and computed in the sharded model's layout
    (``compute_rules``)."""
    return rules or LogicalAxisRules.default()


def compute_rules(vocab_split: bool) -> LogicalAxisRules:
    """The table of the layout the sharded model computes in, whatever
    table stores the params: heads, kv heads and MLP units over tp
    (``tp_layer``), the layer stack over pp, the vocabulary over tp where
    ``vocab_split`` (the vocabulary-parallel embedding and logits), every
    other dim whole."""
    return LogicalAxisRules([("layer", "pp"), ("heads", "tp"),
                             ("kv_heads", "tp"), ("mlp", "tp"),
                             ("vocab", "tp" if vocab_split else None)])


def _layer_tree(fn) -> Dict[str, Any]:
    """A layer's params tree with ``fn(dotted name)`` at each leaf
    ("layers.attn.wq", ...)."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}.{k}") for k, v in node.items()}
        return fn(prefix)
    return walk(param_logical_axes(None)["layers"], "layers")


def _layer_leaf(tree, path, li: int) -> torch.Tensor:
    """Layer ``li``'s tensor at ``path`` (keys under "layers") of a
    position's params, whose "layers" is stacked or a per-layer list."""
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        node = layers[li]
        for k in path:
            node = node[k]
        return node
    for k in path:
        layers = layers[k]
    return layers[li]


def _layer_count(tree) -> int:
    """How many layers a position's params hold."""
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        return len(layers)
    return layers["attn"]["wq"].shape[0]


class _ParamPlan:
    """How each position's params in the compute layout
    (``compute_rules``) come from the slices the table stores: per leaf
    (dotted name) the spec the table stores it under and the spec the
    model computes it under, and per (leaf, position, layer) the
    ``parallel.sharding.reshard_plan`` that builds the compute tensor,
    made once. A compute tensor that is the position's own stored slice
    is that tensor: under ``LogicalAxisRules.default()`` this gathers the
    embed dim across the fsdp positions, as the sharded model always has;
    under a table that stores a dim finer or coarser than the compute
    layout wants, it gathers or slices that dim too, and the gradient goes
    back to the stored slices. Over several processes a block is read
    from a position of the reader's own rank where one holds it
    (``sharding.prefer_rank``), else from the rank that ``reshard_plan``
    names, through ``_Layout.fetch``'s exchange; plans can be made for
    any rank's positions (every rank's positions' slices have one
    shape)."""

    def __init__(self, mesh, rules: LogicalAxisRules):
        axes = param_logical_axes(None)
        self.mesh = mesh
        self.stored = _flat(tree_specs(axes, mesh, rules), lambda sp: sp)
        self.vocab_split = (mesh.shape["tp"] > 1 and "tp" in _dim_axes(
            rules.spec(("vocab",), mesh), 0))
        self.compute = _flat(tree_specs(axes, mesh,
                                        compute_rules(self.vocab_split)),
                             lambda sp: sp)
        self._plans: Dict[tuple, tuple] = {}
        self._keys: Dict[str, list] = {}

    def _full(self, spec, shape) -> Tuple[int, ...]:
        sizes = self.mesh.shape
        return tuple(n * math.prod(sizes[a] for a in _dim_axes(spec, d))
                     for d, n in enumerate(shape))

    def _stacked_shape(self, own, name: str) -> Tuple[int, ...]:
        """The shape of a position's stored tensor of ``name`` (a layer
        leaf's stacked over the layers the position holds)."""
        if not name.startswith("layers."):
            return tuple(own[name].shape)
        leaf = _layer_leaf(own, name.split(".")[1:], 0)
        return (_layer_count(own),) + tuple(leaf.shape)

    def slice_keys(self, own, name: str) -> list:
        """Per position, the slice of the whole stored tensor of ``name``
        that it holds (positions with equal keys hold equal slices)."""
        if name not in self._keys:
            stored = self.stored[name]
            full = self._full(stored, self._stacked_shape(own, name))
            self._keys[name] = [
                tuple((s.start, s.stop) for s in
                      shard_slices(stored, full, self.mesh, c))
                for c in self.mesh.coords()]
        return self._keys[name]

    def _make(self, own, name: str, p: int, li):
        """(reshard plan, the stored layer index, the compute shape of
        the position's leaf: stacked, L/pp layers, for a layer leaf)."""
        mesh, sizes = self.mesh, self.mesh.shape
        stored, compute = self.stored[name], self.compute[name]
        coord = mesh.coords()[p]
        if li is None:
            full = self._full(stored, own[name].shape)
            region = shard_slices(compute, full, mesh, coord)
            plan, local = reshard_plan(stored, full, mesh, region,
                                       coord), None
            shape = tuple(r.stop - r.start for r in region)
        else:
            path = name.split(".")[1:]
            n_own = _layer_count(own)
            layer_spec = PartitionSpec(*stored[1:])
            full = self._full(layer_spec, _layer_leaf(own, path, 0).shape)
            L = n_own * math.prod(sizes[a] for a in _dim_axes(stored, 0))
            stage = shard_slices(compute, (L,), mesh, coord)[0]
            k, local = divmod(stage.start + li, n_own)
            near = dict(zip(sizes, coord))
            for a in reversed(_dim_axes(stored, 0)):
                near[a], k = k % sizes[a], k // sizes[a]
            region = shard_slices(PartitionSpec(*compute[1:]), full, mesh,
                                  coord)
            plan = reshard_plan(layer_spec, full, mesh, region,
                                tuple(near.values()))
            shape = ((stage.stop - stage.start,)
                     + tuple(r.stop - r.start for r in region))
        if mesh.world > 1:
            plan = prefer_rank(plan, self.slice_keys(own, name), mesh,
                               mesh.process_index(p))
        return plan, local, shape

    def _get(self, trees, name: str, p: int, li):
        key = (name, p, li)
        if key not in self._plans:
            own = trees[p] if trees[p] is not None else next(
                t for t in trees if t is not None)
            self._plans[key] = self._make(own, name, p, li)
        return self._plans[key]

    def tensor(self, trees, name: str, p: int, li=None,
               got=None) -> torch.Tensor:
        """Position ``p``'s compute tensor of leaf ``name`` (of its compute
        stage's layer ``li`` for a layer leaf), on its device. ``got``:
        {leaf: (gathered runs, {position: its slot})}, ``_Layout.fetch``'s:
        a block whose holder is in the leaf's exchange, this rank's own
        among them, is read from the runs (whose reduce-scatter returns
        its gradient), any other from this rank's slices."""
        plan, local, _ = self._get(trees, name, p, li)
        dev = self.mesh.devices.flat[p]
        path = name.split(".")[1:]
        runs, slots = (got or {}).get(name, (None, {}))
        if runs is not None:
            whole = from_runs(plan, slots, runs)
            if whole is not None:
                return whole.to(dev)

        def get(i):
            if i in slots:
                return runs[slots[i]]
            return (trees[i][name] if li is None
                    else _layer_leaf(trees[i], path, local))
        return reshard(get, plan, dev)

    def params(self, trees, p: int, li, got=None):
        """Position ``p``'s compute params: the top-level tensors named in
        the tuple ``li``, or its compute stage's layer ``li``'s tree
        (``got`` as in ``tensor``)."""
        if isinstance(li, tuple):
            return {k: self.tensor(trees, k, p, None, got) for k in li}
        return _layer_tree(lambda name: self.tensor(trees, name, p, li,
                                                    got))

    def shape(self, trees, name: str, p: int) -> Tuple[int, ...]:
        """The compute shape of position ``p``'s leaf ``name``: of its
        stage's L/pp stacked layers for a layer leaf."""
        return self._get(trees, name, p,
                         0 if name.startswith("layers.") else None)[2]

    def holds_its_compute(self, trees, p: int) -> bool:
        """Whether position ``p``'s stored tensors are its compute tensors,
        each leaf whole, its layers its compute stage's."""
        for name in self.stored:
            if not name.startswith("layers."):
                if self._get(trees, name, p, None)[0][1] != [(p, None)]:
                    return False
                continue
            n = self.shape(trees, name, p)[0]
            if _layer_count(trees[p]) != n:
                return False
            for li in range(n):
                plan, local, _ = self._get(trees, name, p, li)
                if plan[1] != [(p, None)] or local != li:
                    return False
        return True


class _Stack:
    """A stacked layer leaf of a ``PositionView``: ``[lj]`` builds layer
    lj's tensor at use; ``shape``, ``dtype`` and ``device`` are the
    compute layout's."""

    def __init__(self, view: "PositionView", name: str):
        self._view, self._name = view, name
        self.shape = torch.Size(view._plan.shape(view._trees, name,
                                                 view._p))
        self.device = view.device
        self.dtype = _layer_leaf(view._trees[view._p],
                                 name.split(".")[1:], 0).dtype

    def __getitem__(self, lj: int) -> torch.Tensor:
        v = self._view
        return v._plan.tensor(v._trees, self._name, v._p, lj)


class PositionView(Mapping):
    """Position ``p``'s params in the compute layout, read at use from the
    per-position stored slices ``trees`` (``shard_params`` under any
    table): ``view["embed"]``, ``["ln_f"]`` and ``["lm_head"]`` are built
    when read, and ``view["layers"]`` is a tree of ``_Stack`` leaves,
    so ``layer_params(view, lj)`` builds one layer's tensors. A position
    whose stored slices are its compute tensors needs no view
    (``position_views``)."""

    def __init__(self, plan: _ParamPlan, trees, p: int):
        self._plan, self._trees, self._p = plan, trees, p
        self.device = plan.mesh.devices.flat[p]
        self._layers = _layer_tree(lambda name: _Stack(self, name))

    def __getitem__(self, key: str):
        if key == "layers":
            return self._layers
        if key not in ("embed", "ln_f", "lm_head"):
            raise KeyError(key)
        return self._plan.tensor(self._trees, key, self._p)

    def __iter__(self):
        return iter(("embed", "layers", "ln_f", "lm_head"))

    def __len__(self) -> int:
        return 4


def position_views(trees, mesh, rules: LogicalAxisRules) -> list:
    """Each position's params in the compute layout, in grid order: its
    stored tree (``tp_shards``' under ``rules``) where that is already its
    compute tree, else a ``PositionView`` that gathers and slices from
    every position's slices at use (over the fsdp positions under
    ``LogicalAxisRules.default()``, whose tp positions each hold a
    vocabulary slice). The engine's serving path on a mesh driven by one
    process."""
    plan = _ParamPlan(mesh, rules)
    return [tree if plan.holds_its_compute(trees, p)
            else PositionView(plan, trees, p)
            for p, tree in enumerate(trees)]


@dataclasses.dataclass
class _Event:
    """One exchange event of a round (``_Layout.event``): the leaves this
    rank gathers, in order, with the process group each is gathered over
    and the stored layer index its runs hold (None for a top-level leaf);
    per leaf the slot in the gathered runs of each other rank's position
    that this rank reads; every rank that takes part."""
    names: list
    groups: list
    layers: list
    slots: Dict[str, Dict[int, int]]
    members: set


class _Layout:
    """Where a sharded forward's pieces live, all indexed
    [stage][group][sequence shard]: the tp positions (flat mesh indices)
    of each pipeline stage's batch group's sp shard and their devices; the
    batch groups (``Mesh.batch_groups``) and the sequence shards
    (``Mesh.sequence_shards``) that ``rules`` give, the positions off them
    computing nothing; whether the vocabulary is split over tp; ``plan``
    (``_ParamPlan``), which builds each position's compute params from the
    stored slices.

    Over several processes (``devices`` None at other ranks' positions):
    per [stage][group][shard] the tp indices this rank holds (``local``)
    and the process group of the ranks that hold the shard's tp positions
    (``tp_groups``); per rank the batch groups where it holds a position
    (``rank_groups``, this rank's ``local_groups``). A step runs in
    ``rounds``: in round k every rank runs its k-th group, or none. Each
    time a round's stage reads a leaf (the embedding on stage 0, each
    layer, the head on the last stage: an event, ``event``), the blocks
    that a reader's plan takes from another rank come in one all-gather
    of each rank's run of its positions' slices over the smallest process
    group of ranks that covers the readers and the ranks they read from
    (``sharding.exchange``), whose backward reduce-scatters the gradient
    back. Every rank of that group takes part, in the same order, again
    in a checkpoint's recompute: a rank that reads nothing there (it
    holds no group in the round, as the fsdp > 0 ranks under ``("batch",
    "dp")``, or it runs no head) runs the events alone on a chain of its
    own (``_mock_stage``), so that its backward issues the matching
    reduce-scatters."""

    def __init__(self, mesh, rules: LogicalAxisRules):
        self.mesh, self.rules = mesh, rules
        self.plan = _ParamPlan(mesh, rules)
        self.vocab_split = self.plan.vocab_split
        self.batch_axes = mesh.batch_axes(rules)
        self.groups = mesh.batch_groups(rules)
        self.pp, self.sp = mesh.shape["pp"], mesh.sequence_shards(rules)
        stages, shards = range(self.pp), range(self.sp)
        self.positions = [[[mesh.group_positions(d, f, s, j) for j in shards]
                           for d, f in self.groups] for s in stages]
        self.devices = [[[[mesh.devices.flat[i] for i in pos] for pos in g]
                         for g in st] for st in self.positions]
        self.local = [[[[t for t, i in enumerate(pos) if mesh.is_local(i)]
                        for pos in g] for g in st] for st in self.positions]
        self.tp_groups = [[[mesh.axis_group(pos[0], "tp") for pos in g]
                           for g in st] for st in self.positions]
        rank_of = mesh.process_index
        self.rank_groups = [[g for g in range(len(self.groups))
                             if any(rank_of(i) == r for st in self.positions
                                    for pos in st[g] for i in pos)]
                            for r in range(mesh.world)]
        self.local_groups = self.rank_groups[mesh.rank]
        self.rounds = max(len(gs) for gs in self.rank_groups)
        self.home = mesh.devices.flat[mesh.local_positions()[0]]
        self._events: Dict[tuple, _Event] = {}
        self._mocks: Optional[bool] = None

    def group_rows(self, x: torch.Tensor, g: int) -> torch.Tensor:
        """Batch group ``g``'s rows of ``x`` (the whole batch's leading
        dim), on this rank's first position of the group."""
        n = len(self.groups)
        if x.shape[0] % n:
            raise ValueError(f"a dim of size {x.shape[0]} does not split "
                             f"over {' x '.join(self.batch_axes)}={n}")
        rows = x.shape[0] // n
        return x[g * rows:(g + 1) * rows].to(
            self.mesh.devices.flat[self.first_local(g)])

    def group_at(self, k: int) -> Optional[int]:
        """The batch group this rank runs in round ``k`` (None: none)."""
        return (self.local_groups[k] if k < len(self.local_groups)
                else None)

    def holds(self, s: int, g: int) -> bool:
        """Whether this rank holds a position of stage ``s``'s group
        ``g``."""
        return any(self.local[s][g])

    def _holds_at(self, r: int, k: int, s: int) -> bool:
        """Whether rank ``r`` runs stage ``s`` of a group in round ``k``."""
        gs = self.rank_groups[r]
        return k < len(gs) and any(self.mesh.process_index(i) == r
                                   for pos in self.positions[s][gs[k]]
                                   for i in pos)

    def first_local(self, g: int) -> int:
        """This rank's first position of group ``g`` (any stage)."""
        return next(pos[t] for st, loc in zip(self.positions, self.local)
                    for pos, ts in zip(st[g], loc[g]) for t in ts)

    def keys(self, s: int, n_layers: int) -> list:
        """Stage ``s``'s events in the order a microbatch meets them: the
        embedding on stage 0, its L/pp layers, the head on the last."""
        return ((["embed"] if s == 0 else []) + list(range(n_layers))
                + (["head"] if s == self.pp - 1 else []))

    def readers(self, r: int, k: int, s: int, key) -> list:
        """The positions of rank ``r`` that read the leaves of event
        ``key`` on stage ``s`` in round ``k``: every position it holds of
        its group's stage for a layer; per sequence shard, where the
        vocabulary is whole, the first it holds for the embedding and the
        first tp position for the head (``_group_embed``,
        ``_group_head``)."""
        gs = self.rank_groups[r]
        if k >= len(gs):
            return []
        out = []
        for pos in self.positions[s][gs[k]]:
            ts = [t for t, i in enumerate(pos)
                  if self.mesh.process_index(i) == r]
            if key == "embed" and not self.vocab_split:
                ts = ts[:1]
            elif key == "head" and not self.vocab_split:
                ts = [t for t in ts if t == 0]
            out += [pos[t] for t in ts]
        return out

    def event(self, trees, k: int, s: int, key) -> _Event:
        """Round ``k``'s event ``key`` (a layer index of stage ``s``,
        "embed" or "head") as this rank takes part in it, made once from
        every rank's readers' plans: per leaf, the ranks joined by a read
        from another rank, each such set widened to the fewest ranks that
        one of the mesh's process groups spans (``Mesh.covering``)."""
        ck = (k, s, key)
        if ck in self._events:
            return self._events[ck]
        mesh, world = self.mesh, self.mesh.world
        rank_of = mesh.process_index
        li = key if isinstance(key, int) else None
        names = ([n for n in self.plan.stored if n.startswith("layers.")]
                 if li is not None else
                 ["embed"] if key == "embed" else ["ln_f", "lm_head"])
        reads = ({r: self.readers(r, k, s, key) for r in range(world)}
                 if world > 1 else {})
        ev = _Event([], [], [], {}, set())
        for name in names:
            srcs, layer, joined = {}, None, []
            for r, ps in reads.items():
                for p in ps:
                    plan, layer, _ = self.plan._get(trees, name, p, li)
                    srcs[p] = [i for i, _ in plan[1]]
                    far = {rank_of(i) for i in srcs[p]} - {r}
                    if far:
                        joined.append({r} | far)
            covers: list = []
            for ranks in joined:
                ranks = set(mesh.covering(ranks))
                for c in [c for c in covers if c & ranks]:
                    covers.remove(c)
                    ranks = set(mesh.covering(ranks | c))
                covers.append(ranks)
            for cover in sorted(tuple(sorted(c)) for c in covers):
                ev.members.update(cover)
                if mesh.rank not in cover:
                    continue
                ev.names.append(name)
                ev.groups.append(mesh.group(cover))
                ev.layers.append(layer)
                ev.slots[name] = exchange_slots(
                    mesh, cover, [i for p in reads[mesh.rank]
                                  for i in srcs[p] if rank_of(i) in cover])
        self._events[ck] = ev
        return ev

    def fetch(self, trees, k: int, s: int, key):
        """(link, got) of this rank's exchanges at event ``key`` (see
        ``event``): its run of each leaf's slices gathered over the
        event's groups (``sharding.exchange``), got {leaf: (runs, {other
        rank's position: its slot})} for ``_ParamPlan.tensor``; (None,
        None) where this rank takes part in none."""
        if self.mesh.world == 1:
            return None, None
        ev = self.event(trees, k, s, key)
        if not ev.names:
            return None, None
        parts = []
        for name, layer in zip(ev.names, ev.layers):
            path = name.split(".")[1:]
            mine = [(trees[i][name] if layer is None
                     else _layer_leaf(trees[i], path, layer)).to(self.home)
                    for i in self.mesh.local_positions()]
            parts.append(mine[0][None] if len(mine) == 1
                         else torch.stack(mine))
        link, got = exchange(parts, ev.groups)
        return link, {name: (runs, ev.slots[name])
                      for name, runs in zip(ev.names, got)}

    def member(self, trees, k: int, s: int, n_layers: int) -> bool:
        """Whether this rank takes part in an event of stage ``s`` in
        round ``k``."""
        return self.mesh.world > 1 and any(
            self.mesh.rank in self.event(trees, k, s, key).members
            for key in self.keys(s, n_layers))

    def has_mocks(self, trees, n_layers: int) -> bool:
        """Whether some rank takes part in a stage's events in a round in
        which it runs no group on that stage (``_mock_stage``)."""
        if self._mocks is None:
            self._mocks = self.mesh.world > 1 and any(
                r in self.event(trees, k, s, key).members
                and not self._holds_at(r, k, s)
                for k in range(self.rounds) for s in range(self.pp)
                for key in self.keys(s, n_layers)
                for r in range(self.mesh.world))
        return self._mocks

    def owns(self, g: int, j: int) -> bool:
        """Whether this rank counts group ``g``'s shard ``j``'s loss: it
        holds the shard's first tp position on the last stage, where a
        single controller puts the loss."""
        return self.mesh.is_local(self.positions[-1][g][j][0])

    def sends(self, s: int, g: int, j: int):
        """(tp index, rank) of each hand-off of group ``g``'s shard ``j``
        from stage ``s`` that this rank sends to another rank: every rank
        of stage s + 1 takes one copy, from the position at its first tp
        index."""
        pos, nxt = self.positions[s][g][j], self.positions[s + 1][g][j]
        ranks = [self.mesh.process_index(i) for i in nxt]
        return [(t, r) for t, r in enumerate(ranks)
                if (t == 0 or ranks[t - 1] != r) and r != self.mesh.rank
                and self.mesh.is_local(pos[t])]

    def source(self, s: int, g: int, j: int) -> int:
        """The rank that hands this rank group ``g``'s shard ``j`` from
        stage ``s - 1`` (see ``sends``)."""
        return self.mesh.process_index(
            self.positions[s - 1][g][j][self.local[s][g][j][0]])


def _tied(xss, link) -> list:
    """``xss`` (a list of {device: tensor}) with ``link`` tied to its
    first tensor (``sharding.tie``)."""
    if link is None:
        return xss
    out = [dict(xs) for xs in xss]
    for xs in out:
        if xs:
            d = next(iter(xs))
            xs[d] = tie(xs[d], link)
            break
    return out


def _mock_layer(lay: _Layout, trees, k: int, s: int, key,
                x: torch.Tensor) -> torch.Tensor:
    """Event ``key`` of stage ``s`` in round ``k`` on a rank that reads
    nothing there, tied to its chain ``x``."""
    link, _ = lay.fetch(trees, k, s, key)
    return tie(x, link).clone()


def _mock_stage(lay: _Layout, trees, k: int, s: int, n_layers: int,
                remat: bool) -> torch.Tensor:
    """Stage ``s``'s events of round ``k`` on a rank that takes part in
    them but runs none of that stage's work: a 0-d chain through every
    event in a microbatch's order, each layer's checkpointed where the
    readers' are (so its recompute gathers again where theirs do), ending
    in a zero term (``_Zeroed``) whose backward issues the events'
    reduce-scatters in reverse order."""
    x = torch.zeros((), device=lay.home, requires_grad=(
        torch.is_grad_enabled()
        and any(t.requires_grad for t in _tensors(trees))))
    for key in lay.keys(s, n_layers):
        if remat and isinstance(key, int):
            x = checkpoint(_mock_layer, lay, trees, k, s, key, x,
                           use_reentrant=True, preserve_rng_state=False)
        else:
            x = _mock_layer(lay, trees, k, s, key, x)
    return _Zeroed.apply(x)


def _tensors(tree):
    """Every tensor of nested dicts and lists (None, another process's
    position, holds none)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for node in tree:
            yield from _tensors(node)
    elif tree is not None:
        yield tree


class _WorldSum(torch.autograd.Function):
    """A 0-d tensor summed over ``group``; the gradient passes to this
    rank's term unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def world_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the processes of ``mesh`` where it spans a formed
    world (each rank's share of the loss), else ``t``."""
    group = mesh.world_group()
    return t if group is None else _WorldSum.apply(t, group)


def _position_params(trees, lay: _Layout, s: int, g: int, j: int, t: int,
                     li, got=None):
    """Stage ``s``'s group ``g``'s sp shard ``j``'s tp position ``t``'s
    compute params, built from the stored slices (``_ParamPlan``; ``got``
    the event's exchanges, ``_Layout.fetch``): the top-level tensors named
    in the tuple ``li``, or the stage's layer ``li``'s (an index into the
    stage's own L/pp layers)."""
    return lay.plan.params(trees, lay.positions[s][g][j][t], li, got)


def _sp_attention(cfg: TransformerConfig, lay: _Layout, s: int, g: int,
                  qkv) -> list:
    """Stage ``s``'s group ``g``'s attention over its sequence shards:
    ``qkv[j]`` maps each tp index this rank holds at shard j to (q, k, v),
    (B, S_j, H, D) on its position's device; returns ``out[j][t]``, the
    output of the same shape, likewise. Each tp index runs over its sp
    positions: under ``attention_impl="ring"`` the ring
    (``ops.ring_attention``), otherwise the sequence attended whole on
    the first shard's position and split back, GSPMD's gather around the
    reference's attention (under "flash" the kernel). One shard: the
    attention itself.

    Where the sp positions span ranks (this rank holds a run of the
    shards at each of its tp indices), the ring rotates between ranks by
    P2P, the heads of this rank's tp indices side by side in one ring
    (each head's merges are its own); the gathered sequence is joined on
    the first shard's rank (``seq_gather``), attended there and split
    back (``seq_scatter``), one exchange for all of this rank's tp
    indices."""
    sp, mesh = lay.sp, lay.mesh
    out = [{} for _ in range(sp)]
    ts = sorted({t for per in qkv for t in per})
    if sp == 1:
        for t, (q, k, v) in qkv[0].items():
            out[0][t] = _attention(cfg, q, k, v)
        return out
    scale = 1.0 / math.sqrt(cfg.head_dim_)
    line = mesh.sp_positions(*lay.groups[g], tp=ts[0], stage=s)
    ranks = mesh.ranks(line)
    if len(ranks) == 1:
        for t in ts:
            devices = [lay.devices[s][g][j][t] for j in range(sp)]
            qs, ks, vs = zip(*(qkv[j][t] for j in range(sp)))
            if cfg.attention_impl == "ring":
                outs = _ring_shards(qs, ks, vs, devices, causal=True,
                                    scale=scale)
            else:
                home = devices[0]
                o = _attention(cfg, *(torch.cat([x.to(home) for x in xs],
                                                dim=1)
                                      for xs in (qs, ks, vs)))
                cuts = np.cumsum([0] + [q.shape[1] for q in qs])
                outs = [o[:, a:b].to(d) for a, b, d in
                        zip(cuts[:-1], cuts[1:], devices)]
            for j, o in enumerate(outs):
                out[j][t] = o
        return out
    js = [j for j in range(sp) if qkv[j]]
    if cfg.attention_impl == "ring":
        qs, ks, vs = ([torch.cat([qkv[j][t][x] for t in ts], dim=2)
                       for j in js] for x in range(3))
        outs = _ring_shards(
            qs, ks, vs, [q.device for q in qs], causal=True, scale=scale,
            n=sp, first=js[0],
            rotate=ring_shift(mesh.process_index(line[js[0] - 1]),
                              mesh.process_index(line[(js[-1] + 1) % sp])))
        heads = [qkv[js[0]][t][0].shape[2] for t in ts]
        for j, o in zip(js, outs):
            for t, piece in zip(ts, o.split(heads, dim=2)):
                out[j][t] = piece
        return out
    runs = [torch.cat([qkv[j][t][x] for j in js], dim=1)
            for t in ts for x in range(3)]
    whole = seq_gather(runs, ranks)
    if mesh.rank == ranks[0]:
        whole = [_attention(cfg, *whole[3 * a:3 * a + 3])
                 for a in range(len(ts))]
    lens = [qkv[j][ts[0]][0].shape[1] for j in js]
    for t, o in zip(ts, seq_scatter(whole, runs[0::3], ranks)):
        for j, piece in zip(js, o.split(lens, dim=1)):
            out[j][t] = piece
    return out


def _group_layer(cfg: TransformerConfig, xss, trees, lay: _Layout, k: int,
                 s: int, g: int, li: int, ropes):
    """Stage ``s``'s layer ``li`` over group ``g``'s positions that this
    rank holds in round ``k``: the layer's event (``_Layout.fetch``, the
    blocks other ranks hold), each position's weights built from the
    stored slices, then ``sp_layer`` (its all-reduces over the tp group's
    ranks), whose attention runs per tp position over the sp shards
    (``_sp_attention``)."""
    link, got = lay.fetch(trees, k, s, li)
    xss = _tied(xss, link)
    local = lay.local[s][g]
    devss = [[lay.devices[s][g][j][t] for t in ts]
             for j, ts in enumerate(local)]
    lpss = [[_position_params(trees, lay, s, g, j, t, li, got) for t in ts]
            for j, ts in enumerate(local)]

    def attend(hs):
        qkv = [{} for _ in local]
        for j, ts in enumerate(local):
            for t, lp, d in zip(ts, lpss[j], devss[j]):
                cos, sin = ropes[j][d]
                q, k, v = _layer_qkv(lp, hs[j][d], cfg)
                qkv[j][t] = (apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                             v)
        out = _sp_attention(cfg, lay, s, g, qkv)
        return [[out[j][t] for t in ts] for j, ts in enumerate(local)]
    return sp_layer(cfg, xss, lpss, devss, attend, lay.tp_groups[s][g])


def vocab_embed(tables, devices, tokens, dt, slots=None, group=None
                ) -> Dict[torch.device, torch.Tensor]:
    """The embedding of ``tokens`` in ``dt`` on each distinct device of
    ``devices``: ``tables[i]`` on ``devices[i]`` is either one whole table
    (``slots`` None: the first is read) or a vocabulary slice, slot
    ``slots[i]`` of equal slices. Each slice's rows are looked up, the
    tokens of other slices reading zeros, and the parts summed by
    ``all_reduce`` (over the ranks of ``group`` too): the sum is the
    lookup (JAX's one-hot matmul), exactly."""
    if slots is None:
        table = tables[0]
        return on_each(table.to(dt)[tokens.to(table.device)], devices)
    parts = []
    for slot, table, d in zip(slots, tables, devices):
        n_v = table.shape[0]
        local = tokens.to(d) - slot * n_v
        inside = (local >= 0) & (local < n_v)
        row = table.to(dt)[local.clamp(0, n_v - 1)]
        parts.append(torch.where(inside[..., None], row,
                                 torch.zeros((), dtype=dt, device=d)))
    x = all_reduce(parts, devices[:len(parts)], group)[devices[0]]
    return on_each(x, devices)


def embed_tokens(ps, devices, tokens, cfg: TransformerConfig
                 ) -> Dict[torch.device, torch.Tensor]:
    """``vocab_embed`` for the engine: ``ps[i]`` the params of the tp
    position on ``devices[i]`` of the first stage, in tp order, whose
    tables hold the whole vocabulary or its tp slices."""
    first = ps[0]["embed"]
    if first.shape[0] == cfg.vocab_size:
        return vocab_embed([first], devices, tokens, cfg.dtype)
    tables = [first] + [p["embed"] for p in ps[1:]]
    return vocab_embed(tables, devices, tokens, cfg.dtype,
                       list(range(len(ps))))


def head_logits(ps, devices, xs, at, cfg: TransformerConfig
                ) -> torch.Tensor:
    """The final norm and lm_head at index ``at`` of the hidden state
    ``xs`` {device: x}, f32 over the whole vocabulary on ``devices[0]``:
    ``ps[i]`` the params of the last stage's tp position on
    ``devices[i]``, in tp order, whose heads hold the whole vocabulary
    (the first's is read) or its tp slices (each slice's logits on its
    device, joined in order)."""
    first = ps[0]["lm_head"]
    heads = ([first] if first.shape[1] == cfg.vocab_size
             else [first] + [p["lm_head"] for p in ps[1:]])
    out = []
    for p, head, d in zip(ps, heads, devices):
        x = rms_norm(xs[d], p["ln_f"], cfg.rms_norm_eps)
        out.append((x[at] @ head.to(cfg.dtype)).float().to(devices[0]))
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def _group_embed(trees, lay: _Layout, g: int, j: int, tokens,
                 cfg: TransformerConfig, got=None):
    """Group ``g``'s sp shard ``j``'s embedding on stage 0: {device: (B,
    S_j, E)} on each distinct device of this rank's tp positions. The
    table is looked up per vocabulary slice and summed where the
    vocabulary is split (over the tp group's ranks where it spans
    several); else each rank looks up its first position's copy of the
    table. ``got``: the embedding event's exchanges."""
    ts = lay.local[0][g][j]
    devices = [lay.devices[0][g][j][t] for t in ts]
    use = ts if lay.vocab_split else ts[:1]
    tables = [_position_params(trees, lay, 0, g, j, t, ("embed",),
                               got)["embed"] for t in use]
    if not lay.vocab_split:
        return vocab_embed(tables, devices, tokens, cfg.dtype)
    return vocab_embed(tables, devices, tokens, cfg.dtype, use,
                       lay.tp_groups[0][g][j])


def _stage_layers(cfg: TransformerConfig, xss, trees, lay: _Layout, k: int,
                  s: int, g: int, ropes):
    """Stage ``s``'s L/pp layers over group ``g``'s positions in round
    ``k``, each checkpointed when a gradient is needed (its event, and so
    its exchanges, again in the recompute).

    The checkpoint is the reentrant one: a layer's positions may lie on
    several devices (the ring's sp positions, tp positions), and autograd
    runs each device's part of the backward on that device's thread; the
    non-reentrant checkpoint's unpack hook recomputes the layer on the
    first thread to need a saved tensor and holds no lock, so two devices'
    threads can both recompute it (torch then raises that a different
    number of tensors was saved). The reentrant one recomputes in its own
    backward, on one thread. It tracks top-level tensor arguments only, so
    the layer's inputs go in flat, in ``xss``' order; the params' gradients
    reach their leaves through its inner backward, which runs only where
    an input requires grad: inputs that do not (a frozen embedding) go in
    as leaves that do."""
    remat = (cfg.remat and torch.is_grad_enabled()
             and any(t.requires_grad for t in _tensors(trees)))
    keys = [list(xs) for xs in xss]

    def layer(li, *flat):
        it = iter(flat)
        out = _group_layer(cfg, [{d: next(it) for d in ds} for ds in keys],
                           trees, lay, k, s, g, li, ropes)
        return tuple(o[d] for o, ds in zip(out, keys) for d in ds)
    for li in range(cfg.num_layers // lay.pp):
        if remat:
            flat = [xs[d] for xs, k in zip(xss, keys) for d in k]
            if not any(t.requires_grad for t in flat):
                flat = [t.detach().requires_grad_() for t in flat]
            flat = checkpoint(layer, li, *flat, use_reentrant=True,
                              preserve_rng_state=False)
            it = iter(flat)
            xss = [{d: next(it) for d in k} for k in keys]
        else:
            xss = _group_layer(cfg, xss, trees, lay, k, s, g, li, ropes)
    return xss


def _group_head(trees, lay: _Layout, g: int, j: int, xs,
                cfg: TransformerConfig, got=None):
    """Group ``g``'s sp shard ``j``'s logits on the last stage, split over
    the vocabulary: [(logits (B, S_j, V/tp) f32 on its position's device,
    the slice's first id)], one per tp position this rank holds where the
    vocabulary is split, else one on the first tp position. A rank that
    holds the shard but not that position (the vocabulary unsplit, tp
    across ranks) runs no head: it gets a zero 0-d term on its hidden
    state (``_Zeroed``), whose backward runs the layers' collectives that
    pair with the owner's. ``got``: the head event's exchanges."""
    s = lay.pp - 1
    ts = lay.local[s][g][j]
    if not (lay.vocab_split or 0 in ts):
        return _Zeroed.apply(xs[lay.devices[s][g][j][ts[0]]].sum().float())
    out = []
    for t in (ts if lay.vocab_split else [0]):
        p = _position_params(trees, lay, s, g, j, t, ("ln_f", "lm_head"),
                             got)
        x = rms_norm(xs[lay.devices[s][g][j][t]], p["ln_f"], cfg.rms_norm_eps)
        out.append((torch.einsum("bse,ev->bsv", x,
                                 p["lm_head"].to(cfg.dtype)).float(),
                    t * p["lm_head"].shape[1]))
    return out


def _seq_shards(x, sp: int) -> list:
    """x (B, S, ...) as sp sequence shards (views)."""
    S = x.shape[1]
    if S % sp:
        raise ValueError(f"sequence length {S} does not split over "
                         f"{sp} sp shards")
    return list(x.split(S // sp, dim=1))


def _group_logits(trees, lay: _Layout, k: int, tokens,
                  cfg: TransformerConfig, num_microbatches=None):
    """Round ``k`` on this rank: (out, hand, mocks). ``out[m][j]`` is
    ``_group_head``'s vocabulary slices of microbatch m (one where there
    is no pp axis) and sequence shard j (one where there is no sp axis)
    of the round's group (``_Layout.group_at``) or its zero term, [] for
    a shard this rank holds no position of, and ``out[m]`` None on a rank
    without the last stage; ``hand`` the hand-offs across ranks;
    ``mocks[m]`` the zero term of microbatch m's stages whose events this
    rank takes part in without running them (``_mock_stage``; None where
    there is none).
    ``tokens`` (B_g, S) are the group's rows (None where this rank runs
    no group in the round); shard j takes tokens [j S/sp, (j+1) S/sp) and
    RoPE at those positions. Under pp the group's rows are split into
    ``num_microbatches`` (default pp) that run the GPipe schedule
    (``pipeline.gpipe_ticks``), launched tick by tick, every rank in the
    same order, each rank its own stages; each shard of a stage's output
    goes to the next stage's devices by ``stage_send``, or to the next
    stage's ranks by ``Handoffs``. ``hand`` is None where this rank
    holds every stage, unless some rank runs a stage's events alone
    (``_Layout.has_mocks``) under several microbatches: every rank's
    backward then runs microbatch by microbatch in reverse order
    (``Handoffs.loss``), so that the events' reduce-scatters meet in one
    order."""
    g = lay.group_at(k)
    pp, sp = lay.pp, lay.sp
    mb = (num_microbatches or pp) if pp > 1 else 1
    if pp > 1:
        if cfg.num_layers % pp:
            raise ValueError(f"{cfg.num_layers} layers not divisible by "
                             f"pp={pp}")
        if tokens is not None:
            check_microbatches(tokens.shape[0], mb, pp)
    n_layers = cfg.num_layers // pp
    held = [g is not None and lay.holds(s, g) for s in range(pp)]
    alone = [not held[s] and lay.member(trees, k, s, n_layers)
             for s in range(pp)]
    remat = (cfg.remat and torch.is_grad_enabled()
             and any(t.requires_grad for t in _tensors(trees)))
    out, mocks = [None] * mb, [None] * mb
    hand = (None if all(held) and not (mb > 1
                                       and lay.has_mocks(trees, n_layers))
            else Handoffs(mb))
    if g is not None:
        Sl = tokens.shape[1] // sp
        shards = _seq_shards(tokens, sp)
        ropes = [{d: rope_angles(Sl, cfg.head_dim_, cfg.rope_theta,
                                 offset=j * Sl, device=d)
                  for d in dict.fromkeys(d for st in lay.devices
                                         for d in st[g][j] if d is not None)}
                 for j in range(sp)]
        rows = tokens.shape[0] // mb
        xs = [[t[m * rows:(m + 1) * rows] for t in shards]
              for m in range(mb)]
    for _, s, m in gpipe_ticks(mb, pp):
        if alone[s]:
            z = _mock_stage(lay, trees, k, s, n_layers, remat)
            mocks[m] = z if mocks[m] is None else mocks[m] + z
        if not held[s]:
            continue
        devss = [[lay.devices[s][g][j][t] for t in ts]
                 for j, ts in enumerate(lay.local[s][g])]
        if s == 0:
            link, got = lay.fetch(trees, k, 0, "embed")
            x = _tied([_group_embed(trees, lay, g, j, t, cfg, got)
                       if devss[j] else {} for j, t in enumerate(xs[m])],
                      link)
        elif held[s - 1]:
            x = [stage_send(x[lay.devices[s - 1][g][j][0]], devss[j])
                 for j, x in enumerate(xs[m])]
        else:
            x = []
            for j, tok in enumerate(xs[m]):
                if not devss[j]:
                    x.append({})
                    continue
                x.append(on_each(hand.recv(
                    m, tok.shape + (cfg.hidden_size,), cfg.dtype,
                    devss[j][0], lay.source(s, g, j)), devss[j]))
        xs[m] = _stage_layers(cfg, x, trees, lay, k, s, g, ropes)
        if s == pp - 1:
            link, got = lay.fetch(trees, k, s, "head")
            out[m] = [_group_head(trees, lay, g, j, x, cfg, got) if x else []
                      for j, x in enumerate(_tied(xs[m], link))]
            xs[m] = None
        elif not held[s + 1]:
            for j, x in enumerate(xs[m]):
                for t, dst in lay.sends(s, g, j):
                    hand.send(m, x[lay.devices[s][g][j][t]], dst)
            xs[m] = None
    return out, hand, mocks


def vocab_parallel_nll(logits, targets, group=None) -> torch.Tensor:
    """-log softmax(logits)[target] per token, (B, S) f32 on the first
    slice's device, from logits split over the vocabulary: ``logits`` is
    [(slice (B, S, V_i) f32, its first id)] in order. The max and the sum
    of exponentials are taken slice by slice and combined in f32 in slice
    order; the target's logit comes from the slice that holds it. No
    device holds (B, S, V).

    ``group``: ``logits`` are this rank's slices, and the ranks of
    ``group`` hold the others; the max (without a gradient), the sum of
    exponentials and the target's logit are then all-reduced over it (the
    last two in one ``_AllReduce``), and every rank of the group gets the
    same values."""
    home = logits[0][0].device
    m = None
    for lg, _ in logits:
        mx = lg.detach().amax(dim=-1).to(home)
        m = mx if m is None else torch.maximum(m, mx)
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    total, picked = None, None
    for lg, first in logits:
        d = lg.device
        e = (lg - m.to(d)[..., None]).exp().sum(dim=-1).to(home)
        local = targets.to(d) - first
        inside = (local >= 0) & (local < lg.shape[-1])
        tl = lg.gather(-1, local.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        tl = torch.where(inside, tl, torch.zeros((), device=d)).to(home)
        total = e if total is None else total + e
        picked = tl if picked is None else picked + tl
    if group is not None:
        total, picked = _AllReduce.apply(torch.stack([total, picked]),
                                         group).unbind(0)
    return m + total.log() - picked


class _Zeroed(torch.autograd.Function):
    """A zero in place of a loss term that another rank of its tp group
    counts (or of the head that it runs, ``_group_head``); the backward
    gives the term a zero gradient, so this rank still runs the
    backward's collectives that pair with the owner's."""

    @staticmethod
    def forward(ctx, t):
        return torch.zeros_like(t)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


# Per mesh, its layouts by table and stored shapes: a layout's plans and
# events are made once, not at every step.
_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _sharded(params, mesh, rules):
    """(per-position params, layout) for the sharded model; the layout is
    made once per mesh, table and stored shapes."""
    rules = mesh_rules(mesh, rules)
    trees = (params if isinstance(params, (list, tuple))
             else shard_params(params, mesh, rules))
    if len(trees) != mesh.devices.size:
        raise ValueError(f"{len(trees)} position trees for a mesh of "
                         f"{mesh.devices.size} positions")
    like = next(t for t in trees if t is not None)
    key = (tuple(rules.rules), _layer_count(like),
           tuple(tuple(like[k].shape) for k in ("embed", "ln_f", "lm_head")),
           tuple(_flat(_layer_tree(lambda name: tuple(_layer_leaf(
               like, name.split(".")[1:], 0).shape)), lambda v: v).items()))
    layouts = _LAYOUTS.setdefault(mesh, {})
    if key not in layouts:
        layouts[key] = _Layout(mesh, rules)
    return trees, layouts[key]


def _splits(mesh, params) -> bool:
    """Whether ``forward``/``loss_fn`` take the sharded path: a mesh that
    splits pp, dp, fsdp or tp (beside sp or not; sp alone keeps the ring
    path), or per-position params."""
    if mesh is None:
        return False
    axes = mesh.train_axes()
    return (isinstance(params, (list, tuple))
            or bool(set(axes) & {"pp", "dp", "fsdp", "tp"}))


def mesh_group_losses(params, batch: Dict[str, Any], cfg: TransformerConfig,
                      mesh, rules: Optional[LogicalAxisRules] = None,
                      device: Union[str, torch.device] = "cuda",
                      num_microbatches: Optional[int] = None):
    """Each batch group's share of ``loss_fn``, in group order, as it is
    computed (a generator): its weighted token loss over the global
    weight sum, which is taken from the targets first, a 0-d f32 tensor
    on the group's first device of the last stage (under pp, the sum of
    its microbatches' shares, in microbatch order). ``loss_fn`` sums
    them; the train step runs each one's backward before the next group's
    forward, so that one group's activations (all of its microbatches')
    are alive at a time. Over several processes, one share per round
    (``_Layout.rounds``) in which this rank runs a group or takes part in
    another's exchanges (``batch`` is the whole batch on every rank),
    each its share of the group's loss: a loss term counts on the rank of
    its shard's first tp position on the last stage, and is a zero that
    keeps its graph on the tp group's other ranks (``_Zeroed``: of the
    loss where the vocabulary is split, else of the hidden state), and on
    a rank that only takes part in exchanges, the zero term of its
    events' chain (``_mock_stage``); under stages across ranks the share
    is ``Handoffs.loss``'s (0 on a rank without the last stage), whose
    backward runs the schedule's."""
    trees, lay = _sharded(params, mesh, rules)
    dev = resolve_device(device)
    if "targets" in batch:
        inputs = torch.as_tensor(batch["inputs"], device=dev).long()
        targets = torch.as_tensor(batch["targets"], device=dev).long()
        weights = (targets != 0).float()
    else:
        toks = torch.as_tensor(batch["tokens"], device=dev).long()
        inputs, targets = toks[:, :-1], toks[:, 1:]
        weights = torch.ones(targets.shape, dtype=torch.float32, device=dev)
    denom = weights.sum().clamp(min=1.0)
    whole = {"inputs": inputs, "targets": targets, "weights": weights}
    for k in range(lay.rounds):
        g = lay.group_at(k)
        b = (None if g is None
             else {n: lay.group_rows(v, g) for n, v in whole.items()})
        logits, hand, mocks = _group_logits(
            trees, lay, k, None if b is None else b["inputs"], cfg,
            num_microbatches)
        if b is None and all(z is None for z in mocks):
            continue
        terms = []
        for m, per_shard in enumerate(logits):
            term = mocks[m]
            for j, lg in enumerate(per_shard or ()):
                if torch.is_tensor(lg):
                    term = lg if term is None else term + lg.to(term.device)
                    continue
                if not lg:
                    continue
                rows = b["targets"].shape[0] // len(logits)
                r = slice(m * rows, (m + 1) * rows)
                group = (lay.tp_groups[-1][g][j] if lay.vocab_split
                         else None)
                nll = vocab_parallel_nll(
                    lg, _seq_shards(b["targets"][r], lay.sp)[j], group)
                home = nll.device
                w = _seq_shards(b["weights"][r], lay.sp)[j].to(home)
                part = (nll * w).sum() / denom.to(home)
                if not lay.owns(g, j):
                    part = _Zeroed.apply(part)
                term = part if term is None else term + part.to(term.device)
            terms.append(term)
        if hand is not None:
            yield hand.loss(terms, dev)
            continue
        total = terms[0]
        for term in terms[1:]:
            total = total + term.to(total.device)
        yield total


def _mesh_forward(params, tokens, cfg: TransformerConfig, mesh, rules, dev,
                  num_microbatches=None):
    """The sharded forward's logits (B, S, V) on ``dev``: each piece
    written where a single controller would take it (a vocabulary slice
    from its position; unsplit, from the first tp position), and over
    several processes summed over the world, each piece held by one
    rank (every rank runs every round, ``mesh_group_losses``)."""
    trees, lay = _sharded(params, mesh, rules)
    B, S = tokens.shape
    out = torch.zeros((B, S, cfg.vocab_size), dtype=torch.float32,
                      device=dev)
    Bg, Sl = B // len(lay.groups), S // lay.sp
    for k in range(lay.rounds):
        g = lay.group_at(k)
        logits, _, _ = _group_logits(
            trees, lay, k, None if g is None else lay.group_rows(tokens, g),
            cfg, num_microbatches)
        if g is None:
            continue
        rows = Bg // len(logits)
        for m, per_shard in enumerate(logits):
            r = slice(g * Bg + m * rows, g * Bg + (m + 1) * rows)
            for j, lg in enumerate(per_shard or ()):
                for x, first in ([] if torch.is_tensor(lg) else lg):
                    out[r, j * Sl:(j + 1) * Sl,
                        first:first + x.shape[-1]] = x.to(dev)
    if mesh.world > 1:
        out = out.detach()
        dist.all_reduce(out, group=mesh.world_group())
    return out


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            device: Union[str, torch.device] = "cuda",
            rules: Optional[LogicalAxisRules] = None,
            num_microbatches: Optional[int] = None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32 on ``device``, where
    the params must already live. ``mesh``: an sp-only mesh for
    ``attention_impl="ring"``, or a mesh that splits pp, dp, fsdp or tp,
    over whose positions the params are split by ``rules`` (see the module
    docstring); the logits are then joined on ``device``.
    ``num_microbatches`` sets the pipeline's depth under a pp axis
    (default pp) and is ignored without one, as in the JAX package. Over
    several processes every rank calls it and gets every row's logits
    (not differentiable across ranks)."""
    dev = resolve_device(device)
    where = (next(t for t in params if t is not None)
             if isinstance(params, (list, tuple)) else params)["embed"].device
    if where.type != dev.type:
        raise ValueError(f"params are on {where}, forward was asked for "
                         f"{dev}")
    tokens = torch.as_tensor(tokens, device=dev).long()
    if _splits(mesh, params):
        return _mesh_forward(params, tokens, cfg, mesh, rules, dev,
                             num_microbatches)
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens]
    S = tokens.shape[1]
    cos, sin = rope_angles(S, cfg.head_dim_, cfg.rope_theta, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        if remat:
            x = checkpoint(_layer, cfg, x, lp, cos, sin, mesh,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(cfg, x, lp, cos, sin, mesh)
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    # JAX asks XLA for f32 output (preferred_element_type=f32) of the bf16
    # product; here the bf16 matmul accumulates in f32 and rounds its
    # output to bf16 before the cast, a difference within bf16 tolerance.
    return torch.einsum("bse,ev->bsv", x, params["lm_head"].to(dt)).float()


def loss_fn(params, batch: Dict[str, Any], cfg: TransformerConfig, mesh=None,
            device: Union[str, torch.device] = "cuda",
            rules: Optional[LogicalAxisRules] = None,
            num_microbatches: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy, a 0-d f32 tensor; batch = {"tokens": (B,S)}
    or {"inputs","targets"}; ignores padding id 0 when targets provided.
    ``mesh``, ``rules`` and ``num_microbatches`` as in ``forward``; under a
    mesh that splits pp, dp, fsdp or tp the loss is the sum of
    ``mesh_group_losses``, on ``device`` (over several processes, summed
    over the ranks; its gradient reaches this rank's params only, the
    replicas' sum being the train step's; under stages across ranks its
    ``backward()`` runs the pipeline's nested backward, which fills the
    params' ``.grad`` and gives ``torch.autograd.grad`` nothing)."""
    dev = resolve_device(device)
    if _splits(mesh, params):
        total = None
        for part in mesh_group_losses(params, batch, cfg, mesh, rules, dev,
                                      num_microbatches):
            total = part.to(dev) if total is None else total + part.to(dev)
        if total is None:
            total = torch.zeros((), device=dev)
        return world_sum(total, mesh)
    if "targets" in batch:
        inputs = torch.as_tensor(batch["inputs"], device=dev).long()
        targets = torch.as_tensor(batch["targets"], device=dev).long()
        weights = (targets != 0).float()
    else:
        toks = torch.as_tensor(batch["tokens"], device=dev).long()
        inputs, targets = toks[:, :-1], toks[:, 1:]
        weights = torch.ones(targets.shape, dtype=torch.float32, device=dev)
    logits = forward(params, inputs, cfg, mesh, device=dev)
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    return -(ll * weights).sum() / weights.sum().clamp(min=1.0)
