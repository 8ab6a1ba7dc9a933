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
tensor); no other caller should grow a third form.

``forward`` and ``loss_fn`` take a ``mesh`` (``parallel.mesh.Mesh``):

- sp alone: with ``attention_impl="ring"`` each layer's attention runs
  ``ops.ring_attention.ring_attention`` over it, and every other op runs on
  ``device``, whose values the reference's sharding constraints do not
  change.
- any of dp, fsdp and tp, beside sp or not (training's layouts, and
  tensor-parallel ``forward``): the params are split over the mesh's
  positions by ``rules`` (``LogicalAxisRules.default()``: batch over dp x
  fsdp, embed over fsdp, heads, kv heads, MLP and vocabulary over tp, no
  param over sp; or ``megatron_rules()``; any other table raises
  NotImplementedError), and ``params`` may be the full tree or the
  per-position list that ``parallel.sharding.shard_params`` returns under
  the same rules. The batch groups (one per (dp, fsdp) pair) run in turn.
  A group's sequence is split over its sp positions, shard j holding
  tokens [j S/sp, (j+1) S/sp) (the reference's ``seq`` constraint): each
  shard's tp positions gather their tp slice of a layer's weights across
  the fsdp positions (``fsdp_gather``) and the layer runs as
  ``sp_layer``, ``tp_layer`` per shard. Attention is the one step that
  crosses shards: per tp position, under ``attention_impl="ring"`` the
  ring over its sp positions at its heads, under "xla" and "flash" the
  sequence gathered on its first sp position, attended whole and split
  back (GSPMD's gather around the reference's attention; "flash" runs
  the kernel there). The embedding is looked up per vocabulary slice and
  summed (``all_reduce``), the logits stay split over tp, and the
  cross-entropy reads them slice by slice (``vocab_parallel_nll``). The
  values are those of the unsharded model.
- pp beside any of those (pipeline stages): the default rules split the
  layer stack over pp, so stage s's positions hold layers [s L/pp,
  (s+1) L/pp), and each stage is a dp x fsdp x sp x tp layout of its own.
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
  dp and fsdp across ranks): every rank is given the whole batch and
  runs only its own batch groups. A weight's fsdp slices held by other
  ranks come through ``fsdp_gather``'s all-gather over the process group
  of the ranks that hold them, whose backward reduce-scatters the
  gradient back; the loss is summed over the world (``world_sum``), and
  ``forward`` all-gathers the logits' rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.flash_attention import flash_attention, reference_attention
from ..ops.ring_attention import _ring_shards, ring_attention
from ..parallel.pipeline import check_microbatches, gpipe_ticks, stage_send
from ..parallel.sharding import (LogicalAxisRules, _tree_map,
                                 all_gather_single, axis_dim,
                                 reduce_scatter_single, shard_batch,
                                 shard_params, tree_specs)


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
    """``shard_params`` under ``rules`` (default ``megatron_rules()``) for
    the serving layouts (``tp_layer``): each position's params, in grid
    order. Rules that lay out any dim on the mesh otherwise than
    ``megatron_rules()`` does (the reference's default splits the
    vocabulary over tp, and the embedding dim over fsdp) raise
    NotImplementedError: the port's layer runs the Megatron split, with
    the layer stack over pp and every other axis replicated."""
    rules = rules or megatron_rules()
    axes = param_logical_axes(None)
    sizes = mesh.shape

    def split(r):
        def effective(spec):
            dims = [tuple(a for a in ((ax,) if isinstance(ax, str)
                                      else ax or ()) if sizes[a] > 1)
                    for ax in spec]
            while dims and not dims[-1]:
                dims.pop()
            return tuple(dims)
        return _flat(tree_specs(axes, mesh, r), effective)
    want, got = split(megatron_rules()), split(rules)
    if got != want:
        names = _flat(axes, lambda a: a)
        bad = {k: names[k] for k in got if got[k] != want[k]}
        raise NotImplementedError(
            f"rules that split {bad} otherwise than megatron_rules() are "
            f"not ported: the serving layout splits heads, kv_heads and "
            f"mlp over tp and the layer stack over pp, and replicates the "
            f"rest")
    return shard_params(params, mesh, rules, axes)


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


def all_reduce(parts, devices) -> Dict[torch.device, torch.Tensor]:
    """The sum of one partial per tp position (``parts[i]`` on
    ``devices[i]``), on each distinct device: {device: sum}.

    Each partial goes to the first position's device, where they are added
    in f32 in position order and the sum is rounded to the partials' dtype
    once; the sum then goes to every other distinct device. Against the
    unsharded product, whose one matmul accumulates every term in f32 and
    rounds once, each partial here was rounded once more: a bf16 sum is
    within a few bf16 ulps of it, an f32 one within f32 rounding. (XLA's
    all-reduce does not fix an order.) On one device nothing is copied."""
    if len(parts) == 1:
        total = parts[0]
    else:
        home = devices[0]
        total = parts[0].to(torch.float32, copy=True)
        for p in parts[1:]:
            total += p.to(home)
        total = total.to(parts[0].dtype)
    return on_each(total, devices)


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


def sp_layer(cfg: TransformerConfig, xss, lpss, devss, attend):
    """``tp_layer`` over sequence shards: shard j's input ``xss[j]``
    {device: (B, S_j, E)} runs on its tp positions ``devss[j]``, which
    hold ``lpss[j]``. ``attend(hs)`` gets every shard's normed input and
    returns ``outs[j][i]``, shard j's tp position i's attention output
    (B, S_j, H_i, D) on its device: attention is the only step that
    crosses shards. Each shard's ``wo``, all-reduces, MLP and residuals
    are its own. Returns each shard's output {device: (B, S_j, E)}."""
    eps, dt = cfg.rms_norm_eps, cfg.dtype
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
    for xs, lps, devices, first, o_j in zip(xss, lpss, devss, firsts, outs):
        parts = [torch.einsum("bshd,hde->bse", o, lp["attn"]["wo"].to(dt))
                 for o, lp in zip(o_j, lps)]
        o = all_reduce(parts, devices)
        xs = {d: xs[d] + o[d] for d in first}
        h = {d: rms_norm(xs[d], lps[i]["ln_mlp"], eps)
             for d, i in first.items()}
        m = all_reduce([_mlp_down(lp, h[d], cfg)
                        for lp, d in zip(lps, devices)], devices)
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
    """``rules`` (default ``LogicalAxisRules.default()``), which must split
    the params and the batch on ``mesh`` as the default table or
    ``megatron_rules()`` does: the sharded model knows those two layouts
    (the vocabulary and the embed dim split or not). Any other table
    raises NotImplementedError, as ``tp_shards`` does."""
    rules = rules or LogicalAxisRules.default()
    axes = param_logical_axes(None)

    def layout(r):
        return (tree_specs(axes, mesh, r), r.spec(("batch",), mesh))
    got = layout(rules)
    if got not in (layout(LogicalAxisRules.default()),
                   layout(megatron_rules())):
        default = _flat(layout(LogicalAxisRules.default())[0], tuple)
        names = _flat(axes, lambda a: a)
        bad = {k: names[k] for k, v in _flat(got[0], tuple).items()
               if v != default[k]} or {"batch": got[1]}
        raise NotImplementedError(
            f"rules that lay out {bad} otherwise than "
            f"LogicalAxisRules.default() and megatron_rules() are not "
            f"ported: the sharded model runs those two")
    return rules


class _Layout:
    """Where a sharded forward's pieces live, all indexed
    [stage][group][sequence shard]: the tp positions (flat mesh indices)
    of each pipeline stage's batch group's sp shard and their devices, and
    per tp position the positions whose embed-dim slices it gathers; per
    leaf, the dim its spec splits over fsdp (of one layer's tensor for
    layer leaves); whether the vocabulary is split over tp. Over several
    processes: this rank's batch groups (``local_groups``), and per tp
    position only the fsdp sources this rank holds, with the process
    group of the ranks that hold the others (``fsdp_groups``; None where
    this rank holds them all)."""

    def __init__(self, mesh, rules: LogicalAxisRules):
        self.rules = rules
        specs = tree_specs(param_logical_axes(None), mesh, rules)
        fsdp = mesh.shape["fsdp"] > 1
        self.top_dims = {k: axis_dim(specs[k], "fsdp") if fsdp else None
                         for k in ("embed", "ln_f", "lm_head")}
        # A layer's tensor is its stacked tensor without the (L) dim.
        self.layer_dims = _tree_map(
            lambda sp: axis_dim(sp[1:], "fsdp") if fsdp else None,
            specs["layers"])
        self.vocab_split = (mesh.shape["tp"] > 1
                            and axis_dim(specs["embed"], "tp") == 0)
        self.groups = mesh.batch_groups()
        self.pp, self.sp = mesh.shape["pp"], mesh.shape["sp"]
        stages, shards = range(self.pp), range(self.sp)
        self.positions = [[[mesh.group_positions(d, f, s, j) for j in shards]
                           for d, f in self.groups] for s in stages]
        self.devices = [[[[mesh.devices.flat[i] for i in pos] for pos in g]
                         for g in st] for st in self.positions]
        by_fsdp = [[[[mesh.fsdp_positions(d, t, s, j)
                      for t in range(mesh.shape["tp"])]
                     for j in shards] for d, f in self.groups]
                   for s in stages]
        self.sources = [[[[[i for i in pos if mesh.is_local(i)]
                           for pos in shard] for shard in g] for g in st]
                        for st in by_fsdp]
        self.fsdp_groups = [[[[mesh.group(mesh.ranks(pos)) for pos in shard]
                              for shard in g] for g in st] for st in by_fsdp]
        self.local_groups = [g for g in range(len(self.groups))
                             if mesh.is_local(self.positions[0][g][0][0])]


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


def fsdp_gather(parts, dim: int, device, group=None) -> torch.Tensor:
    """A weight's tp slice on ``device`` from its embed-dim slices
    ``parts``, one per fsdp position in fsdp order: a ``.to()`` of each
    and a ``cat`` along ``dim``. Autograd's backward of it returns each
    slice its own part of the gradient, on its own device (the
    reduce-scatter).

    ``group``: ``parts`` are this process's run of the slices, and the
    ranks of ``group`` hold the others, each an equal run in rank order;
    the runs are all-gathered (``_FsdpGather``)."""
    local = (parts[0].to(device) if len(parts) == 1
             else torch.cat([p.to(device) for p in parts], dim=dim))
    if group is None:
        return local
    return _FsdpGather.apply(local, dim, group)


class _FsdpGather(torch.autograd.Function):
    """The ranks' runs of a weight's fsdp slices concatenated along
    ``dim`` in rank order: one all-gather over ``group`` in the forward
    (again in a checkpoint's recompute, where every rank of the group
    issues it in the same order); the gradient reduce-scattered back to
    each rank's run in the backward, in its dtype, the ranks' sums in
    rank order. It is the fsdp group's share of the gradient's sum; the
    dp replicas of a slice are all-reduced by the train step."""

    @staticmethod
    def forward(ctx, piece, dim: int, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.group, ctx.shape = dim, group, piece.shape
        piece = piece.contiguous()
        out = piece.new_empty((n * piece.shape[0],) + piece.shape[1:])
        all_gather_single(out, piece, group=group)
        return out.view((n,) + piece.shape).movedim(0, dim).flatten(
            dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        dim, shape = ctx.dim, ctx.shape
        n = grad.shape[dim] // shape[dim]
        runs = grad.unflatten(dim, (n, shape[dim])).movedim(dim, 0)
        runs = runs.contiguous().view((n * shape[0],) + shape[1:])
        out = grad.new_empty(shape)
        reduce_scatter_single(out, runs, group=ctx.group)
        return out, None, None


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


def _gathered(own, sources, dims, device, group=None):
    """A tree of a position's tensors: each leaf its own where ``dims``
    says it is not split over fsdp, else gathered from ``sources`` (and
    from the ranks of ``group``)."""
    if isinstance(dims, dict):
        return {k: _gathered(own[k], [s[k] for s in sources], dims[k],
                             device, group) for k in dims}
    return own if dims is None else fsdp_gather(sources, dims, device, group)


def _position_params(trees, lay: _Layout, s: int, g: int, j: int, t: int,
                     li):
    """Stage ``s``'s group ``g``'s sp shard ``j``'s tp position ``t``'s
    params, gathered across fsdp: the top-level tensors named in the tuple
    ``li``, or the stage's layer ``li``'s (an index into the stage's own
    L/pp layers)."""
    own = trees[lay.positions[s][g][j][t]]
    srcs = [trees[i] for i in lay.sources[s][g][j][t]]
    dev = lay.devices[s][g][j][t]
    group = lay.fsdp_groups[s][g][j][t]
    if isinstance(li, tuple):
        dims = {k: lay.top_dims[k] for k in li}
        return _gathered({k: own[k] for k in li},
                         [{k: src[k] for k in li} for src in srcs], dims, dev,
                         group)
    return _gathered(layer_params(own, li),
                     [layer_params(src, li) for src in srcs], lay.layer_dims,
                     dev, group)


def _sp_attention(cfg: TransformerConfig, qs, ks, vs, devices):
    """One tp position's attention over its sequence shards: qs[j] (B,
    S_j, H, D) and ks[j], vs[j] on ``devices[j]``, shard j's output on its
    device. Under ``attention_impl="ring"`` the shards run the ring
    (``ops.ring_attention``); otherwise the sequence is attended whole on
    the first shard's device and split back, GSPMD's gather around the
    reference's attention (under "flash" the kernel). One shard: the
    attention itself."""
    if len(devices) == 1:
        return [_attention(cfg, qs[0], ks[0], vs[0])]
    if cfg.attention_impl == "ring":
        return _ring_shards(qs, ks, vs, devices, causal=True,
                            scale=1.0 / math.sqrt(qs[0].shape[-1]))
    home = devices[0]
    o = _attention(cfg, *(torch.cat([x.to(home) for x in xs], dim=1)
                          for xs in (qs, ks, vs)))
    cuts = np.cumsum([0] + [q.shape[1] for q in qs])
    return [o[:, a:b].to(d) for a, b, d in zip(cuts[:-1], cuts[1:], devices)]


def _group_layer(cfg: TransformerConfig, xss, trees, lay: _Layout, s: int,
                 g: int, li: int, ropes):
    """Stage ``s``'s layer ``li`` over group ``g``'s positions: each
    gathers its weights across fsdp, then ``sp_layer``, whose attention
    runs per tp position over the sp shards (``_sp_attention``)."""
    devss = lay.devices[s][g]
    lpss = [[_position_params(trees, lay, s, g, j, t, li)
             for t in range(len(devices))]
            for j, devices in enumerate(devss)]

    def attend(hs):
        qkv = []
        for j, (lps, devices) in enumerate(zip(lpss, devss)):
            row = []
            for lp, d in zip(lps, devices):
                cos, sin = ropes[j][d]
                q, k, v = _layer_qkv(lp, hs[j][d], cfg)
                row.append((apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                            v))
            qkv.append(row)
        by_tp = [_sp_attention(cfg, *zip(*(qkv[j][t] for j in range(lay.sp))),
                               [devss[j][t] for j in range(lay.sp)])
                 for t in range(len(devss[0]))]
        return [[o[j] for o in by_tp] for j in range(lay.sp)]
    return sp_layer(cfg, xss, lpss, devss, attend)


def _group_embed(trees, lay: _Layout, g: int, j: int, tokens,
                 cfg: TransformerConfig):
    """Group ``g``'s sp shard ``j``'s embedding on stage 0: {device: (B,
    S_j, E)} on each distinct device of its tp positions. The table is
    looked up per vocabulary slice and summed where the vocabulary is
    split."""
    devices = lay.devices[0][g][j]
    dt = cfg.dtype
    tops = [_position_params(trees, lay, 0, g, j, t, ("embed",))
            for t in range(len(devices) if lay.vocab_split else 1)]
    n_v = tops[0]["embed"].shape[0]
    parts = []
    for t, p in enumerate(tops):
        tok = tokens.to(devices[t])
        table = p["embed"].to(dt)
        if lay.vocab_split:
            # The slice's rows; other slices' tokens read zeros, so the sum
            # over slices is the lookup (JAX's one-hot matmul).
            local = tok - t * n_v
            inside = (local >= 0) & (local < n_v)
            row = table[local.clamp(0, n_v - 1)]
            parts.append(torch.where(inside[..., None], row,
                                     torch.zeros((), dtype=dt,
                                                 device=row.device)))
        else:
            parts.append(table[tok])
    x = all_reduce(parts, devices[:len(parts)])[devices[0]]
    return on_each(x, devices)


def _stage_layers(cfg: TransformerConfig, xss, trees, lay: _Layout, s: int,
                  g: int, ropes):
    """Stage ``s``'s L/pp layers over group ``g``'s positions, each
    checkpointed when a gradient is needed.

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
        out = _group_layer(cfg, [{d: next(it) for d in k} for k in keys],
                           trees, lay, s, g, li, ropes)
        return tuple(o[d] for o, k in zip(out, keys) for d in k)
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
            xss = _group_layer(cfg, xss, trees, lay, s, g, li, ropes)
    return xss


def _group_head(trees, lay: _Layout, g: int, j: int, xs,
                cfg: TransformerConfig):
    """Group ``g``'s sp shard ``j``'s logits on the last stage, split over
    the vocabulary: [(logits (B, S_j, V/tp) f32 on its position's device,
    the slice's first id)], one per tp position where the vocabulary is
    split, else one on the first position."""
    s = lay.pp - 1
    devices = lay.devices[s][g][j]
    out = []
    for t in range(len(devices) if lay.vocab_split else 1):
        p = _position_params(trees, lay, s, g, j, t, ("ln_f", "lm_head"))
        x = rms_norm(xs[devices[t]], p["ln_f"], cfg.rms_norm_eps)
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


def _group_logits(trees, lay: _Layout, g: int, tokens,
                  cfg: TransformerConfig, num_microbatches=None) -> list:
    """Group ``g``'s logits per microbatch and sp shard: ``out[m][j]`` is
    ``_group_head``'s vocabulary slices of microbatch m (one where there
    is no pp axis) and sequence shard j (one where there is no sp axis).
    ``tokens`` (B_g, S) is on the group's first device of stage 0; shard
    j takes tokens [j S/sp, (j+1) S/sp) and RoPE at those positions.
    Under pp the group's rows are split into ``num_microbatches``
    (default pp) that run the GPipe schedule (``pipeline.gpipe_ticks``),
    launched tick by tick; each shard of a stage's output goes to the
    next stage's devices by ``stage_send``."""
    pp, sp = lay.pp, lay.sp
    mb = (num_microbatches or pp) if pp > 1 else 1
    if pp > 1:
        if cfg.num_layers % pp:
            raise ValueError(f"{cfg.num_layers} layers not divisible by "
                             f"pp={pp}")
        check_microbatches(tokens.shape[0], mb, pp)
    Sl = tokens.shape[1] // sp
    shards = _seq_shards(tokens, sp)
    ropes = [{d: rope_angles(Sl, cfg.head_dim_, cfg.rope_theta,
                             offset=j * Sl, device=d)
              for d in dict.fromkeys(d for st in lay.devices
                                     for d in st[g][j])}
             for j in range(sp)]
    rows = tokens.shape[0] // mb
    xs = [[t[m * rows:(m + 1) * rows] for t in shards] for m in range(mb)]
    out = [None] * mb
    for _, s, m in gpipe_ticks(mb, pp):
        devss = lay.devices[s][g]
        x = ([_group_embed(trees, lay, g, j, t, cfg)
              for j, t in enumerate(xs[m])] if s == 0 else
             [stage_send(x[lay.devices[s - 1][g][j][0]], devss[j])
              for j, x in enumerate(xs[m])])
        xs[m] = _stage_layers(cfg, x, trees, lay, s, g, ropes)
        if s == pp - 1:
            out[m] = [_group_head(trees, lay, g, j, x, cfg)
                      for j, x in enumerate(xs[m])]
            xs[m] = None
    return out


def vocab_parallel_nll(logits, targets) -> torch.Tensor:
    """-log softmax(logits)[target] per token, (B, S) f32 on the first
    slice's device, from logits split over the vocabulary: ``logits`` is
    [(slice (B, S, V_i) f32, its first id)] in order. The max and the sum
    of exponentials are taken slice by slice and combined in f32 in slice
    order; the target's logit comes from the slice that holds it. No
    device holds (B, S, V)."""
    home = logits[0][0].device
    m = None
    for lg, _ in logits:
        mx = lg.detach().amax(dim=-1).to(home)
        m = mx if m is None else torch.maximum(m, mx)
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
    return m + total.log() - picked


def _sharded(params, mesh, rules):
    """(per-position params, layout) for the sharded model."""
    rules = mesh_rules(mesh, rules)
    trees = (params if isinstance(params, (list, tuple))
             else shard_params(params, mesh, rules))
    if len(trees) != mesh.devices.size:
        raise ValueError(f"{len(trees)} position trees for a mesh of "
                         f"{mesh.devices.size} positions")
    return trees, _Layout(mesh, rules)


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
    are alive at a time. Over several processes, this rank's groups only
    (``batch`` is the whole batch on every rank)."""
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
    per_pos = shard_batch({"inputs": inputs, "targets": targets,
                           "weights": weights}, mesh, lay.rules)
    for g in lay.local_groups:
        b = per_pos[lay.positions[0][g][0][0]]
        logits = _group_logits(trees, lay, g, b["inputs"], cfg,
                               num_microbatches)
        total = None
        for m, per_shard in enumerate(logits):
            for j, lg in enumerate(per_shard):
                last = per_pos[lay.positions[-1][g][j][0]]
                rows = last["targets"].shape[0] // len(logits)
                r = slice(m * rows, (m + 1) * rows)
                nll = vocab_parallel_nll(
                    lg, _seq_shards(last["targets"][r], lay.sp)[j])
                home = nll.device
                w = _seq_shards(last["weights"][r], lay.sp)[j].to(home)
                part = (nll * w).sum() / denom.to(home)
                total = part if total is None else total + part.to(
                    total.device)
        yield total


def _mesh_forward(params, tokens, cfg: TransformerConfig, mesh, rules, dev,
                  num_microbatches=None):
    trees, lay = _sharded(params, mesh, rules)
    per_pos = shard_batch(tokens, mesh, lay.rules)
    out = []
    for g in lay.local_groups:
        for per_shard in _group_logits(trees, lay, g,
                                       per_pos[lay.positions[0][g][0][0]],
                                       cfg, num_microbatches):
            out.append(torch.cat([
                torch.cat([lg.to(dev) for lg, _ in logits], dim=-1)
                for logits in per_shard], dim=1))
    out = torch.cat(out, dim=0)
    if mesh.world > 1:
        # Each rank's groups are an equal run of the batch's rows.
        rows = out.new_empty((mesh.world * out.shape[0],) + out.shape[1:])
        all_gather_single(rows, out, group=mesh.world_group())
        out = rows
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
    dp replicas' sum being the train step's)."""
    dev = resolve_device(device)
    if _splits(mesh, params):
        total = None
        for part in mesh_group_losses(params, batch, cfg, mesh, rules, dev,
                                      num_microbatches):
            total = part.to(dev) if total is None else total + part.to(dev)
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
