"""Llama-style decoder-only transformer in PyTorch.

Port of ray_tpu/models/transformer.py for one device. Params are a plain
dict with the JAX package's keys and layouts (``wq (L,E,H,D)``,
``wo (L,H,D,E)``, ...), so ``from_jax_params`` is a plain copy. bf16
activations and weights, f32 RMSNorm math and f32 logits, GQA, RoPE and
SwiGLU, as in the reference. The layers run as a Python loop in place of
``lax.scan``; with ``remat`` each layer is checkpointed when a gradient is
needed (``torch.utils.checkpoint`` in place of ``jax.checkpoint``), so
inference is unchanged by it.

``params["layers"]`` comes in two forms. Every entry point takes the
stacked JAX form, one (L, ...) tensor per weight. ``layer_params`` also
takes a list of per-layer dicts, which only ``train_step`` builds (views of
the stacked storage, so that autograd gives each layer its own gradient
tensor); no other caller should grow a third form.

``forward`` and ``loss_fn`` take a ``mesh`` (``parallel.mesh.Mesh``) whose
only axis larger than 1 is ``sp``: with ``attention_impl="ring"`` each
layer's attention runs ``ops.ring_attention.ring_attention`` over it, and
every other op runs on ``device``, whose values the reference's sharding
constraints do not change. Not ported yet, each raising
NotImplementedError: meshes with dp, fsdp or tp larger than 1 (the
reference's logical-axis shardings) and pp larger than 1 (pipeline stages).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.flash_attention import flash_attention, reference_attention
from ..ops.ring_attention import ring_attention


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


def _mlp(lp, x, cfg: TransformerConfig):
    """The SwiGLU half of a layer, with its norm and residual."""
    dt = cfg.dtype
    h = rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps)
    g = torch.einsum("bse,em->bsm", h, lp["mlp"]["w_gate"].to(dt))
    u = torch.einsum("bse,em->bsm", h, lp["mlp"]["w_up"].to(dt))
    return x + torch.einsum("bsm,me->bse", F.silu(g) * u,
                            lp["mlp"]["w_down"].to(dt))


def _layer(cfg: TransformerConfig, x, lp, cos, sin, mesh=None):
    h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
    q, k, v = _layer_qkv(lp, h, cfg)
    o = _attention(cfg, apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                   mesh)
    x = x + torch.einsum("bshd,hde->bse", o, lp["attn"]["wo"].to(cfg.dtype))
    return _mlp(lp, x, cfg)


def forward(params: Dict[str, Any], tokens, cfg: TransformerConfig,
            mesh=None, device: Union[str, torch.device] = "cuda"
            ) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32 on ``device``, where
    the params must already live. ``mesh``: an sp-only mesh for
    ``attention_impl="ring"`` (see the module docstring)."""
    if mesh is not None:
        mesh.axis_devices("sp")         # raises for the unported axes
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, "
                         f"forward was asked for {dev}")
    tokens = torch.as_tensor(tokens, device=dev).long()
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


def loss_fn(params: Dict[str, Any], batch: Dict[str, Any],
            cfg: TransformerConfig, mesh=None,
            device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Next-token cross-entropy, a 0-d f32 tensor; batch = {"tokens": (B,S)}
    or {"inputs","targets"}; ignores padding id 0 when targets provided."""
    dev = resolve_device(device)
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
