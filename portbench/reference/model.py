"""The plain float32 reference of a Mistral decoder, in blocks that fit a card.

It follows the published Mistral equations (``MistralForCausalLM``):
pre-norm RMSNorm with a learned scale, grouped-query attention with
rotate-half RoPE at ``rope_theta`` and a causal mask, a SwiGLU MLP
(``down(silu(gate x) * up x)``), a final RMSNorm and an untied head, with
no biases. Everything is float32 with TF32 off. Departures, all shared
with the program: the weights are random from the seed, not trained; no
sliding window (both configurations have none).

The weights come from ``portbench.weights`` one layer at a time, drawn
again from the seed and cast up to f32: the reference takes nothing that
the program made or holds. ``quant`` turns the reference into the control:
it rounds both operands of every matmul to a lower precision first.
It imports nothing of the program, nor JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import weights as W
from ..model_config import Sizes

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The control's rounding: x scaled per slice along ``dim`` (the
    contraction's other side: per row of activations, per output column of
    weights) into float8 e4m3's range, rounded to it and scaled back."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    """x (..., K) @ w (K, N) in f32, both rounded by ``quant`` first."""
    if quant is not None:
        x, w = quant(x, -1), quant(w, 0)
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(s: Sizes, positions: torch.Tensor):
    """cos, sin (S, D) of rotate-half RoPE at ``positions``."""
    D = s.head_dim
    inv = 1.0 / (s.rope_theta ** (torch.arange(
        0, D, 2, dtype=torch.float64, device=positions.device) / D))
    ang = positions.to(torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)
    return ang.cos().float(), ang.sin().float()


def _rotate(x, cos, sin):
    """x (B, S, H, D)."""
    x1, x2 = x.chunk(2, -1)
    rot = torch.cat([-x2, x1], -1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


class Layers:
    """f32 weights of one layer at a time, drawn from the seed. ``offset``,
    when set, gives each leaf a tensor to add (the training reference's
    updates), and ``grad`` makes the leaves require a gradient."""

    def __init__(self, s: Sizes, seed: int, device):
        self.s, self.seed, self.device = s, seed, device

    def leaf(self, leaf: str, layer: int = -1) -> torch.Tensor:
        return W.draw(self.s, self.seed, leaf, layer, self.device,
                      torch.float32)

    def layer(self, li: int) -> Dict[str, torch.Tensor]:
        return {k: self.leaf(k, li) for k in W.MATMUL + W.NORMS}


def layer_forward(s: Sizes, w: Dict[str, torch.Tensor], x: torch.Tensor,
                  cos, sin, quant: Quant = None,
                  key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder layer over x (B, S, E), causal over S."""
    B, S, E = x.shape
    H, KV, D = s.heads, s.kv_heads, s.head_dim
    h = rms_norm(x, w["ln_attn"], s.eps)
    q = mm(h, w["wq"].reshape(E, H * D), quant).view(B, S, H, D)
    k = mm(h, w["wk"].reshape(E, KV * D), quant).view(B, S, KV, D)
    v = mm(h, w["wv"].reshape(E, KV * D), quant).view(B, S, KV, D)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    o = attention(q, k, v, quant)
    x = x + mm(o.reshape(B, S, H * D), w["wo"].reshape(H * D, E), quant)
    h = rms_norm(x, w["ln_mlp"], s.eps)
    g = mm(h, w["w_gate"], quant)
    u = mm(h, w["w_up"], quant)
    return x + mm(F.silu(g) * u, w["w_down"], quant)


def attention(q, k, v, quant: Quant = None) -> torch.Tensor:
    """Causal GQA attention, q (B, S, H, D), k and v (B, S, KV, D), one
    kv group at a time."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    outs = []
    for j in range(KV):
        qj = q[:, :, j * G:(j + 1) * G].transpose(1, 2)       # B G S D
        kj = k[:, :, j].unsqueeze(1)                           # B 1 S D
        vj = v[:, :, j].unsqueeze(1)
        if quant is not None:
            qj, kj, vj = quant(qj, -1), quant(kj, -1), quant(vj, -2)
        sc = (qj @ kj.transpose(-1, -2)) * D ** -0.5
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
        if quant is not None:
            p = quant(p, -1)
        outs.append((p @ vj).transpose(1, 2))                 # B S G D
    return torch.cat(outs, 2)


def head(s: Sizes, ln_f, lm_head, x, quant: Quant = None) -> torch.Tensor:
    return mm(rms_norm(x, ln_f, s.eps), lm_head, quant)


@torch.no_grad()
def logits_at(s: Sizes, layers: Layers, seqs: Sequence[Sequence[int]],
              rows: Sequence[Sequence[int]], quant: Quant = None
              ) -> List[torch.Tensor]:
    """For each token sequence, the f32 logits (len(rows[i]), V) at the
    positions ``rows[i]``: a full forward over the whole sequence, layer by
    layer over every sequence."""
    dev = layers.device
    embed = layers.leaf("embed")
    xs = [embed[torch.as_tensor(list(t), device=dev)][None] for t in seqs]
    del embed
    ropes = [rope(s, torch.arange(len(t), device=dev)) for t in seqs]
    for li in range(s.layers):
        w = layers.layer(li)
        xs = [layer_forward(s, w, x, *r, quant) for x, r in zip(xs, ropes)]
    ln_f, lm = layers.leaf("ln_f"), layers.leaf("lm_head")
    return [head(s, ln_f, lm, x[0, torch.as_tensor(list(r), device=dev)],
                 quant) for x, r in zip(xs, rows)]
