"""Random weights from the seed, made on the device in the program's layout.

Every leaf, and every layer of a stacked leaf, has a generator of its own,
seeded from (seed, leaf, layer). So the harness draws the whole model in one
call per layer and leaf, and the reference draws one layer again whenever it
needs it, bit for bit, without holding the model a second time.

Layout (the port's, ``models/transformer.py``): ``embed (V, E)``,
``layers.attn.wq (L, E, H, D)``, ``wk``/``wv (L, E, KV, D)``,
``wo (L, H, D, E)``, ``layers.mlp.w_gate``/``w_up (L, E, M)``,
``w_down (L, M, E)``, ``layers.ln_attn``/``ln_mlp (L, E)`` f32,
``ln_f (E,)`` f32, ``lm_head (E, V)``. Matmul weights are bf16,
N(0, 1/fan_in); norm scales are f32, 1 + N(0, 0.01).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

from .model_config import Sizes

MATMUL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
NORMS = ("ln_attn", "ln_mlp")
GROUP = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
         "w_gate": "mlp", "w_up": "mlp", "w_down": "mlp"}


def shape_of(s: Sizes, leaf: str) -> Tuple[Tuple[int, ...], int]:
    """(one layer's shape, fan_in) of a layer leaf, or the whole shape of a
    top-level one."""
    E, H, KV, D, M, V = (s.hidden, s.heads, s.kv_heads, s.head_dim,
                         s.intermediate, s.vocab)
    return {"wq": ((E, H, D), E), "wk": ((E, KV, D), E),
            "wv": ((E, KV, D), E), "wo": ((H, D, E), H * D),
            "w_gate": ((E, M), E), "w_up": ((E, M), E),
            "w_down": ((M, E), M), "ln_attn": ((E,), 0),
            "ln_mlp": ((E,), 0), "embed": ((V, E), E),
            "ln_f": ((E,), 0), "lm_head": ((E, V), E)}[leaf]


def _gen(seed: int, leaf: str, layer: int, device) -> torch.Generator:
    h = hashlib.sha256(f"{int(seed)}/{leaf}/{layer}".encode()).digest()
    return torch.Generator(device).manual_seed(
        int.from_bytes(h[:8], "little") >> 1)


def fill(out: torch.Tensor, s: Sizes, seed: int, leaf: str,
         layer: int = -1) -> torch.Tensor:
    """Draw ``leaf`` (one layer of it, or a top-level leaf with layer -1)
    into ``out``, in place, in ``out``'s dtype."""
    _, fan_in = shape_of(s, leaf)
    g = _gen(seed, leaf, layer, out.device)
    if fan_in:
        return out.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
    return out.normal_(1.0, 0.01, generator=g)


def draw(s: Sizes, seed: int, leaf: str, layer: int = -1, device="cuda",
         dtype=None) -> torch.Tensor:
    """One layer of ``leaf`` (or a top-level leaf), as the model holds it,
    or cast to ``dtype`` after the draw."""
    shape, fan_in = shape_of(s, leaf)
    held = torch.bfloat16 if fan_in else torch.float32
    t = fill(torch.empty(shape, dtype=held, device=device), s, seed, leaf,
             layer)
    return t if dtype is None else t.to(dtype)


def make_params(s: Sizes, seed: int, device="cuda") -> Dict[str, object]:
    """The whole model in the port's layout, drawn on ``device``."""
    L = s.layers

    def stacked(leaf):
        shape, fan_in = shape_of(s, leaf)
        held = torch.bfloat16 if fan_in else torch.float32
        out = torch.empty((L,) + shape, dtype=held, device=device)
        for li in range(L):
            fill(out[li], s, seed, leaf, li)
        return out

    return {
        "embed": draw(s, seed, "embed", device=device),
        "layers": {
            "attn": {k: stacked(k) for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: stacked(k) for k in ("w_gate", "w_up", "w_down")},
            "ln_attn": stacked("ln_attn"),
            "ln_mlp": stacked("ln_mlp"),
        },
        "ln_f": draw(s, seed, "ln_f", device=device),
        "lm_head": draw(s, seed, "lm_head", device=device),
    }


def layer_leaf(params, leaf: str, layer: int) -> torch.Tensor:
    """``leaf`` of ``layer`` in a params tree of the port's layout (layer -1:
    a top-level leaf)."""
    if layer < 0:
        return params[leaf]
    if leaf in NORMS:
        return params["layers"][leaf][layer]
    return params["layers"][GROUP[leaf]][leaf][layer]


def leaf_names(s: Sizes):
    """Every (leaf, layer) of the model, top-level leaves with layer -1:
    the leaves by which the training check compares norms."""
    out = [("embed", -1)]
    for li in range(s.layers):
        out += [(k, li) for k in MATMUL + NORMS]
    return out + [("ln_f", -1), ("lm_head", -1)]
