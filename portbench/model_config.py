"""A configuration file's sizes, read the same way by the harness, the
weight maker, the FLOP counts and the reference.

``configs/<name>.json`` holds the model's published ``config.json`` keys as
they are run, plus ``source``, ``deployment``, ``reduced`` and ``assumed``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Sizes:
    name: str
    vocab: int
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float

    @property
    def q_width(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_width(self) -> int:
        return self.kv_heads * self.head_dim

    def layer_matmul_params(self) -> int:
        """Parameters of one layer that take part in a matmul."""
        e = self.hidden
        return (e * self.q_width + 2 * e * self.kv_width
                + self.q_width * e + 3 * e * self.intermediate)

    def matmul_params(self) -> int:
        """N_mm: every parameter that takes part in a matmul, which is all
        of them but the input embedding and the RMSNorm scales."""
        return self.layers * self.layer_matmul_params() \
            + self.hidden * self.vocab

    def param_count(self) -> int:
        return self.matmul_params() + self.vocab * self.hidden \
            + (2 * self.layers + 1) * self.hidden


def from_dict(name: str, d: dict) -> Sizes:
    heads = int(d["num_attention_heads"])
    if d.get("sliding_window") not in (None, 0):
        raise ValueError(f"{name}: a sliding window is not run here")
    if d.get("tie_word_embeddings"):
        raise ValueError(f"{name}: tied embeddings are not run here")
    return Sizes(name=name, vocab=int(d["vocab_size"]),
                 hidden=int(d["hidden_size"]),
                 intermediate=int(d["intermediate_size"]),
                 layers=int(d["num_hidden_layers"]), heads=heads,
                 kv_heads=int(d["num_key_value_heads"]),
                 head_dim=int(d.get("head_dim")
                              or int(d["hidden_size"]) // heads),
                 rope_theta=float(d["rope_theta"]),
                 eps=float(d["rms_norm_eps"]))


def load(name: str) -> Sizes:
    return from_dict(name, json.loads(
        (HERE / "configs" / f"{name}.json").read_text()))
