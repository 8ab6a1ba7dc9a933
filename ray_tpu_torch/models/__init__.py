"""Model zoo of the port: the Llama-style decoder (transformer.py)."""

from .transformer import (PRESETS, TransformerConfig, forward,
                          from_jax_params, init_params)

__all__ = ["PRESETS", "TransformerConfig", "forward", "from_jax_params",
           "init_params"]
