"""Attention ops of the port: hand-written Hopper kernels and plain twins."""

from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_dkv, flash_attention_dq,
                              flash_attention_fwd, reference_attention,
                              reference_attention_bwd,
                              reference_attention_lse)
from .paged_attention import (paged_decode_attention,
                              reference_paged_decode_attention)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_dkv",
           "flash_attention_dq", "flash_attention_fwd", "reference_attention",
           "reference_attention_bwd", "reference_attention_lse",
           "paged_decode_attention", "reference_paged_decode_attention"]
