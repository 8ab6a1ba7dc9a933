"""Flash attention: a hand-written Hopper CUDA kernel and its plain version.

Port of ray_tpu/ops/flash_attention.py. ``flash_attention`` keeps the JAX
contract q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D). Tensors on the CPU
take the plain PyTorch version (``reference_attention``); tensors on a GPU
launch ``csrc/flash_attention_fwd.cu`` or raise, with no fallback.

Only the forward is ported. The backward kernels (dQ, dK/dV) come with the
training slice, so a CUDA call on tensors that require grad raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

MASK_FILL = -1e30


def _scores(q, k, causal: bool, scale: float):
    """f32 scores (B, Hkv, G, S, T), the causal part filled with -1e30."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones(S, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, MASK_FILL)
    return s


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """(B,S,Hq,D),(B,S,Hkv,D) GQA dot-product attention; f32 softmax."""
    B, S, Hq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    w = torch.softmax(_scores(q, k, causal, scale), dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(B, S, Hq, D)


def reference_attention_lse(q, k, v, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin: (o (B,S,Hq,D) in q.dtype, lse (B,Hq,S) f32)."""
    B, S, Hq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq, S)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, Hq, D)
    return o.to(q.dtype), lse


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _library():
    lib = _build.load("flash_attention_fwd")
    if lib.fa_fwd.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fa_fwd.argtypes = ([ptr] * 5 + [i] * 6 + [ll] * 12
                               + [ctypes.c_float, i, ptr])
        lib.fa_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D (B, S, H, D) tensors")
    B, S, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {D}")
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(st % per16 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: the kernel needs a contiguous last dim and 16-byte "
                f"aligned rows, got strides {t.stride()}")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B,S,Hq,D), lse (B,Hq,S) f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. Counts its launches
    in ``flash_attention_fwd.launches``."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return reference_attention_lse(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    B, S, Hq, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    rc = _library().fa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[q.dtype], B, S, Hq, k.shape[2], D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"cudaError_t {rc}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Public entry: q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D).

    CPU tensors run ``reference_attention``; CUDA tensors run the Hopper
    kernel (``flash_attention_fwd``) or raise."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "backward kernels are ported in the training slice")
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
