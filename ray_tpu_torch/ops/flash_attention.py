"""Flash attention: hand-written Hopper CUDA kernels and their plain versions.

Port of ray_tpu/ops/flash_attention.py. ``flash_attention`` keeps the JAX
contract q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D) and is differentiable:
when a gradient is needed it runs ``_FlashAttention``, the counterpart of
the reference's custom VJP ``_flash_diff``, which saves (q, k, v, o, lse)
and recomputes P in its backward.

Three kernels, each beside its plain PyTorch twin with the same signature:

- ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``): o and lse;
- ``flash_attention_dq`` (``csrc/flash_attention_dq.cu``): dQ, and
  delta = rowsum(dO * O), which the reference computes outside its kernels
  (ray_tpu/ops/flash_attention.py:270) and this kernel in its prologue;
- ``flash_attention_dkv`` (``csrc/flash_attention_dkv.cu``): dK and dV,
  with the GQA group summed inside the kernel.

Tensors on the CPU take the plain versions; tensors on a GPU launch the
kernels or raise, with no fallback. Each kernel wrapper counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

MASK_FILL = -1e30


def _scale(q, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _up(t):
    """t in f32, or f64 if it is f64: the plain versions' working type."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, causal: bool, scale: float):
    """f32 scores (B, Hkv, G, S, T), the causal part filled with -1e30."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bskgd,btkd->bkgst", _up(qg), _up(k)) * scale
    if causal:
        mask = torch.ones(S, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, MASK_FILL)
    return s


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """(B,S,Hq,D),(B,S,Hkv,D) GQA dot-product attention; f32 softmax."""
    B, S, Hq, D = q.shape
    w = torch.softmax(_scores(q, k, causal, _scale(q, scale)),
                      dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(B, S, Hq, D)


def reference_attention_lse(q, k, v, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain twin: (o (B,S,Hq,D) in q.dtype,
    lse (B,Hq,S) f32)."""
    B, S, Hq, D = q.shape
    s = _scores(q, k, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq, S)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, Hq, D)
    return o.to(q.dtype), lse


def attention_bwd_delta(o, do):
    """delta = rowsum(dO * O), (B, Hq, S) f32: the backward's correction
    term (the reference's ``:270``), the plain version of what the dQ
    kernel computes in its prologue."""
    return (_up(do) * _up(o)).sum(-1).transpose(1, 2).contiguous()


def _bwd_terms(q, k, v, do, lse, delta, causal, scale):
    """P and dS = P (dP - delta), (B, Hkv, G, S, T) f32, with P recomputed
    from lse as the kernels do, and dO grouped (B, S, Hkv, G, D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    p = torch.exp(_scores(q, k, causal, scale)
                  - lse.reshape(B, Hkv, G, S, 1))
    dog = _up(do).reshape(B, S, Hkv, G, D)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, _up(v))
    return p, p * (dp - delta.reshape(B, Hkv, G, S, 1)), dog


def reference_attention_dq(q, k, v, o, do, lse, causal: bool = True,
                           scale: Optional[float] = None):
    """The dQ kernel's plain twin: (dQ (B,S,Hq,D) in q.dtype, delta
    (B,Hq,S) f32)."""
    B, S, Hq, D = q.shape
    scale = _scale(q, scale)
    delta = attention_bwd_delta(o, do)
    _, ds, _ = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, _up(k)) * scale
    return dq.reshape(B, S, Hq, D).to(q.dtype), delta


def reference_attention_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            scale: Optional[float] = None):
    """The dK/dV kernel's plain twin: (dK, dV) (B,S,Hkv,D) in k.dtype, the
    GQA group summed in f32."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = _scale(q, scale)
    p, ds, dog = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    qg = _up(q).reshape(B, S, Hkv, Hq // Hkv, D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def reference_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                            scale: Optional[float] = None):
    """The backward's plain twin: (dq, dk, dv) from the forward's o and
    lse, recomputing P = exp(S - lse) in f32 as the kernels do."""
    dq, delta = reference_attention_dq(q, k, v, o, do, lse, causal, scale)
    return (dq, *reference_attention_dkv(q, k, v, do, lse, delta, causal,
                                         scale))


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

# wrapper -> (C function, tensor pointers, (b, s, h) stride triples); each
# C function then takes dtype, B, S, Hq, Hkv, D, the strides, scale, causal
# and the stream (csrc/<wrapper>.cu).
_KERNELS = {"flash_attention_fwd": ("fa_fwd", 5, 4),
            "flash_attention_dq": ("fa_dq", 8, 6),
            "flash_attention_dkv": ("fa_dkv", 8, 6)}


def _kernel(name: str):
    c_name, n_ptrs, n_strided = _KERNELS[name]
    fn = getattr(_build.load(name), c_name)
    if fn.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * n_ptrs + [i] * 6 + [ll] * (3 * n_strided)
                       + [ctypes.c_float, i, ptr])
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, ptrs, strided, q, k, causal: bool,
            scale: float) -> None:
    B, S, Hq, D = q.shape
    # The kernels make q's device current (hopper.cuh bind_device); the
    # guard gives the caller's current device back, so a launch on a
    # second card leaves the thread where it was.
    with torch.cuda.device(q.device):
        rc = _kernel(name)(
            *(t.data_ptr() for t in ptrs), _DTYPE_CODES[q.dtype], B, S, Hq,
            k.shape[2], D, *(st for t in strided for st in t.stride()[:3]),
            float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _check(q, k, v, **like_q):
    """Raise unless the kernels take q, k, v and the q-shaped tensors
    ``like_q`` (o, dO) as they are."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D (B, S, H, D) tensors")
    B, S, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    named = {"q": q, "k": k, "v": v, **like_q}
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in named.values()):
        raise ValueError("flash_attention kernel needs its tensors on one "
                         "CUDA device, got " + ", ".join(
                             f"{n} on {t.device}" for n, t in named.items()))
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in named.values()):
        raise ValueError("flash_attention kernel takes float32 or bfloat16, "
                         "all alike, got " + ", ".join(
                             f"{n} {t.dtype}" for n, t in named.items()))
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {D}")
    per16 = 16 // q.element_size()
    for name, t in named.items():
        if name in like_q and t.shape != q.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, q is "
                             f"{tuple(q.shape)}")
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(st % per16 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: the kernel needs a contiguous last dim and 16-byte "
                f"aligned rows, got strides {t.stride()}")


def _check_rows(q, **rows):
    """Raise unless each of ``rows`` (lse, delta) is a contiguous
    (B, Hq, S) f32 tensor on q's device."""
    B, S, Hq, _ = q.shape
    for name, t in rows.items():
        if t.shape != (B, Hq, S) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous (B, Hq, S) = "
                             f"{(B, Hq, S)} float32 tensor on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B,S,Hq,D), lse (B,Hq,S) f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. Counts its launches
    in ``flash_attention_fwd.launches``."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_attention_lse(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    B, S, Hq, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", (q, k, v, o, lse), (q, k, v, o), q, k,
            causal, scale)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_dq(q, k, v, o, do, lse, causal: bool = True,
                       scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dQ (B,S,Hq,D) in q.dtype, delta = rowsum(dO * O) (B,Hq,S) f32) from
    the forward's o and lse (B,Hq,S) f32 and dO. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. Counts its launches
    in ``flash_attention_dq.launches``."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_attention_dq(q, k, v, o, do, lse, causal, scale)
    _check(q, k, v, o=o, do=do)
    _check_rows(q, lse=lse)
    B, S, Hq, _ = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _launch("flash_attention_dq", (q, k, v, o, do, lse, delta, dq),
            (q, k, v, o, do, dq), q, k, causal, scale)
    flash_attention_dq.launches += 1
    return dq, delta


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) (B,S,Hkv,D) in k.dtype, summed over each GQA group, from
    dO, the forward's lse and delta. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. Counts its launches in
    ``flash_attention_dkv.launches``."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_attention_dkv(q, k, v, do, lse, delta, causal,
                                       scale)
    _check(q, k, v, do=do)
    _check_rows(q, lse=lse, delta=delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_attention_dkv", (q, k, v, do, lse, delta, dk, dv),
            (q, k, v, do, dk, dv), q, k, causal, scale)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) from the forward's o and lse: the port of
    ``_flash_backward_pallas``. On CUDA tensors two kernels: dQ, which also
    computes delta = rowsum(dO * O), then dK/dV, which reads that delta;
    on CPU tensors their plain versions."""
    scale = _scale(q, scale)
    # dO comes from autograd, strided as the op after attention left it.
    if not do.is_contiguous() or do.data_ptr() % 16:
        do = do.clone(memory_format=torch.contiguous_format)
    dq, delta = flash_attention_dq(q, k, v, o, do, lse, causal, scale)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, causal, scale))


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's custom VJP ``_flash_diff``: the
    forward saves (q, k, v, o, lse), the backward recomputes P from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Public entry: q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D).

    When a gradient is needed this runs ``_FlashAttention`` (on the CPU
    too, where both halves take their plain versions); otherwise CPU
    tensors run ``reference_attention`` and CUDA tensors the forward
    kernel. CUDA tensors launch the kernels or raise."""
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
