"""Paged-decode attention: a hand-written Hopper CUDA kernel and its plain twin.

One query token per slot attends to that slot's keys in one layer of the
engine's paged KV pool, read through the slot's page table: q (B, Hq, D),
pool_k / pool_v (N, page, KV, D), tables (B, P) int64 page ids, lengths
(B,) int64, active (B,) bool -> o (B, Hq, D) in q's dtype. Slot b's valid
keys are positions 0 .. lengths[b] inclusive (the engine writes the new
token at index lengths[b] just before the call); ``scale`` multiplies
q . k. Inactive slots give zero rows.

``reference_paged_decode_attention`` is the engine's decode attention as
plain PyTorch: it gathers every slot's whole page table, repeats it to
every query head, divides the scores (in q's dtype) by 1 / scale, masks
with -1e30 and takes an f32 softmax. ``paged_decode_attention`` is the entry: CPU
tensors take the twin; CUDA tensors launch ``csrc/paged_decode.cu`` or
raise, with no fallback. The kernel replaces no TPU kernel (the JAX
engine's decode attention is jnp under jit, ray_tpu/llm/engine.py:220-230):
it reads each live key and value row once, in place, for all the query
heads of its kv head, instead of materialising the gather. It is bounded
by those bytes; its source says how its design meets them. Its launches
are counted in ``paged_decode_attention.launches``. ``kernel_tolerance``
is how far the kernel may lie from the exact function, for its checks.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_HEADS_PER_BLOCK = 16   # query heads one block serves (csrc kHeads)
_TILE = 64              # keys a block's four warps take per round
_MAX_TILES = 8          # a split covers at most 8 rounds (512 keys)
_BLOCKS_PER_SM = 8      # blocks per SM the split count aims for


def reference_paged_decode_attention(q, pool_k, pool_v, tables, lengths,
                                     active, scale: float):
    """The kernel's plain twin, the engine's decode attention as it was
    written inline: einsums in q's dtype over the gathered, repeated
    pages, the scores divided by 1 / scale (bit for bit what dividing by the engine's
    rounded sqrt(head_dim) gives), -1e30 past each slot's length, an f32
    softmax cast back to q's dtype. Inactive rows are zero."""
    B, Hq, D = q.shape
    T = tables.shape[1] * pool_k.shape[1]
    groups = Hq // pool_k.shape[2]
    valid = torch.arange(T, device=q.device)[None] <= lengths[:, None]
    # Gather each slot's pages: (B, P, page, KV, D) -> (B, T, ...)
    kr = pool_k[tables].reshape(B, T, -1, D).repeat_interleave(groups, 2)
    vr = pool_v[tables].reshape(B, T, -1, D).repeat_interleave(groups, 2)
    scores = torch.einsum("bhd,bthd->bht", q, kr) / (1.0 / scale)
    scores = scores.masked_fill(~valid[:, None], -1e30)
    p = torch.softmax(scores.float(), -1).to(q.dtype)
    o = torch.einsum("bht,bthd->bhd", p, vr)
    return o.masked_fill(~active[:, None, None], 0)


def kernel_tolerance(dtype, v, exact) -> float:
    """How far the kernel's o may lie from ``exact``, the twin's function
    computed in f32 from the same inputs, with ``v`` the values it
    attends to. bf16: P is rounded to bf16 before P.V (at most 2^-9 of
    each weight, so at most 2^-9 max|v| over a convex sum) and o to bf16
    (2^-9 of |o|). f32 keeps only the order of its sums (2e-5 at the
    engine's sizes)."""
    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** -9 * (v.float().abs().max().item()
                        + exact.abs().max().item()) + 1e-6


def split_keys(B: int, KV: int, G: int, T: int, sms: int):
    """(keys per split, number of splits) for the kernel's grid, from the
    shapes alone: a split is 1 to _MAX_TILES rounds of _TILE keys, as few
    as give every SM about _BLOCKS_PER_SM blocks when each slot holds T
    keys. Shorter slots leave their later splits to exit at once."""
    units = B * KV * -(-G // _HEADS_PER_BLOCK)
    tiles = -(-T // _TILE)
    per = -(-tiles * units // (_BLOCKS_PER_SM * sms))
    chunk = _TILE * max(1, min(_MAX_TILES, per))
    return chunk, -(-T // chunk)


def _check(q, pool_k, pool_v, tables, lengths, active):
    """Raise ValueError unless the kernel takes these tensors as they are.
    Written for the decode step's host time: one pass, messages built only
    on a refusal."""
    qs, ks = q.shape, pool_k.shape
    if len(qs) != 3 or len(ks) != 4:
        raise ValueError(f"paged_decode_attention takes q (B, Hq, D) and a "
                         f"pool (N, page, KV, D), got {tuple(qs)} and "
                         f"{tuple(ks)}")
    B, Hq, D = qs
    _, page, KV, Dk = ks
    if pool_v.shape != ks or Dk != D:
        raise ValueError(f"pool shapes {tuple(ks)}/{tuple(pool_v.shape)} do "
                         f"not match q {tuple(qs)}")
    if Hq % KV:
        raise ValueError(f"Hq={Hq} is not a multiple of KV={KV}")
    ts = tables.shape
    if len(ts) != 2 or ts[0] != B or lengths.shape != (B,) \
            or active.shape != (B,):
        raise ValueError(f"tables (B, P), lengths (B,) and active (B,) for "
                         f"B={B}, got {tuple(ts)}, {tuple(lengths.shape)}, "
                         f"{tuple(active.shape)}")
    dt = q.dtype
    if dt not in _DTYPE_CODES or pool_k.dtype != dt or pool_v.dtype != dt:
        raise ValueError(f"the kernel takes float32 or bfloat16 q and pools, "
                         f"all alike, got {dt}, {pool_k.dtype}, "
                         f"{pool_v.dtype}")
    if tables.dtype != torch.int64 or lengths.dtype != torch.int64 \
            or active.dtype != torch.bool:
        raise ValueError(f"tables and lengths must be int64 and active "
                         f"bool, got {tables.dtype}, {lengths.dtype}, "
                         f"{active.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{D}")
    if page < 1:
        raise ValueError(f"the kernel takes pages of at least one position, "
                         f"got {page}")
    qst, per16 = q.stride(), 16 // q.element_size()
    if qst[2] != 1 or qst[0] % per16 or qst[1] % per16:
        raise ValueError(f"q: the kernel needs a contiguous head dim and "
                         f"16-byte aligned rows, got strides {qst}")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("the kernel needs contiguous pools")
    if tables.stride(1) != 1 or not lengths.is_contiguous() \
            or not active.is_contiguous():
        raise ValueError(f"the kernel needs contiguous table rows, lengths "
                         f"and active, got table strides {tables.stride()}")
    dev = q.device
    if dev.type != "cuda" or pool_k.device != dev or pool_v.device != dev \
            or tables.device != dev or lengths.device != dev \
            or active.device != dev:
        named = dict(q=q, pool_k=pool_k, pool_v=pool_v, tables=tables,
                     lengths=lengths, active=active)
        raise ValueError("paged_decode_attention kernel needs its tensors on "
                         "one CUDA device, got " + ", ".join(
                             f"{n} on {t.device}" for n, t in named.items()))
    if (q.data_ptr() | pool_k.data_ptr() | pool_v.data_ptr()) % 16:
        raise ValueError("the kernel needs 16-byte aligned q and pools")


def _kernel():
    fn = _build.load("paged_decode").paged_decode
    if fn.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 9 + [i] * 7 + [ll] * 3 + [i] * 2
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, pool_k, pool_v, tables, lengths, active,
                           scale: float):
    """o (B, Hq, D) in q's dtype. CPU tensors take the plain twin; CUDA
    tensors launch the kernel or raise. Reads no device value on the host
    and does not synchronise. Counts its launches in
    ``paged_decode_attention.launches``."""
    if q.device.type == "cpu":
        return reference_paged_decode_attention(q, pool_k, pool_v, tables,
                                                lengths, active, scale)
    _check(q, pool_k, pool_v, tables, lengths, active)
    B, Hq, D = q.shape
    _, page, KV, _ = pool_k.shape
    P = tables.shape[1]
    chunk, splits = split_keys(
        B, KV, Hq // KV, P * page,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    o = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    # The splits' f32 outputs (B, Hq, splits, D), then their log-sum-exps.
    rows = B * Hq * splits if splits > 1 else 0
    part = torch.empty(rows * (D + 1), dtype=torch.float32, device=q.device)
    dev = q.device.index
    args = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), active.data_ptr(),
            o.data_ptr(), part.data_ptr(), part.data_ptr() + rows * D * 4,
            _DTYPE_CODES[q.dtype], B, Hq, KV, D, page, P, q.stride(0),
            q.stride(1), tables.stride(0), chunk, splits, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):        # the launch goes to q's device
        rc = _kernel()(*args)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError_t {rc}")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0
