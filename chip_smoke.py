#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line on stdout:

1. device: the card's name and power limit (nvidia-smi), TF32 switched off.
2. build: every kernel under ray_tpu_torch/ops/csrc built with nvcc for
   sm_90a; each kernel's registers, spills and static shared memory from
   the ptxas report (the whole report goes to stderr). A spill fails.
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card, o and lse, at the engine's prefill shapes and at
   f32 / non-causal / D=64 / GQA / ragged shapes; kernel, plain and
   scaled_dot_product_attention times (the last only as a yardstick, its
   device time under torch.profiler, and which SDPA backend ran).
4. kernel_bwd: the dQ and dK/dV kernels against their plain versions, dq,
   dk and dv, at the training shapes and the same f32 / non-causal / D=64
   / GQA / ragged shapes; the autograd Function's grads against autograd
   through plain attention; kernel, delta, plain and SDPA-backward times
   (SDPA's as for the forward).
   Then bf16 cases that cross the kernels' 128-row tiles (S 1, 127, 129,
   255; D 64, 128; GQA groups 1, 2, 4, 8 and 16; causal or not), one whose
   q, k and v are strided views of a fused (B, S, Hq + 2 Hkv, D) tensor,
   and two dK/dV launches on the same inputs, which must agree bit for
   bit (the GQA group is summed in a fixed order).
5. serve: Llama-3-8B-GQA at full width and depth with random weights,
   four greedy requests through LLMEngine; checks tokens, the kernel's
   launch count and each prompt's prefill logits against forward() with
   plain attention.
6. train: the same model at full width and depth, random weights, four
   steps of make_train_step on one fixed 2048-token batch with per-layer
   checkpointing; checks finite metrics, a falling loss, each kernel's
   launches per step, step 1's loss and grad norm against a pass with
   plain attention on the same params, and each attention weight's
   gradient (wq, wk, wv, wo of every layer) from a flash pass against the
   plain pass's, beside a control: the plain pass again on the same model
   with its MLP hidden units relabelled, which changes only the rounding.

Then the kernels line, the card line and, last, the ok line. Any failure
exits non-zero without the ok line, as does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.models import (PRESETS, forward, init_params,
                                  make_optimizer, make_train_step)
from ray_tpu_torch.models.train_step import value_and_grad
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (
    attention_bwd_delta, flash_attention, flash_attention_bwd,
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
    reference_attention, reference_attention_bwd, reference_attention_dkv,
    reference_attention_dq, reference_attention_lse)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on the
# CUDA cores (the f32 kernel does not use tensor cores), HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_S = 3.35e12

# bf16: the kernel feeds unnormalised probabilities rounded to bf16 into
# P.V where the plain version rounds the normalised ones, and o itself is
# bf16 (8 mantissa bits). f32: only the order of the sums differs.
TOL = {torch.bfloat16: {"o": 2e-2, "lse": 1e-3},
       torch.float32: {"o": 1e-4, "lse": 1e-4}}
# Prefill last-token logits of the 8B model, flash kernel vs plain
# attention, max |diff| / max |ref|. Both run in bf16 through 32 layers of
# random weights, where one-ulp differences per layer grow to about 2% of
# the largest logit: the plain path differs from itself by that much when
# only the prompt's padding changes (printed as noise_rel_err beside it).
LOGITS_REL_TOL = 5e-2

ENGINE_HEADS = dict(B=1, Hq=32, Hkv=8, D=128, dtype=torch.bfloat16,
                    causal=True)
KERNEL_CASES = (
    [dict(ENGINE_HEADS, S=s) for s in (8, 64, 512, 1024, 2048)]
    + [dict(B=1, S=256, Hq=8, Hkv=8 // g, D=64, dtype=torch.float32,
            causal=False) for g in (1, 2, 4)]
    + [dict(B=2, S=200, Hq=8, Hkv=2, D=128, dtype=torch.bfloat16,
            causal=True),
       dict(B=2, S=200, Hq=8, Hkv=4, D=64, dtype=torch.bfloat16,
            causal=False),
       dict(B=2, S=200, Hq=8, Hkv=2, D=128, dtype=torch.float32,
            causal=True)])
# bf16 cases across the 128-row tiles of the forward and dK/dV kernels:
# every (S, D, G, causal) below with Hkv = 2, and G = 16 on one kv head.
TILING_CASES = ([dict(B=1, S=s, Hq=2 * g, Hkv=2, D=d, causal=c)
                 for s in (1, 127, 129, 255) for d in (64, 128)
                 for g in (1, 2, 4, 8) for c in (True, False)]
                + [dict(B=1, S=255, Hq=16, Hkv=1, D=d, causal=c)
                   for d in (64, 128) for c in (True, False)])
FUSED_CASE = dict(B=2, S=300, Hq=8, Hkv=2, D=128, causal=True)
PROMPT_LENS = (37, 300, 1000, 1900)
MAX_TOKENS = 16

# Backward, per gradient. bf16, max |diff| / max |ref|: the kernels round P
# and dS to bf16 as the operands of their products and emit bf16, where
# the plain version stays in f32 until its one final cast. f32, max |diff|:
# only the order of the sums differs.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TRAIN_HEADS = dict(B=1, Hq=32, Hkv=8, D=128, dtype=torch.bfloat16,
                   causal=True)
BWD_CASES = ([dict(TRAIN_HEADS, S=s) for s in (64, 512, 1024, 2048)]
             + [c for c in KERNEL_CASES if c["dtype"] == torch.float32
                or c["S"] == 200])

TRAIN_SEQ = 2048
TRAIN_STEPS = 4
# Step 1's loss and grad norm (flash kernels, the optimizer's first step)
# against a loss+grad pass with plain attention on the same params and
# batch, relative. Both run bf16 through 32 layers of random weights; the
# loss is a mean over 2048 tokens, so per-logit drift of ~2% (see
# LOGITS_REL_TOL) averages down to well under 1%. The grad norm sums the
# squares of 8e9 bf16 gradients whose per-element drift does not average
# out the same way, hence the wider limit.
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GNORM_REL_TOL = 5e-2
# Each attention weight's gradient, flash pass against plain pass, as
# ||g_flash - g_plain|| / ||g_plain|| per layer and weight; the worst of
# the 128 is held here. A fault confined to attention's backward (a wrong
# or zero dq, dk or dv, or wrong wiring of the autograd Function or the
# checkpointed recompute) moves these leaves by the whole size of the
# fault (a zero gradient reads 1, a zeroed kv head of 8 sqrt(1/8)),
# where the global norm above is dominated by embed and lm_head. On the
# H100 the flash pass read 0.035 and the control 0.028 (the same measure
# for two plain passes that differ only in rounding: bf16 noise grown
# through 32 layers), so the limit sits just above both (PERF.md).
TRAIN_ATTN_GRAD_REL_TOL = 5e-2
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() over iters calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10):
    """(device time of one fn() call in ms, the names of the kernels it
    ran, longest first): the summed time of every kernel that ``iters``
    calls ran on the card under torch.profiler, over ``iters``, after one
    warm-up call. Host dispatch is not in it. The time is None if the
    profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, names = 0.0, []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and evt.self_device_time_total > 0:
            total += evt.self_device_time_total
            names.append((evt.self_device_time_total, evt.key[:60]))
    names = [n for _, n in sorted(names, reverse=True)]
    return (total / 1e3 / iters if total else None), names


def sdpa_backend(names) -> str:
    """Which scaled_dot_product_attention backend ran, read from the names
    of its kernels."""
    joined = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in joined:
            return backend
    return "math"


def attention_bound(B, S, Hq, Hkv, D, dtype, causal, kernel="fwd"):
    """(bound_ms, bound_by) of one kernel: the larger of its operations
    over the peak rate of the type and its bytes over the memory rate.
    Per live (query, key) pair and head dim: fwd 2 products (4 ops), dq 3
    (6), dkv 4 (8). Bytes: each q-shaped and kv-shaped tensor read or
    written once (fwd q, o / k, v; dq q, dO, dQ / k, v; dkv q, dO / k, v,
    dK, dV) plus the f32 rows (fwd lse; dq and dkv lse, delta)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    ops, n_q, n_kv, n_rows = {"fwd": (4, 2, 2, 1), "dq": (6, 3, 2, 2),
                              "dkv": (8, 2, 4, 2)}[kernel]
    flops = ops * B * Hq * D * pairs
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (elt * B * S * D * (n_q * Hq + n_kv * Hkv)
              + 4 * n_rows * B * Hq * S)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(card: str, failures: list) -> list:
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for case in KERNEL_CASES:
        B, S, Hq, Hkv, D = (case[k] for k in ("B", "S", "Hq", "Hkv", "D"))
        dtype, causal = case["dtype"], case["causal"]

        def rand(h):
            return torch.randn((B, S, h, D), generator=gen, device="cuda"
                               ).to(dtype)
        q, k, v = rand(Hq), rand(Hkv), rand(Hkv)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ro, rlse = reference_attention_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
        tol = TOL[dtype]
        ok = finite and err_o <= tol["o"] and err_lse <= tol["lse"]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound_ms, bound_by = attention_bound(B, S, Hq, Hkv, D, dtype, causal)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        library_ms, library_kernels = device_ms(sdpa)
        row = dict(
            phase="kernel", name="flash_attention_fwd", B=B, S=S, Hq=Hq,
            Hkv=Hkv, D=D, dtype=str(dtype).replace("torch.", ""),
            causal=causal, max_abs_err_o=err_o, max_abs_err_lse=err_lse,
            tol_o=tol["o"], tol_lse=tol["lse"], ok=ok,
            ms=time_ms(lambda: flash_attention_fwd(q, k, v,
                                                      causal=causal)),
            plain_ms=time_ms(lambda: reference_attention_lse(
                q, k, v, causal=causal)),
            library_ms=library_ms, library_backend=sdpa_backend(
                library_kernels), library_kernels=library_kernels[:3],
            library_event_ms=time_ms(sdpa),
            bound_ms=bound_ms, bound_by=bound_by, card=card)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"kernel mismatch: {row}")
    return rows


def _rel_errs(got, want):
    """Per gradient: (max |diff|, max |diff| / max |ref|)."""
    out = []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        out.append((err, err / max(w.float().abs().max().item(), 1e-30)))
    return out


def _bwd_ok(errs, dtype) -> bool:
    i = 1 if dtype == torch.bfloat16 else 0   # relative, or absolute
    return all(e[i] <= BWD_TOL[dtype] for e in errs)


def kernel_bwd_phase(card: str, failures: list) -> list:
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for case in BWD_CASES:
        B, S, Hq, Hkv, D = (case[k] for k in ("B", "S", "Hq", "Hkv", "D"))
        dtype, causal = case["dtype"], case["causal"]

        def rand(h):
            return torch.randn((B, S, h, D), generator=gen, device="cuda"
                               ).to(dtype)
        q, k, v, do = rand(Hq), rand(Hkv), rand(Hkv), rand(Hq)
        # Both sides get the same o and lse, so only the backward differs.
        o, lse = reference_attention_lse(q, k, v, causal=causal)
        delta = attention_bwd_delta(o, do)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = reference_attention_bwd(q, k, v, o, lse, do, causal=causal)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        errs = _rel_errs(got, want)

        # The autograd Function (forward kernel, then dQ and dK/dV) against
        # autograd through plain attention.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fa = torch.autograd.grad(flash_attention(*leaves, causal=causal),
                                 leaves, do)
        ra = torch.autograd.grad(reference_attention(*leaves, causal=causal),
                                 leaves, do)
        fn_errs = _rel_errs(fa, ra)
        ok = finite and _bwd_ok(errs, dtype) and _bwd_ok(fn_errs, dtype)

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                       retain_graph=True)
        library_ms, library_kernels = device_ms(sdpa_bwd)
        shape = (B, S, Hq, Hkv, D, dtype, causal)
        dq_bound, dq_by = attention_bound(*shape, kernel="dq")
        dkv_bound, dkv_by = attention_bound(*shape, kernel="dkv")
        row = dict(
            phase="kernel_bwd", B=B, S=S, Hq=Hq, Hkv=Hkv, D=D,
            dtype=str(dtype).replace("torch.", ""), causal=causal,
            max_abs_err_dq=errs[0][0], max_abs_err_dk=errs[1][0],
            max_abs_err_dv=errs[2][0],
            rel_err=[e[1] for e in errs],
            autograd_rel_err=[e[1] for e in fn_errs],
            autograd_max_abs_err=[e[0] for e in fn_errs],
            tol=BWD_TOL[dtype],
            tol_kind="relative" if dtype == torch.bfloat16 else "absolute",
            ok=ok,
            dq_ms=time_ms(lambda: flash_attention_dq(
                q, k, v, do, lse, delta, causal=causal)),
            dkv_ms=time_ms(lambda: flash_attention_dkv(
                q, k, v, do, lse, delta, causal=causal)),
            delta_ms=time_ms(lambda: attention_bwd_delta(o, do)),
            bwd_ms=time_ms(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal)),
            plain_dq_ms=time_ms(lambda: reference_attention_dq(
                q, k, v, do, lse, delta, causal=causal)),
            plain_dkv_ms=time_ms(lambda: reference_attention_dkv(
                q, k, v, do, lse, delta, causal=causal)),
            plain_ms=time_ms(lambda: reference_attention_bwd(
                q, k, v, o, lse, do, causal=causal)),
            library_ms=library_ms, library_backend=sdpa_backend(
                library_kernels), library_kernels=library_kernels[:3],
            library_event_ms=time_ms(sdpa_bwd),
            dq_bound_ms=dq_bound, dq_bound_by=dq_by,
            dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by, card=card)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"backward kernel mismatch: {row}")
    return rows


def _bf16_inputs(gen, B, S, Hq, Hkv, D):
    def rand(h):
        return torch.randn((B, S, h, D), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
    return rand(Hq), rand(Hkv), rand(Hkv), rand(Hq)


def _tiling_check(q, k, v, do, causal: bool):
    """(errors, ok) of the forward kernel (o, lse) and the backward kernels
    (dq, dk, dv) against their plain versions on one bf16 input. The
    backward is held as BWD_TOL's relative measure with the reference's
    scale floored at 1: where a gradient is zero in exact arithmetic (dK at
    S = 1, whose one probability is 1, so dS = dP - delta = 0) only
    rounding is left, and a ratio to its own maximum means nothing."""
    tol = TOL[torch.bfloat16]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = reference_attention_lse(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, ro, rlse, do, causal=causal)
    want = reference_attention_bwd(q, k, v, ro, rlse, do, causal=causal)
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    bwd = [((g.float() - w.float()).abs().max()
            / max(w.float().abs().max().item(), 1.0)).item()
           for g, w in zip(got, want)]
    finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, *got))
    ok = (finite and err_o <= tol["o"] and err_lse <= tol["lse"]
          and all(e <= BWD_TOL[torch.bfloat16] for e in bwd))
    return dict(max_abs_err_o=err_o, max_abs_err_lse=err_lse,
                bwd_err=bwd), ok


def tiling_phase(card: str, failures: list) -> dict:
    gen = torch.Generator("cuda").manual_seed(2)
    keys = ("B", "S", "Hq", "Hkv", "D")
    cases = []
    for case in TILING_CASES:
        errs, ok = _tiling_check(
            *_bf16_inputs(gen, *(case[x] for x in keys)), case["causal"])
        cases.append(dict(case, **errs, ok=ok))
        if not ok:
            failures.append(f"tiling case mismatch: {cases[-1]}")
    worst = {name: max(cases, key=lambda c: get(c)) for name, get in (
        ("o", lambda c: c["max_abs_err_o"]),
        ("lse", lambda c: c["max_abs_err_lse"]),
        ("bwd", lambda c: max(c["bwd_err"])))}

    # q, k and v as the strided views a fused QKV projection leaves.
    B, S, Hq, Hkv, D = (FUSED_CASE[x] for x in keys)
    x = torch.randn((B, S, Hq + 2 * Hkv, D), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    q, k, v = x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:]
    do = _bf16_inputs(gen, B, S, Hq, Hkv, D)[3]
    errs, ok = _tiling_check(q, k, v, do, FUSED_CASE["causal"])
    fused = dict(FUSED_CASE, strides=[list(t.stride()) for t in (q, k, v)],
                 contiguous=q.is_contiguous(), **errs, ok=ok)
    if not ok or q.is_contiguous():
        failures.append(f"fused-view case: {fused}")

    # Two dK/dV launches on the same inputs give the same bits.
    det = []
    for shape in (dict(TRAIN_HEADS, S=TRAIN_SEQ),
                  dict(B=1, S=255, Hq=16, Hkv=1, D=128, causal=True)):
        q, k, v, do = _bf16_inputs(gen, *(shape[x] for x in keys))
        o, lse = flash_attention_fwd(q, k, v, causal=shape["causal"])
        delta = attention_bwd_delta(o, do)
        first, second = (flash_attention_dkv(q, k, v, do, lse, delta,
                                             causal=shape["causal"])
                         for _ in range(2))
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        det.append(dict({x: shape[x] for x in keys}, bit_identical=same))
        if not same:
            failures.append(f"dK/dV differ between two launches: {det[-1]}")
    res = dict(phase="tiling", cases=len(cases),
               failed=[c for c in cases if not c["ok"]],
               worst={n: {x: c[x] for x in (*keys, "causal", "max_abs_err_o",
                                            "max_abs_err_lse", "bwd_err")}
                      for n, c in worst.items()},
               fused_view=fused, determinism=det, card=card)
    emit(res)
    return res


def serve_phase(card: str, failures: list) -> dict:
    cfg = PRESETS["8b-gqa"]
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = LLMEngine(cfg, params, max_batch=4, max_len=2048, page_size=64,
                    device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    sp = SamplingParams(max_tokens=MAX_TOKENS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    t_start = time.perf_counter()
    ids = [eng.add_request(p, sp) for p in prompts]
    ttft, outs, step_s, step_tokens = {}, {}, [], []
    while eng.has_unfinished():
        t_step = time.perf_counter()
        finished = eng.step()
        now = time.perf_counter()
        events = eng.take_tick_events()
        step_s.append(now - t_step)
        step_tokens.append(len(events))
        for rid, _, _ in events:
            ttft.setdefault(rid, now - t_start)
        for req in finished:
            outs[req.req_id] = req.out
    total_s = time.perf_counter() - t_start
    launches = flash_attention_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want_launches = len(prompts) * cfg.num_layers
    if launches != want_launches:
        failures.append(f"flash kernel launched {launches} times on the "
                        f"serve path, expected {want_launches}")
    for rid in ids:
        out = outs.get(rid, [])
        if len(out) != MAX_TOKENS or not all(0 <= t < cfg.vocab_size
                                             for t in out):
            failures.append(f"request {rid} returned {out}")

    # Each prompt's prefill logits (flash kernel, padded bucket) against
    # forward() with plain attention on the unpadded prompt. The noise
    # floor is plain attention on the padded bucket against the same.
    ref_cfg = dataclasses.replace(cfg, attention_impl="xla")
    checks = []
    with torch.no_grad():
        for rid, prompt in zip(ids, prompts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = eng._run_prefill(prompt)[0]
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            n = len(prompt)
            ref = forward(params, torch.tensor([prompt]), ref_cfg,
                          device="cuda")[0, -1]
            padded = prompt + [0] * (eng._bucket(n) - n)
            noise = forward(params, torch.tensor([padded]), ref_cfg,
                            device="cuda")[0, n - 1]
            scale = ref.abs().max()
            rel = ((logits - ref).abs().max() / scale).item()
            first_ok = int(logits.argmax()) == outs.get(rid, [None])[0]
            checks.append(dict(
                prompt_len=n, prefill_ms=prefill_ms, logits_rel_err=rel,
                noise_rel_err=((noise - ref).abs().max() / scale).item(),
                first_token_ok=first_ok))
            if not (rel < LOGITS_REL_TOL and first_ok
                    and bool(torch.isfinite(logits).all())):
                failures.append(f"prefill logits mismatch: {checks[-1]}")

    decode_tokens = sum(step_tokens[1:])
    decode_s = sum(step_s[1:])
    res = dict(
        phase="serve", preset="8b-gqa", params=cfg.param_count(),
        layers=cfg.num_layers, init_s=init_s, max_batch=4, max_len=2048,
        page_size=64, prompt_lens=list(PROMPT_LENS), max_tokens=MAX_TOKENS,
        flash_launches=launches, expected_launches=want_launches,
        ttft_s=[ttft.get(rid) for rid in ids], steps=len(step_s),
        first_step_s=step_s[0], total_s=total_s,
        decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
        peak_memory_gb=peak_gb, prefill=checks,
        logits_rel_tol=LOGITS_REL_TOL, card=card)
    emit(res)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS on Hopper


def device_time_split(prof) -> tuple:
    """Device time (ms) of the kernels one profiled window ran, by class
    (the three attention kernels by name, dense matmuls, which cuBLAS runs
    as nvjet/GEMM kernels, and everything else: elementwise, reductions,
    copies), and the ten kernels that took the most."""
    split = {"fa_fwd": 0.0, "fa_dq": 0.0, "fa_dkv": 0.0, "matmul": 0.0,
             "other": 0.0}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.key
        ms = evt.self_device_time_total / 1e3
        kernels.append(dict(name=name[:90], ms=ms, calls=evt.count))
        if "fa_dkv" in name:
            split["fa_dkv"] += ms
        elif "fa_dq" in name:
            split["fa_dq"] += ms
        elif "fa_fwd" in name:
            split["fa_fwd"] += ms
        elif any(w in name.lower() for w in MATMUL_KERNELS):
            split["matmul"] += ms
        else:
            split["other"] += ms
    return split, sorted(kernels, key=lambda k: -k["ms"])[:10]


def _named_leaves(tree, prefix=""):
    """(dotted path, tensor) for every tensor of a nested dict / list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _named_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def _is_attn(name: str) -> bool:
    parts = name.split(".")
    return len(parts) == 4 and parts[2] == "attn" and parts[3] in ATTN_WEIGHTS


def grad_pass(params, batch, cfg, impl: str):
    """One loss+grad pass with ``impl`` attention, reduced so that the 16 GB
    of grads need not outlive it: (loss, global norm, per-leaf norms, the
    attention weights' grads)."""
    loss, grads = value_and_grad(
        params, batch, dataclasses.replace(cfg, attention_impl=impl),
        device="cuda")
    named = dict(_named_leaves(grads))
    del grads
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in named.values()])
    gnorm = float(torch.linalg.vector_norm(norms))
    attn = {n: g for n, g in named.items() if _is_attn(n)}
    norms = dict(zip(named, norms.tolist()))
    del named
    gc.collect()
    torch.cuda.empty_cache()
    return float(loss), gnorm, norms, attn


def leaf_diffs(attn, ref_attn, norms, ref_norms) -> dict:
    """The worst attention weight by ||g - g_ref|| / ||g_ref||, and the
    worst leaf of all by |norm - ref norm| / ref norm."""
    errs = {n: (torch.linalg.vector_norm(g.float() - ref_attn[n].float())
                / torch.linalg.vector_norm(ref_attn[n], dtype=torch.float32)
                ).item() for n, g in attn.items()}
    nerrs = {n: abs(norms[n] - ref_norms[n]) / max(ref_norms[n], 1e-30)
             for n in ref_norms}
    worst, nworst = max(errs, key=errs.get), max(nerrs, key=nerrs.get)
    return dict(attn_grad_rel_err=errs[worst], attn_grad_worst=worst,
                attn_grad_rel_err_median=float(np.median(list(errs.values()))),
                leaf_norm_rel_err=nerrs[nworst], leaf_norm_worst=nworst,
                leaves=len(nerrs))


@torch.no_grad()
def relabel_mlp_(params, perm) -> None:
    """Permute every layer's MLP hidden units in place: w_gate and w_up
    columns, w_down rows. The model computes the same function; only the
    order of w_down's sums (and their rounding) changes."""
    mlp = params["layers"]["mlp"]
    for i in range(mlp["w_down"].shape[0]):
        for name in ("w_gate", "w_up"):
            mlp[name][i].copy_(mlp[name][i][:, perm])
        mlp["w_down"][i].copy_(mlp["w_down"][i][perm])


def _launch_counts():
    return (flash_attention_fwd.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches)


def train_phase(card: str, failures: list) -> dict:
    cfg = dataclasses.replace(PRESETS["8b-gqa"], remat=True,
                              attention_impl="flash")
    bundle = make_train_step(cfg, optimizer=make_optimizer(warmup_steps=1),
                             device="cuda")
    t0 = time.perf_counter()
    state = bundle.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                               (1, TRAIN_SEQ + 1))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}

    # Plain attention on the initial params: what step 1 and the flash
    # pass must agree with.
    params = state["params"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref_loss, ref_gnorm, ref_norms, ref_attn = grad_pass(params, batch, cfg,
                                                         "xla")
    ref_s = time.perf_counter() - t0
    ref_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Control: the plain pass on the same model with relabelled MLP units,
    # then the labels put back (bit-exactly: a permutation moves bits).
    perm = torch.randperm(cfg.intermediate_size, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(2))
    torch.cuda.reset_peak_memory_stats()
    relabel_mlp_(params, perm)
    ctl_loss, ctl_gnorm, ctl_norms, ctl_attn = grad_pass(params, batch, cfg,
                                                         "xla")
    relabel_mlp_(params, torch.argsort(perm))
    control = dict(loss_rel_err=abs(ctl_loss - ref_loss) / abs(ref_loss),
                   grad_norm_rel_err=abs(ctl_gnorm - ref_gnorm) / ref_gnorm,
                   **leaf_diffs(ctl_attn, ref_attn, ctl_norms, ref_norms))
    del ctl_attn
    fl_loss, fl_gnorm, fl_norms, fl_attn = grad_pass(params, batch, cfg,
                                                     "flash")
    flash = dict(loss_rel_err=abs(fl_loss - ref_loss) / abs(ref_loss),
                 grad_norm_rel_err=abs(fl_gnorm - ref_gnorm) / ref_gnorm,
                 **leaf_diffs(fl_attn, ref_attn, fl_norms, ref_norms))
    leaf_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del fl_attn, ref_attn
    gc.collect()
    torch.cuda.empty_cache()
    if not flash["attn_grad_rel_err"] <= TRAIN_ATTN_GRAD_REL_TOL:
        failures.append(f"attention weight grads, flash against plain: "
                        f"{flash}")

    # Under per-layer checkpointing each layer's forward runs twice per
    # step (the forward, then the recompute in the backward), its
    # backward once.
    want = (2 * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    flash_attention_fwd.launches = 0
    flash_attention_dq.launches = 0
    flash_attention_dkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        # The last step runs under the profiler, for where its time goes.
        last = i == TRAIN_STEPS - 1
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) if last
                else contextlib.nullcontext())
        before = _launch_counts()
        torch.cuda.synchronize()
        with prof:
            t0 = time.perf_counter()
            state, metrics = bundle.step(state, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        steps.append(dict(metrics, step_ms=step_s * 1e3,
                          launches=dict(zip(("fwd", "dq", "dkv"),
                                            launches))))
        if launches != want:
            failures.append(f"train step {metrics['step']} launched "
                            f"(fwd, dq, dkv) {launches}, expected {want}")
        if not (np.isfinite(metrics["loss"])
                and np.isfinite(metrics["grad_norm"])):
            failures.append(f"train step not finite: {metrics}")
    totals = dict(zip(("fwd", "dq", "dkv"), _launch_counts()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split, top = device_time_split(prof)
    busy_ms = sum(split.values())
    profiled = dict(step=steps[-1]["step"], wall_ms=steps[-1]["step_ms"],
                    device_ms=split if busy_ms else "not measured",
                    idle_share=(1 - busy_ms / steps[-1]["step_ms"]
                                if busy_ms else "not measured"),
                    top_kernels=top)

    first, last = steps[0], steps[-1]
    loss_rel = abs(first["loss"] - ref_loss) / abs(ref_loss)
    gnorm_rel = abs(first["grad_norm"] - ref_gnorm) / abs(ref_gnorm)
    if not last["loss"] < first["loss"]:
        failures.append(f"train loss did not fall: {first['loss']} -> "
                        f"{last['loss']}")
    if not (loss_rel <= TRAIN_LOSS_REL_TOL
            and gnorm_rel <= TRAIN_GNORM_REL_TOL):
        failures.append(f"step 1 against plain attention: loss rel "
                        f"{loss_rel}, grad_norm rel {gnorm_rel}")
    # Steady state: the steps after the first (which also warms up the
    # allocator and cuBLAS) and before the profiled one.
    steady_s = np.mean([s["step_ms"] for s in steps[1:-1]]) / 1e3
    res = dict(
        phase="train", preset="8b-gqa", params=cfg.param_count(),
        layers=cfg.num_layers, seq_len=TRAIN_SEQ, batch=1, remat=cfg.remat,
        init_s=init_s, steps=steps, launches=totals,
        expected_launches_per_step=dict(zip(("fwd", "dq", "dkv"), want)),
        plain_attention=dict(loss=ref_loss, grad_norm=ref_gnorm,
                             seconds=ref_s, peak_memory_gb=ref_peak_gb),
        loss_rel_err=loss_rel, grad_norm_rel_err=gnorm_rel,
        loss_rel_tol=TRAIN_LOSS_REL_TOL,
        grad_norm_rel_tol=TRAIN_GNORM_REL_TOL,
        leaf_grads=dict(flash=flash, control=control,
                        attn_grad_rel_tol=TRAIN_ATTN_GRAD_REL_TOL,
                        peak_memory_gb=leaf_peak_gb),
        steady_step_ms=steady_s * 1e3, profiled_step=profiled,
        tokens_per_s=TRAIN_SEQ / steady_s,
        model_flops_utilization=(cfg.flops_per_token(TRAIN_SEQ) * TRAIN_SEQ
                                 / steady_s / PEAK_FLOPS[torch.bfloat16]),
        peak_memory_gb=peak_gb, card=card)
    emit(res)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    failures: list = []
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(dict(phase="device", card=card,
              name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    seconds = _build.build()
    ptxas = {name: _build.ptxas_report(log)
             for name, log in _build.build_logs.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_kernel=seconds, ptxas=ptxas))
    for name, log in _build.build_logs.items():
        print(f"--- ptxas report for {name} ---\n{log}", file=sys.stderr)
    spilled = [k for r in ptxas.values() for k in r
               if k["spill_stores"] or k["spill_loads"]]
    if spilled:
        failures.append(f"ptxas reports spills: {spilled}")

    rows = kernel_phase(card, failures)
    bwd_rows = kernel_bwd_phase(card, failures)
    tiling_phase(card, failures)
    serve = serve_phase(card, failures)
    train = train_phase(card, failures)

    def main_shape(rs, heads):
        mine = [r for r in rs if r["dtype"] == "bfloat16"
                and all(r[k] == v for k, v in heads.items() if k != "dtype")]
        return mine, max(mine, key=lambda r: r["S"])

    def shape(r):
        return {k: r[k] for k in ("B", "S", "Hq", "Hkv", "D", "dtype",
                                  "causal")}

    engine_rows, at = main_shape(rows, ENGINE_HEADS)
    train_rows, bat = main_shape(bwd_rows, TRAIN_HEADS)
    src = "ray_tpu_torch/ops/csrc/"
    emit({"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention_fwd.cu",
             replaces="ray_tpu/ops/flash_attention.py:89",
             launches=serve["flash_launches"] + train["launches"]["fwd"],
             launches_by_path=dict(serve=serve["flash_launches"],
                                   train=train["launches"]["fwd"]),
             max_abs_err=max(r["max_abs_err_o"] for r in engine_rows),
             ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
             bound_by=at["bound_by"], library_ms=at["library_ms"],
             library_backend=at["library_backend"], shape=shape(at)),
        dict(name="flash_attention_dq", route="cuda",
             source=src + "flash_attention_dq.cu",
             replaces="ray_tpu/ops/flash_attention.py:107",
             launches=train["launches"]["dq"],
             launches_by_path=dict(train=train["launches"]["dq"]),
             max_abs_err=max(r["max_abs_err_dq"] for r in train_rows),
             ms=bat["dq_ms"], plain_ms=bat["plain_dq_ms"],
             bound_ms=bat["dq_bound_ms"], bound_by=bat["dq_bound_by"],
             library_ms=bat["library_ms"], library_covers="dq, dk, dv",
             library_backend=bat["library_backend"], shape=shape(bat)),
        dict(name="flash_attention_dkv", route="cuda",
             source=src + "flash_attention_dkv.cu",
             replaces="ray_tpu/ops/flash_attention.py:154",
             launches=train["launches"]["dkv"],
             launches_by_path=dict(train=train["launches"]["dkv"]),
             max_abs_err=max(max(r["max_abs_err_dk"], r["max_abs_err_dv"])
                             for r in train_rows),
             ms=bat["dkv_ms"], plain_ms=bat["plain_dkv_ms"],
             bound_ms=bat["dkv_bound_ms"], bound_by=bat["dkv_bound_by"],
             library_ms=bat["library_ms"], library_covers="dq, dk, dv",
             library_backend=bat["library_backend"], shape=shape(bat))]})
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
