#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line on stdout:

1. device: the card's name and power limit (nvidia-smi), TF32 switched off.
2. build: every kernel under ray_tpu_torch/ops/csrc built with nvcc for
   sm_90a (the ptxas report goes to stderr).
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card, o and lse, at the engine's prefill shapes and at
   f32 / non-causal / D=64 / GQA / ragged shapes; kernel, plain and
   scaled_dot_product_attention times (the last only as a yardstick).
4. serve: Llama-3-8B-GQA at full width and depth with random weights,
   four greedy requests through LLMEngine; checks tokens, the kernel's
   launch count and each prompt's prefill logits against forward() with
   plain attention.

Then the kernels line, the card line and, last, the ok line. Any failure
exits non-zero without the ok line, as does a machine without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.models import PRESETS, forward, init_params
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                               reference_attention_lse)

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
PROMPT_LENS = (37, 300, 1000, 1900)
MAX_TOKENS = 16


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


def attention_bound(B, S, Hq, Hkv, D, dtype, causal):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate of the type and the bytes (q, k, v, o once each, plus lse) over
    the memory rate."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * Hq * D * pairs
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * B * S * D * (2 * Hq + 2 * Hkv) + 4 * B * Hq * S
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
        row = dict(
            phase="kernel", name="flash_attention_fwd", B=B, S=S, Hq=Hq,
            Hkv=Hkv, D=D, dtype=str(dtype).replace("torch.", ""),
            causal=causal, max_abs_err_o=err_o, max_abs_err_lse=err_lse,
            tol_o=tol["o"], tol_lse=tol["lse"], ok=ok,
            ms=time_ms(lambda: flash_attention_fwd(q, k, v,
                                                      causal=causal)),
            plain_ms=time_ms(lambda: reference_attention_lse(
                q, k, v, causal=causal)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            bound_ms=bound_ms, bound_by=bound_by, card=card)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"kernel mismatch: {row}")
    return rows


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
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_kernel=seconds))
    for name, log in _build.build_logs.items():
        print(f"--- ptxas report for {name} ---\n{log}", file=sys.stderr)

    rows = kernel_phase(card, failures)
    serve = serve_phase(card, failures)

    engine_rows = [r for r in rows
                   if all(r[k] == v for k, v in ENGINE_HEADS.items()
                          if k != "dtype")
                   and r["dtype"] == "bfloat16"]
    at = max(engine_rows, key=lambda r: r["S"])
    emit({"kernels": [dict(
        name="flash_attention_fwd", route="cuda",
        source="ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:89",
        launches=serve["flash_launches"],
        max_abs_err=max(r["max_abs_err_o"] for r in engine_rows),
        ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
        bound_by=at["bound_by"], library_ms=at["library_ms"],
        shape=dict(B=at["B"], S=at["S"], Hq=at["Hq"], Hkv=at["Hkv"],
                   D=at["D"], dtype=at["dtype"], causal=at["causal"]))]})
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
