"""Engine and device-plane microbenchmarks of the port.

A port of the engine and device-plane rows of ray_tpu/util/perf.py: the
same 13 row names, return keys and offered traffic, run on the port's
engine, serving replica and device plane. Run as ``python -m
ray_tpu_torch.util.perf --preset 8b-gqa`` (one JSON line), or call
``run_microbenchmarks``.

Each row takes the reference's ``min_time_s`` and the keyword arguments
``cfg`` (a preset name or a ``TransformerConfig``, default ``"tiny"``),
``params`` (default: ``init_params`` of the config from seed 0, shared by
every engine of a row) and ``device`` (default ``"cuda"``, which raises
without a card; nothing falls back to the CPU). Rows time with ``_timeit``,
whose every batch ends synchronised with the device, as the reference's
``block_until_ready`` does.

The runtime services the reference reaches (Serve, actors, compiled DAGs,
``ray_tpu.put``/``get``) are replaced by the port's in-process
counterparts, as the rest of the port takes runtime services as callbacks:

  - serving: one ``EngineReplica`` on an event loop of its own thread (the
    reference's one-replica deployment; ``llm.serve_patterns.Hosted``,
    the host the serving apps use), fed by ``run_open_loop``;
  - P/D: the port's ``CompiledPDApp``, as the reference's row builds its
    own: a prefill and a decode replica on one set of params, each on a
    loop of its own; the lane's edge carries the KV blob through the
    port's serializer into a host buffer and back onto the device (rung 1,
    the path between processes);
  - the device channel: per step, ``dag_encode_body``/``dag_decode_body``
    carry the payload through a host buffer, as a compiled edge's ring
    does (rung 0 for the device payload, a token);
  - the KV handoff: the blob through the serializer into a pinned host
    buffer made once (the arena) and deserialised onto the device;
  - the prefix-cache and long-context rows run in this process: the port
    has no XLA flags to set, so no subprocess is needed.

Diverges from the reference on failure: the reference turns a failed row
into 0.0 (a bench must never sink the suite). Here a row raises: when its
engine raises, when a request of its open loop errs, is shed, breaks or
does not finish, or returns fewer than ``max_tokens`` tokens, and when the
device channel leaves a rung-0 token registered. It never returns 0.0 for
a failure.

Not ported, because they are runtime code that imports no JAX: the task,
actor, put/get, framer, DAG, placement-group, GCS-failover and
oversubscribed-put rows; ``BASELINE`` and ``vs_ref`` (a 64-core node's
numbers); ``_latest_committed_bench``, the host fingerprint and
``check_against_committed``; the recorder and diagnosis A/Bs,
``warmup_cluster`` and ``_session_cpu_by_role``.
"""

from __future__ import annotations

import functools
import json
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from .._private import device_plane, serialization
from ..llm.engine import LLMEngine, SamplingParams
from ..llm.sequence_parallel import _bench_setup as _setup
from ..llm.sequence_parallel import _sync
from ..llm.serve_patterns import CompiledPDApp, Hosted, _host_buffer, _landing
from ..llm.serving import EngineReplica, run_open_loop
from ..models import PRESETS


def _timeit(run_batch: Callable[[], int], min_time_s: float,
            windows: int = 1, device: torch.device = torch.device("cpu")
            ) -> float:
    """ops/s of run_batch (returns #ops) repeated for >= min_time_s; each
    batch ends synchronised with ``device``.

    windows > 1: measure that many back-to-back windows and report the
    BEST — used for the bandwidth benches, where a noisy co-tenant
    stealing the (often single) core mid-window otherwise produces a
    reading far below what the runtime sustains."""
    run_batch()  # warmup
    _sync(device)

    def one_window():
        total_ops = 0
        t0 = time.perf_counter()
        while True:
            total_ops += run_batch()
            _sync(device)
            dt = time.perf_counter() - t0
            if dt >= min_time_s:
                return total_ops / dt

    return max(one_window() for _ in range(max(1, windows)))


# One run of a report feeds its rows (the reference caches per process);
# ``run_microbenchmarks`` starts each run with an empty cache.
_reports: Dict[tuple, Dict[str, Any]] = {}


def _cached(name: str):
    def wrap(fn):
        @functools.wraps(fn)
        def report(min_time_s: float, *, cfg="tiny", params=None,
                   device="cuda") -> Dict[str, Any]:
            key = (name, float(min_time_s),
                   cfg if isinstance(cfg, str) else id(cfg), id(params),
                   str(device))
            if key not in _reports:
                _reports[key] = fn(min_time_s,
                                   *_setup(cfg, params, device))
            return _reports[key]
        return report
    return wrap


# ---------------------------------------------------------------------------
# LLM serving open-loop benches: one continuous-batching EngineReplica
# (the reference's one-replica deployment: max_len 64, 16 tokens, pages
# of 8), an arrival-rate-driven load (OPEN loop — the next request goes
# out on schedule whether or not earlier ones finished), TTFT and
# tokens/s. The P/D pair takes the same traffic.

_MAX_TOKENS = 16
_OPTS = {"max_tokens": _MAX_TOKENS}
_WARM_PROMPT = [1, 2, 3]


def _prompt(i: int):
    return [(i % 37) + 1, (i % 11) + 2, 7]


def _drain(stream, what: str) -> int:
    """Consume one stream of the submit contract; raise unless it gave
    ``_MAX_TOKENS`` tokens."""
    n = sum(1 for item in stream if not isinstance(item, dict))
    if n != _MAX_TOKENS:
        raise RuntimeError(f"{what}: the warm-up request gave {n} tokens, "
                           f"not {_MAX_TOKENS}")
    return n


def _check_open_loop(rep: Dict[str, Any], what: str) -> None:
    """Raise unless every offered request was served in full: none shed,
    broken, failed or unfinished, each with ``_MAX_TOKENS`` tokens."""
    bad = {k: rep[k] for k in ("shed", "broken", "unfinished") if rep[k]}
    if rep["errors"]:
        bad["errors"] = rep["errors"][:3]
    if rep["completed"] != rep["offered"]:
        bad["completed"] = f"{rep['completed']} of {rep['offered']}"
    if rep["tokens_total"] != rep["completed"] * _MAX_TOKENS:
        bad["tokens_total"] = (f"{rep['tokens_total']}, not "
                               f"{rep['completed']} x {_MAX_TOKENS}")
    if bad:
        raise RuntimeError(f"{what}: the open loop did not serve every "
                           f"request in full: {bad}")


def _open_loop(submit, min_time_s: float, what: str) -> Dict[str, Any]:
    """A warm-up request, then the reference's traffic: 4 Hz for
    max(4, min_time_s) s of 3-token prompts."""
    _drain(submit(_WARM_PROMPT), what)
    rep = run_open_loop(submit, rate_hz=4.0,
                        duration_s=max(4.0, min_time_s),
                        prompt_fn=_prompt, num_replicas=1)
    _check_open_loop(rep, what)
    return rep


@_cached("serving")
def _serving_report(min_time_s, cfg, params, device) -> Dict[str, Any]:
    srv = Hosted(EngineReplica(cfg, params, max_len=64,
                               max_tokens=_MAX_TOKENS, page_size=8, seed=0,
                               device=device))
    try:
        def submit(p):
            return srv.stream(srv.replica.stream_generate(p, _OPTS))

        ol = _open_loop(submit, min_time_s, "serving")
    finally:
        srv.shutdown()
    return {"serving_ttft_p50_ms": ol["ttft_p50_ms"],
            "serving_tokens_per_s_per_replica":
                ol["tokens_per_s_per_replica"],
            "open_loop": ol}


def bench_serving_ttft(min_time_s: float, **kw) -> float:
    return _serving_report(min_time_s, **kw)["serving_ttft_p50_ms"]


def bench_serving_tokens_per_s(min_time_s: float, **kw) -> float:
    return _serving_report(min_time_s, **kw)[
        "serving_tokens_per_s_per_replica"]


# P/D serving bench: the open-loop harness against the CompiledPDApp
# (prefill_handoff_channel, the lane's edge, then admit_external and
# collect_stream), recorded next to the colocated serving_* rows, which is
# its A/B.

def _pd_app(cfg, params, device) -> CompiledPDApp:
    """The reference's bench app: one prefill and one decode replica
    (max_batch 1 and 4, max_len 64, pages of 8, the prefix cache on), each
    hosted on its own loop, on one set of params."""
    return CompiledPDApp(cfg, params, prefill_replicas=1, decode_replicas=1,
                         max_len=64, page_size=8, device=device)


def _pd_pair(cfg, params, device):
    """(prefill host, decode host) of ``_pd_app``; shutting both down
    shuts the app down."""
    app = _pd_app(cfg, params, device)
    return app.prefills[0], app.decodes[0]


def _pd_stream(pre: Hosted, dec: Hosted, prompt):
    """The submit contract over the pair: the prefill replica's handoff
    (a handle to the blob in its host buffers), admitted into the decode
    replica's batch, then its stream."""
    handoff = pre.call(pre.replica.prefill_handoff({"prompt": list(prompt),
                                                    "opts": _OPTS}))
    rid = dec.call(dec.replica.admit_external(handoff))
    yield from dec.stream(dec.replica.collect_stream(rid))


@_cached("pd_serving")
def _pd_serving_report(min_time_s, cfg, params, device) -> Dict[str, Any]:
    app = _pd_app(cfg, params, device)
    try:
        ol = _open_loop(lambda p: app.stream(p, _OPTS), min_time_s,
                        "pd serving")
    finally:
        app.shutdown()
    return {"serving_pd_ttft_p50_ms": ol["ttft_p50_ms"],
            "serving_pd_tokens_per_s_per_replica":
                ol["tokens_per_s_per_replica"],
            "open_loop": ol}


def bench_pd_serving_ttft(min_time_s: float, **kw) -> float:
    return _pd_serving_report(min_time_s, **kw)["serving_pd_ttft_p50_ms"]


def bench_pd_serving_tokens_per_s(min_time_s: float, **kw) -> float:
    return _pd_serving_report(min_time_s, **kw)[
        "serving_pd_tokens_per_s_per_replica"]


# ---------------------------------------------------------------------------
# Prefix-cache hit rate under cyclic pool squeezes, demotion on vs off
# (the same workload): the A/B that justifies the KV offload tier —
# evicted prefix pages demote to host memory and promote back on reuse
# instead of re-running prefill. The reference runs its script in a
# subprocess; this is that script's sequence, in process.

def _kv_pressure_stats(cfg, params, device, demote: bool) -> Dict[str, Any]:
    eng = LLMEngine(cfg, params, max_batch=2, max_len=64, page_size=8,
                    kv_pages=16, prefix_cache=True, seed=0, device=device)
    if not demote:
        eng._demote = None
    # Two 3-page prefix families; admitting one under a squeeze must
    # evict (demote) the other's cached prefix, so every restore-phase
    # reuse either promotes from the demote store or re-prefills.
    A = list(range(1, 25))
    B = list(range(50, 74))
    sp = SamplingParams(max_tokens=2)
    eng.generate([A + [100]], sp)
    for i in range(1, 6):
        eng.apply_pool_pressure(0.25)
        eng.generate([B + [100 + i]], sp)
        eng.apply_pool_pressure(1.0)
        eng.generate([A + [100 + i]], sp)
    return eng.prefix_cache_stats()


def _hit_rate(st: Dict[str, Any]) -> float:
    tot = st["hits"] + st["misses"]
    return st["hits"] / tot if tot else 0.0


@_cached("kv_pressure")
def _kv_pressure_report(min_time_s, cfg, params, device) -> Dict[str, Any]:
    on = _kv_pressure_stats(cfg, params, device, True)
    off = _kv_pressure_stats(cfg, params, device, False)
    return {"prefix_cache_hit_rate_under_pressure": _hit_rate(on),
            "prefix_cache_hit_rate_nodemote": _hit_rate(off),
            "with_demotion": on, "without_demotion": off}


def bench_prefix_cache_hit_rate_under_pressure(min_time_s: float,
                                               **kw) -> float:
    return _kv_pressure_report(min_time_s, **kw)[
        "prefix_cache_hit_rate_under_pressure"]


def bench_prefix_cache_hit_rate_nodemote(min_time_s: float, **kw) -> float:
    """Ungated A/B reference row: the SAME squeezed workload with the
    demote store disabled — what the gated row is read against to see
    the KV offload tier's win."""
    return _kv_pressure_report(min_time_s, **kw)[
        "prefix_cache_hit_rate_nodemote"]


# ---------------------------------------------------------------------------
# Long-context benches: sequence-parallel prefill tokens/s (degree 1 vs
# 4 A/B) and paged cross-host TTFT, from the sequence_parallel bench
# entry with the reference's arguments (degree 4, 512 tokens), in
# process. On one card the sp mesh names the card four times, so the
# shards take turns and sp_speedup reads the mechanism's cost.

@_cached("long_context")
def _long_context_report(min_time_s, cfg, params, device) -> Dict[str, Any]:
    from ..llm.sequence_parallel import _bench_rows
    return _bench_rows(degree=4, tokens=512, strategy="ring",
                       iters=max(2, int(min_time_s)), cfg=cfg,
                       params=params, device=device)


def bench_sp_prefill_tokens_per_s(min_time_s: float, **kw) -> float:
    return _long_context_report(min_time_s, **kw)["sp_prefill_tokens_per_s"]


def bench_sp_prefill_base(min_time_s: float, **kw) -> float:
    """Ungated A/B reference row: the SAME prompt through the
    single-device _prefill_fn (sp_degree=1), in the same run."""
    return _long_context_report(min_time_s, **kw)[
        "sp_prefill_tokens_per_s_base"]


def bench_long_context_ttft(min_time_s: float, **kw) -> float:
    return _long_context_report(min_time_s, **kw)["long_context_ttft_ms"]


def bench_long_context_ttft_staged(min_time_s: float, **kw) -> float:
    """Ungated A/B reference row: the SAME paged-KV serve path with the
    legacy host-staged downgrade (every stripe round-trips through host
    numpy, publish pipelining off) — what long_context_ttft_ms is read
    against to see the device-direct data plane's win."""
    return _long_context_report(min_time_s, **kw)[
        "long_context_ttft_staged_ms"]


# ---------------------------------------------------------------------------
# Device-channel bench: a same-process edge carrying a DEVICE tensor
# payload (rung 0 of the transport ladder — the message is an 8-byte
# token, the tensor never leaves the device) A/B'd against the same edge
# carrying a same-size host numpy payload through a host buffer. Each
# step encodes the payload into the buffer, decodes it and reads its
# shape (the reference's tail stage).

_DEV_PAYLOAD_ELEMS = 1 << 20            # 4 MiB float32 per step


def _channel_step(ctx, payload, buf: memoryview):
    """One step of the edge: the DAG body of ``payload`` written into
    ``buf`` and decoded from it; returns the decoded value."""
    parts, _token = device_plane.dag_encode_body(ctx, b"\x00", payload,
                                                 local_ok=True, nreaders=1)
    n = serialization.write_parts_into(parts, buf)
    return device_plane.dag_decode_body(ctx, buf[:n])


@_cached("device_channel")
def _device_channel_report(min_time_s, cfg, params, device
                           ) -> Dict[str, Any]:
    n_el = _DEV_PAYLOAD_ELEMS
    ctx = serialization.get_context()
    buf = _host_buffer(n_el * 4 + (1 << 16), device)
    payloads = {"dev": torch.arange(n_el, dtype=torch.float32,
                                    device=device),
                "host": np.arange(n_el, dtype=np.float32)}
    registered = device_plane.local_registry_size()
    out: Dict[str, Any] = {}
    for kind, row in (("dev", "device_channel_steps_per_s"),
                      ("host", "device_channel_steps_per_s_host")):
        payload = payloads[kind]

        def run(payload=payload, kind=kind):
            n = 30
            for _ in range(n):
                tail = int(_channel_step(ctx, payload, buf).shape[0])
                if tail != n_el:
                    raise RuntimeError(f"device channel ({kind}): a step "
                                       f"gave {tail} elements, not {n_el}")
            return n

        out[row] = _timeit(run, min_time_s, windows=2, device=device)
    left = device_plane.local_registry_size() - registered
    if left:
        raise RuntimeError(f"device channel: {left} rung-0 tokens were "
                           f"left registered")
    return out


def bench_device_channel_steps(min_time_s: float, **kw) -> float:
    return _device_channel_report(min_time_s, **kw)[
        "device_channel_steps_per_s"]


def bench_device_channel_steps_host(min_time_s: float, **kw) -> float:
    """Ungated A/B base: the same edge, payload staged through the host
    buffer as host numpy (what every edge paid before the device
    plane)."""
    return _device_channel_report(min_time_s, **kw)[
        "device_channel_steps_per_s_host"]


def _kv_blob(chunk_mb: int, device: torch.device) -> Dict[str, Any]:
    half = (chunk_mb << 20) // 8           # elements per array, 2 arrays
    return {"k": torch.arange(half, dtype=torch.float32, device=device),
            "v": torch.arange(half, dtype=torch.float32, device=device),
            "len": half}


def _kv_handoff_round(ctx, blob, buf: memoryview, device: torch.device):
    """The blob through the serializer into ``buf`` and back onto
    ``device``, synchronised; returns the rebuilt blob."""
    n = serialization.write_parts_into(ctx.serialize(blob), buf)
    with _landing(device):
        out = ctx.deserialize(buf[:n])
    _sync(device)
    return out


def bench_kv_handoff_gibs(min_time_s: float, chunk_mb: int = 64, *,
                          cfg="tiny", params=None, device="cuda") -> float:
    """GiB/s of a device-resident KV blob through the object plane's data
    path — the P/D prefill→decode handoff seam: the serializer stages
    each tensor exactly once into the buffer (pickle-5 out-of-band
    buffers, no intermediate copy), and the far side uploads it straight
    from the buffer onto the device. The buffer is pinned host memory
    made once, standing in for the arena."""
    dev = resolve_device(device)
    blob = _kv_blob(chunk_mb, dev)
    ctx = serialization.get_context()
    buf = _host_buffer((chunk_mb << 20) + (1 << 16), dev)

    def run():
        n = 3
        for _ in range(n):
            _kv_handoff_round(ctx, blob, buf, dev)
        return n
    run()                                  # extra warm: first-touch buffer
    chunks_per_s = _timeit(run, min_time_s, windows=2, device=dev)
    return chunks_per_s * chunk_mb / 1024.0


BENCHES: Dict[str, Callable[..., float]] = {
    # name -> bench fn, in the reference's order; units live in UNITS.
    "serving_ttft_p50_ms": bench_serving_ttft,
    "serving_tokens_per_s_per_replica": bench_serving_tokens_per_s,
    "serving_pd_ttft_p50_ms": bench_pd_serving_ttft,
    "serving_pd_tokens_per_s_per_replica": bench_pd_serving_tokens_per_s,
    "sp_prefill_tokens_per_s": bench_sp_prefill_tokens_per_s,
    "sp_prefill_tokens_per_s_base": bench_sp_prefill_base,
    "long_context_ttft_ms": bench_long_context_ttft,
    "long_context_ttft_staged_ms": bench_long_context_ttft_staged,
    "device_channel_steps_per_s": bench_device_channel_steps,
    "device_channel_steps_per_s_host": bench_device_channel_steps_host,
    "kv_handoff_gibs": bench_kv_handoff_gibs,
    "prefix_cache_hit_rate_under_pressure":
        bench_prefix_cache_hit_rate_under_pressure,
    "prefix_cache_hit_rate_nodemote": bench_prefix_cache_hit_rate_nodemote,
}

# Rows that run no model: they need no params.
_NO_MODEL = frozenset({"device_channel_steps_per_s",
                       "device_channel_steps_per_s_host",
                       "kv_handoff_gibs"})

UNITS = {
    "serving_ttft_p50_ms": "ms p50 TTFT (open-loop, lower is better)",
    "serving_tokens_per_s_per_replica": "tok/s/replica (open-loop)",
    "serving_pd_ttft_p50_ms":
        "ms p50 TTFT (P/D replica pair, lower is better)",
    "serving_pd_tokens_per_s_per_replica":
        "tok/s/replica (P/D replica pair, open-loop)",
    "sp_prefill_tokens_per_s":
        "tok/s (ring-attention prefill, sp_degree=4, the shards on one "
        "card in turn)",
    "sp_prefill_tokens_per_s_base":
        "tok/s (same prompt, sp_degree=1 — the A/B base, ungated)",
    "long_context_ttft_ms":
        "ms TTFT (paged cross-host KV path, lower is better)",
    "long_context_ttft_staged_ms":
        "ms TTFT (same path, host-staged KV downgrade — the A/B base, "
        "ungated)",
    "device_channel_steps_per_s":
        "steps/s (same-process edge, 4 MiB DEVICE payload — rung 0, zero "
        "host bytes)",
    "device_channel_steps_per_s_host":
        "steps/s (same edge, 4 MiB host payload via a host buffer — the "
        "A/B base, ungated)",
    "kv_handoff_gibs":
        "GiB/s (device KV blob through the serializer — single-copy "
        "staging + upload)",
    "prefix_cache_hit_rate_under_pressure":
        "hit rate 0..1 (shared-prefix workload, cyclic pool squeeze, "
        "KV demotion on)",
    "prefix_cache_hit_rate_nodemote":
        "hit rate 0..1 (same workload, demotion off — the A/B base, "
        "ungated)",
}

# The reference's metric groups, cut down to these rows.
SERVING_METRICS = (
    "serving_ttft_p50_ms",
    "serving_tokens_per_s_per_replica",
    "serving_pd_ttft_p50_ms",
    "serving_pd_tokens_per_s_per_replica",
)

LONG_CONTEXT_METRICS = (
    "sp_prefill_tokens_per_s",
    "long_context_ttft_ms",
)

DEVICE_PLANE_METRICS = (
    "device_channel_steps_per_s",
    "kv_handoff_gibs",
)

MEMORY_TIER_METRICS = (
    "prefix_cache_hit_rate_under_pressure",
)

# Metrics where SMALLER readings are better (latencies).
LOWER_IS_BETTER = frozenset({"serving_ttft_p50_ms",
                             "serving_pd_ttft_p50_ms",
                             "long_context_ttft_ms",
                             "long_context_ttft_staged_ms"})


def run_microbenchmarks(min_time_s: float = 1.0, only=None, *, cfg="tiny",
                        params=None, device="cuda",
                        details: Optional[dict] = None
                        ) -> Dict[str, Dict[str, Any]]:
    """{name: {"value", "unit"}} of the rows of ``BENCHES`` (those named in
    ``only``, where given), in order, on one set of params. ``details``, a
    dict, receives each report's whole result under its name ("serving",
    "pd_serving", "long_context", "device_channel", "kv_pressure"): the
    open-loop reports, the hit and miss counts."""
    _reports.clear()
    names = [n for n in BENCHES if not only or n in only]
    cfg = PRESETS[cfg] if isinstance(cfg, str) else cfg
    dev = resolve_device(device)
    if params is None and any(n not in _NO_MODEL for n in names):
        _, params, _ = _setup(cfg, None, dev)
    results: Dict[str, Dict[str, Any]] = {}
    for name in names:
        value = BENCHES[name](min_time_s, cfg=cfg, params=params,
                              device=dev)
        results[name] = {"value": round(value, 2), "unit": UNITS[name]}
    if details is not None:
        details.update({key[0]: rep for key, rep in _reports.items()})
    return results


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-time-s", type=float, default=2.0)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", nargs="*", default=None,
                    help="row names to run (default: every row)")
    args = ap.parse_args(argv)
    print(json.dumps(run_microbenchmarks(args.min_time_s, only=args.only,
                                         cfg=args.preset,
                                         device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
