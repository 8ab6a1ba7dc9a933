#!/usr/bin/env python3
"""Break the P/D serving row's TTFT into its stages on one CUDA card.

Run from the repository root on a machine with one card:

    python3 perf_pd_stages.py

Runs ``ray_tpu_torch.util.perf``'s P/D pair (a prefill and a decode
``EngineReplica`` on PRESETS["8b-gqa"]'s seed-0 weights, the reference's
open-loop traffic) three times, sides alternated: each replica on an
event loop of its own (the module's hosting) and both replicas on one
loop. Per request it keeps the host time of the prefill handoff, of the
admission into the decode replica and from the admission to the first
token; per call, the host time of the prefill engine's ``prefill_only``,
of the serializer's publish and resolve and of each decode step. Prints
one JSON line per run (medians, the warm-up request left out) and the
card's name and power limit.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import types

import numpy as np
import torch

import chip_smoke
from ray_tpu_torch.util import perf


def _timed(obj, name: str, into: list) -> None:
    """Keep each call's host ms of ``obj.name`` in ``into``."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)
    setattr(obj, name, timed)


def _staged_stream(pre, dec, prompt, stages: list, lock):
    """``perf._pd_stream`` with the request's stage times kept."""
    t0 = time.perf_counter()
    handoff = pre.call(pre.replica.prefill_handoff(
        {"prompt": list(prompt), "opts": perf._OPTS}))
    t1 = time.perf_counter()
    rid = dec.call(dec.replica.admit_external(handoff))
    t2 = time.perf_counter()
    first = True
    for item in dec.stream(dec.replica.collect_stream(rid)):
        if first:
            first = False
            with lock:
                stages.append(dict(
                    prefill_handoff_ms=(t1 - t0) * 1e3,
                    admit_ms=(t2 - t1) * 1e3,
                    first_after_admit_ms=(time.perf_counter() - t2) * 1e3))
        yield item


def run(cfg, params, shared_loop: bool) -> dict:
    pre, dec = perf._pd_pair(cfg, params, "cuda")
    # One loop: the decode replica's coroutines run on the prefill's loop.
    on = (types.SimpleNamespace(replica=dec.replica, call=pre.call,
                                stream=pre.stream) if shared_loop else dec)
    calls = {"prefill_only": [], "publish": [], "resolve": [], "step": []}
    _timed(pre.replica.engine, "prefill_only", calls["prefill_only"])
    _timed(pre.replica, "_publish_fn", calls["publish"])
    _timed(dec.replica, "_resolve", calls["resolve"])
    _timed(dec.replica.engine, "step", calls["step"])
    stages, lock = [], threading.Lock()
    try:
        ol = perf._open_loop(
            lambda p: _staged_stream(pre, on, p, stages, lock), 1.0,
            "pd stages")
    finally:
        pre.close()
        dec.close()
    return dict(
        shared_loop=shared_loop,
        **{k: ol[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                              "tokens_per_s_per_replica", "max_inflight")},
        stages_p50_ms={k: float(np.median([r[k] for r in stages[1:]]))
                       for k in stages[0]},
        first_after_admit_ms=[round(r["first_after_admit_ms"], 1)
                              for r in stages[1:]],
        calls_p50_ms={k: float(np.median(v[1:])) for k, v in calls.items()},
        calls=({k: len(v) for k, v in calls.items()}))


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_pd_stages: needs one CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke._build.build()
    params, _ = chip_smoke.serve_params()
    cfg = chip_smoke.PRESETS["8b-gqa"]
    for shared in (False, True, False):
        print(json.dumps(run(cfg, params, shared)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
