#!/usr/bin/env python3
"""Compare three wirings of the P/D serving row on one CUDA card.

Run from the repository root on a machine with one card:

    python3 perf_pd_routes.py

Runs ``ray_tpu_torch.util.perf``'s P/D open loop (the reference's
traffic: 4 Hz of 3-token prompts, 16 tokens each) on PRESETS["8b-gqa"]'s
seed-0 weights over three wirings of one prefill and one decode
``EngineReplica``, each replica on an event loop of its own:

  - ``channel``: replicas built with the serializer's channel callbacks
    (``serve_patterns._channel_callbacks``): the prefill replica publishes
    the blob into a host buffer, the decode replica resolves it;
  - ``app``: ``CompiledPDApp.stream`` (the row's own path): the lane
    carries the blob from ``prefill_handoff_channel`` to
    ``admit_external``;
  - ``handle``: ``perf._pd_stream`` over the app's two hosts: a
    ``HostRef`` into the prefill host's buffers, resolved by the decode
    replica.

Each wiring runs three times, interleaved. Prints one JSON line per run
(TTFT and inter-token p50/p99, tokens/s, peak in flight) and the card's
name and power limit.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke
from ray_tpu_torch.llm.serve_patterns import Hosted, _channel_callbacks
from ray_tpu_torch.llm.serving import EngineReplica
from ray_tpu_torch.util import perf

ORDER = ("channel", "app", "handle", "handle", "app", "channel",
         "app", "channel", "handle")


def _channel_pair(cfg, params, device):
    publish, resolve = _channel_callbacks(device)
    common = dict(max_len=64, page_size=8, seed=0, prefix_cache=True,
                  max_queue=64, device=device)
    return (Hosted(EngineReplica(cfg, params, max_batch=1, publish=publish,
                                 **common)),
            Hosted(EngineReplica(cfg, params, max_batch=4, resolve=resolve,
                                 **common)))


def run(kind: str, cfg, params, device) -> dict:
    if kind == "app":
        app = perf._pd_app(cfg, params, device)
        hosts = app.prefills + app.decodes

        def submit(p):
            return app.stream(p, perf._OPTS)
    else:
        hosts = (_channel_pair if kind == "channel" else perf._pd_pair)(
            cfg, params, device)

        def submit(p):
            return perf._pd_stream(*hosts, p)
    try:
        ol = perf._open_loop(submit, 1.0, f"pd {kind}")
    finally:
        for h in hosts:
            h.shutdown()
    return dict(kind=kind, **{k: ol[k] for k in (
        "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms",
        "tokens_per_s_per_replica", "max_inflight")})


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_pd_routes: needs one CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke._build.build()
    params, _ = chip_smoke.serve_params()
    cfg = chip_smoke.PRESETS["8b-gqa"]
    for kind in ORDER:
        print(json.dumps(run(kind, cfg, params, torch.device("cuda", 0))),
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
