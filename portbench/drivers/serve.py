"""The serving driver: one ``EngineReplica`` under open- or closed-loop
traffic.

Set-up makes the weights from the seed, builds the replica with the cell
file's ``engine`` settings, and warms the shapes this cell's traffic
reaches: one prefill per prompt bucket, and for document traffic each
document once (the cache filling that the traffic needs) and one suffix
prefill per suffix bucket. Decode runs every slot at every step, so one
decode step warms it.

The traffic runs ``ramp_s`` before the window, unmeasured, so that the
window starts at the replica's steady load (the ramp is set-up time):

- ``"loop": "open"``: requests due at the mix's Poisson times; those due
  inside the window are measured, each timed from when it was due. Load
  keeps coming after the window, unmeasured, until every measured
  request has its first token (``AFTER_S`` at most).
- ``"loop": "closed"``: ``clients`` clients, started one after another
  over the ramp, each sending its next request when its last one has
  finished; a request sent inside the window is measured, timed from its
  send, and is the window's next of the mix's requests (the ramp has its
  own sequence, so every seed's window sends the same ones in its order).

Then whatever still runs is cancelled (a request cut off so did not
fail). Time to first token is over the measured requests; the gaps
between tokens and the output tokens are those that end inside the
window, of every request.

The check (``check``): a sample drawn from the seed of the run's
finished requests, the one with the most served tokens always in it, until
``check.tokens`` served tokens; the reference runs once over each prompt
with its served tokens, and the number compared is the widest gap by which
a served token's logit lies below the reference's best at its position.
"""

from __future__ import annotations

import asyncio
import gc
import time
from typing import Dict, List

import numpy as np

from .. import flops, traffic
from .. import weights as W
from ..reference import model as ref
from .common import pctl, port_config

STREAM_OPTS = {"temperature": 0.0, "eos_id": None}
# The replica's queue: deep enough that the benchmark's load is never shed.
MAX_QUEUE = 4096
# After the window: open-loop load goes on this long, and a measured request
# without its first token by then has failed.
AFTER_S = 60.0
# The replica's private names the driver relies on until the program offers
# public ones (PERF.md, open questions): the lock that holds it between
# steps, bounding a traced slice, and the decode loop's task, ended at stop.
REPLICA_NAMES = ("_lock", "_loop_task")


def check_replica(replica) -> None:
    missing = [n for n in REPLICA_NAMES if not hasattr(replica, n)]
    if missing:
        raise RuntimeError(
            f"EngineReplica has no {', '.join(missing)}: the serving "
            f"driver needs a way to hold the replica between steps and to "
            f"end its decode loop")


class Serve:
    def __init__(self, run):
        self.r = run
        self.cell = run.cell
        self.s = run.sizes
        self.eng = dict(self.cell["engine"])
        self.max_len = int(self.eng["max_len"])
        self.replica = None
        self.records: List[dict] = []
        self.setup_info: Dict[str, float] = {}

    # ------------------------------------------------------------ set-up --
    def build(self) -> None:
        import torch
        from ray_tpu_torch.llm.serving import EngineReplica
        from ray_tpu_torch.ops import _build
        dev = self.r.device
        self.setup_info["start_s"] = time.perf_counter() - self.r.t_start
        t = time.perf_counter()
        if torch.device(dev).type == "cuda":
            built = _build.build()
            self.setup_info["kernel_build_s"] = sum(built.values())
        self.setup_info["build_call_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.params = W.make_params(self.s, self.r.seed, dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        self.setup_info["weights_s"] = time.perf_counter() - t
        cfg = port_config(self.s, self.max_len)
        self.replica = EngineReplica(
            cfg, self.params, max_batch=int(self.eng["max_batch"]),
            max_len=self.max_len, page_size=int(self.eng["page_size"]),
            kv_pages=self.eng.get("kv_pages"),
            prefix_cache=bool(self.eng.get("prefix_cache", True)),
            max_queue=MAX_QUEUE, max_tokens=16, temperature=0.0,
            eos_id=None, device=dev)
        check_replica(self.replica)
        self.docs = None if self.cell["loop"] == "open" else \
            traffic.Documents(self.cell, self.r.seed, self.s.vocab,
                              self.max_len)

    def _ids(self, n: int, salt: int) -> List[int]:
        rng = np.random.default_rng([int(self.r.seed), 7, salt])
        return rng.integers(0, self.s.vocab, n).tolist()

    async def warm(self) -> None:
        t = time.perf_counter()
        mix = self.cell
        if self.docs is None:
            lens = traffic.open_loop(mix, self.r.seed, self.r.seconds,
                                     self.s.vocab, self.max_len, 0.0)
            prompts = [len(q.prompt) for q in lens]
            for k, b in enumerate(traffic.buckets(prompts, self.max_len)):
                n = min(b, max(prompts), self.max_len - 3)
                await self.generate(self._ids(n, k), 2)
        else:
            page = int(self.eng["page_size"])
            for d in self.docs.docs:
                await self.generate(d, 1)
            suffix = [self.docs.doc_len[self.docs.doc_of[j]] % page
                      + self.docs.q_len[j] for j in range(len(self.docs))]
            doc = self.docs.docs[0]
            for k, b in enumerate(traffic.buckets(suffix, self.max_len)):
                q = max(1, min(b - len(doc) % page,
                               self.max_len - 3 - len(doc)))
                await self.generate(doc + self._ids(q, 100 + k), 2)
        self.setup_info["warm_s"] = time.perf_counter() - t

    async def generate(self, prompt, n: int) -> List[int]:
        out = []
        async for item in self.replica.stream_generate(
                prompt, {"max_tokens": n, **STREAM_OPTS}):
            if not isinstance(item, dict):
                out.append(item)
        return out

    # ------------------------------------------------------------ window --
    async def consume(self, req: traffic.Request, t_ref: float,
                      measured: bool) -> dict:
        rec = {"req": req, "t_ref": t_ref, "t_send": time.perf_counter(),
               "times": [], "tokens": [], "error": None, "finish": None,
               "measured": measured}
        self.records.append(rec)
        try:
            async for item in self.replica.stream_generate(
                    req.prompt, {"max_tokens": req.max_tokens,
                                 **STREAM_OPTS}):
                if isinstance(item, dict):
                    rec["finish"] = item
                    break
                rec["times"].append(time.perf_counter())
                rec["tokens"].append(int(item))
        except asyncio.CancelledError:
            rec["error"] = "cancelled"
            raise
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            rec["error"] = repr(e)
        return rec

    async def window(self, seconds: float, tracer=None) -> dict:
        """Run the traffic: ``ramp_s`` of it to reach a steady load, then
        the measured window. Returns the window's start and end
        (perf_counter and wall clock)."""
        from ray_tpu_torch._private import flight_recorder
        self.fr = flight_recorder.recorder()
        ramp = float(self.cell.get("ramp_s", 0.0))
        t0 = time.perf_counter() + ramp
        self.t0 = t0
        traffic_task = asyncio.ensure_future(
            self._open(t0, seconds) if self.cell["loop"] == "open"
            else self._closed(t0, t0 + seconds, ramp))
        await asyncio.sleep(max(0.0, t0 - time.perf_counter()))
        self.fr.drain()
        self.spans: List[dict] = []
        wall0 = time.time()
        trace_task = None
        if tracer is not None:
            trace_task = asyncio.ensure_future(self._trace(t0, seconds,
                                                           tracer))
        await traffic_task
        if trace_task is not None:
            await trace_task
        self.spans += self.fr.drain()
        return {"t0": t0, "t_end": t0 + seconds, "wall0": wall0,
                "wall_end": wall0 + seconds}

    async def _open(self, t0: float, seconds: float) -> None:
        reqs = traffic.open_loop(self.cell, self.r.seed, seconds,
                                 self.s.vocab, self.max_len, AFTER_S)
        tasks, late = [], []
        for q in reqs:
            now = time.perf_counter() - t0
            if q.due_s > now:
                await asyncio.sleep(q.due_s - now)
            if q.measured:
                late.append(time.perf_counter() - t0 - q.due_s)
            tasks.append(asyncio.ensure_future(
                self.consume(q, t0 + q.due_s, q.measured)))
            if q.due_s >= seconds and self._first_tokens_in():
                break
        self.late_s = late
        await self._close(tasks, t0 + seconds)

    async def _closed(self, t0: float, t_end: float, ramp: float) -> None:
        """``clients`` clients, started one after another over the ramp;
        a request is measured if it is sent inside the window, and is then
        the window's next (the ramp's next before it)."""
        nxt = {False: 0, True: 0}
        n = int(self.cell["clients"])
        tasks = []

        async def client(k):
            await asyncio.sleep(max(0.0, t0 - ramp + k * ramp / n
                                    - time.perf_counter()))
            while time.perf_counter() < t_end:
                now = time.perf_counter()
                in_ramp = now < t0
                i = nxt[in_ramp]
                nxt[in_ramp] += 1
                task = asyncio.ensure_future(self.consume(
                    self.docs.request(i, in_ramp), now, not in_ramp))
                tasks.append(task)
                await asyncio.wait([task], timeout=max(
                    0.0, t_end - time.perf_counter()))

        await asyncio.gather(*(client(k) for k in range(n)))
        self.late_s = []
        await self._close(tasks, t_end)

    def _first_tokens_in(self) -> bool:
        return all(r["times"] or r["error"] is not None
                   for r in self.measured())

    async def _close(self, tasks, t_end: float) -> None:
        """After the window: wait until every measured request has its
        first token (``AFTER_S`` at most: one that never comes has failed),
        then cancel what still runs."""
        limit = t_end + AFTER_S
        while not self._first_tokens_in() and time.perf_counter() < limit:
            await asyncio.sleep(0.01)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    async def _taken(self) -> Dict[int, int]:
        """Let every stream take the tokens already fanned out to it (the
        caller holds the replica's lock, so no step can add more), then
        count each request's tokens."""
        for _ in range(8):
            await asyncio.sleep(0)
        return {id(rec): len(rec["tokens"]) for rec in self.records}

    async def _trace(self, t0: float, seconds: float, tracer) -> None:
        """Profile ``trace_seconds`` in the window's middle. Both bounds are
        taken under the replica's lock, where no step is in flight, with
        the device synchronised."""
        import torch
        span = min(float(self.cell["trace_seconds"]), seconds)
        await asyncio.sleep(max(0.0, t0 + (seconds - span) / 2
                                - time.perf_counter()))
        async with self.replica._lock:
            torch.cuda.synchronize()
            before = await self._taken()
            self.spans += self.fr.drain()
            n_spans = len(self.spans)
            tracer.start()
        await asyncio.sleep(span)
        async with self.replica._lock:
            tracer.stop()
            after = await self._taken()
            self.spans += self.fr.drain()
        self.slice_spans = self.spans[n_spans:]
        self.slice_emitted = (before, after)

    async def stop(self) -> None:
        task = self.replica._loop_task
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    def release(self) -> None:
        import torch
        self.replica = None
        self.params = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- metrics --
    def measured(self) -> List[dict]:
        return [r for r in self.records if r["measured"]]

    def failed(self, rec: dict) -> bool:
        """A request failed if it raised, never gave a first token, or
        finished with another number of tokens than it asked for (one that
        was still generating when the run stopped did not fail)."""
        if rec["error"] not in (None, "cancelled") or not rec["times"]:
            return True
        return (rec["finish"] is not None
                and len(rec["tokens"]) != rec["req"].max_tokens)

    def finished(self) -> List[dict]:
        return [r for r in self.records if r["finish"] is not None
                and not self.failed(r)]

    def end_to_end(self, win: dict) -> Dict[str, float]:
        """TTFT over the window's requests, from when each was due (open
        loop) or sent (closed loop); the inter-token gaps and the output
        tokens of every request that end inside the window."""
        t0, t1 = win["t0"], win["t_end"]
        ok = [r for r in self.measured() if not self.failed(r)]
        ttft = [(r["times"][0] - r["t_ref"]) * 1e3 for r in ok]
        gaps = [(b - a) * 1e3 for r in self.records
                for a, b in zip(r["times"], r["times"][1:]) if t0 <= b <= t1]
        in_window = sum(1 for r in self.records for t in r["times"]
                        if t0 <= t <= t1)
        return {"ttft_p90_ms": pctl(ttft, 90), "itl_p95_ms": pctl(gaps, 95),
                "output_tokens_per_s": in_window / (t1 - t0),
                "ttft_p50_ms": pctl(ttft, 50), "itl_p50_ms": pctl(gaps, 50),
                "requests": len(ok), "gaps": len(gaps)}

    def slice_work(self) -> dict:
        """The slice's model FLOPs (prefills from their spans, decodes from
        each request's tokens emitted between the two boundaries), and the
        full prefills' real lengths (kernel 1's work)."""
        s = self.s
        before, after = self.slice_emitted
        total = 0.0
        full = []
        for sp in self.slice_spans:
            if sp["name"] != "prefill":
                continue
            a = sp.get("args") or {}
            total += flops.prefill_flops(s, a["tokens"], a["cached_tokens"])
            if a["cached_tokens"] == 0 and not a.get("chunked"):
                full.append(a["tokens"])
        for rec in self.records:
            e0, e1 = before.get(id(rec), 0), after.get(id(rec), 0)
            p = len(rec["req"].prompt)
            for k in range(max(2, e0 + 1), e1 + 1):
                total += flops.decode_flops(s, p + k - 1)
        return {"model_flops": total, "full_prefills": full}

    # ------------------------------------------------------------- check --
    def sample(self) -> List[dict]:
        ok = self.finished()
        if not ok:
            return []
        chk = self.cell["check"]
        rng = np.random.default_rng([int(self.r.seed), 11])
        longest = max(ok, key=lambda r: (len(r["tokens"]),
                                         len(r["req"].prompt)))
        rest = [r for r in ok if r is not longest]
        picked = [longest]
        for j in rng.permutation(len(rest)):
            if sum(len(r["tokens"]) for r in picked) >= int(chk["tokens"]):
                break
            picked.append(rest[j])
        return picked

    def reference_gaps(self, picked: List[dict], control: bool = False
                       ) -> Dict[str, float]:
        """The widest gap of the served tokens below the f32 reference's
        best logit; with ``control``, also the widest gap of the tokens
        that an fp8 reference puts first at the same positions."""
        import torch
        ref.no_tf32()
        dev = self.r.device
        layers = ref.Layers(self.s, self.r.seed, dev)
        out = {"logit_gap": 0.0, "served_tokens": 0}
        if control:
            out["control_gap"] = 0.0
        for rec in picked:
            p, toks = rec["req"].prompt, rec["tokens"]
            seq = list(p) + toks[:-1]
            rows = list(range(len(p) - 1, len(seq)))
            lg = ref.logits_at(self.s, layers, [seq], [rows])[0]
            served = torch.as_tensor(toks, device=lg.device)
            best = lg.max(-1).values
            gap = best - lg.gather(1, served[:, None])[:, 0]
            out["logit_gap"] = max(out["logit_gap"], float(gap.max()))
            out["served_tokens"] += len(toks)
            if control:
                lq = ref.logits_at(self.s, layers, [seq], [rows],
                                   quant=ref.fp8)[0]
                pick = lq.argmax(-1)
                cg = best - lg.gather(1, pick[:, None])[:, 0]
                out["control_gap"] = max(out["control_gap"],
                                         float(cg.max()))
            del lg
        return out


def run(r) -> dict:
    """One run of a serving cell: the harness's contract for a driver."""
    import torch
    sv = Serve(r)
    out: dict = {}

    async def main():
        sv.build()
        await sv.warm()
        tracer = None
        if r.trace:
            from ..trace import Slice
            tracer = Slice(torch)
            tracer.warm()
        win = await sv.window(r.seconds, tracer)
        out["setup_s"] = win["t0"] - r.t_start
        out["window"] = win
        await sv.stop()
        out["tracer"] = tracer

    asyncio.run(main())
    win = out["window"]
    res = {"setup_s": out["setup_s"], "setup_info": sv.setup_info,
           "end_to_end": sv.end_to_end(win),
           "attempted": len(sv.measured()),
           "failed": sum(1 for rec in sv.measured() if sv.failed(rec)),
           "late_s_max": max(sv.late_s) if sv.late_s else 0.0,
           "window_s": win["t_end"] - win["t0"]}
    if r.trace:
        lo, hi = win["wall0"] * 1e6, win["wall_end"] * 1e6
        res["trace"] = {"tracer": out["tracer"],
                        "spans": [sp for sp in sv.spans
                                  if lo <= sp["start_us"] <= hi],
                        "slice_spans": sv.slice_spans,
                        "work": sv.slice_work(),
                        "recorder": sv.fr.stats()}
    res["memory_peak_bytes"] = r.memory_peak()
    picked = sv.sample()
    sv.release()
    gaps = sv.reference_gaps(picked)
    limit = float(r.cell["check"]["limit"]["logit_gap"])
    res["checks"] = [("logit_gap", gaps["logit_gap"], limit)]
    res["check_info"] = {"served_tokens_compared": gaps["served_tokens"],
                         "requests_compared": len(picked)}
    if not picked:
        res["checks"].append(("no_request_finished", 1, 0))
    return res
