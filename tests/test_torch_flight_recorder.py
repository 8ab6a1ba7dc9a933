"""Parity of ray_tpu_torch's flight recorder, and of the engine's spans, with
the JAX package's on the CPU.

The recorder is a process singleton on both sides and the suite runs test
files in worker processes that import every file, so each test here swaps
both singletons for capturing recorders and restores them after (as
tests/test_llm_serving.py does). A JAX cluster left running in the same
worker by an earlier test file drains the JAX singleton every second, so a
capturing recorder's ``drain()`` yields nothing and the test reads
``rows()``. Other JAX code left running in the worker writes rows of other
categories into the JAX singleton: the diagnosis watchdog threads of the
in-process GCS servers of tests/test_gcs_failover.py are never stopped,
and once that file's event loop has closed they record an
``anomaly:loop_wedged`` instant every few seconds. So the JAX capture
records only the ``request`` category, through the JAX recorder's own
category gate. The port's recorder has no gate and records every row; its
rows of the categories it adds (``engine:step``, ``replica:fan_out``,
``train:*``) have no JAX counterpart, so the comparisons take the
``request`` rows of both sides, less the arguments that read a clock.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from ray_tpu._private import flight_recorder as jax_flight_recorder
from ray_tpu._private.config import Config
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch import _config
from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.models import PRESETS, from_jax_params

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
TIME_KEYS = ("ts", "start_us", "dur_us")
# Arguments that read a clock: the gather window's wait, the device time of
# a span on a CUDA device, and the serving replica's two waits.
CLOCK_ARGS = ("gather_wait_us", "device_us", "lock_wait_us", "hold_us")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _captured(module, **kw):
    """Swap ``module``'s process recorder for a fresh capturing one, made
    with ``kw`` (JAX's: ``categories`` to record); yield it. Its drain()
    gives a telemetry flush nothing; rows() drains it."""

    class Capture(module.FlightRecorder):
        def drain(self, node_id=b"", worker_id=b""):
            return []

        def rows(self):
            return module.FlightRecorder.drain(self)

    old = module._recorder
    cap = module._recorder = Capture(**kw)
    try:
        yield cap
    finally:
        module._recorder = old


@pytest.fixture
def recorders():
    """(JAX's capturing recorder, the port's), both restored after."""
    with _captured(jax_flight_recorder, categories={"request"}) as jrec, \
            _captured(flight_recorder) as trec:
        yield jrec, trec


def _untimed(rows):
    return [{k: v for k, v in r.items() if k not in TIME_KEYS} for r in rows]


def _spans(rows):
    """(cat, name, id, args) of each ``request`` row, less the args that
    read a clock."""
    out = []
    for r in rows:
        if r["cat"] != "request":
            continue
        args = {k: v for k, v in (r.get("args") or {}).items()
                if k not in CLOCK_ARGS}
        out.append((r["cat"], r["name"], r["task_id"], args))
    return out


def _stats(stats):
    """stats() less the JAX recorder's count of instants sampled away (the
    port does not sample)."""
    return {k: v for k, v in stats.items() if k != "sampled_out"}


# --------------------------------------------------------- the recorder ---

def _script(rec):
    """A fixed sequence of the calls the engine makes: spans by begin/end
    in two categories, with and without ids and args, overflowing 16
    slots."""
    t0 = rec.begin()
    rec.end("request", "decode", t0, batch=3)
    for i in range(12):
        rec.end("request", "sp:gather", rec.begin(), id=bytes([i]), parts=i)
        if i % 2:
            rec.end("transfer", "chunk", rec.begin())


def test_same_calls_give_the_same_rows_and_stats():
    rows, stats = [], []
    for module in (jax_flight_recorder, flight_recorder):
        rec = module.FlightRecorder(capacity=16)
        _script(rec)
        stats.append(_stats(rec.stats()))
        rows.append(_untimed(rec.drain(node_id=b"n", worker_id=b"w")))
        assert rec.drain() == [] and rec.stats()["pending"] == 0
    assert rows[1] == rows[0]
    assert stats[1] == stats[0]
    # A decode span, 12 gathers and 6 chunks into 16 slots: 3 dropped,
    # oldest first.
    assert stats[1] == {"recorded": 19, "dropped": 3, "pending": 16}
    assert [r["name"] for r in rows[1][:4]] \
        == ["chunk", "sp:gather", "sp:gather", "chunk"]
    assert rows[1][1]["args"] == {"parts": 2}
    assert rows[1][1]["task_id"] == b"\x02" and rows[1][0]["node_id"] == b"n"
    assert "args" not in rows[1][-1] and rows[1][-2]["args"] == {"parts": 11}


def _instant_script(rec):
    """Instants in two categories, interleaved with spans, with and without
    ids and args."""
    for i in range(7):
        rec.instant("request", "request:cancelled", id=bytes([i]))
        rec.end("request", "decode", rec.begin(), batch=i)
        if i % 3 == 0:
            rec.instant("anomaly", "anomaly:loop_wedged", loop="main")
    rec.instant("request", "request:kv_broken", id=b"\x07", tokens=3)
    rec.end("lease", "lease:grant", rec.begin())


def test_instants_and_sampling_match_jax():
    """instant() gives JAX's rows and stats() at the JAX recorder's default,
    which samples nothing away (the port keeps every instant)."""
    rows, stats = [], []
    for module in (jax_flight_recorder, flight_recorder):
        rec = module.FlightRecorder(capacity=64)
        _instant_script(rec)
        stats.append(_stats(rec.stats()))
        rows.append(rec.drain())
    assert _untimed(rows[1]) == _untimed(rows[0]) and stats[1] == stats[0]
    names = [r["name"] for r in rows[1]]
    assert names.count("request:cancelled") == 7
    assert names.count("anomaly:loop_wedged") == 3
    assert names.count("decode") == 7 and names.count("lease:grant") == 1
    assert all(r["dur_us"] == 0 for r in rows[1] if r["name"].startswith(
        ("request:", "anomaly:")))


def test_instants_obey_the_enabled_switch():
    rec = flight_recorder.FlightRecorder(enabled=False)
    rec.instant("request", "request:cancelled")
    assert rec.drain() == [] and rec.stats() == {
        "recorded": 0, "dropped": 0, "pending": 0}


def test_drain_converts_to_wall_time_with_order_kept():
    rec = flight_recorder.FlightRecorder()
    t0 = rec.begin()
    rec.end("request", "prefill", t0, tokens=4)
    rec.end("request", "mark", rec.begin())
    a, b = rec.drain()
    assert a["start_us"] <= b["start_us"] and a["dur_us"] >= 0
    assert b["dur_us"] >= 0 and "args" not in b
    assert set(a) == {"task_id", "name", "event", "cat", "ts", "start_us",
                      "dur_us", "worker_id", "node_id", "job_id", "args"}


def test_disabled_recorder_records_nothing():
    rec = flight_recorder.FlightRecorder(enabled=False)
    rec.end("request", "b", rec.begin())
    assert rec.drain() == [] and rec.stats()["recorded"] == 0


# ------------------------------------------------- device-timed spans ---

class _Stream:
    """A stand-in CUDA stream: work (ms) and events queue on it in order,
    and run when the test says the device has caught up."""

    device_index = 0

    def __init__(self):
        self.now_ms = 0.0
        self.queued = []

    def work(self, ms):
        self.queued.append(float(ms))

    def catch_up(self):
        for item in self.queued:
            if isinstance(item, float):
                self.now_ms += item
            else:
                item.at_ms = self.now_ms
        self.queued = []


class _Event:
    """A stand-in timing event that counts how many were made and fails
    the test if anything waits on it."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at_ms = None

    def record(self, stream):
        self.at_ms = None
        stream.queued.append(self)

    def query(self):
        return self.at_ms is not None

    def elapsed_time(self, end):
        assert self.at_ms is not None and end.at_ms is not None
        return end.at_ms - self.at_ms

    def synchronize(self):
        raise AssertionError("the recorder waited for the device")


@pytest.fixture
def stub_cuda(monkeypatch):
    """torch.cuda's stream and events replaced by the stand-ins above; a
    device synchronisation fails the test."""
    stream = _Stream()
    _Event.made = 0
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)

    def no_sync(*a, **k):
        raise AssertionError("the recorder synchronised the device")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    return stream


@pytest.mark.parametrize("case", ["no device", "cpu", "disabled"])
def test_no_device_time_without_a_cuda_device_or_when_disabled(
        monkeypatch, case):
    """begin() on no device or a CPU one is a host stamp: the span has no
    device_us and torch.cuda is never reached; a disabled recorder given a
    CUDA device records nothing and reaches it neither."""
    def unreachable(*a, **k):
        raise AssertionError("torch.cuda reached")
    monkeypatch.setattr(torch.cuda, "current_stream", unreachable)
    monkeypatch.setattr(torch.cuda, "Event", unreachable)
    rec = flight_recorder.FlightRecorder(enabled=case != "disabled")
    device = {"no device": None, "cpu": torch.device("cpu"),
              "disabled": torch.device("cuda")}[case]
    t0 = rec.begin(device)
    assert isinstance(t0, int)
    rec.end("request", "prefill", t0, tokens=4)
    rows = rec.drain()
    if case == "disabled":
        assert rows == []
    else:
        assert [r["args"] for r in rows] == [{"tokens": 4}]


def test_device_time_resolves_as_later_spans_end(stub_cuda):
    """A span's events resolve, without waiting, once the device has
    passed them: at a later span's end, or at drain(). A drain returns
    every record written before it, in order: one whose end event has not
    completed comes out without device_us, and its pair goes back to the
    pool once the device has passed it, for the next span to reuse."""
    rec = flight_recorder.FlightRecorder()
    cuda = torch.device("cuda")
    t0 = rec.begin(cuda)
    stub_cuda.work(3.5)
    rec.end("request", "prefill", t0, tokens=8)
    stub_cuda.catch_up()
    t1 = rec.begin(cuda)
    stub_cuda.work(1.25)
    rec.end("request", "decode", t1, batch=2)
    rows = rec.drain()
    assert [(r["name"], r["args"]) for r in rows] \
        == [("prefill", {"tokens": 8, "device_us": 3500}),
            ("decode", {"batch": 2})]
    assert rec.stats()["pending"] == 0 and _Event.made == 4
    stub_cuda.catch_up()
    t2 = rec.begin(cuda)    # takes the prefill's pair
    stub_cuda.work(2.0)
    rec.end("request", "decode", t2, batch=3)   # frees the decode's pair
    assert rows[1]["args"] == {"batch": 2}      # the drained row stays
    stub_cuda.catch_up()
    t3 = rec.begin(cuda)    # takes the decode's pair
    stub_cuda.work(1.0)
    rec.end("request", "decode", t3, batch=4)
    stub_cuda.catch_up()
    rec.end("request", "sample_sync", rec.begin(), batch=4)
    assert [(r["name"], r["args"]) for r in rec.drain()] \
        == [("decode", {"batch": 3, "device_us": 2000}),
            ("decode", {"batch": 4, "device_us": 1000}),
            ("sample_sync", {"batch": 4})]
    assert _Event.made == 4
    assert rec.drain() == [] and rec.stats()["pending"] == 0


def test_device_time_reuses_its_events(stub_cuda):
    """Back-to-back device-timed spans, each resolved at the next one's
    end, take two pairs of events in all, however many spans."""
    rec = flight_recorder.FlightRecorder()
    for i in range(20):
        t0 = rec.begin(torch.device("cuda"))
        stub_cuda.work(1.0)
        rec.end("request", "decode", t0, batch=i)
        stub_cuda.catch_up()
    rows = rec.drain()
    assert [r["args"] for r in rows] \
        == [{"batch": i, "device_us": 1000} for i in range(20)]
    assert _Event.made == 4


def test_recorder_reads_the_settings_after_reset(monkeypatch):
    """recorder() builds the singleton from RAY_TPU_flight_recorder_* the
    way the reference does, and reset() makes it read them again."""
    names = ("enabled", "capacity")
    old = flight_recorder._recorder
    try:
        for env in ({}, {"enabled": "0", "capacity": "40"},
                    {"capacity": "not a number"},
                    {"enabled": "0", "capacity": "not a number"}):
            for name in names:
                monkeypatch.delenv(f"RAY_TPU_flight_recorder_{name}",
                                   raising=False)
            for name, value in env.items():
                monkeypatch.setenv(f"RAY_TPU_flight_recorder_{name}", value)
            flight_recorder.reset()
            rec = flight_recorder.recorder()
            assert flight_recorder.recorder() is rec
            got = (rec.enabled, rec.capacity)
            if env == {} or "not a number" in env.values():
                assert got == (True, 4096)
            else:
                assert got == (False, 40)
                ref = Config()        # the reference's reading of the env
                for name in names:
                    key = f"flight_recorder_{name}"
                    assert _config.setting(key) == getattr(ref, key)
    finally:
        flight_recorder._recorder = old


# ------------------------------------------------------ the engine's spans ---

@pytest.fixture(scope="module")
def params():
    jeng = JaxEngine(JCFG, max_batch=1, max_len=64, seed=0)
    return from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG, "cpu")


def _engine(jax_side, params, **kw):
    if jax_side:
        return JaxEngine(JCFG, seed=0, **kw)
    return LLMEngine(CFG, params, seed=0, device="cpu", **kw)


def test_admission_sampling_is_one_transfer_per_tick(recorders, params):
    """A 3-request admission wave samples its first tokens in ONE
    device-to-host pull: one ``sample_sync`` span with batch=3 and three
    ``prefill`` spans, on both engines alike."""
    spans = []
    for jax_side, rec in zip((True, False), recorders):
        eng = _engine(jax_side, params, max_batch=4, max_len=64, page_size=8)
        sp = (JaxSP if jax_side else SamplingParams)(max_tokens=3)
        for i in range(3):
            eng.add_request([i + 1, i + 2, i + 3], sp)
        eng.step()
        rows = [r for r in rec.rows() if r["cat"] == "request"]
        samples = [r for r in rows if r["name"] == "sample_sync"]
        prefills = [r for r in rows if r["name"] == "prefill"]
        assert len(samples) == 1, samples
        assert samples[0]["args"]["batch"] == 3
        assert len(prefills) == 3
        while eng.has_unfinished():
            eng.step()
        spans.append(_spans(rows + rec.rows()))
    assert spans[1] == spans[0]


def _span_script(jax_side, params):
    """A miss and a prefix hit, a chunked prefill beside a decoding request,
    a prefill_only, and a paged prefill and decode."""
    sp = (JaxSP if jax_side else SamplingParams)(max_tokens=3)
    rng = np.random.default_rng(4)

    def toks(n):
        return rng.integers(1, CFG.vocab_size, n).tolist()

    a = _engine(jax_side, params, max_batch=2, max_len=128, page_size=8,
                prefix_cache=True)
    prefix = toks(24)
    a.generate([prefix + toks(5)], sp)                    # miss
    a.generate([prefix + toks(9)], sp)                    # hit
    a.prefill_only(prefix + toks(3), sp)                  # hit, external
    b = _engine(jax_side, params, max_batch=2, max_len=128, page_size=8,
                prefill_chunk=16)
    b.add_request(toks(4), sp)
    b.step()
    b.add_request(toks(40), sp)                           # 3 chunks
    while b.has_unfinished():
        b.step()
    pre = _engine(jax_side, params, max_batch=1, max_len=64, page_size=16,
                  kv_pages=4, kv_gather_window=4)
    handoff = pre.prefill_paged(toks(70), sp, span=32)
    dec = _engine(jax_side, params, max_batch=1, max_len=64, page_size=16,
                  kv_pages=4, kv_gather_window=2)
    return dec.decode_paged(handoff, sp)


def test_engine_spans_match_jax(recorders, params):
    """The same requests through both engines write the same spans in the
    same order: names, request ids and args (less the wall-clock
    gather_wait_us)."""
    runs = []
    for jax_side, rec in zip((True, False), recorders):
        out = _span_script(jax_side, params)
        runs.append((out, _spans(rec.rows())))
    assert runs[1] == runs[0]
    spans = runs[1][1]
    names = [n for _, n, _, _ in spans]
    prefills = [a for _, n, _, a in spans if n == "prefill"]
    assert [a.get("cached_tokens") for a in prefills] \
        == [0, 24, 24, 0, 0, 16, 32]
    assert sum(a.get("chunked", False) for a in prefills) == 3
    assert sum(a.get("external", False) for a in prefills) == 1
    gathers = [a for _, n, _, a in spans if n == "sp:gather"]
    assert [a.get("prefill_chunk", False) for a in gathers] \
        == [True] * 3 + [False] * 2
    assert [a["parts"] for a in gathers] == [0, 1, 2, 3, 3]
    assert names.count("decode") > 0 and names.count("sample_sync") > 0
