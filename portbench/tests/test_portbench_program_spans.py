"""The readers of the program's own spans and their arguments
(``replica_lock_wait_ms``, ``first_token_hold_ms``, ``prefill_mfu``,
``optimizer_ms.train``, ``grad_ms.train``) on synthetic spans, and,
marked ``card``, the device time and the clock those spans carry on the
card:

- a lone 1,024-token prefill's ``device_us`` against the first-to-last
  interval of its kernels in a ``torch.profiler`` trace;
- each ``decode`` span of a short traced run ends 0-200 us after its
  device-to-host copy ends, on the wall clock that the trace's ``ts``
  and the drained rows share.
"""

import re

import pytest

from portbench import flops, harness, model_config, program_spans
from portbench import trace as T
from portbench import weights as W
from portbench.drivers.common import port_config
from portbench.drivers.train import CHECK_STEPS

from .test_portbench_readers import read, span
from .tiny import TINY

H100_PEAK = 989e12


def admit(lock_wait_us, hold_us, dur_us=300000):
    return span("request:admit", 0, dur_us, queued=0, decoding=1,
                lock_wait_us=lock_wait_us, hold_us=hold_us)


def test_replica_wait_readers():
    spans = [admit(80000, 150000), admit(20000, 160000),
             span("request:admit", 0, 1000, queued=0, decoding=0),
             span("decode", 0, 150000, batch=2)]
    assert read("replica_lock_wait_ms", spans=spans) == pytest.approx(50.0)
    assert read("first_token_hold_ms", spans=spans) == pytest.approx(155.0)
    # The parent's request:admit spans have neither argument.
    old = [span("request:admit", 0, 1000, queued=0, decoding=0)]
    for name in ("replica_lock_wait_ms", "first_token_hold_ms"):
        assert read(name, spans=old) is None
        assert read(name, spans=[]) is None


def test_prefill_mfu_reader():
    spans = [span("prefill", 0, 900, tokens=512, cached_tokens=0,
                  active=3, device_us=20000),
             span("prefill", 0, 900, tokens=2600, cached_tokens=2560,
                  active=9, device_us=5000),
             span("prefill", 0, 900, tokens=64, cached_tokens=0),
             span("decode", 0, 150000, batch=2, device_us=150000)]
    work = (flops.prefill_flops(TINY, 512, 0)
            + flops.prefill_flops(TINY, 2600, 2560))
    want = 100.0 * work / (25000e-6 * H100_PEAK)
    assert read("prefill_mfu", spans=spans) == pytest.approx(want)
    # Prefills without device time: the parent, or a CPU run.
    assert read("prefill_mfu", spans=spans[2:]) is None
    assert read("prefill_mfu", spans=[]) is None


def train_rows(name, per_step):
    return [{"name": name, "cat": "train",
             "args": {"step": k, **({"device_us": us} if us else {})}}
            for k, us in enumerate(per_step)]


@pytest.mark.parametrize("metric,name", [
    ("optimizer_ms.train", "train:optimizer"),
    ("grad_ms.train", "train:grad")])
def test_train_span_readers(monkeypatch, metric, name):
    """The median device time of the window's steps: the warm-up's steps
    (before ``CHECK_STEPS``), the other span and spans without device time
    are left out; nothing to read gives None."""
    per_step = [9e6, 8e6, 7e6] + [180e3, 200e3, 190e3, 400e3, 195e3]
    assert CHECK_STEPS == 3
    other = "train:grad" if name == "train:optimizer" else "train:optimizer"
    rows = train_rows(name, per_step) + train_rows(other, [1e3] * 8)
    monkeypatch.setattr(program_spans, "_rows", rows)
    assert read(metric) == pytest.approx(195.0)
    monkeypatch.setattr(program_spans, "_rows",
                        train_rows(name, [9e6, 8e6, 7e6, None, None]))
    assert read(metric) is None
    monkeypatch.setattr(program_spans, "_rows", [])
    assert read(metric) is None


def test_program_spans_drain_the_recorder_once(monkeypatch):
    from ray_tpu_torch._private import flight_recorder
    rec = flight_recorder.FlightRecorder()
    monkeypatch.setattr(flight_recorder, "_recorder", rec)
    monkeypatch.setattr(program_spans, "_rows", None)
    for k in range(5):
        rec.end("train", "train:grad", rec.begin(), step=k)
    rows = program_spans.rows()
    assert [r["args"]["step"] for r in rows] == list(range(5))
    rec.end("train", "train:grad", rec.begin(), step=5)
    assert program_spans.rows() is rows
    # On the CPU no span has device time: nothing to read.
    assert program_spans.window_steps_ms("train:grad") is None


# ---------------------------------------------------------------- card ---

def _engine(torch, max_batch):
    """Mistral-7B-v0.3 at full size, weights from a seed, behind the
    port's engine on the card, its kernels built."""
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.ops import _build
    _build.build()
    s = model_config.load("mistral-7b-v0.3")
    params = W.make_params(s, 2 ** 33 + 5, "cuda")
    eng = LLMEngine(port_config(s, 2048), params, max_batch=max_batch,
                    max_len=2048, page_size=64, prefix_cache=False,
                    device="cuda")
    return s, eng


def _fresh_recorder(monkeypatch):
    from ray_tpu_torch._private import flight_recorder
    rec = flight_recorder.FlightRecorder(capacity=1 << 16)
    monkeypatch.setattr(flight_recorder, "_recorder", rec)
    return rec


def _prompt(torch, s, n, salt):
    g = torch.Generator().manual_seed(salt)
    return torch.randint(0, s.vocab, (n,), generator=g).tolist()


@pytest.mark.card
def test_prefill_device_time_matches_its_kernels(card, monkeypatch,
                                                tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.llm import SamplingParams
    s, eng = _engine(torch, 1)
    one = SamplingParams(max_tokens=1)
    eng.generate([_prompt(torch, s, 1024, 1)], one)     # warm the bucket
    torch.cuda.synchronize()
    sample = eng._sample_batch

    def marked(*a):
        torch.cuda._sleep(1000)          # closes the prefill's kernels
        return sample(*a)

    monkeypatch.setattr(eng, "_sample_batch", marked)
    rec = _fresh_recorder(monkeypatch)
    eng.add_request(_prompt(torch, s, 1024, 2), one)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)          # opens them
        torch.cuda.synchronize()
        eng.step()
        torch.cuda.synchronize()
    path = tmp_path / "prefill_trace.json"
    prof.export_chrome_trace(str(path))
    ks = T.kernels_from_chrome(harness.load_json(path))
    marks = [i for i, k in enumerate(ks) if re.search("spin_kernel", k.name)]
    assert len(marks) == 2, [k.name for k in ks][:20]
    inner = ks[marks[0] + 1:marks[1]]
    interval = max(k.start_us + k.dur_us for k in inner) - inner[0].start_us
    (pre,) = [r for r in rec.drain() if r["name"] == "prefill"]
    got = pre["args"]["device_us"]
    print(f"prefill of 1024 tokens: device_us {got}, kernels' interval "
          f"{interval:.1f} us over {len(inner)} kernels, error "
          f"{got - interval:+.1f} us")
    assert abs(got - interval) <= max(0.1 * interval, 50.0)


@pytest.mark.card
def test_decode_spans_end_just_after_their_copy(card, monkeypatch,
                                                tmp_path):
    """The drained spans share the trace's clock: each decode span ends
    0-200 us after its device-to-host copy ends, the trace moved onto the
    wall clock by its own ``baseTimeNanoseconds`` (the exported trace's
    ``ts`` is the wall clock less it). ``trace.py``'s marker offset is
    printed beside: it takes the wall stamp before the marker's launch,
    so it reads later by that launch's latency."""
    import torch
    from ray_tpu_torch.llm import SamplingParams
    s, eng = _engine(torch, 4)
    for i in range(4):
        eng.add_request(_prompt(torch, s, 200 + 50 * i, 10 + i),
                        SamplingParams(max_tokens=40))
    eng.step()                           # admission, one decode step
    eng.step()
    tracer = T.Slice(torch)
    tracer.warm()
    torch.cuda.synchronize()
    rec = _fresh_recorder(monkeypatch)
    tracer.start()
    for _ in range(8):
        eng.step()
    tracer.stop()
    path = tmp_path / "decode_trace.json"
    tracer.prof.export_chrome_trace(str(path))
    trace = harness.load_json(path)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    marker, *kernels = T.kernels_from_chrome(trace)
    offset = tracer.marker_wall_us - marker.start_us   # as Slice.kernels
    decodes = [r for r in rec.drain() if r["name"] == "decode"]
    copies = [k for k in kernels if k.cat == "gpu_memcpy"
              and "DtoH" in k.name]
    assert len(decodes) == len(copies) == 8, (len(decodes), len(copies))

    def after(off):
        return [sp["start_us"] + sp["dur_us"] - (k.start_us + k.dur_us + off)
                for sp, k in zip(decodes, copies)]
    deltas = after(base_us)
    print("decode span end minus its copy's end, us:",
          [round(d, 1) for d in deltas], "by trace.py's marker offset:",
          [round(d, 1) for d in after(offset)])
    assert all(0.0 <= d <= 200.0 for d in deltas), deltas
