"""The port's own flight-recorder spans on the CPU: the train step's
``train:grad`` and ``train:optimizer``, the engine's ``engine:step``, and
the serving replica's ``replica:fan_out`` and the two waits of its
``request:admit`` span (``lock_wait_us``, ``hold_us``).

Each test swaps the process recorder for a fresh one and restores it
after (tests/test_torch_flight_recorder.py says why). On the CPU no span
carries ``device_us``.
"""

import asyncio
import contextlib

import pytest
import torch

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm.serving import EngineReplica
from ray_tpu_torch.models import PRESETS, init_params, make_train_step
from ray_tpu_torch.parallel import MeshSpec, build_mesh

CFG = PRESETS["tiny"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; these small
    shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _recording():
    """A fresh process recorder, the old one restored after."""
    old = flight_recorder._recorder
    rec = flight_recorder._recorder = flight_recorder.FlightRecorder(
        capacity=1 << 14)
    try:
        yield rec
    finally:
        flight_recorder._recorder = old


def _end(row):
    return row["ts"] + row["dur_us"] / 1e6


# ------------------------------------------------------------ training ---

@pytest.mark.parametrize("mesh", [None, dict(dp=2, fsdp=2, tp=2)],
                         ids=["one device", "dp2 fsdp2 tp2"])
def test_train_spans_once_per_step_in_order(mesh):
    """Each step writes train:grad, then train:optimizer, both with the
    state's step at entry, one device or a mesh."""
    if mesh is not None:
        n = MeshSpec(**mesh).n_devices
        mesh = build_mesh(MeshSpec(**mesh), devices=[CPU] * n)
    bundle = make_train_step(CFG, mesh, device="cpu")
    state = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(1, CFG.vocab_size, (8, 17),
                           generator=torch.Generator().manual_seed(1))
    with _recording() as rec:
        for _ in range(3):
            state, _ = bundle.step(state, {"tokens": tokens})
        rows = rec.drain()
    assert all(r["cat"] == "train" for r in rows)
    assert [(r["name"], r["args"]) for r in rows] == [
        (name, {"step": k}) for k in range(3)
        for name in ("train:grad", "train:optimizer")]
    for grad, opt in zip(rows[::2], rows[1::2]):
        assert _end(grad) <= opt["ts"] + 1e-6


# -------------------------------------------------------------- engine ---

def test_engine_step_span_wraps_its_tick():
    """engine:step, a bare span, covers its tick's prefill, sample_sync and
    decode rows; the engine's other spans keep their args."""
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    eng = LLMEngine(CFG, params, max_batch=4, max_len=64, page_size=8,
                    device="cpu")
    with _recording() as rec:
        for i in range(2):
            eng.add_request([i + 1, i + 2, i + 3],
                            SamplingParams(max_tokens=4))
        eng.step()
        eng.step()
        rows = rec.drain()
    steps = [r for r in rows if r["name"] == "engine:step"]
    assert [(r["cat"], r.get("args")) for r in steps] \
        == [("engine", None), ("engine", None)]
    tick = [r for r in rows if r["cat"] == "request"
            and r["ts"] < _end(steps[0])]
    assert [r["name"] for r in tick] \
        == ["prefill", "prefill", "sample_sync", "decode"]
    for r in tick:
        assert steps[0]["ts"] - 1e-6 <= r["ts"]
        assert _end(r) <= _end(steps[0]) + 1e-6
    assert [r["args"] for r in tick] == [
        {"tokens": 3, "cached_tokens": 0, "active": 0},
        {"tokens": 3, "cached_tokens": 0, "active": 1},
        {"batch": 2}, {"batch": 2}]


# ------------------------------------------------------------- serving ---

def _replica(**kw):
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return EngineReplica(CFG, params, max_len=64, page_size=8, device="cpu",
                         **kw)


async def _take(er, prompt, n):
    return [t async for t in er.stream_generate(prompt, {"max_tokens": n})
            if not isinstance(t, dict)]


def test_lock_wait_counts_the_wait_for_the_replica_lock():
    """A request that calls while the replica's lock is held for 50 ms
    reads a lock_wait_us of at least 40 ms; one that finds the lock free
    far less."""
    er = _replica()

    async def main():
        await _take(er, [1, 2, 3], 2)
        async with er._lock:
            task = asyncio.ensure_future(_take(er, [4, 5, 6], 2))
            await asyncio.sleep(0.05)
        return await task

    with _recording() as rec:
        out = asyncio.run(main())
        rows = [r for r in rec.drain() if r["name"] == "request:admit"]
    assert len(out) == 2 and len(rows) == 2
    free, held = (r["args"]["lock_wait_us"] for r in rows)
    assert held >= 40_000 and free < held


def test_every_admit_carries_its_first_token_hold():
    """Every request:admit span, of requests admitted together or queued
    behind a full batch, has hold_us >= 0 and lock_wait_us >= 0 beside
    its queued and decoding args."""
    er = _replica(max_batch=2)

    async def main():
        return await asyncio.gather(*(
            _take(er, [i + 1, i + 2, i + 3], 3 + i) for i in range(5)))

    with _recording() as rec:
        outs = asyncio.run(main())
        rows = [r for r in rec.drain() if r["name"] == "request:admit"]
    assert [len(o) for o in outs] == [3, 4, 5, 6, 7]
    assert len(rows) == 5
    for r in rows:
        a = r["args"]
        assert set(a) == {"queued", "decoding", "lock_wait_us", "hold_us"}
        assert a["hold_us"] >= 0 and a["lock_wait_us"] >= 0
        assert a["hold_us"] <= r["dur_us"]


def test_hold_is_left_out_without_a_first_token_stamp(monkeypatch):
    """Where the engine kept no stamp of a first token reaching the host,
    its request:admit span carries no hold_us (rather than a made-up 0)."""
    er = _replica()
    monkeypatch.setattr(er.engine, "first_token_ns", lambda rid: None)
    with _recording() as rec:
        out = asyncio.run(_take(er, [1, 2, 3], 2))
        rows = [r for r in rec.drain() if r["name"] == "request:admit"]
    assert len(out) == 2 and len(rows) == 1
    assert set(rows[0]["args"]) == {"queued", "decoding", "lock_wait_us"}


def test_fan_out_span_on_every_tick():
    """One replica:fan_out span per decode-loop tick, a bare span, each
    after its tick's engine:step."""
    er = _replica(max_batch=2)

    async def main():
        outs = await asyncio.gather(*(
            _take(er, [i + 1, i + 2], 4) for i in range(3)))
        return outs, await er.debug_stats()

    with _recording() as rec:
        outs, stats = asyncio.run(main())
        rows = rec.drain()
    fans = [r for r in rows if r["name"] == "replica:fan_out"]
    steps = [r for r in rows if r["name"] == "engine:step"]
    assert len(fans) == len(steps) == stats["ticks"] > 0
    assert all(f["cat"] == "replica" and "args" not in f for f in fans)
    assert [len(o) for o in outs] == [4, 4, 4]
    for step, fan in zip(steps, fans):
        assert _end(step) <= fan["ts"] + 1e-6
