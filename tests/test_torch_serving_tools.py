"""Parity of ray_tpu_torch's serving tools with the JAX package's on the
CPU: the open-loop harness ``run_open_loop``, the byte-level tokenizer and
its incremental detokenizer, and the batch stage behind
``build_llm_processor``.
"""

import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

import ray_tpu.exceptions as jax_exc
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import batch as jax_batch
from ray_tpu.llm import openai_api as jax_openai
from ray_tpu.llm import serving as jax_serving
from ray_tpu.models import PRESETS as JAX_PRESETS
import ray_tpu_torch.exceptions as exc
from ray_tpu_torch.llm import EngineReplica, batch, openai_api, serving
from ray_tpu_torch.models import PRESETS, from_jax_params

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seed-0 ``tiny`` params, as the port's tensors."""
    jeng = JaxEngine(JCFG, max_batch=1, max_len=64, seed=0)
    return from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG, "cpu")


# ------------------------------------------------------- open-loop harness ---

def _fake_submit(E):
    """A deterministic stream per prompt: shed, broken after two tokens, a
    plain error, or three tokens and the terminal dict, by prompt % 4.
    ``E`` is the package's exceptions module: each harness catches its
    own package's typed errors."""

    def submit(prompt):
        kind = prompt % 4
        if kind == 0:
            raise E.OverloadedError("admission queue full", retry_after_s=0.5)
        if kind == 2:
            raise ValueError("boom")
        yield 7
        yield 8
        if kind == 1:
            raise E.StreamBrokenError("lost", tokens_emitted=2)
        yield 9
        yield {"finish_reason": "length", "n_tokens": 3}
    return submit


def test_open_loop_harness_counts_match_jax():
    reports = [mod.run_open_loop(_fake_submit(E), rate_hz=200.0,
                                 duration_s=0.05, prompt_fn=lambda i: i,
                                 num_replicas=2)
               for mod, E in ((jax_serving, jax_exc), (serving, exc))]
    assert set(reports[1]) == set(reports[0])
    counts = ("offered", "completed", "shed", "broken", "tokens_total",
              "errors", "unfinished")
    assert {k: reports[1][k] for k in counts} \
        == {k: reports[0][k] for k in counts}
    assert {k: reports[1][k] for k in counts} == dict(
        offered=10, completed=2, shed=3, broken=3, tokens_total=6,
        errors=["ValueError('boom')"] * 2, unfinished=0)
    assert reports[1]["itl_p50_ms"] >= 0 and reports[1]["ttft_p99_ms"] >= 0
    assert serving._pctl([], 50) == jax_serving._pctl([], 50) == 0.0
    xs = [3.0, 1.0, 4.0, 1.5, 9.0]
    assert serving._pctl(xs, 99) == jax_serving._pctl(xs, 99)


class _Bridge:
    """An event loop on its own thread; ``submit`` streams a replica's
    ``stream_generate`` from any thread (the harness's request threads)."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def call(self, coro, timeout=60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def stream(self, agen, timeout=60.0):
        try:
            while True:
                try:
                    yield self.call(agen.__anext__(), timeout)
                except StopAsyncIteration:
                    return
        finally:
            self.call(agen.aclose(), timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        assert not self.thread.is_alive()
        self.loop.close()


def test_open_loop_against_the_port_replica(params):
    """The harness drives the port's replica through a thread bridge: every
    offered request completes with its tokens, nothing shed or broken."""
    bridge = _Bridge()
    try:
        er = EngineReplica(CFG, params, max_batch=2, max_len=64,
                           page_size=8, device="cpu")
        opts = {"max_tokens": 6}
        rep = serving.run_open_loop(
            lambda p: bridge.stream(er.stream_generate(p, opts)),
            rate_hz=20.0, duration_s=0.3,
            prompt_fn=lambda i: [(i % 37) + 1, (i % 11) + 2, 7],
            request_timeout_s=60.0)
        st = bridge.call(er.debug_stats())
    finally:
        bridge.close()
    assert rep["completed"] == rep["offered"] == 6, rep
    assert not rep["errors"] and rep["unfinished"] == 0, rep
    assert rep["shed"] == rep["broken"] == 0
    assert rep["tokens_total"] == 6 * 6 == st["tokens_out"]
    assert st["completed"] == 6
    assert st["kv_pages_free"] == st["kv_pages_total"]
    assert 0 < rep["ttft_p50_ms"] <= rep["total_p50_ms"]


# ------------------------------------------------------------ tokenizers ---

def _random_text(rng, n):
    """Seeded random text mixing 1- to 4-byte UTF-8 characters."""
    pools = [(0x20, 0x7e), (0xa0, 0x7ff), (0x4e00, 0x9fff),
             (0x1f300, 0x1f64f)]
    out = []
    for _ in range(n):
        lo, hi = pools[rng.integers(len(pools))]
        out.append(chr(int(rng.integers(lo, hi + 1))))
    return "".join(out)


@pytest.mark.parametrize("seed", range(4))
def test_byte_tokenizer_and_detokenizer_match_jax(seed):
    """encode/decode and the streamed deltas equal JAX's, multi-byte
    characters split across feeds included; reserved ids read as
    nothing."""
    rng = np.random.default_rng(seed)
    text = _random_text(rng, 40)
    tok, jtok = openai_api.ByteTokenizer(512), jax_openai.ByteTokenizer(512)
    ids = tok.encode(text)
    assert ids == jtok.encode(text) and len(ids) > len(text)
    assert tok.decode(ids) == jtok.decode(ids) == text
    # Reserved ids and a cut mid-character, as a stream ends.
    noisy = ids[:5] + [0, 1, 2] + ids[5:-1]
    assert tok.decode(noisy) == jtok.decode(noisy)
    deltas = [[d.feed(t) for t in noisy] for d in (
        openai_api._Detokenizer(tok), jax_openai._Detokenizer(jtok))]
    assert deltas[0] == deltas[1]
    assert "".join(deltas[0]) == text[:-1] or \
        "".join(deltas[0]) + text[-1] == text
    assert "�" not in "".join(deltas[0])


def test_detokenizer_generic_tokenizer_matches_jax():
    """A tokenizer that is not byte-level: prefix deltas of full
    decodes."""

    class Words:
        def decode(self, ids):
            return " ".join(f"w{i}" for i in ids)

    ids = np.random.default_rng(9).integers(0, 50, 12).tolist()
    deltas = [[d.feed(t) for t in ids] for d in (
        openai_api._Detokenizer(Words()), jax_openai._Detokenizer(Words()))]
    assert deltas[0] == deltas[1]
    assert "".join(deltas[0]) == Words().decode(ids)


# ----------------------------------------------------------- batch stage ---

def _batch(rng):
    lens = np.array([5, 3, 7, 1], np.int64)
    prompts = np.zeros((4, 7), np.int64)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(1, CFG.vocab_size, n)
    return {"prompt_tokens": prompts, "prompt_len": lens,
            "id": np.arange(4)}


def test_engine_stage_matches_jax(params):
    """The stage over the same weights writes JAX's generated tokens and
    lengths, and keeps the batch's other columns."""
    blob = dict(preset="tiny", max_batch=2, max_len=32, max_tokens=5)
    rows = _batch(np.random.default_rng(3))
    want = jax_batch._EngineStage(
        jax_batch.dataclasses.asdict(jax_batch.ProcessorConfig(**blob)))(
        dict(rows))
    cfg = batch.dataclasses.asdict(batch.ProcessorConfig(**blob))
    got = batch._EngineStage(cfg, params, device="cpu")(dict(rows))
    assert set(got) == set(want)
    for key in ("generated_tokens", "generated_tokens_len", "id",
                "prompt_tokens"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["generated_tokens"].dtype == np.int32
    assert list(got["generated_tokens_len"]) == [5, 5, 5, 5]


def test_build_llm_processor_maps_the_stage_over_any_dataset(params):
    """build_llm_processor hands any object with map_batches the stage and
    its constructor arguments, as the reference's does (plus the port's
    params and device)."""
    calls = []

    class FakeDataset:
        def __init__(self, batches):
            self.batches = batches

        def map_batches(self, fn, **kw):
            calls.append((fn, kw))
            stage = fn(*kw["fn_constructor_args"],
                       **(kw.get("fn_constructor_kwargs") or {}))
            return FakeDataset([stage(b) for b in self.batches])

    conf = dict(preset="tiny", max_batch=2, max_len=32, max_tokens=4,
                batch_size=4, concurrency=2)
    rows = _batch(np.random.default_rng(4))
    out = batch.build_llm_processor(batch.ProcessorConfig(**conf), params,
                                    device="cpu")(FakeDataset([dict(rows)]))
    jout = jax_batch.build_llm_processor(
        jax_batch.ProcessorConfig(**conf))(FakeDataset([dict(rows)]))
    (fn, kw), (jfn, jkw) = calls[0], calls[1]
    assert fn is batch._EngineStage and jfn is jax_batch._EngineStage
    assert kw.pop("fn_constructor_kwargs") == {"params": params,
                                               "device": "cpu"}
    assert kw == jkw
    np.testing.assert_array_equal(out.batches[0]["generated_tokens"],
                                  jout.batches[0]["generated_tokens"])
