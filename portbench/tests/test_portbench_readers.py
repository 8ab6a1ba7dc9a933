"""Every per-layer reader on a synthetic trace, and the trace reductions."""

import json

import pytest

from portbench import flops, harness
from portbench import trace as T

from .tiny import TINY

H100 = "NVIDIA H100 80GB HBM3"


def span(name, start_us, dur_us, **args):
    return {"name": name, "start_us": start_us, "dur_us": dur_us,
            "args": args}


def ctx(name, kernels=(), spans=(), work=None, slice_s=1.0, chips=1):
    ks = list(kernels)
    return harness.Context(
        cell="c", sizes=TINY, chips=chips, kind=H100, spans=list(spans),
        slice_spans=list(spans), kernels=ks, slice_s=slice_s,
        busy_s=T.union_us(ks) / 1e6, work=work or {},
        data=harness.metric_data(name))


def read(name, **kw):
    return harness.reader(name)(ctx(name, **kw))


def K(name, start, dur):
    return T.Kernel(name, float(start), float(dur))


def test_union_and_gaps():
    ks = [K("a", 0, 10), K("b", 5, 10), K("c", 30, 5)]
    assert T.union_us(ks) == 20.0
    assert T.gaps_us(ks) == [(15.0, 30.0)]
    assert T.top_ops(ks + [K("a", 40, 1)])[0] == ["a", 11e-6]


def test_chrome_trace_kernels():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 9},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1.0,
         "dur": 1.0}]}
    ks = T.kernels_from_chrome(trace)
    assert [k.name for k in ks] == ["Memcpy DtoH", "k1"]


def test_idle_gaps_named_by_host_span():
    ks = [K("a", 0, 10), K("b", 110, 10)]
    spans = [span("decode", 1000 + 50, 100)]
    got = T.idle_breakdown(ks, spans, offset_us=1000.0)
    assert got == [["host in decode", 100e-6]]


def test_span_readers():
    spans = [span("prefill", 0, 2000, tokens=100, cached_tokens=64),
             span("prefill", 0, 1000, tokens=100, cached_tokens=0),
             span("decode", 0, 30000, batch=4),
             span("decode", 0, 50000, batch=6),
             span("request:admit", 0, 100000),
             span("request:admit", 0, 300000)]
    assert read("prefix_hit_share", spans=spans) == pytest.approx(32.0)
    assert read("decode_step_ms.chat", spans=spans) == pytest.approx(40.0)
    assert read("decode_step_ms.docqa", spans=spans) == pytest.approx(40.0)
    assert read("decode_batch_mean.docqa", spans=spans) == 5.0
    assert read("replica_first_token_ms", spans=spans) == 200.0
    assert read("decode_step_ms.chat", spans=[]) is None


def test_idle_and_mfu_readers():
    ks = [K("gemm", 0, 250000), K("elementwise_kernel", 500000, 250000)]
    w = {"model_flops": 989e12 * 0.25}
    assert read("idle_share.chat", kernels=ks) == pytest.approx(50.0)
    assert read("idle_share.train", kernels=[]) is None
    assert read("mfu.docqa", kernels=ks, work=w) == pytest.approx(25.0)
    assert read("mfu_busy.chat", kernels=ks, work=w) == pytest.approx(50.0)
    assert read("mfu.train", kernels=ks, work=w, chips=4) == \
        pytest.approx(6.25)
    assert read("mfu.train", kernels=ks, work={}) is None


def test_elementwise_share():
    ks = [K("void at::native::vectorized_elementwise_kernel<4>", 0, 30),
          K("nvjet_tst_128x256", 30, 50),
          K("fa_fwd_bf16<128>", 80, 10),
          K("void at::native::reduce_kernel<512>", 90, 10)]
    assert read("elementwise_share.train", kernels=ks) == \
        pytest.approx(30.0)


def test_attention_rooflines():
    f, b = flops.flash_forward_work(TINY, 1, 100)
    t_min = max(f / 989e12, b / 3.35e12)
    ks = [K("fa_fwd_bf16<128>", 0, t_min * 1e6 * 4), K("gemm", 0, 99)]
    got = read("attn_fwd_roofline.chat", kernels=ks,
               work={"full_prefills": [100]})
    assert got == pytest.approx(25.0)
    assert read("attn_fwd_roofline.chat", kernels=ks,
                work={"full_prefills": []}) is None
    f3, b3 = flops.flash_train_work(TINY, 1, 64)
    t3 = max(f3 / 989e12, b3 / 3.35e12)
    ks = [K("fa_fwd_bf16<128>", 0, t3 * 1e6), K("fa_dq_bf16<128>", 0,
                                                   t3 * 1e6),
          K("fa_dkv_bf16<128>", 0, 2 * t3 * 1e6)]
    assert read("attn_roofline.train", kernels=ks,
                work={"attn_flops": f3, "attn_bytes": b3}) == \
        pytest.approx(25.0)


def test_every_per_layer_metric_has_a_reader():
    bench = harness.benchmark()
    for m in bench["per_layer"]:
        assert harness.metric_file(m["name"], ".py") is not None
    assert json.dumps(bench)
    # A variant without a file of its own falls back to its base's reader.
    assert harness.metric_file("idle_share.some_cell", ".py").name == \
        "idle_share.py"
    assert harness.metric_file("no_such_metric", ".py") is None
