"""The traffic generator: the same seed gives the same requests; every
seed the same set of sizes and gaps, in another order; open-loop latency
is timed from each request's due time."""

import types

import numpy as np

from portbench import traffic
from portbench.drivers.serve import Serve

from .tiny import cell


def chat():
    return cell("mistral7b-chat")


def test_open_loop_same_seed_same_requests():
    a = traffic.open_loop(chat(), 5, 4.0, 512, 256, 1.0)
    b = traffic.open_loop(chat(), 5, 4.0, 512, 256, 1.0)
    assert [(q.prompt, q.max_tokens, q.due_s) for q in a] == \
        [(q.prompt, q.max_tokens, q.due_s) for q in b]


def test_open_loop_seeds_share_sizes_and_gaps():
    big = 2 ** 31 + 12345
    a = [q for q in traffic.open_loop(chat(), 1, 4.0, 512, 256, 0.0)
         if q.measured]
    b = [q for q in traffic.open_loop(chat(), big, 4.0, 512, 256, 0.0)
         if q.measured]
    assert len(a) == len(b) == round(chat()["rate_hz"] * 4.0)
    assert sorted((len(q.prompt), q.max_tokens) for q in a) == \
        sorted((len(q.prompt), q.max_tokens) for q in b)
    assert a[0].prompt != b[0].prompt
    assert all(0 <= q.due_s < 4.0 for q in a + b)
    assert [q.due_s for q in a] == [q.due_s for q in b]


def test_open_loop_ramp_and_extra_are_not_measured():
    c = chat()
    reqs = traffic.open_loop(c, 3, 4.0, 512, 256, 2.0)
    assert [q.due_s for q in reqs] == sorted(q.due_s for q in reqs)
    ramp = [q for q in reqs if q.due_s < 0]
    extra = [q for q in reqs if q.due_s >= 4.0]
    assert len(ramp) == int(np.ceil(c["rate_hz"] * c["ramp_s"])) > 0
    assert len(extra) == int(np.ceil(c["rate_hz"] * 2.0))
    assert not any(q.measured for q in ramp + extra)
    assert all(q.measured for q in reqs if 0 <= q.due_s < 4.0)


def test_open_loop_lengths_respect_limits():
    c = chat()
    for q in traffic.open_loop(c, 3, 10.0, 512, 256, 2.0):
        assert c["prompt"]["min"] <= len(q.prompt) <= c["prompt"]["max"]
        assert 1 <= q.max_tokens <= c["output"]["max"]
        assert len(q.prompt) + q.max_tokens <= 255


def test_documents_same_seed_same_requests():
    c = cell("nemo12b-docqa")
    a = traffic.Documents(c, 9, 512, 256)
    b = traffic.Documents(c, 9, 512, 256)
    o = traffic.Documents(c, 10, 512, 256)
    assert [a.request(i).prompt for i in range(20)] == \
        [b.request(i).prompt for i in range(20)]
    assert sorted(len(o.request(i).prompt) for i in range(len(o))) == \
        sorted(len(a.request(i).prompt) for i in range(len(a)))
    q = a.request(3)
    assert q.prompt[:len(a.docs[q.doc])] == a.docs[q.doc]
    # The ramp: the same sizes in another order, with questions of its own.
    r = [a.request(i, ramp=True) for i in range(len(a))]
    assert sorted(len(x.prompt) for x in r) == \
        sorted(len(a.request(i).prompt) for i in range(len(a)))
    assert [len(x.prompt) for x in r] != \
        [len(a.request(i).prompt) for i in range(len(a))]
    k = list(a.ramp_order).index(a.order[0])
    assert len(r[k].prompt) == len(a.request(0).prompt)
    assert r[k].prompt != a.request(0).prompt
    # Past the pool the window starts on it again, with new questions.
    w = a.request(len(a))
    assert len(w.prompt) == len(a.request(0).prompt)
    assert w.prompt != a.request(0).prompt


def test_buckets_follow_engine_rule():
    assert traffic.buckets([1, 8, 9, 600, 2000], 2048) == [8, 16, 1024, 2048]


def test_ttft_from_due_time_and_gaps():
    sv = Serve.__new__(Serve)
    sv.records = []
    due = 10.0
    for i in range(10):
        q = types.SimpleNamespace(max_tokens=3, prompt=[1, 2])
        sv.records.append({
            "req": q, "t_ref": due + i, "measured": True, "error": None,
            "finish": {"finish_reason": "length"},
            "times": [due + i + 0.5, due + i + 0.6, due + i + 0.8],
            "tokens": [1, 2, 3]})
    e2e = sv.end_to_end({"t0": due, "t_end": due + 5.0})
    assert abs(e2e["ttft_p90_ms"] - 500.0) < 1e-6
    assert abs(e2e["itl_p95_ms"] - 200.0) < 1e-6
    assert abs(e2e["output_tokens_per_s"] - 15 / 5.0) < 1e-9


def test_a_late_request_counts_its_wait():
    sv = Serve.__new__(Serve)
    q = types.SimpleNamespace(max_tokens=1, prompt=[1])
    sv.records = [{"req": q, "t_ref": 0.0, "measured": True, "error": None,
                   "finish": {}, "times": [2.0], "tokens": [5]}]
    assert sv.end_to_end({"t0": 0.0, "t_end": 3.0})["ttft_p90_ms"] == 2000.0
    sv.records[0]["error"] = "RuntimeError()"
    assert sv.failed(sv.records[0])
