"""Paged-decode attention (ray_tpu_torch/ops/paged_attention.py).

On the CPU: the plain twin is the engine's old inline decode attention,
bit for bit; the wrapper refuses what the kernel does not take; the split
count follows the shapes; the engine's decode calls the op once per layer
and position a step. Tests marked ``card`` hold the CUDA kernel against
the twin on an NVIDIA card and skip inside the test without one:

    python -m pytest tests/test_torch_paged_decode.py -m card

This file does not import JAX: the engine's parity with the JAX package is
held by tests/test_torch_engine*.py, which run through the twin.
"""

import math

import pytest
import torch

from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as engine_mod
from ray_tpu_torch.models import PRESETS, TransformerConfig, init_params
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops import (paged_decode_attention,
                               reference_paged_decode_attention)
from ray_tpu_torch.parallel import MeshSpec, build_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sqrt_d(D, dtype):
    """The engine's divisor: sqrt(head_dim) rounded to the working type."""
    return float(torch.tensor(math.sqrt(D), dtype=dtype))


def _old_inline(q, pk, pv, tb, lengths, groups, sqrt_d):
    """The engine's decode attention as it was written inline in
    ``_decode_fn`` before the op existed, line for line."""
    B, _, D = q.shape
    T = tb.shape[1] * pk.shape[1]
    valid = torch.arange(T, device=q.device)[None] <= lengths[:, None]
    masked = ~valid[:, None]
    kr = pk[tb].reshape(B, T, -1, D).repeat_interleave(groups, 2)
    vr = pv[tb].reshape(B, T, -1, D).repeat_interleave(groups, 2)
    scores = torch.einsum("bhd,bthd->bht", q, kr) / sqrt_d
    scores = scores.masked_fill(masked, -1e30)
    p = torch.softmax(scores.float(), -1).to(q.dtype)
    return torch.einsum("bht,bthd->bhd", p, vr)


def _inputs(gen, B, Hq, KV, D, page, P, lengths, active, dtype, device):
    """Random q and pools; each slot's live pages distinct and scattered
    over the pool, its other table entries 0 (the scratch page), as the
    engine lays them out."""
    N = B * P + 1
    q = torch.randn((B, Hq, D), generator=gen).to(dtype)
    pk = torch.randn((N, page, KV, D), generator=gen).to(dtype)
    pv = torch.randn((N, page, KV, D), generator=gen).to(dtype)
    perm = torch.randperm(N - 1, generator=gen) + 1
    tables = torch.zeros((B, P), dtype=torch.int64)
    for b in range(B):
        live = int(lengths[b]) // page + 1
        tables[b, :live] = perm[b * P:b * P + live]
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    active = torch.as_tensor(active, dtype=torch.bool)
    return [t.to(device) for t in (q, pk, pv, tables, lengths, active)]


# --------------------------------------------------------------- the twin --

TWIN_CASES = [  # (G, page, D, dtype)
    (1, 16, 16, torch.bfloat16),
    (2, 16, 16, torch.bfloat16),
    (4, 16, 16, torch.bfloat16),
    (1, 64, 16, torch.bfloat16),
    (2, 64, 16, torch.float32),
    (4, 64, 16, torch.bfloat16),
    # bf16(sqrt(38)) does not survive 1 / (1 / x) in float64: the twin's
    # division must still match.
    (4, 16, 38, torch.bfloat16),
    (2, 16, 11, torch.float32),
]


@pytest.mark.parametrize("G,page,D,dtype", TWIN_CASES,
                         ids=[f"G{c[0]}-page{c[1]}-D{c[2]}-{c[3]}"
                              .replace("torch.", "") for c in TWIN_CASES])
def test_twin_is_the_old_inline_code_bit_for_bit(G, page, D, dtype):
    P, KV = 4, 2
    T = P * page
    # 0, the last key of page 0, the first of page 1, the last of page 1,
    # T - 1; slots 1 and 4 inactive.
    lengths = [0, page - 1, page, 2 * page - 1, T - 1, T - 1, 3]
    active = [True, False, True, True, False, True, True]
    gen = torch.Generator().manual_seed(G * 1000 + page + D)
    q, pk, pv, tb, lens, act = _inputs(gen, len(lengths), G * KV, KV, D,
                                       page, P, lengths, active, dtype,
                                       "cpu")
    sqrt_d = _sqrt_d(D, dtype)
    old = _old_inline(q, pk, pv, tb, lens, G, sqrt_d)
    for fn in (reference_paged_decode_attention, paged_decode_attention):
        got = fn(q, pk, pv, tb, lens, act, 1.0 / sqrt_d)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got[act], old[act])
        assert not got[~act].any()


# ------------------------------------------------------------ the wrapper --

def _good(dtype=torch.bfloat16, D=128, page=64, device="cpu"):
    gen = torch.Generator().manual_seed(0)
    return _inputs(gen, 2, 8, 2, D, page, 2, [3, page + 5], [True, True],
                   dtype, device)


def test_check_takes_what_the_kernel_takes_but_the_device():
    with pytest.raises(ValueError, match="CUDA"):
        pa._check(*_good())
    with pytest.raises(ValueError, match="CUDA"):
        pa._check(*_good(torch.float32, 64, 16))


@pytest.mark.parametrize("what,match", [
    ("head_dim", "head_dim"), ("page", "at least one"), ("dtype", "float32"),
    ("pool_dtype", "float32"), ("tables", "int64"), ("active", "bool"),
    ("groups", "multiple"), ("q_rank", r"\(B, Hq, D\)"),
    ("pool_shape", "do not match"), ("lengths", r"lengths \(B,\)"),
    ("q_stride", "contiguous head dim"), ("pool_layout", "contiguous pools"),
    ("table_stride", "table rows"), ("mixed_devices", "one CUDA device")])
def test_check_refuses_what_the_kernel_does_not_take(what, match):
    q, pk, pv, tb, lens, act = _good()
    if what == "head_dim":
        q, pk, pv, tb, lens, act = _good(D=96)
    elif what == "page":
        pk, pv = pk[:, :0], pv[:, :0]
    elif what == "dtype":
        q, pk, pv = (t.half() for t in (q, pk, pv))
    elif what == "pool_dtype":
        pk = pk.float()
    elif what == "tables":
        tb = tb.int()
    elif what == "active":
        act = act.long()
    elif what == "groups":
        q = q[:, :7].contiguous()
    elif what == "q_rank":
        q = q[:, None]
    elif what == "pool_shape":
        pv = pv[:, :, :1].contiguous()
    elif what == "lengths":
        lens = lens[:1]
    elif what == "q_stride":
        q = torch.empty((2, 8, 256), dtype=q.dtype)[..., ::2]
    elif what == "pool_layout":
        pk = pk.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "table_stride":
        tb = torch.zeros((4, 2), dtype=torch.int64).t()
    elif what == "mixed_devices":
        q = q.to("meta")
    with pytest.raises(ValueError, match=match):
        pa._check(q, pk, pv, tb, lens, act)


def test_non_cpu_tensors_never_take_the_twin():
    """Off the CPU the wrapper launches the kernel or raises: meta tensors
    stand in for a device the kernel does not take."""
    args = [t.to("meta") for t in _good()]
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(*args, 0.088)


def test_kernel_source_is_found():
    assert "paged_decode" in pa._build.kernel_names()


@pytest.mark.parametrize("shape,want", [
    ((16, 8, 4, 4096, 132), (512, 8)),      # docqa: 16 slots, Nemo heads
    ((32, 8, 4, 2048, 132), (512, 4)),      # chat: 32 slots, Mistral heads
    ((16, 4, 4, 4096, 132), (256, 16)),     # docqa at a tp=2 position
    ((16, 2, 4, 4096, 132), (128, 32)),     # docqa at a tp=4 position
    ((1, 2, 4, 2048, 132), (64, 32)),       # one request, a tp=4 position
    ((1, 1, 32, 128, 132), (64, 2)),        # G 32: two head chunks
    ((4, 2, 2, 48, 132), (64, 1)),          # T shorter than a round
])
def test_split_count_follows_the_shapes(shape, want):
    assert pa.split_keys(*shape) == want


def test_splits_cover_every_key_in_steps_of_16():
    for B in (1, 3, 16, 64):
        for KV in (1, 2, 8):
            for G in (1, 4, 17):
                for T in (16, 48, 64, 1000, 2048, 4096, 8192):
                    chunk, S = pa.split_keys(B, KV, G, T, 132)
                    assert chunk % 16 == 0 and chunk <= 512
                    assert (S - 1) * chunk < T <= S * chunk


# ------------------------------------------------------------- the engine --

@pytest.mark.parametrize("tp", [1, 2])
def test_engine_decode_calls_the_op_per_layer_and_position(monkeypatch, tp):
    """Every decode step attends through the op, once per layer and
    position, with each position's pool of its own kv heads."""
    cfg = PRESETS["tiny"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []

    def counted(q, pk, pv, *rest):
        calls.append((q.shape[1], pk.shape[2]))
        return reference_paged_decode_attention(q, pk, pv, *rest)

    monkeypatch.setattr(engine_mod, "paged_decode_attention", counted)
    kw = {} if tp == 1 else dict(
        mesh=build_mesh(MeshSpec(tp=tp), devices=[torch.device("cpu")] * tp))
    eng = LLMEngine(cfg, params, max_batch=3, max_len=64, page_size=16,
                    device="cpu", **kw)
    decodes = []
    step = engine_mod._decode_fn

    def counted_step(*a, **k):
        decodes.append(1)
        return step(*a, **k)

    monkeypatch.setattr(engine_mod, "_decode_fn", counted_step)
    eng.generate([[1, 2, 3], [4, 5, 6, 7, 8]], SamplingParams(max_tokens=5))
    assert decodes and len(calls) == cfg.num_layers * tp * len(decodes)
    assert set(calls) == {(cfg.num_heads // tp, cfg.num_kv_heads // tp)}


# --------------------------------------------------------------- the card --

def _against_twin(args, scale):
    """(kernel o, twin o, exact o, max |kernel - exact|, tol, max |kernel -
    twin|, max |twin - exact|) over the active rows."""
    q, pk, pv, tb, lens, act = args
    o = paged_decode_attention(q, pk, pv, tb, lens, act, scale)
    twin = reference_paged_decode_attention(q, pk, pv, tb, lens, act, scale)
    exact = reference_paged_decode_attention(q.float(), pk.float(),
                                             pv.float(), tb, lens, act,
                                             scale)
    torch.cuda.synchronize()
    a = act
    err = (o[a].float() - exact[a]).abs().max().item()
    err_twin = (o[a].float() - twin[a].float()).abs().max().item()
    twin_err = (twin[a].float() - exact[a]).abs().max().item()
    tol = pa.kernel_tolerance(q.dtype, pv, exact[a])
    return o, twin, exact, err, tol, err_twin, twin_err


def _lengths(gen, B, lo, hi):
    return torch.randint(lo, hi + 1, (B,), generator=gen).tolist()


CARD_CASES = {
    # (B, Hq, KV, D, page, P, dtype, lengths(gen), active)
    "chat": (32, 32, 8, 128, 64, 32, torch.bfloat16,
             lambda g: [0, 63, 64, 2047] + _lengths(g, 28, 31, 2047),
             [i % 3 != 1 for i in range(32)]),
    "docqa": (16, 32, 8, 128, 64, 64, torch.bfloat16,
              lambda g: _lengths(g, 16, 2048, 3327), [True] * 16),
    "tp2_docqa": (16, 16, 4, 128, 64, 64, torch.bfloat16,
                  lambda g: _lengths(g, 16, 2048, 3327), [True] * 16),
    "tp4_docqa": (16, 8, 2, 128, 64, 64, torch.bfloat16,
                  lambda g: _lengths(g, 16, 2048, 3327), [True] * 16),
    "cut_in_page": (1, 8, 2, 128, 128, 16, torch.bfloat16,
                    lambda g: [2047 - 37], [True]),
    "G1_D64_page16": (5, 8, 8, 64, 16, 20, torch.bfloat16,
                      lambda g: [0, 15, 16, 319, 200], [True] * 5),
    "page8": (4, 32, 8, 128, 8, 40, torch.bfloat16,
              lambda g: [0, 7, 8, 319], [True] * 4),
    "page24": (3, 16, 4, 128, 24, 20, torch.bfloat16,
               lambda g: [23, 24, 479], [True, True, True]),
    "G2_page32": (4, 16, 8, 128, 32, 10, torch.bfloat16,
                  lambda g: [31, 32, 319, 100], [True, False, True, True]),
    "G12_hi_rows": (3, 24, 2, 128, 64, 8, torch.bfloat16,
                    lambda g: [5, 300, 511], [True] * 3),
    "G32_chunks": (2, 32, 1, 64, 64, 8, torch.bfloat16,
                   lambda g: [511, 77], [True] * 2),
    "f32": (6, 32, 8, 128, 64, 8, torch.float32,
            lambda g: [0, 63, 64, 511, 300, 9], [True] * 5 + [False]),
    "f32_D64_G3": (3, 6, 2, 64, 16, 12, torch.float32,
                   lambda g: [0, 191, 50], [True] * 3),
}


def _case(name, device):
    B, Hq, KV, D, page, P, dtype, lens, active = CARD_CASES[name]
    gen = torch.Generator().manual_seed(len(name))
    args = _inputs(gen, B, Hq, KV, D, page, P, lens(gen), active, dtype,
                   device)
    return args, 1.0 / _sqrt_d(D, dtype)


@pytest.mark.card
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_the_twin_on_the_card(card, name):
    """Within the kernel's own rounding of the exact function, and no
    farther from the twin than the twin is from the exact function plus
    that rounding (the twin rounds its scores to bf16 twice); inactive
    rows zero."""
    args, scale = _case(name, card)
    act = args[5]
    o, twin, exact, err, tol, err_twin, twin_err = _against_twin(args, scale)
    print(f"{name}: |kernel - exact| {err:.3g} (tol {tol:.3g}), "
          f"|kernel - twin| {err_twin:.3g}, |twin - exact| {twin_err:.3g}")
    assert torch.isfinite(o).all()
    assert err <= tol
    assert err_twin <= twin_err + tol
    assert not o[~act].any()


@pytest.mark.card
def test_a_split_cuts_inside_a_page(card):
    B, Hq, KV, D, page, P = CARD_CASES["cut_in_page"][:6]
    chunk, splits = pa.split_keys(
        B, KV, Hq // KV, P * page,
        torch.cuda.get_device_properties(card).multi_processor_count)
    assert chunk % page and splits > 1


@pytest.mark.card
def test_kernel_reads_only_live_keys(card):
    """Every pool row outside a slot's live keys holds NaN, the scratch
    page and the rest of each slot's last page included; the kernel's
    output stays finite and equal to its output on the clean pool."""
    args, scale = _case("chat", card)
    q, pk, pv, tb, lens, act = args
    clean = paged_decode_attention(q, pk, pv, tb, lens, act, scale)
    live = torch.zeros(pk.shape[:2], dtype=torch.bool, device=card)
    page = pk.shape[1]
    for b in torch.nonzero(act)[:, 0].tolist():
        pos = torch.arange(int(lens[b]) + 1, device=card)
        live[tb[b, pos // page], pos % page] = True
    dirty_k, dirty_v = pk.clone(), pv.clone()
    dirty_k[~live] = float("nan")
    dirty_v[~live] = float("nan")
    o = paged_decode_attention(q, dirty_k, dirty_v, tb, lens, act, scale)
    assert torch.equal(o, clean)


@pytest.mark.card
def test_launch_count_no_host_sync_and_graph_replay(card):
    """Each call is one counted launch; a call makes no host sync; a call
    captured in a CUDA graph replays against new lengths and slots."""
    args, scale = _case("chat", card)
    q, pk, pv, tb, lens, act = args
    paged_decode_attention(*args, scale)        # builds and loads
    torch.cuda.synchronize()
    n0 = paged_decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            paged_decode_attention(*args, scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert paged_decode_attention.launches == n0 + 3

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_decode_attention(*args, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_decode_attention(*args, scale)
    gen = torch.Generator().manual_seed(7)
    new_lens = torch.randint(0, int(lens.max()) + 1, lens.shape,
                             generator=gen)
    lens.copy_(new_lens)
    act.copy_(torch.rand(act.shape, generator=gen) < 0.5)
    graph.replay()
    torch.cuda.synchronize()
    want = reference_paged_decode_attention(q, pk, pv, tb, lens, act, scale)
    exact = reference_paged_decode_attention(q.float(), pk.float(),
                                             pv.float(), tb, lens, act,
                                             scale)
    assert (out[act].float() - exact[act]).abs().max() \
        <= pa.kernel_tolerance(q.dtype, pv, exact[act])
    assert not out[~act].any() and not want[~act].any()


@pytest.mark.card
def test_engine_decode_launches_the_kernel(card):
    """On a CUDA engine every decode step launches the kernel once per
    layer."""
    cfg = TransformerConfig(vocab_size=512, hidden_size=512,
                            intermediate_size=1024, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=512,
                            dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         "cuda")
    eng = LLMEngine(cfg, params, max_batch=4, max_len=256, page_size=64,
                    device="cuda")
    steps = []
    step = engine_mod._decode_fn

    def counted(*a, **k):
        steps.append(1)
        return step(*a, **k)

    n0 = paged_decode_attention.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "_decode_fn", counted)
        eng.generate([[1, 2, 3], list(range(5, 90))],
                     SamplingParams(max_tokens=8))
    assert steps
    assert paged_decode_attention.launches - n0 \
        == cfg.num_layers * len(steps)
