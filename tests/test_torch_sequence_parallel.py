"""Parity of ray_tpu_torch's streamed paged-KV attention with the JAX
package's on the CPU.

``_stream_block_fn`` runs on the same seeded numpy queries, blocks and
running state on both sides, and ``StreamAttn``'s pieces on the JAX
engine's ``tiny`` params (f32) carried across; both within 1e-5 relative.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.sequence_parallel import StreamAttn as JaxStreamAttn
from ray_tpu.llm.sequence_parallel import \
    _stream_block_fn as jax_stream_block_fn
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.models import init_params as jax_init_params
from ray_tpu_torch.llm.sequence_parallel import StreamAttn, _stream_block_fn
from ray_tpu_torch.models import PRESETS, from_jax_params
from ray_tpu_torch.models.transformer import layer_params, tp_layer

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
HQ, HKV, D = 8, 4, 16
SCALE = 1.0 / np.sqrt(D)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _q(rng, sq):
    return rng.standard_normal((sq, HQ, D)).astype(np.float32)


def _kv(rng, sk):
    return (rng.standard_normal((sk, HKV, D)).astype(np.float32),
            rng.standard_normal((sk, HKV, D)).astype(np.float32))


def _init(sq):
    shape = (HKV, HQ // HKV, sq)
    return (np.full(shape + (1,), -1e30, np.float32),
            np.zeros(shape + (1,), np.float32),
            np.zeros(shape + (D,), np.float32))


def _both(q, kb, vb, k_valid, q0, k0, state):
    """One block on each side: (JAX's (m, l, acc), the port's) as numpy."""
    want = jax_stream_block_fn(jnp.asarray(q), jnp.asarray(kb),
                               jnp.asarray(vb), k_valid, q0, k0,
                               *map(jnp.asarray, state), scale=SCALE)
    got = _stream_block_fn(torch.from_numpy(q), torch.from_numpy(kb),
                           torch.from_numpy(vb), k_valid, q0, k0,
                           *(torch.tensor(s) for s in state), scale=SCALE)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


# (Sq, Sk, k_valid, q_pos0, k_pos0): every kind of block the engine merges.
BLOCKS = {
    "before": (5, 8, 8, 40, 0),
    "before_ragged": (5, 8, 3, 40, 16),        # key-valid count below Sk
    "self_triangular": (5, 8, 5, 40, 40),      # padded to 8, 5 valid
    "decode_before": (1, 8, 8, 40, 8),
    "decode_ragged": (1, 8, 6, 40, 24),
    "decode_self": (1, 1, 1, 40, 40),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_stream_block_fn_matches_jax(name):
    """From a running state left by an earlier block, one more block gives
    the same (m, l, acc) on both sides."""
    sq, sk, k_valid, q0, k0 = BLOCKS[name]
    rng = np.random.default_rng(sorted(BLOCKS).index(name))
    q = _q(rng, sq)
    want, got = _both(q, *_kv(rng, 8), 8, q0, 0, _init(sq))
    state = [w.copy() for w in want]
    want, got = _both(q, *_kv(rng, sk), k_valid, q0, k0, state)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert np.isfinite(got[1]).all() and (got[1] > 0).all()


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("fresh", [True, False])
def test_a_block_after_the_queries_leaves_the_state_bit_identical(sq, fresh):
    """A block wholly after the queries is fully masked: the state comes
    back unchanged, bit for bit, on both sides (the explicit re-mask of p;
    without it each masked key would add exp(0) = 1 to l)."""
    rng = np.random.default_rng(7 + sq)
    q = _q(rng, sq)
    state = _init(sq)
    if not fresh:
        state = [np.asarray(w) for w in
                 _both(q, *_kv(rng, 8), 8, 40, 0, state)[0]]
    want, got = _both(q, *_kv(rng, 8), 8, 40, 48, state)
    for s, w, g in zip(state, want, got):
        assert np.array_equal(w, s) and np.array_equal(g, s)


@pytest.mark.parametrize("sq", [1, 5])
def test_every_block_order_gives_the_same_attention(sq):
    """Three blocks (a full one before the queries, a ragged one, the
    triangular self block) merged in each of the six orders: acc / l agrees
    across orders and with JAX's within 1e-5."""
    rng = np.random.default_rng(20 + sq)
    q0 = 40
    q = _q(rng, sq)
    blocks = [(*_kv(rng, 8), 8, 0), (*_kv(rng, 8), 5, 16),
              (*_kv(rng, sq), sq, q0)]
    results = []
    for order in itertools.permutations(range(3)):
        jstate = tstate = _init(sq)
        for i in order:
            kb, vb, k_valid, k0 = blocks[i]
            want, _ = _both(q, kb, vb, k_valid, q0, k0, jstate)
            _, got = _both(q, kb, vb, k_valid, q0, k0, tstate)
            jstate, tstate = want, got
        o_jax = jstate[2] / jstate[1]
        o_port = tstate[2] / tstate[1]
        np.testing.assert_allclose(o_port, o_jax, rtol=RTOL, atol=ATOL)
        results.append(o_port)
    for o in results[1:]:
        np.testing.assert_allclose(o, results[0], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def stream_pair():
    """JAX's StreamAttn and the port's, over the same ``tiny`` params."""
    jparams = jax_init_params(JCFG, jax.random.key(3))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    return (JaxStreamAttn(JCFG), jparams), (StreamAttn(CFG, "cpu"), params)


@pytest.mark.parametrize("pos0", [0, 37])
@pytest.mark.parametrize("sq", [1, 6])
def test_stream_attn_pieces_match_jax(stream_pair, pos0, sq):
    """embed, rope_qkv (RoPE at pos0 + i) and heads through tp_layer (one
    position, as the engine's streamed layer runs them), and logits, of
    the port's StreamAttn against JAX's qkv, finish and logits on the
    same tokens and state."""
    (jsa, jparams), (tsa, params) = stream_pair
    rng = np.random.default_rng(pos0 + sq)
    toks = rng.integers(1, CFG.vocab_size, (1, sq)).astype(np.int32)
    jx = jsa.embed(jparams, toks)
    tx = tsa.embed(params, toks)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    shape = (CFG.num_kv_heads, CFG.num_heads // CFG.num_kv_heads, sq)
    l = rng.uniform(0.5, 3.0, shape + (1,)).astype(np.float32)
    acc = rng.standard_normal(shape + (CFG.head_dim_,)).astype(np.float32)
    dev = tx.device
    for li in range(CFG.num_layers):
        want = jsa.qkv(jparams["layers"], li, jx, pos0)
        lp = layer_params(params, li)

        def attend(h):
            got = tsa.rope_qkv(lp, h[dev], pos0)
            for w, g in zip(want, got):
                assert tuple(g.shape) == w.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)
            return [tsa.heads(torch.from_numpy(l), torch.from_numpy(acc))]
        jx = jsa.finish(jparams["layers"], li, jx, jnp.asarray(l),
                        jnp.asarray(acc))
        tx = tp_layer(CFG, {dev: tx}, [lp], [dev], attend)[dev]
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)
    for idx in range(sq):
        want = np.asarray(jsa.logits(jparams, jx, idx))
        got = tsa.logits(params, tx, idx)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_init_state_and_device():
    sa = StreamAttn(CFG, "cpu")
    m, l, acc = sa.init(3)
    kv, g, d = CFG.num_kv_heads, CFG.num_heads // CFG.num_kv_heads, \
        CFG.head_dim_
    assert tuple(m.shape) == tuple(l.shape) == (kv, g, 3, 1)
    assert tuple(acc.shape) == (kv, g, 3, d)
    assert all(t.dtype == torch.float32 for t in (m, l, acc))
    assert (m == -1e30).all() and not l.any() and not acc.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamAttn(CFG)
