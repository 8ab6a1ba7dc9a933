"""The dQ kernel's tile schedule, modelled in plain PyTorch.

The bf16 dQ kernel (``ray_tpu_torch/ops/csrc/flash_attention_dq.cu``)
gives a block a 128-row query tile of one head, split over two consumer
warpgroups of 64 rows, and walks 64-key kv tiles up to the block's causal
end. It masks only on tiles that cross the diagonal or the ragged end, and
a warpgroup skips a tile in which none of its rows sees a live key. Each
warpgroup also computes delta = rowsum(dO * O) for its rows. These tests
repeat that index arithmetic tile by tile in f32, with rows past S read as
the zeros TMA gives, and hold the result against the plain twin
``reference_attention_dq`` for sequence lengths on both sides of the tile
edges: an off-by-one in the tile bounds shows here before it shows on the
card. They also check that the schedule counts every live (query, key)
pair exactly once, that no tile it leaves unmasked holds a masked pair and
that no tile it skips holds a live one. chip_smoke.py holds the kernel
itself against the twin on the card.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops.flash_attention import (reference_attention_dq,
                                               reference_attention_lse)

# f32 on both sides; the schedule sums over kv tiles and takes P in base 2
# as the kernel does, the twin in one einsum with exp.
TOL = 1e-5
BQ = 128      # query rows per block
WG_ROWS = 64  # query rows per consumer warpgroup
BK = 64       # keys per kv tile
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; these small
    shapes gain nothing from more torch threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tile(x, start: int, n: int):
    """Rows start .. start + n - 1 of the (S, D) x, zeros past its end."""
    out = x.new_zeros((n, x.shape[1]))
    rows = max(0, min(n, x.shape[0] - start))
    out[:rows] = x[start:start + rows]
    return out


def tiled_dq(q, k, v, o, do, lse, causal: bool, scale: float):
    """(dQ, delta, live) computed block by block, warpgroup by warpgroup
    and kv tile by kv tile as the kernel schedules them; live[i, j] counts
    how often the pair (query i, key j) of head 0 passed the mask."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    dq = torch.zeros_like(q)
    delta = torch.zeros((B, Hq, S))
    live = torch.zeros((S, S), dtype=torch.int64)
    n_blocks = -(-S // BQ)
    for b in range(B):
        for h in range(Hq):
            kvh = h // G
            for bx in range(n_blocks):
                q0 = (n_blocks - 1 - bx) * BQ  # longest causal row first
                kv_end = min(S, q0 + BQ) if causal else S
                n_tiles = -(-kv_end // BK)
                for wg in range(BQ // WG_ROWS):
                    row0 = q0 + wg * WG_ROWS
                    rows = torch.arange(row0, row0 + WG_ROWS)
                    valid = rows < S
                    qw = _tile(q[b, :, h], row0, WG_ROWS)
                    dow = _tile(do[b, :, h], row0, WG_ROWS)
                    dl = (dow * _tile(o[b, :, h], row0, WG_ROWS)).sum(-1)
                    l2 = torch.where(valid, lse[b, h, rows.clamp(max=S - 1)]
                                     * LOG2E, 0.0)
                    acc = torch.zeros((WG_ROWS, D))
                    for it in range(n_tiles):
                        k0 = it * BK
                        keys = torch.arange(k0, k0 + BK)
                        keep = (keys[None] < S) & valid[:, None]
                        if causal:
                            keep &= keys[None] <= rows[:, None]
                        if causal and k0 > row0 + WG_ROWS - 1:
                            assert not keep.any(), (row0, k0)
                            continue
                        kt = _tile(k[b, :, kvh], k0, BK)
                        vt = _tile(v[b, :, kvh], k0, BK)
                        p = torch.exp2(qw @ kt.T * (scale * LOG2E)
                                       - l2[:, None])
                        dp = dow @ vt.T
                        edge = k0 + BK > S or (causal
                                               and k0 + BK - 1 > row0)
                        if edge:
                            p = torch.where(keys[None] < S, p, 0.0)
                            if causal:
                                p = torch.where(
                                    keys[None] <= rows[:, None], p, 0.0)
                        else:
                            assert keep[valid].all(), (row0, k0)
                        if b == 0 and h == 0:
                            r, c = keep.nonzero(as_tuple=True)
                            live[rows[r], keys[c]] += 1
                        acc += (p * (dp - dl[:, None])) @ kt
                    dq[b, rows[valid], h] = acc[valid] * scale
                    delta[b, h, rows[valid]] = dl[valid]
    return dq, delta, live


def _inputs(S, Hq, Hkv, D, causal, seed=0):
    rng = np.random.default_rng(seed + S + 7 * D + Hq + int(causal))
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, S, h, D))
                                    .astype(np.float32))
                   for h in (Hq, Hkv, Hkv, Hq))
    o, lse = reference_attention_lse(q, k, v, causal=causal)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 255])
def test_tile_schedule_matches_the_plain_twin(S, causal, D, G):
    Hkv = 2
    q, k, v, o, do, lse = _inputs(S, G * Hkv, Hkv, D, causal)
    scale = D ** -0.5
    dq, delta, live = tiled_dq(q, k, v, o, do, lse, causal, scale)
    want_dq, want_delta = reference_attention_dq(q, k, v, o, do, lse,
                                                 causal=causal, scale=scale)
    torch.testing.assert_close(delta, want_delta, rtol=TOL, atol=TOL)
    torch.testing.assert_close(dq, want_dq, rtol=TOL, atol=TOL)
    pairs = torch.ones((S, S), dtype=torch.int64)
    torch.testing.assert_close(live, pairs.tril() if causal else pairs,
                               rtol=0, atol=0)
