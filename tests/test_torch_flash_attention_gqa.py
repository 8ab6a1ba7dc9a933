"""The GQA group sum that the dK/dV kernel's cluster reduction rests on.

The dK/dV kernel splits the G query heads of a kv head over a thread-block
cluster: each block accumulates dK and dV over its share of the heads, and
the blocks' partial sums are added in a fixed order. That is right because
the GQA gradient of k and v is the sum, over the group, of the gradients
each query head would give a k and v of its own (multi-head attention with
k and v repeated). These tests hold the port's plain twin
``reference_attention_dkv`` to that decomposition, in the kernel's order,
and to ``jax.vjp`` of the JAX package's ``reference_attention``, on numpy
inputs from a seed. No CPU test reaches the kernel: chip_smoke.py holds it
against the twin on the card, with a check that two launches agree bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import (
    reference_attention as jax_reference_attention)
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (
    attention_bwd_delta, reference_attention_dkv, reference_attention_lse)

# f32 throughout. The twin sums a group's heads and its queries in one
# einsum, the decompositions head by head, so only the order of the f32
# sums differs; JAX differentiates the softmax where the port recomputes
# P = exp(S - lse).
TOL = 1e-5
MAX_CLUSTER = 8  # the portable thread-block cluster size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; these small
    shapes gain nothing from more torch threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(G, causal, B=2, S=24, Hkv=2, D=16, seed=0):
    """q, k, v, dO from a numpy seed, and the forward's lse and delta."""
    rng = np.random.default_rng(seed + 10 * G + int(causal))
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, h, D))
                                    .astype(np.float32))
                   for h in (G * Hkv, Hkv, Hkv, G * Hkv))
    o, lse = reference_attention_lse(q, k, v, causal=causal)
    return q, k, v, do, lse, attention_bwd_delta(o, do)


def _per_head(q, k, v, do, lse, delta, causal):
    """dK and dV (B, S, Hq, D) of every query head with a k and v of its
    own: multi-head attention on k and v repeated over the group."""
    G = q.shape[2] // k.shape[2]
    return reference_attention_dkv(
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2), do,
        lse, delta, causal=causal)


def _group_sum(per, G, heads):
    """(B, S, Hkv, D): per kv head j, the per-head gradients of query heads
    j G .. j G + G - 1 added in the order that ``heads`` lists them."""
    B, S, Hq, D = per.shape
    grouped = per.reshape(B, S, Hq // G, G, D)
    out = grouped[:, :, :, heads[0]].clone()
    for i in heads[1:]:
        out += grouped[:, :, :, i]
    return out


def _cluster(G):
    """The dK/dV kernel's cluster size: the largest divisor of G that is at
    most 8."""
    return max(c for c in range(1, MAX_CLUSTER + 1) if G % c == 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_group_dkv_is_the_ordered_sum_of_per_head_dkv(G, causal):
    q, k, v, do, lse, delta = _inputs(G, causal)
    dk, dv = reference_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    pk, pv = _per_head(q, k, v, do, lse, delta, causal)
    for got, per in ((dk, pk), (dv, pv)):
        torch.testing.assert_close(got, _group_sum(per, G, range(G)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_group_dkv_matches_jax_vjp_of_reference_attention(G, causal):
    q, k, v, do, lse, delta = _inputs(G, causal, seed=1)
    _, vjp = jax.vjp(
        lambda *a: jax_reference_attention(*a, causal=causal),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    _, jdk, jdv = vjp(jnp.asarray(do.numpy()))
    dk, dv = reference_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    for name, got, want in (("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 3, 4, 16])
def test_cluster_partials_summed_in_rank_order_give_the_group_sum(G,
                                                                  causal):
    """The kernel's order: block r of a cluster of C sums heads
    r G/C .. (r + 1) G/C - 1, then rank order adds the C partial sums."""
    C = _cluster(G)
    assert G % C == 0 and C <= MAX_CLUSTER
    q, k, v, do, lse, delta = _inputs(G, causal, seed=2)
    dk, dv = reference_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    for got, per in zip((dk, dv), _per_head(q, k, v, do, lse, delta, causal)):
        n = G // C
        partials = [_group_sum(per, G, range(r * n, (r + 1) * n))
                    for r in range(C)]
        total = partials[0].clone()
        for p in partials[1:]:
            total += p
        torch.testing.assert_close(got, total, rtol=TOL, atol=TOL)


def test_cluster_size_is_the_largest_divisor_up_to_eight():
    assert [_cluster(g) for g in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 32)] == \
        [1, 2, 3, 4, 5, 6, 7, 8, 6, 8, 8]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__97fe6771_22_\
flash_attention_fwd_cu_fa_fwd10fa_fwd_f32ILi128EEEvPKfS2_S2_PfS3_iiiNS_7\
StridesES4_S4_S4_fi' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__97fe6771_22_flash_\
attention_fwd_cu_fa_fwd10fa_fwd_f32ILi128EEEvPKfS2_S2_PfS3_iiiNS_7StridesES4\
_S4_S4_fi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 32768 bytes smem
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
function '_ZN53_GLOBAL__N__853623ed_22_flash_attention_dkv_cu_fa_dkv11fa_dkv\
_bf16ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiNS_7\
StridesES6_fi'
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__853623ed_22_\
flash_attention_dkv_cu_fa_dkv11fa_dkv_bf16ILi64EEEv14CUtensorMap_stS1_S1_S1\
_PKfS3_P13__nv_bfloat16S5_iiiNS_7StridesES6_fi' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__853623ed_22_flash_\
attention_dkv_cu_fa_dkv11fa_dkv_bf16ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3\
_P13__nv_bfloat16S5_iiiNS_7StridesES6_fi
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 16 bytes cumulative \
stack size
"""


def test_ptxas_report_reads_registers_spills_and_serialisation():
    assert _build.ptxas_report(PTXAS_LOG) == [
        dict(kernel="fa_fwd_f32<128>", registers=128, spill_stores=0,
             spill_loads=0, smem=32768, wgmma_serialized=False),
        dict(kernel="fa_dkv_bf16<64>", registers=168, spill_stores=8,
             spill_loads=12, smem=0, wgmma_serialized=True)]
    assert _build.ptxas_report("nvcc: no kernels\n") == []


def test_hopper_header_is_a_shared_source():
    """The primitives header is hashed into every kernel's build key."""
    assert (_build.CSRC / "hopper.cuh").exists()
    assert {"flash_attention_fwd", "flash_attention_dkv"} <= set(
        _build.kernel_names())
