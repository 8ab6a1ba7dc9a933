"""Parity of ray_tpu_torch's memory planner with the JAX package's
``parallel/planner.py``, and with the bytes the port's shards hold.

The state part (params, grads, Adam moments per position) is exact: it
must equal the JAX planner's for the same config, mesh spec, batch and
``hbm_gib``, and the bytes of each position's own params, mu and nu in the
sharded train state on a mesh that names the CPU 8 times. The activation
part is the port's own (its remat keeps each layer's input), so it is
checked against its definition, not against JAX's.
"""

import dataclasses

import jax
import pytest
import torch

from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel.planner import plan_train_memory as jax_plan
from ray_tpu.parallel.sharding import LogicalAxisRules as JaxRules
from ray_tpu_torch.models import PRESETS, make_optimizer, make_train_step
from ray_tpu_torch.models.transformer import megatron_rules
from ray_tpu_torch.parallel import (MemoryPlan, MeshSpec, build_mesh,
                                    plan_7b_north_star, plan_train_memory)

SPECS = [dict(), dict(dp=2), dict(fsdp=2), dict(tp=2), dict(fsdp=2, tp=2),
         dict(dp=2, fsdp=2, tp=2), dict(fsdp=4, tp=2), dict(dp=8),
         dict(sp=4), dict(pp=2), dict(pp=2, dp=2, tp=2),
         dict(pp=4, fsdp=2), dict(dp=2, sp=2), dict(sp=2, tp=2),
         dict(fsdp=2, sp=2, tp=2), dict(pp=2, sp=2)]
ENGINE_OVERRIDES = (("vocab", None), ("embed", None))


def _rules(megatron: bool):
    if not megatron:
        return JaxRules.default(), None
    return JaxRules.default().with_overrides(*ENGINE_OVERRIDES), \
        megatron_rules()


@pytest.mark.parametrize("megatron", [False, True])
@pytest.mark.parametrize("preset", ["tiny", "8b-gqa"])
@pytest.mark.parametrize("spec", SPECS)
def test_state_bytes_match_jax(spec, preset, megatron):
    jrules, rules = _rules(megatron)
    want = jax_plan(JAX_PRESETS[preset], JaxMeshSpec(**spec),
                    global_batch=8, seq_len=256, rules=jrules, hbm_gib=80.0)
    got = plan_train_memory(PRESETS[preset], MeshSpec(**spec),
                            global_batch=8, seq_len=256, rules=rules,
                            hbm_gib=80.0)
    assert isinstance(got, MemoryPlan)
    assert (got.params_bytes, got.grads_bytes, got.opt_bytes) == \
        (want.params_bytes, want.grads_bytes, want.opt_bytes)
    assert got.hbm_bytes == want.hbm_bytes == 80 << 30
    assert got.global_batch == 8 and got.seq_len == 256


def test_the_8b_state_on_one_position_is_the_unsharded_state():
    """PERF.md's reckoning: 8,030,261,248 bf16 params (norms f32) are
    16.06 GB; grads as much, mu and nu twice."""
    plan = plan_train_memory(PRESETS["8b-gqa"], MeshSpec(), global_batch=4,
                             seq_len=2048, hbm_gib=80.0)
    assert plan.params_bytes == 16_061_054_976
    assert plan.state_bytes == 4 * 16_061_054_976
    assert plan.fits and "=> FITS" in plan.table()
    small = plan_train_memory(PRESETS["8b-gqa"], MeshSpec(), global_batch=4,
                              seq_len=2048, hbm_gib=64.0)
    assert not small.fits and "DOES NOT FIT" in small.table()


@pytest.mark.parametrize("megatron", [False, True])
@pytest.mark.parametrize("spec", [dict(dp=2, fsdp=2, tp=2),
                                  dict(fsdp=4, tp=2), dict(dp=2, tp=4),
                                  dict(fsdp=8), dict(pp=2, dp=2, tp=2),
                                  dict(pp=2, fsdp=2, tp=2),
                                  dict(dp=2, sp=2, tp=2),
                                  dict(pp=2, sp=2, tp=2)])
def test_position_bytes_equal_the_shards_bytes(spec, megatron):
    """For every position of the sharded train state, the planner's params
    and optimizer bytes are those of that position's own params, mu and nu
    (the tensors it shares with other positions included); under pp a
    position's layer tensors hold its stage's L/pp layers."""
    cfg = PRESETS["tiny"]
    rules = megatron_rules() if megatron else None
    mesh = build_mesh(MeshSpec(**spec), devices=["cpu"] * 8)
    tb = make_train_step(cfg, mesh, optimizer=make_optimizer(),
                         rules=rules, device="cpu")
    state = tb.init(torch.Generator().manual_seed(0))
    plan = plan_train_memory(cfg, MeshSpec(**spec), global_batch=8,
                             rules=rules, hbm_gib=1.0)
    opt = state["opt_state"]

    def nbytes(tree):
        return sum(t.nbytes for t in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for i in range(8):
        assert nbytes(state["params"][i]) == plan.params_bytes, i
        assert nbytes(opt["mu"][i]) + nbytes(opt["nu"][i]) \
            == plan.opt_bytes, i


def test_activation_part_reckons_the_ports_remat():
    """Each layer's input per batch group, the logits and their saved
    exponentials split over tp, and one layer's recompute with its fsdp
    gather."""
    cfg = PRESETS["8b-gqa"]
    plan = plan_train_memory(cfg, MeshSpec(dp=2, fsdp=2, tp=2),
                             global_batch=4, seq_len=2048, hbm_gib=80.0)
    tokens = 1 * 2048                       # one sequence per batch group
    assert plan.activation_bytes == 32 * tokens * 4096 * 2
    assert plan.logits_bytes == 2 * tokens * (128256 // 2) * 4
    layer = 2 * 4096 + 2 * 16 * 128 + 2 * 4 * 128 + 16 * 128 + 3 * 7168
    weights = (4096 * 128 * (2 * 32 + 2 * 8) + 3 * 4096 * 14336) // 2
    assert plan.workspace_bytes == tokens * layer * 2 + weights * 2
    assert plan.total_bytes == (plan.state_bytes + plan.activation_bytes
                                + plan.logits_bytes + plan.workspace_bytes)


def test_pp_part_reckons_the_pipeline_schedule():
    """Under pp=2 x dp=2 x tp=2 with 2 microbatches a position holds its
    stage's 16 layers' inputs for every row of its batch group and, on the
    last stage, the group's logits (the group's backward starts after all
    of its microbatches' forwards); the workspace is one microbatch's."""
    cfg = PRESETS["8b-gqa"]
    plan = plan_train_memory(cfg, MeshSpec(pp=2, dp=2, tp=2),
                             global_batch=4, seq_len=2048,
                             num_microbatches=2, hbm_gib=80.0)
    group = 2 * 2048                      # two sequences per batch group
    assert plan.activation_bytes == 16 * group * 4096 * 2
    assert plan.logits_bytes == 2 * group * (128256 // 2) * 4
    layer = 2 * 4096 + 2 * 16 * 128 + 2 * 4 * 128 + 16 * 128 + 3 * 7168
    assert plan.workspace_bytes == (group // 2) * layer * 2
    deeper = plan_train_memory(cfg, MeshSpec(pp=2, dp=2, tp=2),
                               global_batch=4, seq_len=2048,
                               num_microbatches=1, hbm_gib=80.0)
    assert deeper.workspace_bytes == group * layer * 2
    default = plan_train_memory(cfg, MeshSpec(pp=2, dp=2, tp=2),
                                global_batch=4, seq_len=2048, hbm_gib=80.0)
    assert default == plan


def test_7b_north_star_plans_fit():
    """Llama-2-7B state and activations fit 80 GB cards at n=16 and n=64
    (the port of tests/test_parallel_advanced.py:242-256, at the H100's
    memory), the total param bytes across the mesh within the reference's
    bounds of param_count * 2."""
    for n in (16, 64):
        plan = plan_7b_north_star(n, hbm_gib=80.0)
        assert plan.fits, plan.table()
        assert plan.spec.n_devices == n
        assert plan.cfg == PRESETS["7b"] and plan.seq_len == 4096
        total_params = plan.params_bytes * plan.spec.n_devices
        expect = plan.cfg.param_count() * 2
        assert expect * 0.98 <= total_params <= expect * 1.30, \
            (total_params, expect)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_7b_north_star(16)


def test_unported_layouts_and_a_missing_card_raise():
    cfg = PRESETS["tiny"]
    # pp is a training layout now; num_microbatches without a pp axis is
    # ignored, as the train step ignores it.
    assert plan_train_memory(cfg, MeshSpec(pp=2), global_batch=8,
                             hbm_gib=1.0).params_bytes < plan_train_memory(
        cfg, MeshSpec(), global_batch=8, hbm_gib=1.0).params_bytes
    assert plan_train_memory(cfg, MeshSpec(), global_batch=8, hbm_gib=1.0,
                             num_microbatches=2) == plan_train_memory(
        cfg, MeshSpec(), global_batch=8, hbm_gib=1.0)
    # sp beside tp is a training layout now: a position holds its
    # sequence shard (S / sp tokens of each row), and under ring attention
    # the ring's saved f32 blocks (3 per merge, sp merges, each
    # (B, H/tp, S/sp, S/sp)) join the workspace.
    tp2 = plan_train_memory(cfg, MeshSpec(tp=2), global_batch=8,
                            hbm_gib=1.0)
    sptp = plan_train_memory(cfg, MeshSpec(sp=2, tp=2), global_batch=8,
                             hbm_gib=1.0)
    assert sptp.state_bytes == tp2.state_bytes
    assert 2 * sptp.activation_bytes == tp2.activation_bytes
    assert 2 * sptp.logits_bytes == tp2.logits_bytes
    ring = plan_train_memory(
        dataclasses.replace(cfg, attention_impl="ring"), MeshSpec(sp=2, tp=2),
        global_batch=8, hbm_gib=1.0)
    S = cfg.max_seq_len // 2
    assert ring.workspace_bytes - sptp.workspace_bytes == \
        3 * 2 * 8 * (cfg.num_heads // 2) * S * S * 4
    with pytest.raises(ValueError, match="resolve"):
        plan_train_memory(cfg, MeshSpec(dp=-1), global_batch=8, hbm_gib=1.0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_train_memory(cfg, MeshSpec(), global_batch=8)
