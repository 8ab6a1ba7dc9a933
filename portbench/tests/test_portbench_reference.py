"""The float32 reference against the program at a tiny size on the CPU,
where the program also runs in float32: they compute the same model."""

import types

import torch

from portbench import weights as W
from portbench.drivers import train as T
from portbench.drivers.common import port_config
from portbench.reference import model as M
from portbench.reference import train as RT

from .tiny import SEED, TINY, cell


def f32_tree(tree):
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    return tree.float()


def test_forward_matches_program_with_wide_queries():
    from ray_tpu_torch.models.transformer import forward
    assert TINY.heads * TINY.head_dim != TINY.hidden
    torch.manual_seed(0)
    toks = torch.randint(0, TINY.vocab, (1, 40))
    cfg = port_config(TINY, 64, dtype=torch.float32)
    want = forward(f32_tree(W.make_params(TINY, SEED, "cpu")), toks, cfg,
                   device="cpu")[0]
    got = M.logits_at(TINY, M.Layers(TINY, SEED, "cpu"), [toks[0].tolist()],
                      [list(range(40))])[0]
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5), \
        (got - want).abs().max()


def test_fp8_control_departs_from_reference():
    toks = list(range(3, 43))
    layers = M.Layers(TINY, SEED, "cpu")
    ref = M.logits_at(TINY, layers, [toks], [list(range(40))])[0]
    ctl = M.logits_at(TINY, layers, [toks], [list(range(40))],
                      quant=M.fp8)[0]
    d = (ctl - ref).abs().max()
    assert 1e-2 < d < 10 * ref.abs().max()


def test_two_steps_match_program_train_step():
    from ray_tpu_torch.models.train_step import make_optimizer, \
        make_train_step
    c = cell("mistral7b-train4k")
    cfg = port_config(TINY, c["seq"], dtype=torch.float32, **c["model"])
    opt = make_optimizer(**c["optimizer"])
    bundle = make_train_step(cfg, optimizer=opt, device="cpu")
    params = f32_tree(W.make_params(TINY, SEED, "cpu"))
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    r = types.SimpleNamespace(seed=SEED, device="cpu", sizes=TINY, cell=c)
    prog = {"loss": []}
    for k in range(3):
        state, m = bundle.step(state, {"tokens": T.batch_tokens(r, k)})
        prog["loss"].append(m["loss"])
        if k == 0:
            prog["grad"] = T.leaf_norms(TINY, state["opt_state"]["mu"],
                                        1 / (1 - c["optimizer"]["b1"]))
        if k == 1:
            prog["change"] = T.change_norms(r, state["params"])
    ref = RT.Follow(TINY, SEED, "cpu", c["optimizer"]).follow(
        [T.batch_tokens(r, k) for k in range(3)])
    got = RT.compare(prog, ref)
    assert got["loss_gap"] < 1e-5, got
    assert got["grad_gap"] < 1e-4, got
    assert got["change_gap"] < 1e-3, got


def test_schedule_is_optax_warmup_cosine():
    opt = {"learning_rate": 1.0, "warmup_steps": 10, "decay_steps": 110}
    assert RT.schedule(opt, 0) == 0.0
    assert RT.schedule(opt, 5) == 0.5
    assert abs(RT.schedule(opt, 60) - 0.5) < 1e-12
    assert RT.schedule(opt, 500) == 0.0
    assert RT.schedule({**opt, "warmup_steps": 0}, 0) == 1.0
