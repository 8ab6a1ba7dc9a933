"""A run with its timed path broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card (the cell's
code at the tiny size, on the CPU) with one fault planted in the program:
a token altered where it is produced, a step that returns its state
unchanged, half of the batch left out. (The cells run on one card, so no
exchange between cards can be left out.) The unbroken run passes.
"""

import pytest
import torch

from .tiny import cell, run

CHAT, DOCQA, TRAIN = "mistral7b-chat", "nemo12b-docqa", "mistral7b-train4k"
# Where the faults are planted: private names of the program, checked here
# in one place so that a rename fails with its name.
PLANTED = (("ray_tpu_torch.llm.engine", "LLMEngine._emit"),
           ("ray_tpu_torch.llm.engine", "_decode_fn"),
           ("ray_tpu_torch.models.train_step", "AdamW.update_"),
           ("ray_tpu_torch.models.train_step", "loss_fn"))


def test_the_program_has_the_names_faults_are_planted_at():
    import importlib
    from portbench.drivers import serve
    from ray_tpu_torch.llm.serving import EngineReplica
    for module, name in PLANTED:
        obj = importlib.import_module(module)
        for part in name.split("."):
            assert hasattr(obj, part), \
                f"{module}.{name} is gone: re-plant this file's faults"
            obj = getattr(obj, part)
    serve.check_replica(EngineReplica("tiny", device="cpu"))
    with pytest.raises(RuntimeError, match="_lock"):
        serve.check_replica(object())


def test_unbroken_serving_runs_are_correct():
    for name in (CHAT, DOCQA):
        line = run(name)
        assert line["correct"], line["compared"]
        assert line["attempted"] > 5 and line["failed"] == 0


def test_unbroken_training_run_is_correct():
    line = run(TRAIN)
    assert line["correct"], line["compared"]


@pytest.mark.parametrize("name", [CHAT, DOCQA])
def test_token_altered_where_produced(monkeypatch, name):
    from ray_tpu_torch.llm import engine
    emit = engine.LLMEngine._emit
    calls = [0]

    def altered(self, req, token):
        calls[0] += 1
        if calls[0] % 5 == 0:
            token = (int(token) + 1) % self.cfg.vocab_size
        return emit(self, req, token)

    monkeypatch.setattr(engine.LLMEngine, "_emit", altered)
    line = run(name)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("name", [CHAT, DOCQA])
def test_decode_step_returns_its_state_unchanged(monkeypatch, name):
    from ray_tpu_torch.llm import engine

    def unchanged(params, pool_k, pool_v, tables, last_tokens, *a, **k):
        return last_tokens.clone()

    monkeypatch.setattr(engine, "_decode_fn", unchanged)
    line = run(name)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("name", [CHAT, DOCQA])
def test_decode_leaves_half_the_batch_out(monkeypatch, name):
    from ray_tpu_torch.llm import engine
    decode = engine._decode_fn

    def half(*a, **k):
        out = decode(*a, **k)
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(engine, "_decode_fn", half)
    line = run(name)
    assert not line["correct"], line["compared"]


def test_train_step_returns_its_state_unchanged(monkeypatch):
    from ray_tpu_torch.models import train_step

    def unchanged(self, params, grads, mu, nu, opt_state, gnorm=None):
        return ({**opt_state, "count": opt_state["count"] + 1,
                 "schedule_count": opt_state["schedule_count"] + 1},
                gnorm or 0.0)

    monkeypatch.setattr(train_step.AdamW, "update_", unchanged)
    line = run(TRAIN)
    assert not line["correct"], line["compared"]


def test_train_step_leaves_half_the_batch_out(monkeypatch):
    from ray_tpu_torch.models import train_step
    loss_fn = train_step.loss_fn

    def half(params, batch, cfg, *a, **k):
        toks = torch.as_tensor(batch["tokens"])
        targets = toks[:, 1:].clone()
        targets[:, targets.shape[1] // 2:] = 0     # id 0 is left out
        return loss_fn(params, {"inputs": toks[:, :-1],
                                "targets": targets}, cfg, *a, **k)

    monkeypatch.setattr(train_step, "loss_fn", half)
    line = run(TRAIN)
    assert not line["correct"], line["compared"]
