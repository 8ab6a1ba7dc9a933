"""The control comes out not correct: the reference computed in float8
(e4m3), put in the program's place, fails the cell's check where the
program passes it.

On the CPU at the tiny size, and, marked ``card``, at each cell's own size
on the card for one seed (``calibrate.py`` reads the dozen seeds and the
controls from which the limits were set; PERF.md gives the readings).
"""

import pytest
import torch

from portbench import harness
from portbench.reference import model as M
from portbench.reference import train as RT

from .tiny import SEED, TINY, cell


def widest_gaps(s, seed, seqs, served):
    """(the f32 reference's widest gap of the served tokens, the fp8
    control's widest gap of its own first tokens) over ``seqs``."""
    layers = M.Layers(s, seed, "cpu")
    rows = [list(range(len(q) - len(t), len(q))) for q, t in
            zip(seqs, served)]
    ref = M.logits_at(s, layers, seqs, rows)
    ctl = M.logits_at(s, layers, seqs, rows, quant=M.fp8)
    g = c = 0.0
    for lr, lq, t in zip(ref, ctl, served):
        best = lr.max(-1).values
        g = max(g, float((best - lr.gather(1, torch.as_tensor(t)[:, None])
                          [:, 0]).max()))
        c = max(c, float((best - lr.gather(1, lq.argmax(-1)[:, None])
                          [:, 0]).max()))
    return g, c


def test_fp8_control_fails_where_greedy_f32_passes():
    torch.manual_seed(1)
    seqs, served = [], []
    layers = M.Layers(TINY, SEED, "cpu")
    for n in (40, 90):
        q = torch.randint(0, TINY.vocab, (n,)).tolist()
        toks = []
        for _ in range(30):       # greedy decoding by the f32 reference
            lg = M.logits_at(TINY, layers, [q + toks], [[len(q + toks) - 1]])
            toks.append(int(lg[0][0].argmax()))
        seqs.append(q + toks[:-1])
        served.append(toks)
    g, c = widest_gaps(TINY, SEED, seqs, served)
    limit = cell("mistral7b-chat")["check"]["limit"]["logit_gap"]
    assert g < 1e-4
    assert c > limit, c


def test_fp8_training_control_fails_the_gradient_check():
    c = cell("mistral7b-train4k")
    gen = torch.Generator().manual_seed(3)
    batches = [torch.randint(0, TINY.vocab, (2, 65), generator=gen)
               for _ in range(3)]
    ref = RT.Follow(TINY, SEED, "cpu", c["optimizer"]).follow(batches)
    ctl = RT.Follow(TINY, SEED, "cpu", c["optimizer"],
                    quant=M.fp8).follow(batches)
    got = RT.compare(ctl, ref)
    assert got["grad_gap"] > c["check"]["limit"]["grad_gap"], got


@pytest.mark.card
@pytest.mark.parametrize("name", ["mistral7b-chat", "nemo12b-docqa",
                                  "mistral7b-train4k"])
def test_control_fails_at_the_cells_size(card, name):
    from portbench import calibrate
    c = harness.load_json(harness.HERE / "workloads" / f"{name}.json")
    harness.set_environment(c, False)
    r = harness.make_run(name, 2 ** 31 + 101, 15.0, False, "cuda", cell=c)
    lim = c["check"]["limit"]
    if c["driver"] == "serve":
        row = calibrate.serve_seed(r, control=True)
        assert row["logit_gap"] <= lim["logit_gap"] < row["control_gap"]
    else:
        row = calibrate.train_seed(r, control=True)
        for k, v in lim.items():
            assert row["program"][k] <= v
        assert any(row["control"][k] > v for k, v in lim.items())
        assert any(row["half_batch"][k] > v for k, v in lim.items())
