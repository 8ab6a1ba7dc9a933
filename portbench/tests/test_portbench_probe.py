"""The four-rank probe at the tiny size: four gloo ranks on the CPU run the
program's sharded train step and agree on its loss."""

from portbench import probe_ranks

from .tiny import SEED, TINY


def test_probe_runs_four_ranks_that_agree():
    line = probe_ranks.probe(TINY, SEED, device="cpu", seq=32, steps=1)
    assert line is not None
    ranks = line["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(len(r["step_ms"]) == 1 and len(r["loss"]) == 3
               for r in ranks)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert line["train_tokens_per_s"] > 0
