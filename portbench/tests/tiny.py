"""Tiny sizes for the CPU tests: a query width (heads x head_dim = 128)
unlike the hidden size (64), as Mistral-Nemo's, and GQA 2:1."""

import copy

from portbench import harness, model_config

TINY = model_config.Sizes(name="tiny", vocab=512, hidden=64,
                          intermediate=128, layers=2, heads=4, kv_heads=2,
                          head_dim=32, rope_theta=1e6, eps=1e-5)
SEED = 2 ** 33 + 17


def cell(name: str) -> dict:
    """The cell file of ``name``, cut to a size the CPU runs in seconds."""
    c = copy.deepcopy(harness.load_json(harness.HERE / "workloads"
                                        / f"{name}.json"))
    if name == "mistral7b-chat":
        c["engine"].update(max_batch=4, max_len=256, kv_pages=64)
        c.update(rate_hz=8.0, ramp_s=0.5)
        c["prompt"].update(median=40, min=8, max=128)
        c["output"].update(median=8, min=4, max=24)
        c["check"]["tokens"] = 60
    elif name == "nemo12b-docqa":
        c["engine"].update(max_batch=4, max_len=256)
        c.update(clients=4, pool=64, ramp_s=0.5)
        c["docs"].update(count=4)
        c["docs"]["length"].update(min=64, max=130)
        c["question"].update(min=4, max=20)
        c["output"].update(min=4, max=12)
        c["check"]["tokens"] = 60
    else:
        c.update(seq=64, batch=2)
    return c


def run(name: str, seconds: float = 2.0, seed: int = SEED, c=None):
    """One run of the cell's code at the tiny size on the CPU: its result
    line."""
    c = c or cell(name)
    harness.set_environment(c, False)
    r = harness.make_run(name, seed, seconds, False, "cpu", cell=c,
                         sizes=TINY)
    return harness.execute(r)
