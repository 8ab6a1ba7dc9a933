"""The training driver: the program's train step, steps back to back.

Set-up makes the weights from the seed and builds one train step
(``make_train_step`` with the cell file's model and optimizer settings) and
its state, then drives that same state through its first three steps with
the window's own call and feed: step k trains on batch k, ``batch`` rows
of ``seq`` + 1 token ids drawn from (seed, k) on the device. Those steps
are the warm-up, and the check reads them: each step's loss, every leaf's
gradient norm as the optimizer got it in step 1 (its first moment after
one step, over 1 - b1), and every leaf's change after step 2. The window
then runs steps from batch 4 on until ``--seconds`` have passed; the rate
is every token trained over all the window's time.

After the window the program's state is freed and the reference follows
the same two steps from the seed's weights (``reference/train.py``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

from .. import flops
from .. import weights as W
from ..reference import train as RT
from .common import port_config

CHECK_STEPS = 3


def batch_tokens(r, k: int):
    """Step k's batch: (rows, seq + 1) ids from (seed, k), on the device."""
    import torch
    c = r.cell
    g = torch.Generator(r.device).manual_seed(
        (int(r.seed) * 1000003 + k) % (1 << 62))
    return torch.randint(0, r.sizes.vocab, (int(c["batch"]),
                                             int(c["seq"]) + 1),
                         generator=g, device=r.device)


def leaf_norms(s, tree, scale: float = 1.0) -> Dict:
    return {key: float(W.layer_leaf(tree, *key).float().norm()) * scale
            for key in W.leaf_names(s)}


def change_norms(r, params) -> Dict:
    out = {}
    for leaf, li in W.leaf_names(r.sizes):
        p0 = W.draw(r.sizes, r.seed, leaf, li, r.device)
        out[(leaf, li)] = float((W.layer_leaf(params, leaf, li).float()
                                 - p0.float()).norm())
    return out


def build(r):
    """The program's train step (the cell file's model and optimizer
    settings) and its state over the seed's weights."""
    from ray_tpu_torch.models.train_step import make_optimizer, \
        make_train_step
    c = r.cell
    cfg = port_config(r.sizes, int(c["seq"]), **c.get("model", {}))
    opt = make_optimizer(**c["optimizer"])
    bundle = make_train_step(cfg, optimizer=opt, device=r.device)
    params = W.make_params(r.sizes, r.seed, r.device)
    return bundle, {"params": params, "opt_state": opt.init(params),
                    "step": 0}


def first_steps(r, bundle, state):
    """The first ``CHECK_STEPS`` steps through the window's call and feed,
    and what the check reads of them: the losses, step 1's gradient norms
    (first moment over 1 - b1) and the change after step 2."""
    s = r.sizes
    b1 = float(r.cell["optimizer"]["b1"])
    prog = {"loss": []}
    for k in range(CHECK_STEPS):
        state, m = bundle.step(state, {"tokens": batch_tokens(r, k)})
        prog["loss"].append(float(m["loss"]))
        if k == 0:
            prog["grad"] = leaf_norms(s, state["opt_state"]["mu"],
                                      1.0 / (1.0 - b1))
        if k == 1:
            prog["change"] = change_norms(r, state["params"])
    return state, prog


def run(r) -> dict:
    import torch
    from ray_tpu_torch.ops import _build
    s, c = r.sizes, r.cell
    cuda = torch.device(r.device).type == "cuda"
    info = {"start_s": time.perf_counter() - r.t_start}
    t = time.perf_counter()
    if cuda:
        info["kernel_build_s"] = sum(_build.build().values())
    bundle, state = build(r)
    if cuda:
        torch.cuda.synchronize()
    info["build_and_weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state, prog = first_steps(r, bundle, state)
    info["first_steps_s"] = time.perf_counter() - t
    tracer = None
    if r.trace:
        from ..trace import Slice
        tracer = Slice(torch)
        tracer.warm()
    setup_s = time.perf_counter() - r.t_start
    tokens = int(c["batch"]) * int(c["seq"])
    span = min(float(c.get("trace_seconds", 0)), r.seconds)
    at = (r.seconds - span) / 2
    k, steps, traced = CHECK_STEPS, 0, 0
    t0 = time.perf_counter()
    while True:
        el = time.perf_counter() - t0
        if tracer is not None and tracer.t0 is None and el >= at:
            tracer.start()
        state, m = bundle.step(state, {"tokens": batch_tokens(r, k)})
        k += 1
        steps += 1
        if tracer is not None and tracer.t0 is not None \
                and tracer.t1 is None:
            traced += 1
            if time.perf_counter() - tracer.t0 >= span:
                tracer.stop()
        if time.perf_counter() - t0 >= r.seconds:
            break
    elapsed = time.perf_counter() - t0
    if tracer is not None and tracer.t1 is None:
        tracer.stop()
    res = {"setup_s": setup_s, "setup_info": info,
           "end_to_end": {"train_tokens_per_s": steps * tokens / elapsed,
                          "steps": steps, "step_ms": elapsed / steps * 1e3},
           "attempted": steps, "failed": 0, "window_s": elapsed}
    if tracer is not None:
        fwd_flops, fwd_bytes = flops.flash_train_work(
            s, int(c["batch"]), int(c["seq"]))
        res["trace"] = {
            "tracer": tracer, "spans": [], "slice_spans": [],
            "host": "host, inside the train step (no spans there)",
            "work": {"model_flops": traced * flops.train_step_flops(
                s, int(c["batch"]), int(c["seq"])),
                "attn_flops": traced * fwd_flops,
                "attn_bytes": traced * fwd_bytes, "steps": traced}}
    res["memory_peak_bytes"] = r.memory_peak()
    del state, bundle
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    res["checks"], res["check_info"] = check(r, prog)
    return res


def check(r, prog: dict):
    """The reference's two steps against the program's; the numbers and
    their limits."""
    from ..reference import model as M
    M.no_tf32()
    t = time.perf_counter()
    ref = RT.Follow(r.sizes, r.seed, r.device, r.cell["optimizer"]).follow(
        [batch_tokens(r, k) for k in range(CHECK_STEPS)])
    got = RT.compare(prog, ref)
    lim = r.cell["check"]["limit"]
    info = {"reference_s": time.perf_counter() - t,
            "loss_program": prog["loss"], "loss_reference": ref["loss"],
            "loss_gap": got["loss_gap"]}
    return [(k, got[k], float(lim[k])) for k in sorted(lim)], info
