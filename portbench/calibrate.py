"""Readings from which a cell's correctness limits are set.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11 12 13 ... [--controls 3]

One process, on the card, at the cell's own sizes and load. For each seed
it runs what a benchmark run runs (set-up, a window of ``--seconds`` at
the cell's own load, the check), and prints one JSON line with the
numbers the check compares for the program. For the first ``--controls``
seeds it also reads the control, the reference in float8 (e4m3) in the
program's place, and, for training, a planted fault (half of the batch
left out, the mean taken over the rest), each against the float32
reference. The limits in the cell file are set between the program's
largest reading and the smallest control or fault reading (PERF.md gives
both). Not run by the benchmark.
"""

import argparse
import asyncio
import gc
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402


def serve_seed(r, control: bool) -> dict:
    import torch
    from portbench.drivers.serve import Serve
    sv = Serve(r)

    async def go():
        sv.build()
        await sv.warm()
        win = await sv.window(r.seconds)
        await sv.stop()
        return win

    win = asyncio.run(go())
    e2e = sv.end_to_end(win)
    picked = sv.sample()
    failed = sum(1 for x in sv.measured() if sv.failed(x))
    sv.release()
    gaps = sv.reference_gaps(picked, control=control)
    gc.collect()
    torch.cuda.empty_cache()
    return {"failed": failed, "requests": len(sv.measured()),
            "ttft_p90_ms": e2e["ttft_p90_ms"], **gaps}


def train_seed(r, control: bool) -> dict:
    import torch
    from portbench.drivers import train as T
    from portbench.reference import model as M
    from portbench.reference import train as RT
    s, c = r.sizes, r.cell
    bundle, state = T.build(r)
    state, prog = T.first_steps(r, bundle, state)
    del state, bundle
    gc.collect()
    torch.cuda.empty_cache()
    M.no_tf32()
    batches = [T.batch_tokens(r, k) for k in range(T.CHECK_STEPS)]
    ref = RT.Follow(s, r.seed, r.device, c["optimizer"]).follow(batches)
    out = {"program": RT.compare(prog, ref), "loss_program": prog["loss"],
           "loss_reference": ref["loss"]}
    if control:
        ctl = RT.Follow(s, r.seed, r.device, c["optimizer"],
                        quant=M.fp8).follow(batches)
        out["control"] = RT.compare(ctl, ref)
        S = int(c["seq"])
        mask = torch.ones(int(c["batch"]), S, device=r.device)
        mask[:, S // 2:] = 0
        half = RT.Follow(s, r.seed, r.device, c["optimizer"]).follow(
            batches, [mask] * 3)
        out["half_batch"] = RT.compare(half, ref)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    a = ap.parse_args()
    cell = harness.load_json(harness.HERE / "workloads"
                             / f"{a.workload}.json")
    harness.set_environment(cell, False)
    for i, seed in enumerate(a.seeds):
        t = time.perf_counter()
        r = harness.make_run(a.workload, seed, a.seconds, False, "cuda",
                             cell=cell)
        fn = serve_seed if cell["driver"] == "serve" else train_seed
        row = fn(r, i < a.controls)
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t,
                          **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
