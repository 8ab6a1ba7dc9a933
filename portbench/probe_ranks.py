"""Probe the program's train step across ranks: set-up, step time and peak
memory of ``make_train_step(cfg, mesh)`` with one process a card.

    python3 portbench/probe_ranks.py --config mistral-nemo-12b --seed 7

Each of four ranks joins an NCCL world over a free localhost port (gloo on
the CPU), builds the mesh (dp=2 x fsdp=2 under the default table), draws
the whole model from the seed on its card (``weights.py``), keeps its
shards, and runs two warm-up steps and then ``STEPS`` timed ones, each on
four rows of ``SEQ`` tokens (one a rank). Prints one JSON line: per rank
the set-up, the first step, the timed steps, the losses and the peak
bytes; and the tokens a second over all ranks. It checks nothing against
a reference: it sizes the four-card training cell that the benchmark does
not have yet, and is not run by it.
"""

import argparse
import json
import multiprocessing
import os
import socket
import statistics
import sys
import time
import traceback

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import model_config  # noqa: E402

DP, FSDP, SEQ = 2, 2, 4096
WARM_STEPS, STEPS = 2, 8
TIMEOUT_S = 300.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, a: dict, sizes,
              results) -> None:
    try:
        results.put((rank, "ok", rank_run(rank, world, port, a, sizes)))
    except BaseException:  # noqa: BLE001 - the parent reports it
        results.put((rank, "error", traceback.format_exc()))
        raise


def rank_run(rank: int, world: int, port: int, a: dict, sizes) -> dict:
    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.train_step import make_optimizer, \
        make_train_step
    from ray_tpu_torch.parallel import MeshSpec, build_mesh, shard_params
    from portbench import weights as W
    from portbench.drivers.common import port_config
    cuda = a["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = build_mesh(MeshSpec(dp=DP, fsdp=FSDP))
        seq = a["seq"]
        cfg = port_config(sizes, seq, attention_impl="flash", remat=True)
        bundle = make_train_step(cfg, mesh, optimizer=make_optimizer(
            warmup_steps=0), device=dev)
        params = W.make_params(sizes, a["seed"], dev)
        shards = shard_params(params, mesh, bundle.rules)
        del params
        if cuda:
            torch.cuda.empty_cache()
        state = {"params": shards, "step": 0,
                 "opt_state": bundle.optimizer.init(shards)}
        del shards

        def batch(k):
            g = torch.Generator(dev).manual_seed(
                (int(a["seed"]) * 1000003 + k) % (1 << 62))
            return {"tokens": torch.randint(
                0, sizes.vocab, (world, seq + 1), generator=g, device=dev)}

        def sync():
            if cuda:
                torch.cuda.synchronize()
            dist.barrier()

        steps_ms, losses, first_s = [], [], None
        sync()
        setup_until_steps = time.perf_counter() - t_start
        for k in range(WARM_STEPS + a["steps"]):
            t = time.perf_counter()
            state, m = bundle.step(state, batch(k))
            losses.append(float(m["loss"]))
            sync()
            dt = time.perf_counter() - t
            if k == 0:
                first_s = dt
            if k == WARM_STEPS - 1:
                setup_s = time.perf_counter() - t_start
            if k >= WARM_STEPS:
                steps_ms.append(dt * 1e3)
        return {"rank": rank, "setup_s": setup_s,
                "setup_before_steps_s": setup_until_steps,
                "first_step_s": first_s, "step_ms": steps_ms,
                "loss": losses,
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if cuda else 0)}
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args()
    line = probe(model_config.load(a.config), a.seed)
    if line is None:
        return 1
    print(json.dumps(line), flush=True)
    return 0


def probe(sizes, seed: int, device: str = "cuda", seq: int = SEQ,
          steps: int = STEPS):
    """The probe's line, or None (with the ranks' errors on stderr)."""
    world = DP * FSDP
    if device == "cuda":
        import torch
        if torch.cuda.device_count() < world:
            print(f"needs {world} CUDA devices", file=sys.stderr)
            return None
        from ray_tpu_torch.ops import _build
        _build.build()
    a = {"seed": seed, "device": device, "seq": seq, "steps": steps}
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, a, sizes, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = [None] * world, []
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for _ in range(world):
            rank, status, value = results.get(
                timeout=max(1.0, deadline - time.monotonic()))
            if status == "ok":
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    except Exception as e:  # noqa: BLE001 - queue.Empty: a rank hung
        errors.append(f"no result from every rank: {e!r}")
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors or any(o is None for o in out):
        print("\n".join(errors) or "a rank gave no result", file=sys.stderr)
        return None
    step_ms = [max(o["step_ms"][i] for o in out)
               for i in range(len(out[0]["step_ms"]))]
    med = statistics.median(step_ms)
    return {"config": sizes.name, "dp": DP, "fsdp": FSDP, "seq": seq,
            "step_ms_median": med,
            "train_tokens_per_s": world * seq / (med / 1e3),
            "setup_s_max": max(o["setup_s"] for o in out),
            "peak_bytes_max": max(o["peak_bytes"] for o in out),
            "ranks": out}


if __name__ == "__main__":
    sys.exit(main())
