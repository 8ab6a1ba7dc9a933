"""The flagship training loop on the port: the sharded Llama-style train
step per rank, with checkpoints.

Port of ray_tpu/train/examples/transformer_example.py. It runs in each
worker of a formed torch.distributed world (``train.backend.TorchConfig``
forms it; one rank a GPU, or gloo ranks on the CPU): the mesh spans every
rank, each rank holds its own positions' shards and runs its own batch
groups (``models.train_step``). ``torch.save`` of each rank's own state
replaces orbax, and ``report(metrics, checkpoint_dir)`` replaces
``ray_tpu.train.report``.

Divergence: the reference draws its batches from a generator seeded
afresh on every (re)start, so a resumed run sees the first batches again;
here a resumed run draws past the steps already taken, and so sees the
batches an uninterrupted run would (it equals that run bit for bit).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional


def transformer_train_loop(config: Dict[str, Any],
                           report: Optional[Callable] = None
                           ) -> List[Dict[str, Any]]:
    """train_loop_per_worker: ``config`` as the reference's ("preset",
    "mesh", "lr", "warmup", "steps", "batch", "seq", "seed",
    "checkpoint_every", "resume_from_checkpoint"), plus
    "checkpoint_dir", a directory every rank can write (needed with
    "checkpoint_every"). Each step calls ``report(metrics,
    checkpoint_dir or None)``; returns the steps' metrics."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import PRESETS, make_train_step
    from ray_tpu_torch.models.train_step import make_optimizer
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = PRESETS[config.get("preset", "tiny")]
    mesh = build_mesh(MeshSpec(**config.get("mesh", {"dp": -1})))
    device = mesh.devices.flat[mesh.local_positions()[0]]
    steps = config.get("steps", 10)
    bundle = make_train_step(
        cfg, mesh,
        optimizer=make_optimizer(
            learning_rate=config.get("lr", 1e-2),
            warmup_steps=config.get("warmup", 1),
            decay_steps=steps * 2),
        device=device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    ckpt_every = config.get("checkpoint_every", 0)
    root = config.get("checkpoint_dir")
    if ckpt_every and not root:
        raise ValueError("checkpoint_every needs checkpoint_dir, a "
                         "directory every rank can write")

    resume = config.get("resume_from_checkpoint")
    seed = config.get("seed", 0)
    if resume:
        state = torch.load(os.path.join(resume, f"rank_{rank}.pt"),
                           map_location=device)
    else:
        state = bundle.init(torch.Generator(device).manual_seed(seed))
    start_step = state["step"]

    rng = np.random.default_rng(seed)
    B, S = config.get("batch", 8), config.get("seq", 64)

    def draw():
        return rng.integers(1, cfg.vocab_size, (B, S + 1))
    for _ in range(start_step):
        draw()
    history = []
    for step in range(start_step, steps):
        batch = {"tokens": torch.as_tensor(draw(), device=device)}
        state, metrics = bundle.step(state, batch)
        ckpt = None
        if ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt = os.path.join(root, f"step_{step + 1}")
            os.makedirs(ckpt, exist_ok=True)
            torch.save(state, os.path.join(ckpt, f"rank_{rank}.pt"))
        row = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        history.append(row)
        if report is not None:
            report(row, ckpt)
    return history
