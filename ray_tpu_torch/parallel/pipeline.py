"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp`` axis.

Port of ray_tpu/parallel/pipeline.py. ``split_stages`` and
``merge_stages`` are copies (a reshape, here a view). ``pipeline_spmd``
keeps JAX's schedule and its checks on the port's single-controller
``Mesh``: where JAX stacks the stages' params and activations on a
leading [pp] dim sharded over the pp axis, vmaps the stage function over
it and rolls the activation buffer a tick at a time (a collective-permute),
here stage s's params and its activations live on pp position s's device,
and a stage's output goes to the next stage's device by ``.to()``
(``stage_send``).

The schedule (``gpipe_ticks``) has T = num_microbatches + pp - 1 ticks;
at tick t stage s works on microbatch t - s. The work is launched tick by
tick, not stage after stage: CUDA launches are asynchronous, so stages on
distinct cards overlap, while stages that share a card take turns on it.
The values do not depend on the order. Autograd differentiates through
the schedule: the backward of each ``.to()`` returns the gradient to the
stage that sent it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .mesh import AXES, Mesh
from .sharding import _tree_map


def split_stages(stacked_params: Any, pp: int) -> Any:
    """[L, ...] layer-stacked params -> [pp, L/pp, ...] stage-stacked
    views. The leading stage dim is what the pp axis splits."""

    def _split(x):
        L = x.shape[0]
        if L % pp:
            raise ValueError(f"{L} layers not divisible by pp={pp}")
        return x.view((pp, L // pp) + tuple(x.shape[1:]))

    return _tree_map(_split, stacked_params)


def merge_stages(stage_params: Any) -> Any:
    """Inverse of split_stages."""
    return _tree_map(lambda x: x.view((-1,) + tuple(x.shape[2:])),
                     stage_params)


def check_microbatches(batch: int, num_microbatches: int, pp: int) -> None:
    """JAX's two checks, in its words: the batch must split into the
    microbatches, and there must be at least as many microbatches as
    stages."""
    if batch % num_microbatches:
        raise ValueError(
            f"batch {batch} not divisible by num_microbatches="
            f"{num_microbatches}")
    if num_microbatches < pp:
        raise ValueError(
            f"num_microbatches ({num_microbatches}) must be >= pp ({pp}) "
            "or the bubble dominates and ranks idle")


def gpipe_ticks(num_microbatches: int,
                pp: int) -> Iterator[Tuple[int, int, int]]:
    """(tick, stage, microbatch) in launch order: T = num_microbatches +
    pp - 1 ticks, at tick t each stage s with 0 <= t - s <
    num_microbatches works on microbatch t - s, stages in order."""
    for t in range(num_microbatches + pp - 1):
        for s in range(pp):
            if 0 <= t - s < num_microbatches:
                yield t, s, t - s


def stage_send(x: torch.Tensor, devices: Sequence[torch.device]
               ) -> Dict[torch.device, torch.Tensor]:
    """A stage's output ``x`` handed to the next stage: on each distinct
    device of ``devices`` (no copy where it already is)."""
    return {d: x.to(d) for d in dict.fromkeys(devices)}


def _stage_devices(mesh: Mesh, axis: str = "pp") -> list:
    """Each stage's device: the first position of each index along
    ``axis``."""
    grid = np.moveaxis(mesh.devices, AXES.index(axis), 0)
    return [grid[s].flat[0] for s in range(grid.shape[0])]


def pipeline_spmd(apply_stage: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any,
                  x: torch.Tensor,
                  *,
                  mesh: Mesh,
                  num_microbatches: int,
                  axis: str = "pp") -> torch.Tensor:
    """Run activations through pp stages with microbatch rotation.

    ``apply_stage(stage_local_params, x_mb) -> x_mb`` applies ONE stage's
    layers (``stage_local_params`` has the [L/pp, ...] layer-stack shape).
    ``stage_params`` carries a leading [pp, ...] dim (see
    ``split_stages``). ``x``: [B, ...] activations; B must divide by
    ``num_microbatches``. Stage s runs on its pp position's device (the
    first position of stage s), its params moved there
    (no copy where they already are); the output is on ``x``'s device."""
    mesh.check_one_process("pipeline_spmd")
    pp = mesh.shape[axis]
    if pp == 1:
        return apply_stage(_tree_map(lambda p: p[0], stage_params), x)
    check_microbatches(x.shape[0], num_microbatches, pp)
    devices = _stage_devices(mesh, axis)
    params = [_tree_map(lambda p, s=s, d=d: p[s].to(d), stage_params)
              for s, d in enumerate(devices)]
    xs = list(x.split(x.shape[0] // num_microbatches))
    outs = [None] * num_microbatches
    for _, s, m in gpipe_ticks(num_microbatches, pp):
        xs[m] = apply_stage(params[s], xs[m].to(devices[s]))
        if s == pp - 1:
            outs[m] = xs[m].to(x.device)
    return torch.cat(outs)
