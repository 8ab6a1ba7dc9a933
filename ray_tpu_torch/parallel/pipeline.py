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

Where the stages lie on several processes (the model's pp branch on a
mesh over ranks, ``models.transformer``), a hand-off between ranks is a
send/recv pair (``Handoffs``): the stage's rank sends its output to the
next stage's rank, which takes it as a leaf. Every rank issues the ticks
in the same order. NCCL's send and recv wait for the peer's side, and
autograd's own order is not the same on two ranks whose graphs differ,
so the backward is ordered by hand: ``Handoffs.loss`` returns the rank's
loss share, whose backward runs one ``torch.autograd.backward`` per
microbatch in reverse order on every rank (the gradient of the outputs
received from the next stage's rank, or the loss on the last stage; the
inputs' gradients sent back to the previous stage's rank).
``pipeline_spmd`` itself stays in one process (ROADMAP item 15).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

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


class Handoffs:
    """One batch group's stage hand-offs across processes, per microbatch
    in issue order: the outputs this rank sent to the next stage's ranks,
    and the inputs it received from the previous stage's ranks (leaves
    that take their gradient in the backward)."""

    def __init__(self, num_microbatches: int):
        self.sent: List[list] = [[] for _ in range(num_microbatches)]
        self.recvd: List[list] = [[] for _ in range(num_microbatches)]

    def send(self, m: int, x: torch.Tensor, dst: int) -> None:
        """Microbatch ``m``'s stage output ``x`` to rank ``dst``."""
        dist.send(x.detach().contiguous(), dst)
        self.sent[m].append((x, dst))

    def recv(self, m: int, shape, dtype, device, src: int) -> torch.Tensor:
        """Microbatch ``m``'s stage input of ``shape`` and ``dtype`` on
        ``device``, from rank ``src``: a leaf that requires grad."""
        x = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(x, src)
        x.requires_grad_()
        self.recvd[m].append((x, src))
        return x

    def loss(self, terms: Sequence[Optional[torch.Tensor]], device
             ) -> torch.Tensor:
        """The sum of the microbatches' loss ``terms`` (None on a rank
        without the last stage: 0), a 0-d tensor on ``device`` whose
        backward runs the schedule's (``_PipelineBackward``)."""
        roots = [t for t in terms if t is not None] + [
            x for sent in self.sent for x, _ in sent]
        # The roots' graphs are the nested backward's alone: a leaf of no
        # size stands in for them in the caller's graph.
        link = torch.empty(0, device=device, requires_grad=any(
            r.requires_grad for r in roots))
        return _PipelineBackward.apply(self, list(terms), link)


class _PipelineBackward(torch.autograd.Function):
    """A rank's share of a group's loss under stages across processes.
    Its backward runs the schedule's, microbatch by microbatch in reverse
    order, in that order on every rank: the microbatch's loss terms (the
    last stage) or the gradients of its sent outputs, received from the
    next stage's ranks; ``torch.autograd.backward`` of them through this
    rank's stages; its inputs' gradients sent to the previous stage's
    ranks. The params' gradients accumulate in their ``.grad`` (the
    nested backward's), as ``Tensor.backward`` leaves them."""

    @staticmethod
    def forward(ctx, hand, terms, link):
        ctx.hand, ctx.terms = hand, terms
        total = torch.zeros((), dtype=torch.float32, device=link.device)
        for t in terms:
            if t is not None:
                total += t.detach().to(link.device)
        return total

    @staticmethod
    def backward(ctx, grad):
        hand = ctx.hand
        for m in reversed(range(len(hand.sent))):
            term = ctx.terms[m]
            if term is not None:
                torch.autograd.backward(term, grad.to(term.device))
            elif hand.sent[m]:
                grads = []
                for x, dst in hand.sent[m]:
                    g = torch.empty_like(x)
                    dist.recv(g, dst)
                    grads.append(g)
                torch.autograd.backward([x for x, _ in hand.sent[m]],
                                        grads)
            for x, src in hand.recvd[m]:
                dist.send(x.grad if x.grad is not None
                          else torch.zeros_like(x), src)
        ctx.hand = ctx.terms = None
        return None, None, None


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
    mesh.check_one_process("pipeline_spmd", "15")
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
