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
``pipeline_spmd`` on a mesh over ranks runs the same way: each rank runs
its stage's ticks, and its output's backward runs the rank's share of the
schedule's backward.
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
        link = self.link([t for t in terms if t is not None], device)
        return _PipelineBackward.apply(self, list(terms), link)

    def link(self, roots: Sequence[torch.Tensor], device) -> torch.Tensor:
        """A leaf of no size on ``device`` that stands in the caller's
        graph for the graphs of ``roots`` and of the sent outputs, which
        the nested backward (``backward``) runs alone."""
        roots = list(roots) + [x for sent in self.sent for x, _ in sent]
        return torch.empty(0, device=device, requires_grad=any(
            r.requires_grad for r in roots))

    def backward(self, seeds: Sequence[Optional[tuple]]) -> None:
        """The schedule's backward on this rank, microbatch by microbatch
        in reverse order, in that order on every rank: ``seeds[m]``, a
        (tensor, gradient) pair on the last stage (else None), or the
        gradients of the microbatch's sent outputs, received from the next
        stage's ranks; ``torch.autograd.backward`` of them through this
        rank's stages; its inputs' gradients sent to the previous stage's
        ranks. The params' gradients accumulate in their ``.grad``."""
        for m in reversed(range(len(self.sent))):
            if seeds[m] is not None:
                torch.autograd.backward(*seeds[m])
            elif self.sent[m]:
                grads = []
                for x, dst in self.sent[m]:
                    g = torch.empty_like(x)
                    dist.recv(g, dst)
                    grads.append(g)
                torch.autograd.backward([x for x, _ in self.sent[m]], grads)
            for x, src in self.recvd[m]:
                dist.send(x.grad if x.grad is not None
                          else torch.zeros_like(x), src)


class _PipelineBackward(torch.autograd.Function):
    """A rank's share of a group's loss under stages across processes.
    Its backward runs the rank's share of the schedule's
    (``Handoffs.backward``), seeded on the last stage by the microbatches'
    loss terms."""

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
        ctx.hand.backward([None if t is None else (t, grad.to(t.device))
                           for t in ctx.terms])
        ctx.hand = ctx.terms = None
        return None, None, None


class _PipelineOutput(torch.autograd.Function):
    """``pipeline_spmd``'s output on a rank under stages across processes:
    the last stage's microbatch outputs ``ys`` joined (a tensor of no size
    on a rank without the last stage). Its backward runs the rank's share
    of the schedule's (``Handoffs.backward``), seeded on the last stage by
    the output's gradient, split by microbatch."""

    @staticmethod
    def forward(ctx, hand, ys, link):
        ctx.hand, ctx.ys = hand, ys
        if not ys:
            return link.new_empty(0)
        return torch.cat([y.detach() for y in ys])

    @staticmethod
    def backward(ctx, grad):
        ys = ctx.ys
        if ys:
            grads = grad.split([y.shape[0] for y in ys])
            ctx.hand.backward([(y, g) for y, g in zip(ys, grads)])
        else:
            ctx.hand.backward([None] * len(ctx.hand.sent))
        ctx.hand = ctx.ys = None
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
    layers (``stage_local_params`` has the [L/pp, ...] layer-stack shape)
    and keeps the microbatch's shape and dtype, as JAX's activation buffer
    requires. ``stage_params`` carries a leading [pp, ...] dim (see
    ``split_stages``). ``x``: [B, ...] activations; B must divide by
    ``num_microbatches``. Stage s runs on its pp position's device (the
    first position of stage s), its params moved there (no copy where
    they already are); in one process the output is on ``x``'s device.

    On a mesh over several processes every rank passes the same
    arguments (it reads only its stages' params) and runs its stages'
    ticks of the schedule along the pp positions of its first position;
    a hand-off between ranks is a send/recv pair (``Handoffs``). The
    output lands on the last stage's rank, whole ([B, ...], on its
    device); every other rank gets a tensor of no size. Each rank calls
    backward on what it got (the same graph on every rank: a loss of no
    size is 0): the gradients run back stage by stage, microbatch by
    microbatch in reverse order, and each rank's params and ``x`` take
    their gradients there."""
    pp = mesh.shape[axis]
    if pp == 1:
        return apply_stage(_tree_map(lambda p: p[0], stage_params), x)
    check_microbatches(x.shape[0], num_microbatches, pp)
    xs = list(x.split(x.shape[0] // num_microbatches))
    if mesh.world > 1:
        line = mesh.axis_positions(mesh.local_positions()[0], axis)
        if len(mesh.ranks(line)) > 1:
            return _pipeline_ranks(apply_stage, stage_params, xs, mesh, line,
                                   num_microbatches)
        devices = [mesh.devices.flat[i] for i in line]
    else:
        devices = _stage_devices(mesh, axis)
    params = [_tree_map(lambda p, s=s, d=d: p[s].to(d), stage_params)
              for s, d in enumerate(devices)]
    outs = [None] * num_microbatches
    for _, s, m in gpipe_ticks(num_microbatches, pp):
        xs[m] = apply_stage(params[s], xs[m].to(devices[s]))
        if s == pp - 1:
            outs[m] = xs[m].to(x.device)
    return torch.cat(outs)


def _pipeline_ranks(apply_stage, stage_params, xs, mesh: Mesh, line,
                    num_microbatches: int) -> torch.Tensor:
    """``pipeline_spmd`` along the pp positions ``line``, which lie on
    several ranks: this rank's stages' ticks in GPipe order, the hand-offs
    between ranks by send/recv."""
    pp = len(line)
    rank_of = [mesh.process_index(i) for i in line]
    devices = [mesh.devices.flat[i] for i in line]
    mine = [s for s in range(pp) if rank_of[s] == mesh.rank]
    params = {s: _tree_map(lambda p, s=s: p[s].to(devices[s]), stage_params)
              for s in mine}
    hand = Handoffs(num_microbatches)
    ys = []
    for _, s, m in gpipe_ticks(num_microbatches, pp):
        if s not in params:
            continue
        like = xs[m]
        if s > 0 and rank_of[s - 1] != mesh.rank:
            xs[m] = hand.recv(m, like.shape, like.dtype, devices[s],
                              rank_of[s - 1])
        y = apply_stage(params[s], xs[m].to(devices[s]))
        if y.shape != like.shape or y.dtype != like.dtype:
            raise ValueError(f"a stage turned a microbatch of "
                             f"{tuple(like.shape)} {like.dtype} into "
                             f"{tuple(y.shape)} {y.dtype}: pipeline_spmd's "
                             f"stages keep the shape and dtype")
        if s == pp - 1:
            ys.append(y)
        elif rank_of[s + 1] != mesh.rank:
            hand.send(m, y, rank_of[s + 1])
        xs[m] = y
    return _PipelineOutput.apply(hand, ys, hand.link(ys, devices[mine[0]]))
