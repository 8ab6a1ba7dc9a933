"""Sequence parallelism: ring attention and Ulysses over an ``sp`` mesh axis.

Port of ray_tpu/ops/ring_attention.py, plain PyTorch as the reference
writes it: einsums with an online softmax in f32 (the products of the
working dtype's values taken in f32, the reference's
``preferred_element_type=float32``), no kernel.

  ring_attention     KV blocks rotate around the ``sp`` positions and merge
                     into a running (m, l, acc) by log-sum-exp rescaling
  ulysses_attention  seq -> heads resharding, plain attention over the
                     whole sequence, heads -> seq

The reference runs each as a ``shard_map`` program whose specs put the
batch over ``batch_axes`` (dp, fsdp), the sequence over ``axis_name`` and
the heads over ``heads_axis`` (tp); here one process runs every shard in
turn, each on its shard's device (``parallel.mesh.Mesh``), and a rotation
or an all-to-all is a ``.to(device)``: a no-op where two positions share a
device. Each (batch group, tp slice) runs its own ring, or its own
all-to-all, over the sp positions that share its coordinate
(``Mesh.sp_positions``): only the sequence communicates. An axis named in
neither spec replicates the body in the reference; here its coordinate 0
runs it. So ``shard_map_compat`` and ``_qkv_specs``, which build the
reference's ``shard_map`` and its PartitionSpecs, have no counterpart.
Under autograd the gradient runs back through these plain ops.

The model's sequence shards may also lie on several processes (a mesh
over ranks, ``models.transformer``): the ring then rotates K/V between
ranks by P2P (``ring_shift``, ``dist.batch_isend_irecv``, its backward the
reverse rotation of the gradients), and the sequence gathered for one
attention pass is joined on the first shard's rank and split back
(``seq_gather``, ``seq_scatter``, each the other's backward). The
free-standing ``ring_attention`` and ``ulysses_attention`` stay in one
process (ROADMAP item 14).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import AXES
from .flash_attention import MASK_FILL, reference_attention

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _grouped(q, n_kv: int):
    """q (B,Sq,Hq,D) -> (B,Sq,Hkv,G,D)."""
    B, Sq, Hq, D = q.shape
    return q.reshape(B, Sq, n_kv, Hq // n_kv, D)


def _grouped_scores(q, k, scale):
    """q (B,Sq,Hkv,G,D), k (B,Sk,Hkv,D) → scores (B,Hkv,G,Sq,Sk) f32."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale


def _empty_state(qg) -> State:
    """m = -1e30, l = 0, acc = 0 in f32: (B,Hkv,G,Sq,1) twice and
    (B,Hkv,G,Sq,D), on qg's device."""
    B, Sq, Hkv, G, D = qg.shape
    kw = dict(dtype=torch.float32, device=qg.device)
    return (torch.full((B, Hkv, G, Sq, 1), MASK_FILL, **kw),
            torch.zeros((B, Hkv, G, Sq, 1), **kw),
            torch.zeros((B, Hkv, G, Sq, D), **kw))


def _merge(qg, k_blk, v_blk, live: Optional[torch.Tensor], m, l, acc,
           scale: float) -> State:
    """One online-softmax update of (m, l, acc) by a K/V block. ``live``
    (Sq, Sk) or (1, Sk) says which pairs count (None: all). p is re-masked
    after the exp: a block with no live pair for a row leaves m at -1e30,
    where exp(-1e30 - -1e30) would add 1 per key (the reference's suffix
    body does this; in its ring body every row's first block is its own,
    so m is real from then on and the re-mask changes nothing)."""
    scores = _grouped_scores(qg, k_blk, scale)             # (B,Hkv,G,Sq,Sk)
    if live is not None:
        scores = scores.masked_fill(~live, MASK_FILL)
    m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
    p = torch.exp(scores - m_new)
    if live is not None:
        p = p.masked_fill(~live, 0.0)
    alpha = torch.exp(m - m_new)                           # (B,Hkv,G,Sq,1)
    l_new = alpha * l + p.sum(-1, keepdim=True)
    # p rounds to the values' dtype, as in the reference, then P.V in f32.
    pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v_blk.dtype).float(),
                      v_blk.float())
    return m_new, l_new, alpha * acc + pv


def _causal(q0: int, k0: int, sq: int, sk: int, device) -> torch.Tensor:
    """(Sq, Sk) live pairs: query q0 + i sees key k0 + j iff
    k0 + j <= q0 + i."""
    i = torch.arange(q0, q0 + sq, device=device)
    j = torch.arange(k0, k0 + sk, device=device)
    return i[:, None] >= j[None, :]


def _ring_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], devices: Sequence[torch.device],
                 *, causal: bool, scale: float,
                 states: Optional[List[State]] = None, n: Optional[int] = None,
                 first: int = 0, rotate=None) -> List[torch.Tensor]:
    """The ring over n sequence shards: qs[i] (B,Sq,Hq,D) and ks[i], vs[i]
    (B,Sk,Hkv,D) on devices[i], holding positions [i*Sq, (i+1)*Sq) and
    [i*Sk, (i+1)*Sk). At step s shard i merges the K/V block of source
    (i - s) % n, causal by absolute position; n - 1 rotate-and-merge steps,
    then a last merge with no rotation (``_ring_attention_shard``).
    ``states`` seeds each shard's (m, l, acc) (default: empty). Returns
    each shard's output (B,Sq,Hq,D) in q's dtype, on its device.

    ``n``, ``first``, ``rotate``: the lists hold shards first, first + 1,
    ... of a ring of ``n`` (default: all of them), and ``rotate(blocks)``
    gives each listed shard the (k, v) block the shard before it held
    (across processes, ``ring_shift``); by default the blocks move by
    ``.to()``."""
    n = n or len(qs)
    B, Sq, Hq, D = qs[0].shape
    Sk, Hkv = ks[0].shape[1], ks[0].shape[2]
    qgs = [_grouped(q, Hkv) for q in qs]
    if states is None:
        states = [_empty_state(qg) for qg in qgs]
    states = list(states)
    blocks = list(zip(ks, vs))
    for s in range(n):
        for a in range(len(qs)):
            i = first + a
            live = (_causal(i * Sq, ((i - s) % n) * Sk, Sq, Sk, devices[a])
                    if causal else None)
            states[a] = _merge(qgs[a], *blocks[a], live, *states[a], scale)
        if s < n - 1:
            # Rotate: shard i takes the block shard i - 1 held.
            blocks = (rotate(blocks) if rotate is not None else
                      [tuple(t.to(devices[i], non_blocking=True)
                             for t in blocks[(i - 1) % n]) for i in range(n)])
    outs = []
    for q, (_, l, acc) in zip(qs, states):
        o = acc / l.clamp_min(1e-30)                        # (B,Hkv,G,Sq,D)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
                    .to(q.dtype))
    return outs


def _exchange(ts, to: int, frm: int) -> tuple:
    """``ts`` sent to rank ``to`` while tensors of their shapes arrive
    from rank ``frm``, in one batch of P2P ops."""
    ts = [t.contiguous() for t in ts]
    got = [torch.empty_like(t) for t in ts]
    ops = ([dist.P2POp(dist.isend, t, to) for t in ts]
           + [dist.P2POp(dist.irecv, g, frm) for g in got])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(got)


class _RingShift(torch.autograd.Function):
    """One rotation of a ring across processes: (k, v) go to rank
    ``nxt`` while rank ``prev``'s arrive. The backward is the reverse
    rotation: the arrived blocks' gradients go back to ``prev`` and this
    rank's come from ``nxt``."""

    @staticmethod
    def forward(ctx, k, v, prev: int, nxt: int):
        ctx.prev, ctx.nxt = prev, nxt
        return _exchange((k, v), nxt, prev)

    @staticmethod
    def backward(ctx, gk, gv):
        return _exchange((gk, gv), ctx.prev, ctx.nxt) + (None, None)


def ring_shift(prev: int, nxt: int):
    """``_ring_shards``' ``rotate`` for a rank that holds a run of a
    ring's shards, rank ``prev`` the shard before the run and ``nxt`` the
    one after it: the run's last block goes to ``nxt``, ``prev``'s comes
    in as the run's first, the others move along the run."""
    def rotate(blocks):
        return [_RingShift.apply(*blocks[-1], prev, nxt)] + blocks[:-1]
    return rotate


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _recv_all(metas, src: int) -> tuple:
    """Tensors of ``metas`` (shape, dtype, device) received from ``src``
    in order."""
    out = []
    for shape, dtype, device in metas:
        out.append(torch.empty(shape, dtype=dtype, device=device))
        dist.recv(out[-1], src)
    return tuple(out)


class _SeqGather(torch.autograd.Function):
    """Tensors split along dim 1 (the sequence) over ``ranks`` (each an
    equal run, in rank order) joined on ``ranks[0]``: the others send
    theirs, it receives them and concatenates (its outputs the whole
    tensors); another rank's output is one empty tensor that carries the
    graph on to ``_SeqScatter``. The backward sends each rank its run of
    the gradients."""

    @staticmethod
    def forward(ctx, ranks, *parts):
        ctx.ranks, ctx.like = ranks, [_meta(p) for p in parts]
        if dist.get_rank() != ranks[0]:
            for p in parts:
                dist.send(p.contiguous(), ranks[0])
            return parts[0].new_empty(0)
        whole = []
        for p in parts:
            pieces = [p]
            for r in ranks[1:]:
                pieces.append(torch.empty_like(p))
                dist.recv(pieces[-1], r)
            whole.append(torch.cat(pieces, dim=1))
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        ranks, like = ctx.ranks, ctx.like
        ctx.like = None
        if dist.get_rank() != ranks[0]:
            return (None, *_recv_all(like, ranks[0]))
        out = []
        for g, p in zip(grads, like):
            runs = g.split(p[0][1], dim=1)
            for r, run in zip(ranks[1:], runs[1:]):
                dist.send(run.contiguous(), r)
            out.append(runs[0])
        return (None, *out)


class _SeqScatter(torch.autograd.Function):
    """The inverse of ``_SeqGather``: ``ranks[0]``'s whole tensors split
    along dim 1, each rank its equal run, whose shapes and dtypes
    ``like`` gives (another rank's input is ``_SeqGather``'s empty
    output), as ``(shape, dtype, device)``. The backward joins the
    gradients on ``ranks[0]``."""

    @staticmethod
    def forward(ctx, ranks, like, *xs):
        ctx.ranks, ctx.like = ranks, like
        ctx.empty = xs[0].shape
        if dist.get_rank() != ranks[0]:
            return _recv_all(like, ranks[0])
        out = []
        for x, p in zip(xs, like):
            runs = x.split(p[0][1], dim=1)
            for r, run in zip(ranks[1:], runs[1:]):
                dist.send(run.contiguous(), r)
            out.append(runs[0].clone())
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        ranks = ctx.ranks
        if dist.get_rank() != ranks[0]:
            for g in grads:
                dist.send(g.contiguous(), ranks[0])
            return (None, None, grads[0].new_empty(ctx.empty))
        out = []
        for g in grads:
            pieces = [g]
            for r in ranks[1:]:
                pieces.append(torch.empty_like(g))
                dist.recv(pieces[-1], r)
            out.append(torch.cat(pieces, dim=1))
        return (None, None, *out)


def seq_gather(parts, ranks) -> tuple:
    """``parts`` (each this rank's run of a sequence, dim 1) joined on
    ``ranks[0]``, the first of the ranks that hold the runs: the whole
    tensors there; elsewhere one empty tensor to hand to
    ``seq_scatter``."""
    out = _SeqGather.apply(tuple(ranks), *parts)
    return (out,) if torch.is_tensor(out) else out


def seq_scatter(xs, like, ranks) -> tuple:
    """``seq_gather``'s inverse: ``xs`` (on ``ranks[0]``, the whole
    tensors; elsewhere ``seq_gather``'s output) split back, each rank its
    run, shaped as ``like``'s tensors."""
    out = _SeqScatter.apply(tuple(ranks), [_meta(p) for p in like], *xs)
    return (out,) if torch.is_tensor(out) else out


def _ulysses_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor],
                    devices: Sequence[torch.device], *, causal: bool,
                    scale: float) -> List[torch.Tensor]:
    """Ulysses over n sequence shards laid out as in ``_ring_shards``:
    shard i joins every shard's query heads [i*Hq/n, (i+1)*Hq/n) and KV
    heads [i*Hkv/n, (i+1)*Hkv/n) along the sequence (the reference's tiled
    all_to_all, split over heads, concatenated over sequence), attends
    over the whole sequence, then gives each shard its sequence slice of
    its heads back."""
    n = len(devices)

    def seq_to_heads(xs):
        H = xs[0].shape[2]
        if H % n:
            raise ValueError(f"ulysses needs head counts divisible by the "
                             f"sp size {n}, got {H}")
        h = H // n
        return [torch.cat([x[:, :, i * h:(i + 1) * h].to(
            devices[i], non_blocking=True) for x in xs], dim=1)
            for i in range(n)]

    def heads_to_seq(xs):
        sl = xs[0].shape[1] // n
        return [torch.cat([x[:, j * sl:(j + 1) * sl].to(
            devices[j], non_blocking=True) for x in xs], dim=2)
            for j in range(n)]

    outs = [reference_attention(q, k, v, causal=causal, scale=scale)
            for q, k, v in zip(seq_to_heads(qs), seq_to_heads(ks),
                               seq_to_heads(vs))]
    return heads_to_seq(outs)


def _split(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """x (B, S, ...) -> n sequence shards, shard i on devices[i]."""
    n = len(devices)
    S = x.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} does not split over "
                         f"{n} sp shards")
    return [c.to(d, non_blocking=True)
            for c, d in zip(x.split(S // n, dim=1), devices)]


def _sharded(body, q, k, v, mesh, axis_name: str, causal: bool,
             scale: Optional[float], batch_axes: Tuple[str, ...],
             heads_axis: Optional[str]):
    """q, k, v whole (B, S, H*, D) on one device: rows split over
    ``batch_axes`` (row-major over them, JAX's order), heads over
    ``heads_axis``, and each piece's ``body`` run over its sp positions'
    devices; the pieces are joined back on q's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    mesh.check_one_process("ring and Ulysses attention", "14")
    shape = mesh.shape
    batch_axes = tuple(a for a in batch_axes if shape.get(a, 1) > 1)
    if heads_axis is not None and shape.get(heads_axis, 1) == 1:
        heads_axis = None
    nb = math.prod(shape[a] for a in batch_axes)
    nh = shape[heads_axis] if heads_axis else 1
    B, Hq, Hkv = q.shape[0], q.shape[2], k.shape[2]
    for what, n, size in (("batch", nb, B), ("query heads", nh, Hq),
                          ("kv heads", nh, Hkv)):
        if size % n:
            raise ValueError(f"{what} {size} does not split over {n} "
                             f"positions")
    rows, hq, hk = B // nb, Hq // nh, Hkv // nh
    grid = np.moveaxis(mesh.devices, AXES.index(axis_name), -1)
    out = []
    for b, at in enumerate(np.ndindex(*(shape[a] for a in batch_axes))):
        coord = dict(zip(batch_axes, at))
        heads = []
        for h in range(nh):
            if heads_axis:
                coord[heads_axis] = h
            idx = tuple(coord.get(a, 0) for a in AXES if a != axis_name)
            devices = list(grid[idx])
            r, qh, kh = (slice(b * rows, (b + 1) * rows),
                         slice(h * hq, (h + 1) * hq),
                         slice(h * hk, (h + 1) * hk))
            outs = body(_split(q[r, :, qh], devices),
                        _split(k[r, :, kh], devices),
                        _split(v[r, :, kh], devices), devices,
                        causal=causal, scale=scale)
            heads.append(torch.cat([o.to(q.device) for o in outs], dim=1))
        out.append(torch.cat(heads, dim=2))
    return torch.cat(out, dim=0)


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = True, scale: Optional[float] = None,
                   batch_axes: Tuple[str, ...] = ("dp", "fsdp"),
                   heads_axis: Optional[str] = "tp"):
    """Causal GQA attention with the sequence split over ``axis_name``.

    q, k, v: (B, S, H*, D) whole tensors; S must divide by the axis size.
    Batch and heads keep their ``batch_axes``/``heads_axis`` splits and
    only the sequence communicates: each (batch group, tp slice) takes its
    rows and heads of q, k and v[:, i*S/n:(i+1)*S/n] onto its i-th sp
    position's device. The output is joined back on q's device.
    Degenerate sp=1 is one local attention pass."""
    return _sharded(_ring_shards, q, k, v, mesh, axis_name, causal, scale,
                    batch_axes, heads_axis)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True, scale: Optional[float] = None,
                      batch_axes: Tuple[str, ...] = ("dp", "fsdp"),
                      heads_axis: Optional[str] = "tp"):
    """All-to-all sequence parallelism: reshard seq→heads, attend locally,
    reshard back.  Requires local head count (H / tp) divisible by the sp
    size."""
    return _sharded(_ulysses_shards, q, k, v, mesh, axis_name, causal,
                    scale, batch_axes, heads_axis)
