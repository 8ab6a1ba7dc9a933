"""Per-position memory accounting for the port's sharded training step.

Port of ray_tpu/parallel/planner.py (``MemoryPlan``, ``plan_train_memory``):
given a ``TransformerConfig``, a ``MeshSpec`` and ``LogicalAxisRules``, the
bytes one mesh position holds, checked against a card's memory, before
anything is allocated.

Accounting model (per position):
  params     exact: each leaf's bytes over the product of the mesh-axis
             sizes its spec consumes, ceil per dim (the same consumption
             as ``LogicalAxisRules.spec``), so it equals the bytes of the
             position's own shards (``sharding.shard_params``).
  grads      the same shards and dtypes as the params.
  optimizer  ``opt_slots`` copies of the params' accounting (Adam: mu and
             nu in the params' dtypes).
  activations the port's remat (``torch.utils.checkpoint`` per layer): each
             layer's input, (B_loc, S, E) in the config's dtype, for every
             layer the position holds (L/pp of them) and every row of its
             batch group. The reference keeps XLA's
             ``dots_with_no_batch_dims_saveable`` residuals of all
             mb + pp - 1 pipeline ticks instead; those are not what the
             port saves.
  logits     the f32 logits of the position's vocabulary slice (split over
             tp) and the exponentials the cross-entropy saves beside them,
             (B_loc, S, V/tp) f32 each, on the last stage.
  workspace  one layer of one microbatch at a time in the backward: its
             recomputed activations (q, k, v, o, the two normed inputs,
             gate, up and their product, each at the position's heads and
             hidden units) and, under fsdp, the layer's tp slice of the
             weights gathered across the fsdp positions. Under sp with
             ``attention_impl="ring"`` also the ring's saved f32 blocks:
             per merge of one of the sp K/V blocks, the scores, their
             exponentials and the rounded probabilities, each (B_mb,
             H/tp, S/sp, S/sp).

Batch groups take turns (the train step runs one group's forward and
backward at a time), so one group's activations are live at once. Under
pp the group's rows run as ``num_microbatches`` microbatches (default
pp) through the GPipe schedule, and the group's backward starts after its
whole forward: every microbatch's layer inputs (the stage's L/pp layers)
and, on the last stage, every microbatch's logits are alive at once, so
those two terms are the group's, as without pp, while the workspace is
one microbatch's. The plan is the last stage's, which holds the most.

Per rank (``world`` processes, one per GPU, each holding an equal run of
the positions in grid order, ``parallel.mesh``, any axis across ranks):
the params and optimizer bytes of the distinct tensors a rank holds, each
slice once however many of its positions hold it (they share one tensor
on its card); the activation, logits and workspace terms stay a
position's, which is what a rank holding one position of a split tp, sp
or pp group keeps (its own copy of each layer input, its vocabulary
slice's logits, its stage's layers).

The reference's default of 16 GiB is a TPU's memory: here the default is
the card's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .mesh import AXES, MeshSpec
from .sharding import LogicalAxisRules

GiB = float(1 << 30)


def _spec_axes(spec) -> set:
    """The mesh axes a spec splits some dim over."""
    return {a for axes in spec if axes is not None
            for a in ((axes,) if isinstance(axes, str) else axes)}


def _rank_slices(spec, sizes: Dict[str, int], world: int) -> int:
    """The most distinct slices of a leaf under ``spec`` that one rank's
    positions hold: positions agree on a slice where they agree on every
    axis the spec splits."""
    shape = tuple(sizes[a] for a in AXES)
    named = [k for k, a in enumerate(AXES) if a in _spec_axes(spec)]
    coords = list(np.ndindex(shape))
    per = len(coords) // world
    return max(len({tuple(c[k] for k in named)
                    for c in coords[r * per:(r + 1) * per]})
               for r in range(world))


def _leaf_local_bytes(shape: Sequence[int], itemsize: int,
                      logical_axes: Sequence[Optional[str]],
                      rules: LogicalAxisRules,
                      sizes: Dict[str, int]) -> int:
    """Per-position bytes of one leaf under the rule table (ceil per
    dim)."""
    spec = rules.spec(logical_axes)
    elems = 1
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            elems *= dim
            continue
        if isinstance(axes, str):
            axes = (axes,)
        shards = math.prod(sizes.get(a, 1) for a in axes)
        elems *= math.ceil(dim / shards)
    return elems * itemsize


@dataclasses.dataclass
class MemoryPlan:
    """Per-position byte budget for one (config, mesh, batch) choice."""
    cfg: Any
    spec: MeshSpec
    global_batch: int
    seq_len: int
    params_bytes: int
    grads_bytes: int
    opt_bytes: int
    activation_bytes: int
    logits_bytes: int
    workspace_bytes: int
    hbm_bytes: int
    world: int = 1
    rank_params_bytes: int = 0
    rank_opt_bytes: int = 0

    @property
    def state_bytes(self) -> int:
        return self.params_bytes + self.grads_bytes + self.opt_bytes

    @property
    def total_bytes(self) -> int:
        return (self.state_bytes + self.activation_bytes +
                self.logits_bytes + self.workspace_bytes)

    @property
    def fits(self) -> bool:
        return self.total_bytes <= self.hbm_bytes

    def table(self) -> str:
        rows = [
            ("params", self.params_bytes),
            ("grads", self.grads_bytes),
            ("optimizer", self.opt_bytes),
            ("activations", self.activation_bytes),
            ("logits+exps", self.logits_bytes),
            ("layer workspace", self.workspace_bytes),
            ("TOTAL", self.total_bytes),
            ("card", self.hbm_bytes),
        ]
        sizes = self.spec.sizes()
        mesh_s = "x".join(f"{a}={s}" for a, s in sizes.items() if s > 1) or "1"
        n_params = self.cfg.param_count()
        head = (f"mem-plan mesh[{mesh_s}] n={self.spec.n_devices} "
                f"params={n_params/1e9:.2f}B batch={self.global_batch} "
                f"seq={self.seq_len}")
        body = "\n".join(f"  {name:<18}{b/GiB:8.3f} GiB" for name, b in rows)
        verdict = "FITS" if self.fits else "DOES NOT FIT"
        margin = (self.hbm_bytes - self.total_bytes) / GiB
        return f"{head}\n{body}\n  => {verdict} (margin {margin:+.2f} GiB)"


def _card_bytes() -> int:
    """The current CUDA card's memory; raises where there is none."""
    from .._device import resolve_device
    resolve_device("cuda")
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory


def plan_train_memory(cfg, spec: MeshSpec, *,
                      global_batch: int,
                      seq_len: Optional[int] = None,
                      num_microbatches: Optional[int] = None,
                      rules: Optional[LogicalAxisRules] = None,
                      hbm_gib: Optional[float] = None,
                      opt_slots: int = 2, world: int = 1) -> MemoryPlan:
    """The per-position budget for ``make_train_step(cfg)`` on ``spec``,
    and the params and optimizer bytes one of ``world`` ranks holds.

    Pure arithmetic over shapes: needs no device but for the default
    ``hbm_gib``, which is the current CUDA card's memory (raising without
    one). ``spec`` must be fully resolved (no -1). ``num_microbatches``
    sets the pipeline's depth under pp > 1 (default pp) and is ignored
    without it, as the train step does. Under sp a position holds its
    sequence shard, ``ceil(seq / sp)`` tokens of each row, as in JAX."""
    from ..models.transformer import param_logical_axes, param_shapes

    rules = rules or LogicalAxisRules.default()
    sizes = spec.sizes()
    if any(s == -1 for s in sizes.values()):
        raise ValueError("resolve() the MeshSpec first (no -1 axes)")
    seq = seq_len or cfg.max_seq_len
    hbm = int(hbm_gib * GiB) if hbm_gib is not None else _card_bytes()

    # ---- state: exact, leaf by leaf ---------------------------------------
    def leaves(shapes, axes):
        if isinstance(shapes, dict):
            for k in shapes:
                yield from leaves(shapes[k], axes[k])
        else:
            yield shapes, axes
    state = list(leaves(param_shapes(cfg), param_logical_axes(cfg)))
    per_leaf = [_leaf_local_bytes(
        shape, torch.tensor([], dtype=dtype).element_size(), ax, rules,
        sizes) for (shape, dtype), ax in state]
    params_b = sum(per_leaf)
    if spec.n_devices % world:
        raise ValueError(f"{spec.n_devices} positions do not split over "
                         f"{world} ranks")
    rank_params_b = sum(b * _rank_slices(rules.spec(ax), sizes, world)
                        for b, (_, ax) in zip(per_leaf, state))
    grads_b = params_b                       # same shards and dtypes
    opt_b = opt_slots * params_b             # Adam: mu and nu mirror params

    # ---- one batch group's activations ------------------------------------
    pp, dp, fsdp = sizes["pp"], sizes["dp"], sizes["fsdp"]
    sp, tp = sizes["sp"], sizes["tp"]
    act = torch.tensor([], dtype=cfg.dtype).element_size()
    h, m, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    B_loc = math.ceil(global_batch / (dp * fsdp))
    S_loc = math.ceil(seq / sp)
    tokens_loc = B_loc * S_loc
    # Under pp the group's microbatches are all alive until its backward;
    # the workspace is one microbatch's.
    mb = (num_microbatches or pp) if pp > 1 else 1
    tokens_mb = math.ceil(B_loc / mb) * S_loc
    L_loc = math.ceil(cfg.num_layers / pp)
    act_b = L_loc * tokens_loc * h * act                 # each layer's input

    V_loc = math.ceil(cfg.vocab_size / tp)
    logits_b = 2 * tokens_loc * V_loc * 4                # logits + exps, f32

    layer_tok = (2 * h                                   # the normed inputs
                 + 2 * math.ceil(nh / tp) * d            # q (and roped)
                 + 2 * math.ceil(nkv / tp) * d           # k, v
                 + math.ceil(nh / tp) * d                # o
                 + 3 * math.ceil(m / tp))                # gate, up, product
    gathered = 0
    if fsdp > 1:
        w_elems = h * d * (2 * nh + 2 * nkv) + 3 * h * m
        gathered = math.ceil(w_elems / tp) * act
    ring = 0
    if sp > 1 and cfg.attention_impl == "ring":
        ring = (3 * sp * math.ceil(B_loc / mb) * math.ceil(nh / tp)
                * S_loc * S_loc * 4)
    ws_b = tokens_mb * layer_tok * act + gathered + ring

    return MemoryPlan(
        cfg=cfg, spec=spec, global_batch=global_batch, seq_len=seq,
        params_bytes=params_b, grads_bytes=grads_b, opt_bytes=opt_b,
        activation_bytes=act_b, logits_bytes=logits_b, workspace_bytes=ws_b,
        hbm_bytes=hbm, world=world, rank_params_bytes=rank_params_b,
        rank_opt_bytes=opt_slots * rank_params_b)


def plan_7b_north_star(n_devices: int, *,
                       global_batch: Optional[int] = None,
                       seq_len: int = 4096,
                       hbm_gib: Optional[float] = None) -> MemoryPlan:
    """The BASELINE.json north-star shape, Llama-2-7B (``PRESETS["7b"]``),
    on ``n_devices`` H100s; ``hbm_gib`` defaults to the card's memory.

    The mesh is fsdp over every card (the mesh of torchtitan's published
    Llama-3-8B recipe, which sets no tensor parallelism). The reference
    picks fsdp x tp=4 for a v5e, whose 16 GiB cannot hold 7B's state on few
    chips and whose 2D interconnect makes tp > 4 cross its slow axis. On
    80 GB cards the state (params, grads and two moments in bf16, 54 GB
    for 7B) split over 16 or more cards leaves most of each card free, so
    tp is not needed for memory. fsdp moves each layer's weights, a cost
    independent of the batch that can cross the slower links between
    8-card NVLink nodes, while tp all-reduces the activations twice a
    layer in each direction, which only NVLink inside a node carries at
    speed. The batch defaults to one 4096-token sequence per card (at
    least 8).
    """
    from ..models.transformer import PRESETS
    cfg = PRESETS["7b"]
    spec = MeshSpec(fsdp=n_devices)
    if global_batch is None:
        global_batch = max(n_devices, 8)
    return plan_train_memory(cfg, spec, global_batch=global_batch,
                             seq_len=seq_len, hbm_gib=hbm_gib)
