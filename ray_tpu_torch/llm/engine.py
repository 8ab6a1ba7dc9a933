"""Continuous-batching LLM generation engine in PyTorch.

Port of the single-device path of ray_tpu/llm/engine.py: a paged KV pool
shared by all slots (page 0 is the scratch page), bucketed prefill (pow-2
padding), one batched decode step for every active slot, the page-granular
prefix cache with its demotion tier (evicted pages move to host memory and
overflow to files), chunked prefill, cancellation, and prefill/decode
disaggregation (``prefill_only`` / ``decode_from``).

Full prefills and the first chunk of a chunked prefill run attention
through ``ops.flash_attention`` and so, on a GPU, through the hand-written
flash-attention kernel. Decode attends through
``ops.paged_decode_attention``: on a GPU a hand-written kernel that reads
each slot's live pages in place through its page table, on the CPU its
plain twin, the JAX package's gather written in PyTorch. The suffix
prefill of a prefix-cache hit and every later chunk of a chunked prefill
attend from a few queries to many more keys; that attention is plain
PyTorch, as in the JAX package.

JAX donates the pool to its jitted steps; here the pool is updated in
place. Temperature sampling draws from the engine's ``torch.Generator``
and cannot reproduce ``jax.random``'s bits; greedy decoding is exact.

Paged external requests (``add_paged_request``, ``prefill_paged``,
``decode_paged``) serve a context longer than ``max_len`` or the pool: its
KV lives in external (L, span, KV, D) parts, gathered through a bounded
window (``kv_gather_window``, ``kv_fetch``, ``kv_prefetch``), and only the
decode tail takes pool pages. Their attention is ``StreamAttn``
(sequence_parallel.py), plain PyTorch as in the JAX package; it never runs
the flash kernel.

The engine writes the reference's flight-recorder spans in the
``request`` category (``prefill``, ``sample_sync``, ``decode``,
``sp:gather``), ``prefill`` with its device time (``device_us``) on a
CUDA engine, and one ``engine:step`` span of its own per ``step()`` (see
_private/flight_recorder.py). Not copied:
``_report_pool_pressure``, which feeds the reference runtime's memory
monitor.

Copy audit (_private/device_plane.py), at the reference's seams: a paged
part that arrives on the host (a numpy array, or a CPU tensor on a CUDA
engine) counts ``record_h2d`` when ``_part_layer`` uploads it, and
``prefill_paged(host_staged=True)`` copies each part to host numpy (bf16 as
its int16 bits, with "dtype": "bfloat16" in the part) and counts
``record_d2h``. ``prefill_only``'s blob is one contiguous (L, S, KV, D)
tensor per k and v on the engine's device, joined there from a sharded
engine's positions, so shipping it through the port's serializer
(_private/serialization.py) stages each exactly once; ``decode_from``
takes the rebuilt tensors.

Sequence parallelism (``sp_degree``, ``sp_strategy``, ``mesh``): full
prefills, chunks and prefix-hit suffixes split their sequence over the
``sp`` positions of a ``parallel.mesh.Mesh`` and run ring attention or
Ulysses (sequence_parallel.py), plain PyTorch as in the JAX package: an SP
prefill launches no flash kernel. One process drives every shard on its
device, as the JAX engine does. The weights go once to each distinct device
of the mesh; the pool and decode stay on the engine's device, where JAX
replicates the pool over the mesh and decodes on every shard: the placement
differs, the values do not.

Tensor parallelism (``mesh`` with a ``tp`` axis, ``rules``): the weights
split over the mesh's ``tp`` positions, by default in the Megatron
layout (heads, kv heads and the MLP's hidden units; embedding, norms and
lm_head replicated, the JAX engine's rules), and the pool over kv heads,
one (L, N, page, KV/tp, D) pool per position, while page ids, tables,
the free list, the refcounts and the prefix cache stay single, one
logical pool as in JAX.
Every layer of every prefill, suffix, decode step and streamed step runs
each position's share and all-reduces after the attention and after the
MLP (``models.transformer.tp_layer``); a full prefill launches the flash
kernel once per position and layer, over the position's heads. Embedding,
final norm, lm_head and sampling run once, on the first position's device,
and KV blobs (P/D, demotion, external parts) keep the full (L, S, KV, D)
layout, split over the positions at install and joined at export, so KV
moves between sharded and unsharded engines. One process drives every
position, as the JAX engine's single controller does; the engine keeps only
the positions' params (``params`` is None).

The other serving meshes (``Mesh.serve_axes``):

- sp x tp: the weights split over tp as above, each tp position's pool at
  its first sp position (JAX replicates it over sp: the placement differs,
  the values do not). Full prefills, chunks and suffixes run
  sequence-parallel, each tp position running the ring or Ulysses over its
  sp positions at its own heads (``sp_prefill_fn`` on ``tp_shards``'
  per-position params, the reference's ``heads_axis="tp"``); decode,
  install, the prefix cache, demotion, P/D and the paged path run per tp
  position, as on a tp mesh.
- pp, alone or beside tp: the layer stack splits over the stages (the
  Megatron rules' ``layer -> pp``), stage s's positions holding layers
  [s L/pp, (s+1) L/pp) and a pool for those layers. Every prefill, suffix,
  decode step and streamed step goes stage by stage, the hidden state
  handed on by ``.to()`` (``pipeline.stage_send``); a full prefill runs
  the flash kernel on each stage's layers. Embedding and sampling run on
  the first position, the final norm and lm_head on the last stage's;
  blobs join the stages' layers in order and split them at install.
- dp or fsdp, alone or beside the others: the Megatron rules put no
  param on either axis, so JAX replicates the weights and the pool over
  them (a table that stores params over them, as the default table does
  over fsdp, leaves each replica's positions only their slices, gathered
  at use). Here a replica is the mesh's split layout at one dp x fsdp
  coordinate (one position, a tp group, a pp x tp stack or an sp x tp
  group), held once per distinct placement of its positions on devices
  (``_replicas``): n distinct card sets hold n times the weight bytes and
  do n times the work, for the same tokens. Every prefill, suffix and
  decode step runs on each replica and installs into its pools; the first
  samples, and a later replica's greedy decode tokens that differ from
  the first's raise RuntimeError. The paged path's streamed attention
  runs on the first replica, its tail KV written into every replica's
  pools. A mesh that names one device n times holds one replica.
- pp beside sp (and tp): full prefills, chunks and suffixes run
  sequence-parallel stage by stage, each stage's sp shards over its
  layers, a shard's hidden state handed to the next stage's devices by
  ``.to()``; decode and the rest run stage by stage as under pp x tp, on
  the pools of sp shard 0's positions.

Any other rule table (``rules``): each position stores the slices the
table gives it (``tp_shards``; once per distinct device) and computes in
the layout above, building each layer's weights from the stored slices
when it runs the layer (``models.transformer.PositionView``: under
``LogicalAxisRules.default()`` with fsdp, a replica's positions hold
embed-dim slices and gather them a layer at a time). Where a table
splits the vocabulary over tp (the default table does), each tp position
holds its vocabulary slice of embed and lm_head, and the embedding and the
logits are vocabulary-parallel (``transformer.embed_tokens``,
``head_logits``), the training path's: no position gathers the whole
table. The pool stays over kv heads on tp, as JAX's does. A mesh over
several processes raises NotImplementedError: the engine drives every
position from one process, as the JAX engine's single controller does.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import math
import os
import tempfile
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import _config
from .._device import resolve_device
from .._private import device_plane, flight_recorder
from ..exceptions import KVGatherError
from ..models.transformer import (TransformerConfig, _flat,
                                  _layer_qkv, apply_rope, embed_tokens,
                                  head_logits, init_params, layer_params,
                                  megatron_rules, param_logical_axes,
                                  position_views,
                                  rope_angles, tp_layer, tp_shards)
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_decode_attention
from ..parallel.mesh import Mesh, MeshSpec, build_mesh
from ..parallel.pipeline import stage_send
from ..parallel.sharding import LogicalAxisRules, _dim_axes, tree_specs
from .sequence_parallel import (StreamAttn, _stream_block_fn,
                                replicate_params, sp_mesh, sp_prefill_fn,
                                sp_stripe_pages, sp_suffix_prefill_fn,
                                validate_sp)


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    eos_id: Optional[int] = None


@dataclasses.dataclass
class _Request:
    req_id: int
    prompt: List[int]
    params: SamplingParams
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    # Why generation ended: "stop" (eos), "length" (max_tokens/max_len) or
    # "cancelled" (cancel_request).
    finish_reason: str = ""
    # Prefix-cache bookkeeping: pages borrowed from the cache (ref-held,
    # never written by this request) and how many prompt tokens they cover.
    shared_pages: List[int] = dataclasses.field(default_factory=list)
    prefix_len: int = 0
    no_cache: bool = False
    # P/D: a shipped KV blob installed at admission in place of a prefill
    # (add_external_request), and the first token sampled where it ran.
    kv_blob: Optional[dict] = None
    first_token: int = -1
    # Chunked prefill: prompt tokens already prefilled into the slot's pages.
    prefilled: int = 0
    # Paged external context (add_paged_request): the prompt's KV lives in
    # external parts and only the decode tail takes pool pages; ext_written
    # counts the tail tokens whose KV is appended (the next write position
    # is ext_len + ext_written).
    kv_paged: bool = False
    ext_parts: List[dict] = dataclasses.field(default_factory=list)
    ext_len: int = 0
    ext_written: int = 0
    # A typed failure (KVGatherError of a part): the request retires with
    # finish_reason "error" and never emits a wrong token.
    error: Optional[BaseException] = None
    # SP accounting: shard i's stripe of the slot's pages (which pages a
    # sequence-parallel prefill shard installed and would hand off).
    sp_stripes: Optional[List[List[int]]] = None


# --------------------------------------------------------------------------
# Pure pieces
# --------------------------------------------------------------------------

def _sqrt_head_dim(cfg: TransformerConfig) -> float:
    """sqrt(D) rounded to the working dtype: JAX divides the scores of its
    plain attention by that."""
    return float(torch.tensor(math.sqrt(cfg.head_dim_), dtype=cfg.dtype))


def _devices(shards) -> List[torch.device]:
    """Each position's device: where its layer weights live."""
    return [s["layers"]["attn"]["wq"].device for s in shards]


def _embed(shards, tokens, cfg: TransformerConfig):
    """The embedding of ``tokens`` {device: x} on the first stage's
    positions (``embed_tokens``: the first position's table, or each
    position's vocabulary slice summed)."""
    n = shards[0]["layers"]["attn"]["wq"].shape[0]
    first = shards[:len(shards) * n // cfg.num_layers]
    return embed_tokens(first, _devices(first), tokens, cfg)


def _walk(shards, cfg: TransformerConfig):
    """(li, lj, idx) for every layer li in order: ``shards`` is the
    positions' list, pipeline stage by stage (each stage its tp positions
    in order, one stage without pp), each position holding its stage's
    L/pp layers; lj is li's index among them and idx the flat indices of
    its stage's positions."""
    n = shards[0]["layers"]["attn"]["wq"].shape[0]
    tp = len(shards) * n // cfg.num_layers
    for li in range(cfg.num_layers):
        s = li // n
        yield li, li % n, list(range(s * tp, (s + 1) * tp))


def _onto(xs, devices) -> Dict[torch.device, torch.Tensor]:
    """The activation {device: x} on each distinct device of ``devices``:
    as it is where it already is there, else handed from the previous
    pipeline stage's first device (``pipeline.stage_send``)."""
    if all(d in xs for d in devices):
        return xs
    return stage_send(next(iter(xs.values())), devices)


def _replicas(mesh) -> List[Tuple[Mesh, List[int]]]:
    """The serving replicas of ``mesh``: per dp x fsdp coordinate whose
    positions' devices (in grid order) differ from every earlier one's,
    its pp x sp x tp mesh and the flat indices of its positions. The
    Megatron rules place nothing on dp or fsdp, so replicas on the same
    devices would hold the same tensors and do the same work: a mesh that
    names one device n times holds one replica."""
    out: Dict[tuple, Tuple[Mesh, List[int]]] = {}
    coords = mesh.coords()
    for d in range(mesh.shape["dp"]):
        for f in range(mesh.shape["fsdp"]):
            at = [i for i, c in enumerate(coords) if c[1:3] == (d, f)]
            out.setdefault(tuple(mesh.devices.flat[i] for i in at),
                           (Mesh(mesh.devices[:, d:d + 1, f:f + 1]), at))
    return list(out.values())


def _kv_buffers(shards, S: int, cfg: TransformerConfig):
    """Empty (L_i, S, KV_i, D) k and v per position, for its layers and kv
    heads."""
    ks = [torch.empty(p["layers"]["attn"]["wk"].shape[:1]
                      + (S, p["layers"]["attn"]["wk"].shape[2],
                         cfg.head_dim_), dtype=cfg.dtype, device=d)
          for p, d in zip(shards, _devices(shards))]
    return ks, [torch.empty_like(k) for k in ks]


def _logits(shards, xs, idx, at, home, cfg: TransformerConfig):
    """The final norm and lm_head at index ``at`` of the last stage's
    activation (``idx`` the last stage's positions): f32 logits, on
    ``home`` (``head_logits``: once on the first position, or each
    position's vocabulary slice, joined)."""
    ps = [shards[i] for i in idx]
    return head_logits(ps, _devices(ps), xs, at, cfg).to(home)


def _prefill_fn(params, tokens, length: int, cfg: TransformerConfig):
    """tokens (1, Sb) padded prompt -> (last_logits (V,) f32,
    ks, vs (L, Sb, KV, D)).

    Positions >= length produce garbage cache rows; decode masks them out
    via per-slot lengths, and the last real token's logits only attend
    backwards (causal), so padding never leaks into results.

    ``params`` is the list of the positions' params
    (``models.transformer.tp_shards``; one entry without a mesh): per
    pipeline stage its tp positions (``_walk``). Each position runs the
    flash kernel over its own heads and layers, and ks, vs are lists of
    (L_i, Sb, KV_i, D), one per position on its device. The embedding
    runs on the first position, the final norm and lm_head on the last
    stage's, and the logits come back to tokens' device."""
    devices = _devices(params)
    B, S = tokens.shape
    xs = _embed(params, tokens, cfg)
    ropes = {d: rope_angles(S, cfg.head_dim_, cfg.rope_theta, device=d)
             for d in dict.fromkeys(devices)}
    ks, vs = _kv_buffers(params, S, cfg)
    for li, lj, idx in _walk(params, cfg):
        devs = [devices[i] for i in idx]
        xs = _onto(xs, devs)
        lps = [layer_params(params[i], lj) for i in idx]

        def attend(h):
            out = []
            for i, lp, d in zip(idx, lps, devs):
                cos, sin = ropes[d]
                q, k, v = _layer_qkv(lp, h[d], cfg)
                k = apply_rope(k, cos, sin)
                ks[i][lj] = k[0]          # drop the B=1 dim for the cache
                vs[i][lj] = v[0]
                # The JAX engine writes this causal GQA attention inline;
                # it is reference_attention, so here it runs through the
                # flash kernel.
                out.append(flash_attention(apply_rope(q, cos, sin), k, v,
                                           causal=True))
            return out
        xs = tp_layer(cfg, xs, lps, devs, attend)
    return (_logits(params, xs, idx, (0, length - 1), tokens.device, cfg),
            ks, vs)


def _suffix_prefill_fn(params, pool_k, pool_v, pages, tokens, prefix_len: int,
                       length: int, cfg: TransformerConfig, page: int):
    """Suffix half of a prefix-cache hit, and every chunk after the first of
    a chunked prefill: the transformer over only tokens[prefix_len:], whose
    queries attend to the cached KV of tokens[:prefix_len] already resident
    in the pool, and causally to the suffix itself.

    pages: (P,) a full page-table row: the prefix pages first, then pages
    whose contents are garbage and masked, like decode's scratch reads
    (prefix_len is page-aligned). tokens: (1, Sb) the padded suffix; length
    = its real length. Returns (last_logits (V,) f32, the suffix's ks, vs
    (L, Sb, KV, D)), the contract of _prefill_fn, so installing is shared.
    ``params`` is the positions' list (as _prefill_fn), pool_k and pool_v
    are the positions' pools, and each position attends over its own kv
    heads and layers.

    The attention is plain PyTorch, as in the JAX engine: the flash kernel
    takes as many queries as keys."""
    devices = _devices(params)
    B, Sb = tokens.shape
    T = pages.shape[0] * page
    D = cfg.head_dim_
    groups = cfg.num_heads // cfg.num_kv_heads
    dev = tokens.device
    xs = _embed(params, tokens, cfg)
    # RoPE at absolute positions prefix_len + i.
    cos, sin = rope_angles(Sb, D, cfg.rope_theta, offset=prefix_len,
                           device=dev)
    # Key t of [cached T | suffix Sb] is valid for suffix query s iff it is
    # a real cached prefix position or a suffix position <= s.
    tpos = torch.arange(T + Sb, device=dev)[None]
    qpos = torch.arange(Sb, device=dev)[:, None]
    valid = (tpos < prefix_len) | ((tpos >= T) & (tpos - T <= qpos))
    on = {d: [t.to(d) for t in (cos, sin, ~valid[None, None], pages)]
          for d in dict.fromkeys(devices)}
    sqrt_d = _sqrt_head_dim(cfg)
    ks, vs = _kv_buffers(params, Sb, cfg)
    for li, lj, idx in _walk(params, cfg):
        devs = [devices[i] for i in idx]
        xs = _onto(xs, devs)
        lps = [layer_params(params[i], lj) for i in idx]

        def attend(h):
            out = []
            for i, lp, d in zip(idx, lps, devs):
                cos, sin, masked, pg = on[d]
                q, k, v = _layer_qkv(lp, h[d], cfg)
                q = apply_rope(q, cos, sin)
                k = apply_rope(k, cos, sin)
                KV = k.shape[2]
                kk = torch.cat([pool_k[i][lj][pg].reshape(1, T, KV, D), k],
                               dim=1)
                vv = torch.cat([pool_v[i][lj][pg].reshape(1, T, KV, D), v],
                               dim=1)
                kr = kk.repeat_interleave(groups, dim=2)    # (1, T+Sb, H, D)
                vr = vv.repeat_interleave(groups, dim=2)
                scores = torch.einsum("bshd,bthd->bhst", q, kr) / sqrt_d
                scores = scores.masked_fill(masked, -1e30)
                p = torch.softmax(scores.float(), -1).to(q.dtype)
                out.append(torch.einsum("bhst,bthd->bshd", p, vr))
                ks[i][lj] = k[0]
                vs[i][lj] = v[0]
            return out
        xs = tp_layer(cfg, xs, lps, devs, attend)
    return _logits(params, xs, idx, (0, length - 1), dev, cfg), ks, vs


def _install_fn(pool_k, pool_v, ks, vs, pages, page: int) -> None:
    """Write a prefill's (L, Sb, KV, D) kv into the slot's reserved pages,
    in place.

    pages: (P,) physical page ids. Entries past the slot's reserved count
    are 0, the shared scratch page, whose contents are garbage by
    contract: every read of it is masked and page 0 is never handed out."""
    L, Sb, KV, D = ks.shape
    P = pages.shape[0]
    pad = P * page - Sb
    if pad > 0:
        ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
    pool_k[:, pages] = ks.reshape(L, P, page, KV, D)
    pool_v[:, pages] = vs.reshape(L, P, page, KV, D)


def _decode_fn(params, pool_k, pool_v, tables, last_tokens, lengths, active,
               temps, generator, cfg: TransformerConfig, page: int):
    """One decode step for ALL slots against the paged pool, which it
    updates in place.

    ``params`` is the positions' list (as _prefill_fn); pool_k/pool_v
    the positions' pools, (L_i, N, page, KV_i, D) each, written and read by
    its own position; tables (B, P) physical page ids (page 0 = scratch
    for inactive slots); lengths (B,) = tokens already in cache (the new
    token is written at index lengths); active (B,) bool; temps (B,) f32
    sampling temperatures, or None when every slot decodes greedily.
    Returns next tokens (B,)."""
    devices = _devices(params)
    D = cfg.head_dim_
    dev = last_tokens.device
    xs = _embed(params, last_tokens[:, None], cfg)
    # Per-slot RoPE at each slot's own position.
    freqs = 1.0 / (cfg.rope_theta
                   ** (torch.arange(0, D, 2, dtype=torch.float32, device=dev)
                       / D))
    ang = lengths.float()[:, None] * freqs[None]                 # (B, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]  # (B,1,D/2)
    # Physical write position of the incoming token for every slot.
    write_page = tables.gather(1, (lengths // page)[:, None])[:, 0]
    write_page = torch.where(active, write_page, 0)              # scratch
    write_off = lengths % page
    on = {d: [t.to(d) for t in (cos, sin, write_page, write_off, tables,
                                lengths, active)]
          for d in dict.fromkeys(devices)}
    scale = 1.0 / _sqrt_head_dim(cfg)

    def rope1(t, cos, sin):             # t: (B, 1, H, D)
        t1, t2 = t.float().chunk(2, dim=-1)
        c, s = cos[..., None, :], sin[..., None, :]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s],
                         dim=-1).to(t.dtype)

    for li, lj, idx in _walk(params, cfg):
        devs = [devices[i] for i in idx]
        xs = _onto(xs, devs)
        lps = [layer_params(params[i], lj) for i in idx]

        def attend(h):
            out = []
            for i, lp, d in zip(idx, lps, devs):
                cos, sin, wpage, woff, tb, lens, act = on[d]
                q, k, v = _layer_qkv(lp, h[d], cfg)
                q, k = rope1(q, cos, sin), rope1(k, cos, sin)
                pk, pv = pool_k[i][lj], pool_v[i][lj]
                pk[wpage, woff] = k[:, 0]
                pv[wpage, woff] = v[:, 0]
                out.append(paged_decode_attention(
                    q[:, 0], pk, pv, tb, lens, act, scale)[:, None])
            return out
        xs = tp_layer(cfg, xs, lps, devs, attend)
    logits = _logits(params, xs, idx, (slice(None), 0), dev, cfg)
    nxt = logits.argmax(-1)
    if temps is not None:
        probs = torch.softmax(logits / temps.clamp_min(1e-6)[:, None], -1)
        sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
        nxt = torch.where(temps > 0, sampled, nxt)
    return torch.where(active, nxt, 0)


# --------------------------------------------------------------------------
# Prefix cache and its demotion tier
# --------------------------------------------------------------------------

class _PrefixCache:
    """Page-granular KV prefix reuse (vLLM's PagedAttention block sharing
    on the paged pool): every FULL prompt page is keyed by the rolling hash
    of all tokens up to its end, so requests sharing a prompt prefix share
    the physical pages, skipping both the page allocation and the prefill
    compute for the shared span.

    Entries are LRU-ordered; the reserve path evicts until a new request
    fits or the cache is dry. The engine ref-counts pages: cache membership
    holds one ref per entry, each active request one, and a page returns to
    the free list only when the last holder lets go, so evicting an entry
    out from under an in-flight request is safe."""

    def __init__(self, page: int, tag: bytes = b""):
        self.page = page
        # Key namespace tag (the JAX engine tags sequence-parallel layouts).
        self.tag = tag
        # rolling-hash key -> page ids covering the whole prefix
        self._entries: "OrderedDict[bytes, List[int]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hit_pages = 0          # pages whose prefill was skipped
        self.evictions = 0

    def _keys(self, prompt: Sequence[int], upto: int) -> List[bytes]:
        """Rolling hash at every page boundary 1..upto: blake2b over the
        tag and each page's tokens as int32 bytes, the JAX engine's keys."""
        h = hashlib.blake2b(digest_size=16)
        h.update(self.tag)
        out = []
        for k in range(1, upto + 1):
            h.update(np.asarray(prompt[(k - 1) * self.page: k * self.page],
                                np.int32).tobytes())
            out.append(h.copy().digest())
        return out

    def lookup(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix usable by this prompt: (token count, page
        ids). Capped at S-1 tokens: the last prompt token's logits must be
        computed, so at least a one-token suffix always runs."""
        usable = (len(prompt) - 1) // self.page
        if usable <= 0:
            return 0, []
        keys = self._keys(prompt, usable)
        for k in range(usable, 0, -1):
            pages = self._entries.get(keys[k - 1])
            if pages is not None:
                self._entries.move_to_end(keys[k - 1])
                self.hits += 1
                self.hit_pages += k
                return k * self.page, list(pages)
        self.misses += 1
        return 0, []

    def insert(self, prompt: Sequence[int], table_row, incref) -> None:
        """Register every full prompt page of a freshly prefilled request
        (decode writes land strictly after them, so they are immutable)."""
        full = len(prompt) // self.page
        if full <= 0:
            return
        keys = self._keys(prompt, full)
        for k in range(1, full + 1):
            key = keys[k - 1]
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            pages = [int(p) for p in table_row[:k]]
            self._entries[key] = pages
            for p in pages:
                incref(p)

    def evict_lru(self, decref, demote=None) -> bool:
        """Drop the least-recently-used entry; True if one was dropped.
        Pages still held by active requests stay allocated (ref > 0).
        ``demote(key, pages)``, when given, runs BEFORE the refs drop, so it
        can copy the pages out of the pool while they cannot be reused."""
        if not self._entries:
            return False
        key, pages = self._entries.popitem(last=False)
        self.evictions += 1
        if demote is not None:
            demote(key, pages)
        for p in pages:
            decref(p)
        return True


_BITS = {2: torch.int16, 4: torch.int32}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's raw bits as a numpy integer array (numpy has no bf16)."""
    return t.contiguous().view(_BITS[t.element_size()]).numpy()


class _KVDemoteStore:
    """Demoted prefix-cache pages: a byte-bounded host window with
    overflow to files.

    LRU-evicted prefix-cache entries land here instead of being freed
    outright: the pages' contents move device -> host as CPU tensors of
    shape (L, pages, page, KV, D) in an LRU window of at most ``byte_limit``
    bytes, and what overflows goes to ``kvdemote-<pid>-<seq>.npz`` files
    under ``spill_dir`` (the raw bits as integers beside the dtype's name,
    read back bit-exactly). A later request sharing the prefix promotes the
    entry back into the pool in place of re-running prefill. Entries are
    caches, never truth: one may be dropped (on a failed write) at the cost
    of a re-prefill.

    Divergence from the reference, whose fault it is: the JAX store writes
    bf16 pages with ``np.savez`` as ml_dtypes arrays, which load back as
    ``|V2`` void, and promoting such a file entry raises ``ValueError: No
    cast function available.`` out of ``step()``. Here the raw bits round
    trip, so a bf16 entry that overflowed to a file promotes, with the
    tokens of a resident hit (tests/test_torch_engine_cache.py pins both
    sides)."""

    def __init__(self, byte_limit: int, spill_dir: str):
        self.byte_limit = max(0, int(byte_limit))
        self.spill_dir = spill_dir
        self._host: "OrderedDict[bytes, dict]" = OrderedDict()
        self._disk: Dict[bytes, str] = {}
        self._host_bytes = 0
        self._seq = 0
        self.demoted_pages = 0
        self.promoted_pages = 0
        self.disk_spills = 0

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def contains(self, key: bytes) -> bool:
        return key in self._host or key in self._disk

    def put(self, key: bytes, k: torch.Tensor, v: torch.Tensor,
            npages: int) -> None:
        if self.contains(key):
            return
        self._host[key] = {"k": k, "v": v, "len": int(npages)}
        self._host_bytes += k.nbytes + v.nbytes
        self.demoted_pages += int(npages)
        while self._host_bytes > self.byte_limit and self._host:
            okey, part = self._host.popitem(last=False)
            self._host_bytes -= part["k"].nbytes + part["v"].nbytes
            self._spill(okey, part)

    def _spill(self, key: bytes, part: dict) -> None:
        try:
            os.makedirs(self.spill_dir, exist_ok=True)
            self._seq += 1
            path = os.path.join(
                self.spill_dir,
                "kvdemote-%d-%d.npz" % (os.getpid(), self._seq))
            np.savez(path, k=_bits(part["k"]), v=_bits(part["v"]),
                     dtype=str(part["k"].dtype).removeprefix("torch."),
                     len=np.int64(part["len"]))
            self._disk[key] = path
            self.disk_spills += 1
        except OSError:
            pass    # dropped: a demoted entry is a cache, never truth

    def get(self, key: bytes) -> Optional[dict]:
        """Pop an entry for promotion ({"k", "v", "len"}), or None."""
        part = self._host.pop(key, None)
        if part is not None:
            self._host_bytes -= part["k"].nbytes + part["v"].nbytes
            self.promoted_pages += part["len"]
            return part
        path = self._disk.pop(key, None)
        if path is None:
            return None
        try:
            with np.load(path) as z:
                dtype = getattr(torch, str(z["dtype"]))
                part = {"k": torch.from_numpy(z["k"]).view(dtype),
                        "v": torch.from_numpy(z["v"]).view(dtype),
                        "len": int(z["len"])}
        except OSError:
            return None
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.promoted_pages += part["len"]
        return part

    def stats(self) -> Dict[str, Any]:
        return {"demoted_pages": self.demoted_pages,
                "promoted_pages": self.promoted_pages,
                "demoted_entries": len(self),
                "demoted_host_bytes": self._host_bytes,
                "demoted_disk_entries": len(self._disk),
                "demoted_disk_spills": self.disk_spills}


class _KVWindow:
    """Bounded window over the external KV parts of paged requests.

    The streamed-attention path never holds a paged request's context in
    the pool; it needs each part it attends to, one at a time. This window
    holds at most ``capacity`` parts (LRU), fetched through the engine's
    ``kv_fetch`` callback and optionally warmed ahead of the attention by
    ``kv_prefetch`` (which returns futures). A window smaller than a
    request's part count degrades to fetching again, counted in
    ``refetches``, never silent. The entry of a fetched part is the
    window's own shallow copy of what ``kv_fetch`` returned, so the device
    copy the engine caches in it (``_part_layer``) goes when the entry
    goes: device residency is bounded by ``capacity`` parts."""

    def __init__(self, capacity: int, fetch, prefetch=None):
        self.capacity = max(1, int(capacity))
        self._fetch = fetch
        self._prefetch = prefetch
        self._data: "OrderedDict[str, dict]" = OrderedDict()
        self._futures: Dict[str, Any] = {}
        # Recently seen keys, for refetch counting; LRU-bounded, since a
        # prefill streams one-shot part keys that no request ever drops.
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._seen_cap = max(64, 16 * self.capacity)
        self.fetches = 0
        self.refetches = 0
        self.bytes_fetched = 0
        self.wait_s = 0.0

    def _mark_seen(self, key: str) -> None:
        self._seen[key] = None
        self._seen.move_to_end(key)
        while len(self._seen) > self._seen_cap:
            self._seen.popitem(last=False)

    def _validate(self, key: str, data) -> dict:
        if not isinstance(data, dict) or "k" not in data or "v" not in data:
            raise KVGatherError(
                f"KV part {key!r} resolved to {type(data).__name__}, "
                f"expected a {{'k','v','len'}} dict")
        return data

    def _admit(self, key: str, data: dict) -> dict:
        self._data[key] = data
        self._data.move_to_end(key)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
        return data

    def put(self, key: str, data: dict) -> None:
        """Seed a locally produced part (a paged prefill keeps its own
        fresh parts hot for its next chunk)."""
        self._mark_seen(key)
        self._admit(key, data)

    def prefetch(self, items) -> None:
        """Start ``kv_prefetch`` for [(key, handle)] not already held."""
        if self._prefetch is None:
            return
        for key, handle in items:
            if key in self._data or key in self._futures:
                continue
            try:
                self._futures[key] = self._prefetch(handle)
            except Exception:   # best effort: get() fetches and types it
                self._futures.pop(key, None)

    def get(self, key: str, handle) -> dict:
        data = self._data.get(key)
        if data is not None:
            self._data.move_to_end(key)
            return data
        t0 = time.perf_counter()
        fut = self._futures.pop(key, None)
        try:
            data = fut.result() if fut is not None else self._fetch(handle)
        except KVGatherError:
            raise
        except Exception as e:
            raise KVGatherError(
                f"gather of KV part {key!r} failed: "
                f"{type(e).__name__}: {e}") from e
        self.wait_s += time.perf_counter() - t0
        data = self._validate(key, data)
        self.fetches += 1
        if key in self._seen:
            self.refetches += 1
        self._mark_seen(key)
        self.bytes_fetched += (getattr(data["k"], "nbytes", 0)
                               + getattr(data["v"], "nbytes", 0))
        return self._admit(key, dict(data))

    def drop(self, keys) -> None:
        for k in keys:
            self._data.pop(k, None)
            self._futures.pop(k, None)
            self._seen.pop(k, None)

    def stats(self) -> Dict[str, Any]:
        return {"fetches": self.fetches, "refetches": self.refetches,
                "bytes": self.bytes_fetched, "wait_s": self.wait_s,
                "resident": len(self._data), "capacity": self.capacity}


def _default_kv_fetch(handle):
    """Fetch without a ``kv_fetch`` callback: parts passed by value are
    their data."""
    if isinstance(handle, dict):
        return handle
    raise KVGatherError(
        f"remote KV handle {type(handle).__name__} needs a kv_fetch "
        f"callback")


def _host_part(part: dict) -> dict:
    """A KV part copied to host numpy (the host-staged downgrade), its
    copies counted by the device plane's ``record_d2h``; a bf16 part's
    arrays hold its int16 bits and the part says "dtype": "bfloat16"."""
    hk, name = device_plane.host_array(part["k"])
    hv, _ = device_plane.host_array(part["v"])
    device_plane.record_d2h(hk.nbytes + hv.nbytes)
    out = {"k": hk, "v": hv, "len": part["len"]}
    if name == "bfloat16":
        out["dtype"] = name
    return out


def _publish_when_made(publish, part: dict,
                       made: Optional[torch.cuda.Event]):
    """``publish(part)`` on the publish thread, once the stream that
    computed the part has passed ``made``."""
    if made is not None:
        made.synchronize()
    return publish(part)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

class LLMEngine:
    """Continuous-batching engine with a paged KV pool on one device, or
    on any serving mesh: sequence-parallel prefill over ``sp``,
    tensor-parallel weights and pool over ``tp``, pipeline stages over
    ``pp``, and replicas of that layout over ``dp`` and ``fsdp``."""

    def __init__(self, cfg: TransformerConfig, params=None, *,
                 max_batch: int = 4, max_len: int = 256, seed: int = 0,
                 page_size: int = 64, kv_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 kv_gather_window: int = 4, kv_fetch=None, kv_prefetch=None,
                 sp_degree: Optional[int] = None, sp_strategy: str = "ring",
                 mesh=None, rules: Optional[LogicalAxisRules] = None,
                 device: Union[str, torch.device] = "cuda"):
        """kv_pages sizes the shared pool (default: enough for every slot
        at max_len; set it lower to oversubscribe: admission then queues
        until pages free up). params default to ``init_params`` drawn from
        ``seed``; given params must already live on ``device``.

        prefix_cache=True enables page-granular KV prefix reuse (shared
        full prompt pages skip prefill; LRU-evicted under pool pressure,
        into the demotion tier unless ``RAY_TPU_kv_cache_demotion_enabled``
        says otherwise). It is off by default: retired pages then linger
        in the cache instead of returning to the free list at once.
        prefill_chunk (tokens, rounded down to a page multiple, at least
        one page) bounds the prefill work per step(): a longer prompt
        advances one chunk per step, so it cannot starve the decoding
        requests.

        kv_gather_window, kv_fetch and kv_prefetch configure the paged
        external requests (add_paged_request): at most ``kv_gather_window``
        external parts are held at once (host and device), fetched by
        ``kv_fetch(handle)`` (blocking; default: a part passed by value is
        its data) and warmed by ``kv_prefetch(handle) -> future``.

        sp_degree (default: cfg.sp_degree, or a given mesh's sp axis) > 1
        splits prefill over an ``sp`` mesh (ring attention, or Ulysses
        with sp_strategy="ulysses"). Without a mesh the engine builds one:
        ``sp_mesh(sp_degree)`` over the visible CUDA devices, which raises
        where there are fewer, or on ``device="cpu"`` a mesh that names
        the CPU sp_degree times. ``mesh=build_mesh(MeshSpec(sp=n),
        devices=[cuda:0] * n)`` runs n shards in turn on one card.

        A mesh with a ``tp`` or ``pp`` axis splits the weights (stored
        as ``rules`` say, default ``megatron_rules()``, the JAX engine's;
        any table is accepted, see the module docstring) and the pool
        over its positions: tp over heads, kv heads and the MLP's hidden
        units, pp over the layer stack; beside them an sp axis splits the
        prefills as well.
        ``mesh=build_mesh(MeshSpec(tp=n), devices=[cuda:0] * n)`` runs n
        positions in turn on one card. A dp or fsdp axis replicates the
        split layout once per distinct placement of its positions. The
        engine's device must be of the first position's type, and becomes
        that device. A mesh over several processes raises
        NotImplementedError (``Mesh.serve_axes``)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.page = max(8, min(page_size, max_len))
        self.pages_per_slot = math.ceil(max_len / self.page)
        # page 0 is scratch (inactive-slot writes land there); never handed out
        self.n_pages = 1 + (kv_pages if kv_pages is not None
                            else max_batch * self.pages_per_slot)
        deg = sp_degree if sp_degree is not None else cfg.sp_degree
        if sp_degree is None and deg == 1 and mesh is not None \
                and mesh.shape.get("sp", 1) > 1:
            # No caller-requested degree: adopt the mesh's sp axis. An
            # explicit sp_degree (or a cfg default > 1) is never silently
            # overridden: a mismatch hits the ValueError below.
            deg = mesh.shape["sp"]
        self.sp_degree = max(1, int(deg))
        self.sp_strategy = sp_strategy
        if self.sp_degree > 1:
            if self.sp_degree & (self.sp_degree - 1):
                raise ValueError(
                    f"sp_degree={self.sp_degree} must be a power of two "
                    f"(pow-2 prefill buckets shard evenly)")
            if max_len % self.sp_degree:
                # _bucket clamps to max_len, so a non-divisible max_len
                # could not split over the shards on the first long
                # prompt: fail at construction instead.
                raise ValueError(
                    f"max_len={max_len} must be divisible by "
                    f"sp_degree={self.sp_degree} (prefill buckets clamp "
                    f"to max_len)")
            validate_sp(cfg, self.sp_degree, sp_strategy,
                        mesh.shape["tp"] if mesh is not None else 1)
            if mesh is None:
                mesh = (build_mesh(MeshSpec(sp=self.sp_degree),
                                   devices=[self.device] * self.sp_degree)
                        if self.device.type == "cpu"
                        else sp_mesh(self.sp_degree))
            elif mesh.shape.get("sp", 1) != self.sp_degree:
                raise ValueError(
                    f"sp_degree={self.sp_degree} but the given mesh's sp "
                    f"axis is {mesh.shape.get('sp', 1)} — build the mesh "
                    f"with MeshSpec(sp={self.sp_degree})")
        self.mesh = mesh
        # The serving layout (Mesh.serve_axes): tp splits the weights and
        # the pool over kv heads, pp over the layer stack (Megatron rules,
        # the JAX engine's), and dp or fsdp replicate the split layout
        # once per distinct placement. Embedding and sampling run on the
        # first position, the final norm and lm_head on the last stage's.
        self.tp_degree = self.pp_degree = 1
        axes = mesh.serve_axes() if mesh is not None else ()
        if mesh is not None:
            self.tp_degree = mesh.shape["tp"]
            self.pp_degree = mesh.shape["pp"]
            # The JAX engine's check, word for word.
            if cfg.num_kv_heads % self.tp_degree:
                raise ValueError(f"num_kv_heads={cfg.num_kv_heads} not "
                                 f"divisible by tp={self.tp_degree}")
            if cfg.num_layers % self.pp_degree:
                raise ValueError(f"{cfg.num_layers} layers not divisible "
                                 f"by pp={self.pp_degree}")
            home = mesh.devices.flat[0]
            if home.type != self.device.type:
                raise ValueError(f"the mesh's first position is on {home}, "
                                 f"the engine on {self.device}")
            self.device = home
        if params is None:
            params = init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                self.device)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        # Each replica's positions' params (``_walk``'s order: per stage its
        # tp positions, at sp shard 0), one replica per distinct placement
        # of the mesh's dp x fsdp coordinates (``_replicas``). The params
        # are stored as ``rules`` say (``tp_shards``), each position's
        # slices once per distinct device; a position computes with them
        # as they are where they are its compute layout's (the Megatron
        # table's, and the default table's without fsdp), else through a
        # ``PositionView`` that gathers and slices them at use. Layouts
        # that split the params keep only the positions' (``params`` is
        # None). A mesh that splits nothing, or only sp without a table
        # that stores a param over it, keeps the params as given.
        # ``_sp_reps``: per replica, its sp x tp x pp mesh and the params
        # its SP prefills read.
        self._reps = [[params]]
        self.params = params
        self._stored = None
        rules = rules or megatron_rules()
        split = mesh is not None and any(
            mesh.shape[a] > 1 for spec in _flat(tree_specs(
                param_logical_axes(None), mesh, rules), tuple).values()
            for d in range(len(spec)) for a in _dim_axes(spec, d))
        if set(axes) & {"tp", "pp", "dp", "fsdp"} or split:
            self._stored = tp_shards(params, mesh, rules)
            views = position_views(self._stored, mesh, rules)
            self._reps, self._sp_reps = [], []
            for sub, at in _replicas(mesh):
                self._reps.append([views[i] for i, c in zip(
                    at, sub.coords()) if c[3] == 0])
                self._sp_reps.append((sub, [views[i] for i in at]
                                      if self.sp_degree > 1 else None))
            if set(axes) & {"tp", "pp"} or split:
                self.params = None
        else:
            self._sp_reps = [(mesh, replicate_params(params, mesh)
                              if self.sp_degree > 1 else None)]
        self._sp_params = self._sp_reps[0][1]
        self._shards = self._reps[0]
        n = self._n_pos = len(self._shards)
        # Per position of every replica: (its layers, its kv heads, its
        # device), for splitting a full (L, ..., KV, D) tensor.
        L_loc = cfg.num_layers // self.pp_degree
        kv = cfg.num_kv_heads // self.tp_degree
        self._pos = [(slice(i // self.tp_degree * L_loc,
                            (i // self.tp_degree + 1) * L_loc),
                      slice(i % self.tp_degree * kv,
                            (i % self.tp_degree + 1) * kv), d)
                     for rep in self._reps
                     for i, d in enumerate(_devices(rep))]
        # One pool per position, holding its layers and kv heads; page ids,
        # tables, the free list and refcounts are the engine's, one
        # logical pool.
        pool_shape = (L_loc, self.n_pages, self.page, kv, cfg.head_dim_)
        self._pk = [torch.zeros(pool_shape, dtype=cfg.dtype, device=d)
                    for _, _, d in self._pos]
        self._pv = [torch.zeros(pool_shape, dtype=cfg.dtype, device=d)
                    for _, _, d in self._pos]
        self._gen = torch.Generator(self.device).manual_seed(seed + 1)
        self._free_slots = list(range(max_batch))
        self._free_pages = list(range(1, self.n_pages))
        # page -> holder count (requests + cache entries); a page leaves
        # _free_pages with count 1 and returns when the count hits 0.
        self._page_refs: Dict[int, int] = {}
        cache_tag = (b"sp%d" % self.sp_degree) if self.sp_degree > 1 else b""
        self._cache = _PrefixCache(self.page, cache_tag) \
            if prefix_cache else None
        # KV demotion tier: LRU-evicted prefix-cache pages demote to host
        # memory (overflowing to files) instead of being freed; hits
        # promote them back. Pool squeezes (apply_pool_pressure) park free
        # pages on the ballast list so admission sees a smaller pool.
        self._demote: Optional[_KVDemoteStore] = None
        self._ballast_pages: List[int] = []
        if self._cache is not None \
                and _config.setting("kv_cache_demotion_enabled"):
            spill_dir = _config.setting("object_spill_dir") or os.path.join(
                tempfile.gettempdir(), "ray_tpu_kv_demote_%d" % os.getpid())
            self._demote = _KVDemoteStore(
                _config.setting("kv_demoted_bytes_limit"), spill_dir)
        self._tables = np.zeros((max_batch, self.pages_per_slot), np.int64)
        self._slots: Dict[int, _Request] = {}
        self._waiting: List[_Request] = []
        # Live requests by id (waiting, prefilling, active): cancel_request
        # addresses requests through this.
        self._requests: Dict[int, _Request] = {}
        self._tick_events: List[Tuple[int, int, bool]] = []
        # req_id -> time.monotonic_ns() when its first token reached the
        # host, for the first tokens of the last step().
        self._tick_first_ns: Dict[int, int] = {}
        self._next_id = 0
        self._last = np.zeros(max_batch, np.int64)
        self._lengths = np.zeros(max_batch, np.int64)
        self._temps = np.zeros(max_batch, np.float32)
        # Chunked prefill: the chunk is a page multiple, so every chunk
        # boundary is a page boundary (the suffix path needs a page-aligned
        # resident prefix).
        if prefill_chunk:
            c = max(self.page, int(prefill_chunk))
            self.prefill_chunk: Optional[int] = c - (c % self.page)
        else:
            self.prefill_chunk = None
        self._prefilling: Dict[int, _Request] = {}
        # Streamed external KV (paged requests and the pool-free prefill).
        self._stream_attn = StreamAttn(cfg, self.device)
        self._kv_window = _KVWindow(kv_gather_window,
                                    kv_fetch or _default_kv_fetch,
                                    kv_prefetch)
        self._part_seq = 0

    def _head_slices(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A full (L, ..., KV, D) tensor as each position's slice of its
        layers and kv heads, on the position's device, for every
        replica."""
        return [t[lsl][..., hsl, :].to(d) for lsl, hsl, d in self._pos]

    def _join_heads(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The first replica's positions' (L_i, ..., KV_i, D) slices
        (``parts`` may hold every replica's) joined into (L, ..., KV, D) on
        the engine's device: heads within a stage, then the stages' layers
        (one position: its tensor as it is)."""
        parts = list(parts[:self._n_pos])
        if len(parts) == 1:
            return parts[0]
        tp = self.tp_degree
        return torch.cat([torch.cat([p.to(self.device)
                                     for p in parts[i:i + tp]], dim=-2)
                          for i in range(0, len(parts), tp)], dim=0)

    def _rep_pools(self, r: int):
        """Replica r's positions' pools (k, v)."""
        n = self._n_pos
        return self._pk[r * n:(r + 1) * n], self._pv[r * n:(r + 1) * n]

    def _append_tail(self, ks, vs, page_id: int, off: int) -> None:
        """Write one token's k, v at (page_id, off), in place: per position
        its (L_i, KV_i, D)."""
        for pk, pv, k, v in zip(self._pk, self._pv, ks, vs):
            pk[:, page_id, off] = k.to(pk.device)
            pv[:, page_id, off] = v.to(pv.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------ requests --
    def _pages_needed(self, req: _Request) -> int:
        if req.kv_paged:
            # External context: only the decode tail lives in the pool.
            return math.ceil((req.params.max_tokens + 1) / self.page)
        budget = len(req.prompt) + req.params.max_tokens + 1
        return math.ceil(min(budget, self.max_len) / self.page)

    def _queue(self, req: _Request) -> int:
        need = self._pages_needed(req)
        if need > self.n_pages - 1:
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.n_pages - 1}; raise kv_pages or lower max_tokens")
        self._next_id += 1
        self._requests[req.req_id] = req
        self._waiting.append(req)
        return req.req_id

    def add_request(self, prompt_tokens: Sequence[int],
                    params: Optional[SamplingParams] = None, *,
                    no_cache: bool = False) -> int:
        """Queue a prompt; no_cache=True keeps it out of the prefix cache
        (neither looked up nor inserted)."""
        if len(prompt_tokens) >= self.max_len:
            raise ValueError(
                f"prompt ({len(prompt_tokens)}) >= max_len ({self.max_len})")
        req = _Request(self._next_id, list(prompt_tokens),
                       params or SamplingParams())
        req.no_cache = no_cache
        return self._queue(req)

    def add_external_request(self, kv_blob: dict, first_token: int,
                             params: Optional[SamplingParams] = None, *,
                             prompt_tokens: Optional[Sequence[int]] = None
                             ) -> int:
        """Queue a request whose prefill ran elsewhere (the P/D decode
        half): the shipped blob ({"k", "v": (L, S, KV, D) tensors or numpy
        arrays, "len": S}) installs at admission, through the same queue,
        page accounting and, when the real prompt tokens are given, prefix
        cache as locally prefilled requests."""
        S = int(kv_blob["len"])
        if S >= self.max_len:
            raise ValueError(f"prompt ({S}) >= max_len ({self.max_len})")
        prompt = (list(prompt_tokens) if prompt_tokens is not None
                  else [0] * S)
        if len(prompt) != S:
            raise ValueError(
                f"prompt_tokens length ({len(prompt)}) != kv blob length "
                f"({S})")
        self._check_blob(kv_blob, S)
        req = _Request(self._next_id, prompt, params or SamplingParams())
        req.no_cache = prompt_tokens is None
        req.kv_blob = kv_blob
        req.first_token = int(first_token)
        return self._queue(req)

    def _check_blob(self, kv_blob: dict, S: int) -> None:
        """Refuse a blob that cannot install, before it is queued: its k
        and v are first read at admission, inside a step, where the fault
        would not be the caller's alone. (The reference checks only the
        length.)"""
        want = (self.cfg.num_layers, S, self.cfg.num_kv_heads,
                self.cfg.head_dim_)
        for name in ("k", "v"):
            if name not in kv_blob:
                raise ValueError(f"kv blob has no {name!r}")
            a = kv_blob[name]
            shape = tuple(getattr(a, "shape", np.shape(a)))
            if shape != want:
                raise ValueError(f"kv blob's {name!r} has shape {shape}, "
                                 f"want (L, S, KV, D) = {want}")
            dt = getattr(a, "dtype", None)
            if isinstance(a, torch.Tensor):
                floating = a.is_floating_point()
            else:
                dt = kv_blob.get("dtype") or (
                    np.dtype(dt) if dt is not None
                    else np.asarray(a).dtype).name
                floating = (dt == "bfloat16"
                            or np.issubdtype(np.dtype(dt), np.floating))
            if not floating:
                raise ValueError(f"kv blob's {name!r} has dtype {dt}, "
                                 f"want a floating type")

    def _norm_parts(self, parts, length: int, tag: str) -> List[dict]:
        """Validate and key a part list: contiguous spans covering
        [0, length), each entry {"span": (s, e), "handle": ...}."""
        pos = 0
        norm = []
        for i, part in enumerate(parts):
            s, e = part["span"]
            if s != pos or e <= s:
                raise ValueError(
                    f"KV parts must tile the context contiguously: part "
                    f"{i} spans [{s}, {e}) but {pos} tokens are covered")
            pos = e
            handle = part["handle"]
            key = part.get("key")
            if key is None:
                hx = getattr(handle, "hex", None)
                key = hx() if callable(hx) else f"{tag}:{i}"
            norm.append({"span": (int(s), int(e)), "handle": handle,
                         "key": key})
        if pos != length:
            raise ValueError(
                f"KV parts cover {pos} tokens, context is {length}")
        return norm

    def add_paged_request(self, parts, length: int, first_token: int,
                          params: Optional[SamplingParams] = None, *,
                          prompt_tokens: Optional[Sequence[int]] = None
                          ) -> int:
        """Queue a request whose prompt KV lives in external PARTS,
        [{"span": (s, e), "handle": h}] tiling [0, length), each handle
        resolving through ``kv_fetch`` to {"k", "v": (L, span, KV, D),
        "len": valid tokens}. Only the decode tail takes pool pages, so the
        context may be longer than max_len or the pool. Decode streams
        attention over the parts through the gather window; a part that
        cannot be gathered fails this request typed (KVGatherError, finish
        reason "error"), never with a wrong token."""
        params = params or SamplingParams()
        S = int(length)
        req = _Request(self._next_id,
                       list(prompt_tokens) if prompt_tokens else [], params)
        req.kv_paged = True
        req.no_cache = True
        req.ext_len = S
        req.first_token = int(first_token)
        req.ext_parts = self._norm_parts(parts, S, f"req{req.req_id}")
        need = self._pages_needed(req)
        if need > min(self.pages_per_slot, self.n_pages - 1):
            raise ValueError(
                f"decode tail needs {need} KV pages but a slot holds "
                f"{self.pages_per_slot} and the pool {self.n_pages - 1} "
                f"— lower max_tokens or raise kv_pages/max_len")
        return self._queue(req)

    def cancel_request(self, req_id: int) -> bool:
        """Retire a request mid-flight (waiting, prefilling or decoding):
        its pages return to the pool at once. True if it was live."""
        req = self._requests.get(req_id)
        if req is None:
            return False
        req.finished = True
        req.finish_reason = req.finish_reason or "cancelled"
        if req.slot >= 0 and self._slots.get(req.slot) is req:
            self._retire(req.slot)
        elif req.slot >= 0 and self._prefilling.get(req.slot) is req:
            del self._prefilling[req.slot]
            self._free_slot(req)
        else:
            self._waiting.remove(req)
            del self._requests[req_id]
        return True

    def take_tick_events(self) -> List[Tuple[int, int, bool]]:
        """(req_id, token, finished) tuples emitted by the last step():
        admission first tokens and decode tokens, in emission order."""
        ev = self._tick_events
        self._tick_events = []
        return ev

    def first_token_ns(self, req_id: int) -> Optional[int]:
        """``time.monotonic_ns()`` when the request's first token reached
        the host (its sampling wave's sync, or the emit of a shipped first
        token), if the last step() emitted it."""
        return self._tick_first_ns.get(req_id)

    def has_unfinished(self) -> bool:
        return bool(self._waiting or self._slots or self._prefilling)

    def kv_pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def kv_pages_total(self) -> int:
        return self.n_pages - 1

    def kv_page_occupancy(self) -> float:
        return 1.0 - len(self._free_pages) / max(1, self.n_pages - 1)

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    @property
    def active_requests(self) -> int:
        return len(self._slots) + len(self._prefilling)

    def kv_gather_stats(self) -> Dict[str, Any]:
        """The gather window's counters (fetches, refetches, bytes, the
        blocking wait_s, resident parts, capacity); ``refetches`` > 0 means
        the window is smaller than a live request's part count."""
        return self._kv_window.stats()

    def prefix_cache_stats(self) -> Dict[str, Any]:
        """The JAX engine's keys: cache counters, page accounting and, with
        the demotion tier, its counters."""
        if self._cache is None:
            return {"enabled": False}
        out = {"enabled": True, "entries": len(self._cache._entries),
               "hits": self._cache.hits, "misses": self._cache.misses,
               "hit_pages": self._cache.hit_pages,
               "evictions": self._cache.evictions,
               "allocated_pages": len(self._page_refs),
               "free_pages": len(self._free_pages),
               "ballast_pages": len(self._ballast_pages)}
        if self._demote is not None:
            out.update(self._demote.stats())
        return out

    # ---------------------------------------------------------------- step --
    def _bucket(self, n: int) -> int:
        # Floor at sp_degree (both pow-2): a short prompt's bucket must
        # still split over every sequence-parallel shard.
        b = max(8, self.sp_degree)
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _run_prefill(self, prompt: Sequence[int]):
        """Bucketed prefill; returns (last_logits, ks, vs), ks and vs one
        (L_i, Sb, KV_i, D) per position of every replica, each replica
        having computed its own (the logits are the first's). With
        sp_degree > 1 it runs sequence-parallel over the mesh."""
        S = len(prompt)
        toks = np.zeros((1, self._bucket(S)), np.int64)
        toks[0, :S] = prompt
        if self.sp_degree > 1:
            return self._each(lambda r, rep, pk, pv, to: sp_prefill_fn(
                self._sp_reps[r][1], to(toks), S, self.cfg,
                self._sp_reps[r][0], self.sp_strategy))
        return self._each(lambda r, rep, pk, pv, to: _prefill_fn(
            rep, to(toks), S, self.cfg))

    def _each(self, run):
        """``run(r, rep, pool_k, pool_v, to)`` on every replica r, ``to``
        putting a numpy array on its first device; (the first's logits,
        every replica's ks and vs in position order; a replica's one
        (L, Sb, KV, D) pair counts as its one position's)."""
        logits, ks, vs = None, [], []
        for r, rep in enumerate(self._reps):
            dev = _devices(rep)[0]
            out = run(r, rep, *self._rep_pools(r),
                      lambda a, dev=dev: torch.from_numpy(a).to(dev))
            logits = out[0] if logits is None else logits
            one = isinstance(out[1], torch.Tensor)
            ks += [out[1]] if one else out[1]
            vs += [out[2]] if one else out[2]
        return logits, ks, vs

    def _run_suffix(self, prompt: Sequence[int], prefix_len: int, pages_row,
                    upto: Optional[int] = None):
        """Bucketed suffix prefill of prompt[prefix_len:upto] against the
        resident prefix pages of ``pages_row``; ``upto`` bounds the suffix
        to one chunk of a chunked prefill. With sp_degree > 1 the suffix
        runs sequence-parallel (a ring seeded by the resident prefix)."""
        suf = prompt[prefix_len:upto]
        S = len(suf)
        toks = np.zeros((1, self._bucket(S)), np.int64)
        toks[0, :S] = suf
        row = np.asarray(pages_row, np.int64)
        if self.sp_degree > 1:
            return self._each(lambda r, rep, pk, pv, to: sp_suffix_prefill_fn(
                self._sp_reps[r][1], pk, pv, to(row), to(toks), prefix_len,
                S, self.cfg, self.page, self._sp_reps[r][0]))
        return self._each(lambda r, rep, pk, pv, to: _suffix_prefill_fn(
            rep, pk, pv, to(row), to(toks), prefix_len, S, self.cfg,
            self.page))

    # ------------------------------------------------------ page refcounts --
    def _alloc_page(self) -> int:
        p = self._free_pages.pop(0)
        self._page_refs[p] = 1
        return p

    def _incref(self, p: int) -> None:
        self._page_refs[p] += 1

    def _decref(self, p: int) -> None:
        n = self._page_refs[p] - 1
        if n > 0:
            self._page_refs[p] = n
        else:
            del self._page_refs[p]
            self._free_pages.append(p)

    # ---------------------------------------------------------- KV demotion --
    def _demote_entry(self, key: bytes, pages: Sequence[int]) -> None:
        """Prefix-cache eviction hook: copy the evicted pages device -> host
        into the demote store BEFORE the refs drop (after decref the pages
        rejoin the free list and any admission may overwrite them)."""
        pages = list(pages)
        n = self._n_pos
        self._demote.put(key,
                         self._join_heads([pk[:, pages]
                                           for pk in self._pk[:n]]).cpu(),
                         self._join_heads([pv[:, pages]
                                           for pv in self._pv[:n]]).cpu(),
                         len(pages))

    def _try_promote(self, req: _Request, c: int, shared: List[int],
                     total: int) -> Tuple[int, List[int]]:
        """Promote the longest demoted prefix usable by this prompt back
        into the pool, superseding any shorter resident hit. Only fires
        when the pool can hold the promoted pages AND the request's
        remainder (``total`` pages all told): promotion must never starve
        the admission it serves. Returns the possibly updated
        (prefix_tokens, shared_pages)."""
        usable = (len(req.prompt) - 1) // self.page
        have = len(shared)
        if usable <= have:
            return c, shared
        keys = self._cache._keys(req.prompt, usable)
        for k in range(usable, have, -1):
            key = keys[k - 1]
            if not self._demote.contains(key):
                continue
            if len(self._free_pages) < total:
                break               # no headroom: admit on what we have
            part = self._demote.get(key)
            if part is None or int(part["len"]) != k:
                continue
            L, KV, D = (part["k"].shape[0], part["k"].shape[-2],
                        part["k"].shape[-1])
            kk = part["k"].reshape(L, k * self.page, KV, D).to(
                self.device, self.cfg.dtype)
            vv = part["v"].reshape(L, k * self.page, KV, D).to(
                self.device, self.cfg.dtype)
            new_pages = [self._alloc_page() for _ in range(k)]
            self._install_pages(new_pages, self._head_slices(kk),
                                self._head_slices(vv))
            # Re-register under the same rolling-hash key: the alloc ref is
            # the cache's membership hold; the request holds one more (the
            # refcount shape of a lookup hit in _reserve).
            self._cache._entries[key] = [int(p) for p in new_pages]
            for p in new_pages:
                self._incref(p)
            for p in shared:
                self._decref(p)     # superseded shorter-prefix hold
            # The lookup scored this admission a miss (or a shorter hit)
            # before the demoted tier resolved it: reclass it, since its
            # prefill IS skipped, as on a pool hit.
            if have == 0:
                self._cache.misses -= 1
                self._cache.hits += 1
            self._cache.hit_pages += k - have
            return k * self.page, new_pages
        return c, shared

    def apply_pool_pressure(self, frac: float) -> None:
        """Shrink (frac < 1) or restore (frac = 1) the usable page pool by
        parking free pages on a ballast list. Admission then sees a smaller
        free list, evicts the prefix cache sooner, and the demotion tier
        absorbs the evicted pages. Allocated pages are never touched: the
        squeeze throttles new admissions only."""
        frac = min(1.0, max(0.0, float(frac)))
        parked_target = (self.n_pages - 1) - max(
            0, int((self.n_pages - 1) * frac))
        while len(self._ballast_pages) < parked_target and self._free_pages:
            self._ballast_pages.append(self._free_pages.pop())
        while len(self._ballast_pages) > parked_target:
            self._free_pages.append(self._ballast_pages.pop())

    # ----------------------------------------------------------- admission --
    def _reserve(self, req: _Request) -> bool:
        """Reserve slot + pages for a request; False = wait for capacity.
        With the prefix cache on, shared prefix pages are reused
        (ref-counted, never re-allocated) and LRU entries are evicted under
        pool pressure before giving up."""
        if not self._free_slots:
            return False
        c, shared = 0, []
        if self._cache is not None and not req.no_cache:
            c, shared = self._cache.lookup(req.prompt)
        total = self._pages_needed(req)
        need = total - len(shared)
        # Hold the shared pages before any eviction can touch them.
        for p in shared:
            self._incref(p)
        demote = self._demote_entry if self._demote is not None else None
        while len(self._free_pages) < need and self._cache is not None \
                and self._cache.evict_lru(self._decref, demote):
            pass
        if len(self._free_pages) < need:
            for p in shared:
                self._decref(p)
            return False
        if self._demote is not None and not req.no_cache \
                and len(self._demote):
            c, shared = self._try_promote(req, c, shared, total)
            need = total - len(shared)
        req.slot = self._free_slots.pop(0)
        req.pages = [self._alloc_page() for _ in range(need)]
        req.shared_pages = shared
        req.prefix_len = c
        row = np.zeros(self.pages_per_slot, np.int64)
        row[:len(shared)] = shared
        row[len(shared):total] = req.pages
        self._tables[req.slot] = row
        return True

    def _install(self, slot: int, ks, vs):
        self._install_pages(self._tables[slot], ks, vs)

    def _install_pages(self, page_ids: Sequence[int], ks, vs):
        """Install KV into specific pool pages: ks, vs per tp position,
        (L, S, KV_i, D) starting page-aligned on page_ids[0]; rows past
        them go to the scratch page, as in _install."""
        pages = np.zeros(self.pages_per_slot, np.int64)
        pages[:len(page_ids)] = page_ids
        pages = self._to_device(pages)
        for pk, pv, k, v in zip(self._pk, self._pv, ks, vs):
            _install_fn(pk, pv, k, v, pages.to(pk.device), self.page)

    def _install_new_pages(self, req: _Request, ks, vs):
        """Install suffix KV into the request's newly reserved pages (the
        suffix starts page-aligned at prefix_len; the shared prefix pages
        are resident and never written)."""
        self._install_pages(req.pages, ks, vs)

    def _blob_tensor(self, a, dtype: Optional[str] = None) -> torch.Tensor:
        """A blob's k or v on the engine's device, in its dtype: a tensor
        as it is, a numpy array bit-exactly (ml_dtypes bf16, or the int16
        bits of bf16 with ``dtype`` "bfloat16", as host_staged parts
        carry them)."""
        if not isinstance(a, torch.Tensor):
            a = device_plane.from_host_array(a, dtype, self.device)
        return a.to(self.device, self.cfg.dtype)

    def _on_host(self, a) -> bool:
        """Whether a blob's k or v lies in host memory apart from the
        engine's devices: a numpy array, or a CPU tensor on a CUDA
        engine."""
        if isinstance(a, torch.Tensor):
            return a.device.type == "cpu" and self.device.type != "cpu"
        return True

    def _install_external(self, req: _Request):
        """Install a shipped KV blob, each tp position its kv heads; on a
        prefix-cache hit only the suffix pages are written (the shared span
        is already resident)."""
        name = req.kv_blob.get("dtype")
        ks = self._head_slices(self._blob_tensor(req.kv_blob["k"], name))
        vs = self._head_slices(self._blob_tensor(req.kv_blob["v"], name))
        if req.prefix_len:
            self._install_new_pages(req, [k[:, req.prefix_len:] for k in ks],
                                    [v[:, req.prefix_len:] for v in vs])
        else:
            self._install(req.slot, ks, vs)

    def _admit(self):
        rec = flight_recorder.recorder()
        admitted = []
        while self._waiting and self._reserve(self._waiting[0]):
            req = self._waiting.pop(0)
            if req.kv_paged:
                # External paged context: nothing to prefill; the reserved
                # pages are the decode tail.
                self._lengths[req.slot] = 0
                self._temps[req.slot] = req.params.temperature
                self._slots[req.slot] = req
                self._last[req.slot] = req.first_token
                self._emit(req, req.first_token)
                continue
            S = len(req.prompt)
            if self.prefill_chunk and req.kv_blob is None \
                    and S - req.prefix_len > self.prefill_chunk:
                # Chunked prefill: advances one chunk per step().
                req.prefilled = req.prefix_len
                self._prefilling[req.slot] = req
                continue
            active_before = len(self._slots)
            t0 = rec.begin(self.device)
            if req.kv_blob is not None:
                self._install_external(req)
            elif req.prefix_len:
                logits, ks, vs = self._run_suffix(
                    req.prompt, req.prefix_len, self._tables[req.slot])
                self._install_new_pages(req, ks, vs)
            else:
                logits, ks, vs = self._run_prefill(req.prompt)
                self._install(req.slot, ks, vs)
            rec.end("request", "prefill", t0,
                    id=req.req_id.to_bytes(8, "little"), tokens=S,
                    cached_tokens=req.prefix_len, active=active_before)
            if self._cache is not None and not req.no_cache:
                self._cache.insert(req.prompt, self._tables[req.slot],
                                   self._incref)
            if self.sp_degree > 1:
                # Which pages each SP shard installed: the stripe
                # accounting a cross-host handoff consumes. Boundaries
                # follow the padded bucket; a prefix-cache hit stripes only
                # the suffix's new pages (no shard computed the prefix).
                # As in JAX, an installed P/D blob is striped too.
                if req.prefix_len:
                    suf = S - req.prefix_len
                    req.sp_stripes = sp_stripe_pages(
                        req.pages, suf, self.sp_degree, self.page,
                        padded=self._bucket(suf))
                else:
                    req.sp_stripes = sp_stripe_pages(
                        self._tables[req.slot], S, self.sp_degree,
                        self.page, padded=self._bucket(S))
            self._lengths[req.slot] = S
            self._temps[req.slot] = req.params.temperature
            self._slots[req.slot] = req
            if req.kv_blob is not None:
                req.kv_blob = None          # release the shipped copy
                self._last[req.slot] = req.first_token
                self._emit(req, req.first_token)
            else:
                admitted.append((req, logits))
        if admitted:
            firsts = self._sample_batch([lg for _, lg in admitted],
                                        [r.params for r, _ in admitted])
            for (req, _), first in zip(admitted, firsts):
                self._last[req.slot] = first
                self._emit(req, first)

    def _advance_prefilling(self) -> None:
        """Advance chunked prefills by AT MOST one chunk per step, in all:
        the step's latency is bounded by one chunk's compute, so a long
        prompt cannot starve the decoding requests. The first chunk is a
        full prefill (the flash kernel); later ones are suffix prefills
        against the chunks already installed. The final chunk samples the
        first token and activates the slot for decode."""
        if not self._prefilling:
            return
        slot, req = min(self._prefilling.items())
        S = len(req.prompt)
        nxt = min(req.prefilled + self.prefill_chunk, S)
        row = self._tables[slot]
        rec = flight_recorder.recorder()
        t0 = rec.begin(self.device)
        if req.prefilled == 0:
            logits, ks, vs = self._run_prefill(req.prompt[:nxt])
            self._install_pages(row[:math.ceil(nxt / self.page)], ks, vs)
        else:
            logits, ks, vs = self._run_suffix(req.prompt, req.prefilled, row,
                                              upto=nxt)
            self._install_pages(row[req.prefilled // self.page:
                                    math.ceil(nxt / self.page)], ks, vs)
        rec.end("request", "prefill", t0,
                id=req.req_id.to_bytes(8, "little"), tokens=nxt,
                cached_tokens=req.prefilled, chunked=True,
                active=len(self._slots))
        req.prefilled = nxt
        if nxt >= S:
            del self._prefilling[slot]
            if self._cache is not None and not req.no_cache:
                self._cache.insert(req.prompt, row, self._incref)
            # No sp_stripes for chunked prefills (as in JAX): each chunk
            # was its own SP pass with its own bucket.
            self._lengths[slot] = S
            self._temps[slot] = req.params.temperature
            self._slots[slot] = req
            first = self._sample_host(logits, req.params)
            self._last[slot] = first
            self._emit(req, first)

    def _sample_batch(self, logits_list, params_list) -> List[int]:
        """Sample first tokens for a whole admission wave with one
        device-to-host transfer, inside a ``sample_sync`` span."""
        rec = flight_recorder.recorder()
        t0 = rec.begin()
        lg = torch.stack(logits_list)                     # (N, V) f32
        toks = lg.argmax(-1)
        temps = torch.tensor([p.temperature for p in params_list],
                             dtype=torch.float32, device=lg.device)
        if any(p.temperature > 0 for p in params_list):
            probs = torch.softmax(lg / temps.clamp_min(1e-6)[:, None], -1)
            sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            toks = torch.where(temps > 0, sampled, toks)
        out = toks.tolist()                               # the one sync
        rec.end("request", "sample_sync", t0, batch=len(params_list))
        return out

    def _sample_host(self, logits, params: SamplingParams) -> int:
        return self._sample_batch([logits], [params])[0]

    def sample_first(self, logits, params: Optional[SamplingParams] = None
                     ) -> int:
        """Sample a first token from prefill logits (V,)."""
        return self._sample_host(logits, params or SamplingParams())

    def _emit(self, req: _Request, token: int):
        req.out.append(token)
        if len(req.out) == 1:
            self._tick_first_ns[req.req_id] = time.monotonic_ns()
        p = req.params
        if p.eos_id is not None and token == p.eos_id:
            req.finished = True
            req.finish_reason = req.finish_reason or "stop"
        elif req.kv_paged:
            # Paged context: bounded by max_tokens and the reserved tail
            # pages, never by max_len (the context lives in the parts).
            if len(req.out) >= p.max_tokens \
                    or req.ext_written + 1 >= len(req.pages) * self.page:
                req.finished = True
                req.finish_reason = req.finish_reason or "length"
        elif len(req.out) >= p.max_tokens \
                or len(req.prompt) + len(req.out) >= self.max_len - 1:
            req.finished = True
            req.finish_reason = req.finish_reason or "length"
        self._tick_events.append((req.req_id, token, req.finished))

    @torch.no_grad()
    def step(self) -> List[_Request]:
        """Admit waiting requests, advance chunked prefills by one chunk,
        run ONE decode step for all active slots (paged-context slots
        stream their attention over external parts), retire finished
        requests. Returns the requests finished in this step. The whole
        is one ``engine:step`` span."""
        rec = flight_recorder.recorder()
        t0 = rec.begin()
        done = self._step()
        rec.end("engine", "engine:step", t0)
        return done

    def _step(self) -> List[_Request]:
        self._tick_events = []
        self._tick_first_ns = {}
        self._admit()
        self._advance_prefilling()
        done: List[_Request] = []
        # Retire requests that finished at admission (eos on first token).
        for slot, req in list(self._slots.items()):
            if req.finished:
                done.append(self._retire(slot))
        if not self._slots:
            return done
        # Paged-context slots: one streamed-attention token each (their KV
        # is in external parts, which the batched decode cannot read).
        for slot, req in list(self._slots.items()):
            if not req.kv_paged or req.finished:
                continue
            try:
                tok = self._ext_decode_step(req)
            except KVGatherError as e:
                req.error = e
                req.finished = True
                req.finish_reason = "error"
                done.append(self._retire(slot))
                continue
            self._last[slot] = tok
            self._emit(req, tok)
            if req.finished:
                done.append(self._retire(slot))
        batch = [s for s, r in self._slots.items() if not r.kv_paged]
        if not batch:
            return done
        active = np.zeros(self.max_batch, bool)
        active[batch] = True
        temps = self._to_device(self._temps) if (self._temps > 0).any() \
            else None
        rec = flight_recorder.recorder()
        t0 = rec.begin()
        nxt = None
        for r, rep in enumerate(self._reps):
            # Each replica decodes on its own weights and pool; the first
            # samples, and the others' greedy tokens must equal its.
            dev = _devices(rep)[0]
            out = _decode_fn(
                rep, *self._rep_pools(r),
                *(torch.from_numpy(a).to(dev) for a in (
                    self._tables, self._last, self._lengths, active)),
                temps if r == 0 else None, self._gen, self.cfg,
                self.page).cpu().numpy()
            if nxt is None:
                nxt = out
            elif temps is None and not np.array_equal(out, nxt):
                raise RuntimeError(f"replica {r} decoded {out.tolist()}, "
                                   f"the first {nxt.tolist()}")
        rec.end("request", "decode", t0, batch=len(batch))
        for slot in batch:
            req = self._slots[slot]
            self._lengths[slot] += 1          # the token we just attended
            tok = int(nxt[slot])
            self._last[slot] = tok
            self._emit(req, tok)
            if req.finished:
                done.append(self._retire(slot))
        return done

    def _retire(self, slot: int) -> _Request:
        req = self._slots.pop(slot)
        self._free_slot(req)
        return req

    def _free_slot(self, req: _Request) -> None:
        """Return a reserved slot's pages + slot to the pool (retirement
        and cancellation mid-prefill)."""
        slot = req.slot
        self._free_slots.append(slot)
        for p in req.pages + req.shared_pages:
            self._decref(p)
        req.pages = []
        req.shared_pages = []
        if req.ext_parts:
            self._kv_window.drop([p["key"] for p in req.ext_parts])
            # The handles go with the slot: a part's host buffer is freed
            # when its last handle is dropped.
            req.ext_parts = []
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._temps[slot] = 0.0
        self._requests.pop(req.req_id, None)

    # ------------------------------------------------ streamed external KV --
    def _part_layer(self, part: dict, li: int, idx: Sequence[int]):
        """Layer li's (ks, vs, valid_len) of an external part, through the
        gather window: ks and vs hold the kv heads of each position of
        ``idx`` (li's stage's).

        The whole part goes to each distinct device of the engine once per
        window residency and is sliced by layer and heads there, cached in
        the window's entry: a part that arrives on the host (a numpy array,
        f32 as in the JAX tests, or a CPU tensor, bf16 included) is copied
        once per device; a part already on a device is used as it is.
        Nothing is copied per layer or per token, and each device holds at
        most the window's parts."""
        data = self._kv_window.get(part["key"], part["handle"])
        on = data.get("_on")
        if on is None:
            name = data.get("dtype")
            kd = self._blob_tensor(data["k"], name)
            vd = self._blob_tensor(data["v"], name)
            if self._on_host(data["k"]):
                # A host-resident part: this upload is a transfer seam
                # (a part already on the device skips it).
                device_plane.record_h2d(kd.nbytes + vd.nbytes)
            on = data["_on"] = {d: (kd.to(d), vd.to(d)) for d in
                                dict.fromkeys(_devices(self._shards))}
        at = [self._pos[i] for i in idx]
        ks = [on[d][0][li, :, hsl] for _, hsl, d in at]
        vs = [on[d][1][li, :, hsl] for _, hsl, d in at]
        return ks, vs, int(data.get("len", data["k"].shape[1]))

    def _stream_layers(self, tokens, pos0: int, blocks):
        """The transformer over ``tokens`` (1, Sq) at absolute positions
        pos0 + i with streamed attention, on the first replica: in layer li
        each position of li's stage (``idx``, its layer lj of its own)
        merges, by online softmax, the blocks that ``blocks(li, lj, idx,
        ks, vs)`` yields as (ks, vs, valid, k_pos0), ks and vs one (Sk,
        KV_i, D) per position (``ks``, ``vs`` are the layer's own keys and
        values, for the self block). A block is read once for every
        position, so a part goes through the gather window once per layer.
        Returns (the final norm and lm_head's f32 logits at index ``at``
        of the last layer's output, on the engine's device, as a function
        of ``at``; ks, vs: per position (L_i, Sq, KV_i, D))."""
        sa = self._stream_attn
        shards = self._shards
        devices = _devices(shards)
        xs = _embed(shards, torch.as_tensor(np.asarray(tokens),
                                            device=devices[0]).long(),
                    self.cfg)
        ks_out = [[] for _ in devices]
        vs_out = [[] for _ in devices]
        for li, lj, idx in _walk(shards, self.cfg):
            devs = [devices[i] for i in idx]
            xs = _onto(xs, devs)
            lps = [layer_params(shards[i], lj) for i in idx]

            def attend(h):
                qkv = [sa.rope_qkv(lp, h[d], pos0)
                       for lp, d in zip(lps, devs)]
                states = [sa.init(q.shape[0], k.shape[1], k.device)
                          for q, k, _ in qkv]
                for kb, vb, valid, k0 in blocks(li, lj, idx,
                                                [k for _, k, _ in qkv],
                                                [v for _, _, v in qkv]):
                    states = [_stream_block_fn(q, k, v, valid, pos0, k0, *st,
                                               scale=sa.scale)
                              for (q, _, _), k, v, st in zip(qkv, kb, vb,
                                                             states)]
                for i, (_, k, v) in zip(idx, qkv):
                    ks_out[i].append(k)
                    vs_out[i].append(v)
                return [sa.heads(l, acc) for _, l, acc in states]
            xs = tp_layer(self.cfg, xs, lps, devs, attend)
        heads = [shards[i] for i in idx]
        if heads[0]["lm_head"].shape[1] == self.cfg.vocab_size:
            heads = heads[:1]
        return (lambda at: torch.cat([
                    sa.logits(p, xs[d], at).to(self.device)
                    for p, d in zip(heads, _devices(heads))]),
                [torch.stack(k) for k in ks_out],
                [torch.stack(v) for v in vs_out])

    def _window_prefetch(self, parts) -> None:
        self._kv_window.prefetch([(p["key"], p["handle"]) for p in parts])

    def _ext_decode_step(self, req: _Request) -> int:
        """One decode token of a paged-context slot: online-softmax
        attention over the external parts (layers outer, parts inner), the
        pool-resident decode tail and the incoming token itself; the new
        token's KV is appended to the tail pages. Raises KVGatherError if a
        part cannot be gathered."""
        S, t = req.ext_len, req.ext_written
        pos = S + t                       # absolute write/query position
        rec = flight_recorder.recorder()
        win = self._kv_window
        b0, w0, f0 = win.bytes_fetched, win.wait_s, win.fetches
        t0 = rec.begin()
        self._window_prefetch(req.ext_parts)
        pages = self._to_device(np.asarray(req.pages, np.int64))
        tail = [pages.to(d) for d in _devices(self._shards)]

        def blocks(li, lj, idx, ks, vs):
            """Per part, the tail, then the incoming token itself."""
            for part in req.ext_parts:
                pk, pv, valid = self._part_layer(part, li, idx)
                yield pk, pv, valid, part["span"][0]
            if t > 0:
                yield ([self._pk[i][lj][tail[i]].flatten(0, 1) for i in idx],
                       [self._pv[i][lj][tail[i]].flatten(0, 1) for i in idx],
                       t, S)
            yield ks, vs, 1, pos
        logits, ks_new, vs_new = self._stream_layers(
            [[self._last[req.slot]]], pos, blocks)
        logits = logits(0)
        # The span covers the prefetch kick to the last layer's dispatch;
        # gather_wait_us is its blocking part.
        rec.end("request", "sp:gather", t0,
                id=req.req_id.to_bytes(8, "little"),
                parts=len(req.ext_parts),
                gather_bytes=win.bytes_fetched - b0,
                gather_wait_us=int((win.wait_s - w0) * 1e6),
                fetches=win.fetches - f0)
        # The first replica's tail KV goes into every replica's pool.
        n = self._n_pos
        self._append_tail([ks_new[i % n][:, 0] for i in range(len(self._pk))],
                          [vs_new[i % n][:, 0] for i in range(len(self._pv))],
                          req.pages[t // self.page], t % self.page)
        req.ext_written = t + 1
        return self._sample_batch([logits], [req.params])[0]

    @torch.no_grad()
    def prefill_paged_chunk(self, chunk_tokens: Sequence[int], pos0: int,
                            ctx_parts, *, span: int, is_last: bool):
        """One streamed prefill chunk that never touches the page pool: the
        chunk's queries attend to the context parts before it (through the
        gather window) and causally to the chunk itself, and the chunk's KV
        comes back as a new part on this engine's device, padded to
        ``span`` with its real length in "len". Returns (part, the last
        token's f32 logits if ``is_last`` else None)."""
        Sc = len(chunk_tokens)
        if not (0 < Sc <= span):
            raise ValueError(f"chunk of {Sc} tokens vs span {span}")
        ctx = self._norm_parts(
            ctx_parts, pos0, f"pf{self._part_seq}") if ctx_parts else []
        self._part_seq += 1
        rec = flight_recorder.recorder()
        win = self._kv_window
        b0, w0, f0 = win.bytes_fetched, win.wait_s, win.fetches
        t0 = rec.begin()
        self._window_prefetch(ctx)
        toks = np.zeros((1, span), np.int64)
        toks[0, :Sc] = chunk_tokens

        def blocks(li, lj, idx, ks, vs):
            """Per context part, then the chunk itself, causally."""
            for part in ctx:
                pk, pv, valid = self._part_layer(part, li, idx)
                yield pk, pv, valid, part["span"][0]
            yield ks, vs, Sc, pos0
        logits, ks_out, vs_out = self._stream_layers(toks, pos0, blocks)
        rec.end("request", "sp:gather", t0, parts=len(ctx),
                gather_bytes=win.bytes_fetched - b0,
                gather_wait_us=int((win.wait_s - w0) * 1e6),
                fetches=win.fetches - f0, prefill_chunk=True)
        part = {"k": self._join_heads(ks_out), "v": self._join_heads(vs_out),
                "len": Sc}
        logits = logits(Sc - 1) if is_last else None
        return part, logits

    @torch.no_grad()
    def prefill_paged(self, prompt_tokens: Sequence[int],
                      params: Optional[SamplingParams] = None, *,
                      span: int = 64, publish=None, pipeline: bool = True,
                      host_staged: bool = False) -> dict:
        """Streamed chunked prefill of a context of any length with a
        bounded device working set: chunk c attends to the c parts before
        it, then becomes part c. ``publish(part) -> handle`` puts each part
        wherever it should live; without it parts travel by value. Returns
        the handoff {"parts": [{"span", "handle"}], "len", "first"} that
        add_paged_request and decode_paged take.

        pipeline=True (the default) runs each publish on one background
        thread, overlapping it with the next chunk's compute; the handles
        resolve when the handoff is assembled, and a failed publish raises
        there. The next chunk reads a part through this engine's window,
        never through its handle, so a window smaller than the part count
        makes a pipelined prefill fetch an unresolved handle and fail, as
        in the reference: give it at least as many slots as parts.

        Parts cross to the publish thread as device tensors. On a CUDA
        device each carries an event recorded on the stream that computed
        it, and the publish thread waits on that event before it calls
        ``publish``, so the part is complete whatever stream the engine runs
        on. A publish that copies a part to the host must use a synchronous
        copy (``.cpu()``, or ``copy_`` without ``non_blocking``), so that a
        handle it returns is never read before its bytes exist.

        host_staged=True forces the reference's host-staged downgrade, for
        the device-vs-staged A/B: every part is copied to host numpy
        (``device_plane.host_array``: bf16 as its int16 bits, the part
        then carrying "dtype": "bfloat16") before it is kept or published,
        each copy counted by ``record_d2h``; the next chunk uploads it
        again (``record_h2d``, in ``_part_layer``)."""
        params = params or SamplingParams()
        prompt = list(prompt_tokens)
        S = len(prompt)
        span = max(8, int(span))
        parts_meta: List[dict] = []
        n_chunks = math.ceil(S / span)
        logits = None
        pub_pool = None
        try:
            for c in range(n_chunks):
                s0 = c * span
                chunk = prompt[s0:s0 + span]
                part, logits = self.prefill_paged_chunk(
                    chunk, s0, parts_meta, span=span,
                    is_last=(c == n_chunks - 1))
                if host_staged:
                    part = _host_part(part)
                key = f"pp{id(self) & 0xffff}:{self._part_seq}"
                self._part_seq += 1
                # Keep our own fresh part hot for chunk c + 1.
                self._kv_window.put(key, part)
                if publish is None:
                    handle = part
                elif pipeline:
                    if pub_pool is None:
                        pub_pool = concurrent.futures.ThreadPoolExecutor(
                            1, thread_name_prefix="kvpublish")
                    made = None
                    if self.device.type == "cuda":
                        made = torch.cuda.Event()
                        made.record(torch.cuda.current_stream(self.device))
                    handle = pub_pool.submit(_publish_when_made, publish,
                                             part, made)
                else:
                    handle = publish(part)
                parts_meta.append({"span": (s0, s0 + len(chunk)),
                                   "handle": handle, "key": key})
            first = self._sample_batch([logits], [params])[0]
            for m in parts_meta:
                if isinstance(m["handle"], concurrent.futures.Future):
                    m["handle"] = m["handle"].result()
        finally:
            if pub_pool is not None:
                pub_pool.shutdown(wait=True)
        return {"parts": [{"span": m["span"], "handle": m["handle"]}
                          for m in parts_meta],
                "len": S, "first": int(first)}

    def decode_paged(self, handoff: dict,
                     params: Optional[SamplingParams] = None) -> List[int]:
        """Decode a paged handoff to completion (a closed loop over
        add_paged_request); raises the request's KVGatherError if a part
        could not be gathered mid-decode."""
        rid = self.add_paged_request(handoff["parts"], handoff["len"],
                                     handoff["first"], params,
                                     prompt_tokens=handoff.get("prompt"))
        while self.has_unfinished():
            for done in self.step():
                if done.req_id == rid:
                    if done.error is not None:
                        raise done.error
                    return done.out
        raise RuntimeError(
            f"paged request {rid} was dropped without finishing")

    # ------------------------------------------------------------ generate --
    def generate(self, prompts: Sequence[Sequence[int]],
                 params: Optional[SamplingParams] = None
                 ) -> List[List[int]]:
        """Batch API: returns generated token lists, in prompt order."""
        ids = [self.add_request(p, params) for p in prompts]
        results: Dict[int, List[Any]] = {}
        while self.has_unfinished():
            for req in self.step():
                results[req.req_id] = req.out
        return [results[i] for i in ids]

    # ------------------------------------ prefill/decode disaggregation --
    @torch.no_grad()
    def prefill_only(self, prompt_tokens: Sequence[int],
                     params: Optional[SamplingParams] = None
                     ) -> Tuple[dict, int]:
        """Prefill half of P/D disaggregation: returns (kv_blob,
        first_token) for a decode engine's ``decode_from``. The blob is
        {"k", "v": (L, S, KV, D) tensors on this engine's device, "len": S}.
        With the prefix cache on, a hit computes only the suffix and
        gathers the shared span from the resident pages, and the prompt's
        full pages enter the cache (a prefill-only engine runs no
        admission, so this is where it learns prefixes)."""
        params = params or SamplingParams()
        S = len(prompt_tokens)
        if S >= self.max_len:
            raise ValueError(f"prompt ({S}) >= max_len ({self.max_len})")
        prompt = list(prompt_tokens)
        rec = flight_recorder.recorder()
        t0 = rec.begin(self.device)
        c, shared = 0, []
        if self._cache is not None:
            c, shared = self._cache.lookup(prompt)
        if c:
            row = np.zeros(self.pages_per_slot, np.int64)
            row[:len(shared)] = shared
            logits, ks, vs = self._run_suffix(prompt, c, row)
            k_full, v_full = (self._join_heads([
                torch.cat([p[:, shared].flatten(1, 2), k[:, :S - c]], 1)
                for p, k in zip(pool[:self._n_pos], kv)])
                for pool, kv in ((self._pk, ks), (self._pv, vs)))
        else:
            logits, ks, vs = self._run_prefill(prompt)
            k_full = self._join_heads([k[:, :S] for k in ks])
            v_full = self._join_heads([v[:, :S] for v in vs])
        # The full prompt pages past the cached prefix install into fresh
        # pool pages held by the cache entries alone (skipped under pool
        # pressure: eviction is the admission path's call).
        full = S // self.page
        new_cnt = full - len(shared)
        if self._cache is not None and new_cnt > 0 \
                and len(self._free_pages) >= new_cnt:
            fresh = [self._alloc_page() for _ in range(new_cnt)]
            span = full * self.page - c       # tokens [c, full * page)
            self._install_pages(fresh, [k[:, :span] for k in ks],
                                [v[:, :span] for v in vs])
            row = np.zeros(self.pages_per_slot, np.int64)
            row[:len(shared)] = shared
            row[len(shared):full] = fresh
            self._cache.insert(prompt, row, self._incref)
            for p in fresh:
                self._decref(p)               # the cache's refs keep them
        rec.end("request", "prefill", t0, tokens=S, cached_tokens=c,
                external=True)
        first = self._sample_host(logits, params)
        return {"k": k_full.contiguous(), "v": v_full.contiguous(),
                "len": S}, first

    def decode_from(self, kv_blob: dict, first_token: int,
                    params: Optional[SamplingParams] = None, *,
                    prompt_tokens: Optional[Sequence[int]] = None
                    ) -> List[int]:
        """Decode half of P/D: install a shipped prefill and decode it to
        completion (a closed loop over add_external_request)."""
        rid = self.add_external_request(kv_blob, first_token, params,
                                        prompt_tokens=prompt_tokens)
        while self.has_unfinished():
            for done in self.step():
                if done.req_id == rid:
                    return done.out
        raise RuntimeError(
            f"decode request {rid} was dropped without finishing")
