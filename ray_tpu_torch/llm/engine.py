"""Continuous-batching LLM generation engine in PyTorch.

Port of the single-device path of ray_tpu/llm/engine.py: a paged KV pool
shared by all slots (page 0 is the scratch page), bucketed prefill (pow-2
padding), one batched decode step for every active slot, the page-granular
prefix cache with its demotion tier (evicted pages move to host memory and
overflow to files), chunked prefill, cancellation, and prefill/decode
disaggregation (``prefill_only`` / ``decode_from``).

Full prefills and the first chunk of a chunked prefill run attention
through ``ops.flash_attention`` and so, on a GPU, through the hand-written
flash-attention kernel. The suffix prefill of a prefix-cache hit, every
later chunk of a chunked prefill and decode attend from a few queries to
many more keys; that attention is plain PyTorch, as in the JAX package.

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
``sp:gather``; see _private/flight_recorder.py). Not copied:
``_report_pool_pressure``, which feeds the reference runtime's memory
monitor; the device plane's copy counters that ``_part_layer`` feeds in the
reference (they come with the port of the device plane); and
``prefill_paged``'s ``host_staged=`` option, which only the reference's
staged A/B bench helper passes.

Sequence parallelism (``sp_degree``, ``sp_strategy``, ``mesh``): full
prefills, chunks and prefix-hit suffixes split their sequence over the
``sp`` positions of a ``parallel.mesh.Mesh`` and run ring attention or
Ulysses (sequence_parallel.py), plain PyTorch as in the JAX package: an SP
prefill launches no flash kernel. One process drives every shard on its
device, as the JAX engine does. The weights go once to each distinct device
of the mesh; the pool and decode stay on the engine's device, where JAX
replicates the pool over the mesh and decodes on every shard: the placement
differs, the values do not.

Not ported yet: meshes with dp, fsdp, tp or pp larger than 1 (the JAX
engine's tensor-parallel weights and pool, with its ``rules=``; ROADMAP
Queue 1 item 4), which raise NotImplementedError.
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
from .._private import flight_recorder
from ..exceptions import KVGatherError
from ..models.transformer import (TransformerConfig, _layer_qkv, _mlp,
                                  _to_tensor, apply_rope, init_params,
                                  layer_params, rms_norm, rope_angles)
from ..ops.flash_attention import flash_attention
from ..parallel.mesh import MeshSpec, build_mesh
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


def _prefill_fn(params, tokens, length: int, cfg: TransformerConfig):
    """tokens (1, Sb) padded prompt -> (last_logits (V,) f32,
    ks, vs (L, Sb, KV, D)).

    Positions >= length produce garbage cache rows; decode masks them out
    via per-slot lengths, and the last real token's logits only attend
    backwards (causal), so padding never leaks into results."""
    B, S = tokens.shape
    L, KV, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    x = params["embed"].to(cfg.dtype)[tokens]
    cos, sin = rope_angles(S, D, cfg.rope_theta, device=tokens.device)
    ks = torch.empty((L, S, KV, D), dtype=cfg.dtype, device=tokens.device)
    vs = torch.empty_like(ks)
    for i in range(L):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
        q, k, v = _layer_qkv(lp, h, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # The JAX engine writes this causal GQA attention inline; it is
        # reference_attention, so here it runs through the flash kernel.
        o = flash_attention(q, k, v, causal=True)
        o = torch.einsum("bshd,hde->bse", o, lp["attn"]["wo"].to(cfg.dtype))
        x = _mlp(lp, x + o, cfg)
        ks[i] = k[0]                      # drop the B=1 dim for the cache
        vs[i] = v[0]
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    last = x[0, length - 1]
    logits = (last @ params["lm_head"].to(cfg.dtype)).float()
    return logits, ks, vs


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

    The attention is plain PyTorch, as in the JAX engine: the flash kernel
    takes as many queries as keys."""
    B, Sb = tokens.shape
    T = pages.shape[0] * page
    L, KV, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    groups = cfg.num_heads // cfg.num_kv_heads
    dev = tokens.device
    x = params["embed"].to(cfg.dtype)[tokens]
    # RoPE at absolute positions prefix_len + i.
    cos, sin = rope_angles(Sb, D, cfg.rope_theta, offset=prefix_len,
                           device=dev)
    # Key t of [cached T | suffix Sb] is valid for suffix query s iff it is
    # a real cached prefix position or a suffix position <= s.
    tpos = torch.arange(T + Sb, device=dev)[None]
    qpos = torch.arange(Sb, device=dev)[:, None]
    valid = (tpos < prefix_len) | ((tpos >= T) & (tpos - T <= qpos))
    masked = ~valid[None, None]
    sqrt_d = _sqrt_head_dim(cfg)
    ks = torch.empty((L, Sb, KV, D), dtype=cfg.dtype, device=dev)
    vs = torch.empty_like(ks)
    for i in range(L):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
        q, k, v = _layer_qkv(lp, h, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kk = torch.cat([pool_k[i][pages].reshape(1, T, KV, D), k], dim=1)
        vv = torch.cat([pool_v[i][pages].reshape(1, T, KV, D), v], dim=1)
        kr = kk.repeat_interleave(groups, dim=2)            # (1, T+Sb, H, D)
        vr = vv.repeat_interleave(groups, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q, kr) / sqrt_d
        scores = scores.masked_fill(masked, -1e30)
        p = torch.softmax(scores.float(), -1).to(q.dtype)
        o = torch.einsum("bhst,bthd->bshd", p, vr)
        o = torch.einsum("bshd,hde->bse", o, lp["attn"]["wo"].to(cfg.dtype))
        x = _mlp(lp, x + o, cfg)
        ks[i] = k[0]
        vs[i] = v[0]
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps)
    last = x[0, length - 1]
    logits = (last @ params["lm_head"].to(cfg.dtype)).float()
    return logits, ks, vs


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

    pool_k/pool_v (L, N, page, KV, D); tables (B, P) physical page ids
    (page 0 = scratch for inactive slots); lengths (B,) = tokens already
    in cache (the new token is written at index lengths); active (B,)
    bool; temps (B,) f32 sampling temperatures, or None when every slot
    decodes greedily. Returns next tokens (B,)."""
    B = last_tokens.shape[0]
    P = tables.shape[1]
    T = P * page
    D = cfg.head_dim_
    groups = cfg.num_heads // cfg.num_kv_heads
    dev = last_tokens.device
    x = params["embed"].to(cfg.dtype)[last_tokens][:, None]      # (B,1,E)
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
    valid = torch.arange(T, device=dev)[None] <= lengths[:, None]  # (B, T)
    sqrt_d = _sqrt_head_dim(cfg)

    def rope1(t):                       # t: (B, 1, H, D)
        t1, t2 = t.float().chunk(2, dim=-1)
        c, s = cos[..., None, :], sin[..., None, :]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s],
                         dim=-1).to(t.dtype)

    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
        q, k, v = _layer_qkv(lp, h, cfg)
        q, k = rope1(q), rope1(k)
        pool_k[i, write_page, write_off] = k[:, 0]
        pool_v[i, write_page, write_off] = v[:, 0]
        # Gather each slot's pages: (B, P, page, KV, D) -> (B, T, KV, D)
        ck = pool_k[i][tables].reshape(B, T, -1, D)
        cv = pool_v[i][tables].reshape(B, T, -1, D)
        kr = ck.repeat_interleave(groups, dim=2)                 # (B,T,H,D)
        vr = cv.repeat_interleave(groups, dim=2)
        scores = torch.einsum("bhd,bthd->bht", q[:, 0], kr) / sqrt_d
        scores = scores.masked_fill(~valid[:, None], -1e30)
        p = torch.softmax(scores.float(), -1).to(q.dtype)
        o = torch.einsum("bht,bthd->bhd", p, vr)
        o = torch.einsum("bhd,hde->be", o, lp["attn"]["wo"].to(cfg.dtype))
        x = _mlp(lp, x + o[:, None], cfg)
    x = rms_norm(x[:, 0], params["ln_f"], cfg.rms_norm_eps)
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
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
    """Continuous-batching engine with a paged KV pool on one device, and
    sequence-parallel prefill over an ``sp`` mesh."""

    def __init__(self, cfg: TransformerConfig, params=None, *,
                 max_batch: int = 4, max_len: int = 256, seed: int = 0,
                 page_size: int = 64, kv_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 kv_gather_window: int = 4, kv_fetch=None, kv_prefetch=None,
                 sp_degree: Optional[int] = None, sp_strategy: str = "ring",
                 mesh=None, device: Union[str, torch.device] = "cuda"):
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
        devices=[cuda:0] * n)`` runs n shards in turn on one card. A mesh
        with any other axis larger than 1 raises NotImplementedError."""
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
            validate_sp(cfg, self.sp_degree, sp_strategy)
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
        if mesh is not None:
            mesh.axis_devices("sp")     # dp/fsdp/tp/pp meshes: not ported
        self.mesh = mesh
        if params is None:
            params = init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                self.device)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        # The weights on each distinct device of the SP mesh (the engine's
        # own device keeps the same tensors).
        self._sp_params = (replicate_params(params, mesh)
                           if self.sp_degree > 1 else None)
        pool_shape = (cfg.num_layers, self.n_pages, self.page,
                      cfg.num_kv_heads, cfg.head_dim_)
        self._pk = torch.zeros(pool_shape, dtype=cfg.dtype, device=self.device)
        self._pv = torch.zeros(pool_shape, dtype=cfg.dtype, device=self.device)
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

    def _tail_gather(self, li: int, pages: torch.Tensor):
        """Layer li's k, v of a paged request's decode-tail pages:
        (pages * page, KV, D) each."""
        KV, D = self.cfg.num_kv_heads, self.cfg.head_dim_
        return (self._pk[li][pages].reshape(-1, KV, D),
                self._pv[li][pages].reshape(-1, KV, D))

    def _append_tail(self, ks, vs, page_id: int, off: int) -> None:
        """Write one token's (L, KV, D) k, v at (page_id, off), in place."""
        self._pk[:, page_id, off] = ks
        self._pv[:, page_id, off] = vs

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
                dt = np.dtype(dt) if dt is not None else np.asarray(a).dtype
                floating = (np.issubdtype(dt, np.floating)
                            or dt.name == "bfloat16")
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
        """Bucketed prefill; returns (last_logits, ks, vs). With
        sp_degree > 1 it runs sequence-parallel over the mesh."""
        S = len(prompt)
        toks = np.zeros((1, self._bucket(S)), np.int64)
        toks[0, :S] = prompt
        if self.sp_degree > 1:
            return sp_prefill_fn(self._sp_params, self._to_device(toks), S,
                                 self.cfg, self.mesh, self.sp_strategy)
        return _prefill_fn(self.params, self._to_device(toks), S, self.cfg)

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
        args = (self._pk, self._pv,
                self._to_device(np.asarray(pages_row, np.int64)),
                self._to_device(toks), prefix_len, S, self.cfg, self.page)
        if self.sp_degree > 1:
            return sp_suffix_prefill_fn(self._sp_params, *args, self.mesh)
        return _suffix_prefill_fn(self.params, *args)

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
        idx = torch.tensor(list(pages), dtype=torch.long, device=self.device)
        self._demote.put(key, self._pk[:, idx].cpu(), self._pv[:, idx].cpu(),
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
            self._install_pages(new_pages, kk, vv)
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
        _install_fn(self._pk, self._pv, ks, vs,
                    self._to_device(self._tables[slot]), self.page)

    def _install_pages(self, page_ids: Sequence[int], ks, vs):
        """Install KV into specific pool pages (ks/vs start page-aligned on
        page_ids[0]; rows past them go to the scratch page, as in
        _install)."""
        pages = np.zeros(self.pages_per_slot, np.int64)
        pages[:len(page_ids)] = page_ids
        _install_fn(self._pk, self._pv, ks, vs, self._to_device(pages),
                    self.page)

    def _install_new_pages(self, req: _Request, ks, vs):
        """Install suffix KV into the request's newly reserved pages (the
        suffix starts page-aligned at prefix_len; the shared prefix pages
        are resident and never written)."""
        self._install_pages(req.pages, ks, vs)

    def _blob_tensor(self, a) -> torch.Tensor:
        """A blob's k or v on the engine's device, in its dtype: a tensor
        as it is, a numpy array (ml_dtypes bf16 included) bit-exactly."""
        if not isinstance(a, torch.Tensor):
            a = _to_tensor(np.asarray(a), self.device)
        return a.to(self.device, self.cfg.dtype)

    def _install_external(self, req: _Request):
        """Install a shipped KV blob; on a prefix-cache hit only the suffix
        pages are written (the shared span is already resident)."""
        ks = self._blob_tensor(req.kv_blob["k"])
        vs = self._blob_tensor(req.kv_blob["v"])
        if req.prefix_len:
            self._install_new_pages(req, ks[:, req.prefix_len:],
                                    vs[:, req.prefix_len:])
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
            t0 = rec.begin()
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
        t0 = rec.begin()
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
        requests. Returns the requests finished in this step."""
        self._tick_events = []
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
        nxt = _decode_fn(
            self.params, self._pk, self._pv, self._to_device(self._tables),
            self._to_device(self._last), self._to_device(self._lengths),
            self._to_device(active), temps, self._gen, self.cfg, self.page)
        nxt = nxt.cpu().numpy()
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
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._temps[slot] = 0.0
        self._requests.pop(req.req_id, None)

    # ------------------------------------------------ streamed external KV --
    def _part_layer(self, part: dict, li: int):
        """Layer li's (k, v, valid_len) of an external part, through the
        gather window.

        The whole part goes to the engine's device once per window
        residency and is sliced by layer there, cached in the window's
        entry: a part that arrives on the host (a numpy array, f32 as in
        the JAX tests, or a CPU tensor, bf16 included) is copied once; a
        part already on the device is used as it is. Nothing is copied per
        layer or per token, and the device holds at most the window's
        parts."""
        data = self._kv_window.get(part["key"], part["handle"])
        kd = data.get("_kd")
        if kd is None:
            kd = data["_kd"] = self._blob_tensor(data["k"])
            data["_vd"] = self._blob_tensor(data["v"])
        valid = int(data.get("len", data["k"].shape[1]))
        return kd[li], data["_vd"][li], valid

    def _window_prefetch(self, parts) -> None:
        self._kv_window.prefetch([(p["key"], p["handle"]) for p in parts])

    def _ext_decode_step(self, req: _Request) -> int:
        """One decode token of a paged-context slot: online-softmax
        attention over the external parts (layers outer, parts inner), the
        pool-resident decode tail and the incoming token itself; the new
        token's KV is appended to the tail pages. Raises KVGatherError if a
        part cannot be gathered."""
        sa = self._stream_attn
        S, t = req.ext_len, req.ext_written
        pos = S + t                       # absolute write/query position
        rec = flight_recorder.recorder()
        win = self._kv_window
        b0, w0, f0 = win.bytes_fetched, win.wait_s, win.fetches
        t0 = rec.begin()
        self._window_prefetch(req.ext_parts)
        x = sa.embed(self.params, [[self._last[req.slot]]])
        pages_row = self._to_device(np.asarray(req.pages, np.int64))
        ks_new, vs_new = [], []
        for li in range(self.cfg.num_layers):
            q, k, v = sa.qkv(self.params["layers"], li, x, pos)
            m, l, acc = sa.init(1)
            for part in req.ext_parts:
                pk, pv, valid = self._part_layer(part, li)
                m, l, acc = _stream_block_fn(q, pk, pv, valid, pos,
                                             part["span"][0], m, l, acc,
                                             scale=sa.scale)
            if t > 0:
                tk, tv = self._tail_gather(li, pages_row)
                m, l, acc = _stream_block_fn(q, tk, tv, t, pos, S, m, l, acc,
                                             scale=sa.scale)
            m, l, acc = _stream_block_fn(q, k, v, 1, pos, pos, m, l, acc,
                                         scale=sa.scale)
            x = sa.finish(self.params["layers"], li, x, l, acc)
            ks_new.append(k)
            vs_new.append(v)
        logits = sa.logits(self.params, x, 0)
        # The span covers the prefetch kick to the last layer's dispatch;
        # gather_wait_us is its blocking part.
        rec.end("request", "sp:gather", t0,
                id=req.req_id.to_bytes(8, "little"),
                parts=len(req.ext_parts),
                gather_bytes=win.bytes_fetched - b0,
                gather_wait_us=int((win.wait_s - w0) * 1e6),
                fetches=win.fetches - f0)
        self._append_tail(torch.stack(ks_new)[:, 0],
                          torch.stack(vs_new)[:, 0],
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
        sa = self._stream_attn
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
        x = sa.embed(self.params, toks)
        ks_out, vs_out = [], []
        for li in range(self.cfg.num_layers):
            q, k, v = sa.qkv(self.params["layers"], li, x, pos0)
            m, l, acc = sa.init(span)
            for part in ctx:
                pk, pv, valid = self._part_layer(part, li)
                m, l, acc = _stream_block_fn(q, pk, pv, valid, pos0,
                                             part["span"][0], m, l, acc,
                                             scale=sa.scale)
            m, l, acc = _stream_block_fn(q, k, v, Sc, pos0, pos0, m, l, acc,
                                         scale=sa.scale)
            x = sa.finish(self.params["layers"], li, x, l, acc)
            ks_out.append(k)
            vs_out.append(v)
        rec.end("request", "sp:gather", t0, parts=len(ctx),
                gather_bytes=win.bytes_fetched - b0,
                gather_wait_us=int((win.wait_s - w0) * 1e6),
                fetches=win.fetches - f0, prefill_chunk=True)
        part = {"k": torch.stack(ks_out), "v": torch.stack(vs_out), "len": Sc}
        logits = sa.logits(self.params, x, Sc - 1) if is_last else None
        return part, logits

    @torch.no_grad()
    def prefill_paged(self, prompt_tokens: Sequence[int],
                      params: Optional[SamplingParams] = None, *,
                      span: int = 64, publish=None, pipeline: bool = True
                      ) -> dict:
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
        handle it returns is never read before its bytes exist."""
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
        t0 = rec.begin()
        c, shared = 0, []
        if self._cache is not None:
            c, shared = self._cache.lookup(prompt)
        L, KV, D = self.cfg.num_layers, self.cfg.num_kv_heads, \
            self.cfg.head_dim_
        if c:
            row = np.zeros(self.pages_per_slot, np.int64)
            row[:len(shared)] = shared
            logits, ks, vs = self._run_suffix(prompt, c, row)
            idx = torch.tensor(shared, dtype=torch.long, device=self.device)
            k_full = torch.cat([self._pk[:, idx].reshape(L, c, KV, D),
                                ks[:, :S - c]], 1)
            v_full = torch.cat([self._pv[:, idx].reshape(L, c, KV, D),
                                vs[:, :S - c]], 1)
        else:
            logits, ks, vs = self._run_prefill(prompt)
            k_full = ks[:, :S]
            v_full = vs[:, :S]
        # The full prompt pages past the cached prefix install into fresh
        # pool pages held by the cache entries alone (skipped under pool
        # pressure: eviction is the admission path's call).
        full = S // self.page
        new_cnt = full - len(shared)
        if self._cache is not None and new_cnt > 0 \
                and len(self._free_pages) >= new_cnt:
            fresh = [self._alloc_page() for _ in range(new_cnt)]
            span = full * self.page - c       # tokens [c, full * page)
            self._install_pages(fresh, ks[:, :span], vs[:, :span])
            row = np.zeros(self.pages_per_slot, np.int64)
            row[:len(shared)] = shared
            row[len(shared):full] = fresh
            self._cache.insert(prompt, row, self._incref)
            for p in fresh:
                self._decref(p)               # the cache's refs keep them
        rec.end("request", "prefill", t0, tokens=S, cached_tokens=c,
                external=True)
        first = self._sample_host(logits, params)
        return {"k": k_full, "v": v_full, "len": S}, first

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
