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

Not ported yet: sequence parallelism (``sp_degree``, ``sp_strategy``),
meshes, paged external requests (``add_paged_request``, ``prefill_paged``,
``decode_paged`` and their ``kv_fetch`` / ``kv_prefetch`` /
``kv_gather_window`` gather window) and the flight-recorder spans.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import tempfile
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import _config
from .._device import resolve_device
from ..models.transformer import (TransformerConfig, _to_tensor, apply_rope,
                                  init_params, layer_params, rms_norm,
                                  rope_angles)
from ..ops.flash_attention import flash_attention


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


# --------------------------------------------------------------------------
# Pure pieces
# --------------------------------------------------------------------------

def _layer_qkv(lp, h, cfg):
    dt = cfg.dtype
    q = torch.einsum("bse,ehd->bshd", h, lp["attn"]["wq"].to(dt))
    k = torch.einsum("bse,ekd->bskd", h, lp["attn"]["wk"].to(dt))
    v = torch.einsum("bse,ekd->bskd", h, lp["attn"]["wv"].to(dt))
    return q, k, v


def _mlp(lp, x, cfg):
    dt = cfg.dtype
    h = rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps)
    g = torch.einsum("bse,em->bsm", h, lp["mlp"]["w_gate"].to(dt))
    u = torch.einsum("bse,em->bsm", h, lp["mlp"]["w_up"].to(dt))
    return x + torch.einsum("bsm,me->bse", F.silu(g) * u,
                            lp["mlp"]["w_down"].to(dt))


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
    of a re-prefill."""

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


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

class LLMEngine:
    """Continuous-batching engine with a paged KV pool on one device."""

    def __init__(self, cfg: TransformerConfig, params=None, *,
                 max_batch: int = 4, max_len: int = 256, seed: int = 0,
                 page_size: int = 64, kv_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
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
        requests."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.page = max(8, min(page_size, max_len))
        self.pages_per_slot = math.ceil(max_len / self.page)
        # page 0 is scratch (inactive-slot writes land there); never handed out
        self.n_pages = 1 + (kv_pages if kv_pages is not None
                            else max_batch * self.pages_per_slot)
        if params is None:
            params = init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                self.device)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
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
        self._cache = _PrefixCache(self.page) if prefix_cache else None
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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------ requests --
    def _pages_needed(self, req: _Request) -> int:
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
        req = _Request(self._next_id, prompt, params or SamplingParams())
        req.no_cache = prompt_tokens is None
        req.kv_blob = kv_blob
        req.first_token = int(first_token)
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
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _run_prefill(self, prompt: Sequence[int]):
        """Bucketed prefill; returns (last_logits, ks, vs)."""
        S = len(prompt)
        toks = np.zeros((1, self._bucket(S)), np.int64)
        toks[0, :S] = prompt
        return _prefill_fn(self.params, self._to_device(toks), S, self.cfg)

    def _run_suffix(self, prompt: Sequence[int], prefix_len: int, pages_row,
                    upto: Optional[int] = None):
        """Bucketed suffix prefill of prompt[prefix_len:upto] against the
        resident prefix pages of ``pages_row``; ``upto`` bounds the suffix
        to one chunk of a chunked prefill."""
        suf = prompt[prefix_len:upto]
        S = len(suf)
        toks = np.zeros((1, self._bucket(S)), np.int64)
        toks[0, :S] = suf
        return _suffix_prefill_fn(
            self.params, self._pk, self._pv,
            self._to_device(np.asarray(pages_row, np.int64)),
            self._to_device(toks), prefix_len, S, self.cfg, self.page)

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
        admitted = []
        while self._waiting and self._reserve(self._waiting[0]):
            req = self._waiting.pop(0)
            S = len(req.prompt)
            if self.prefill_chunk and req.kv_blob is None \
                    and S - req.prefix_len > self.prefill_chunk:
                # Chunked prefill: advances one chunk per step().
                req.prefilled = req.prefix_len
                self._prefilling[req.slot] = req
                continue
            if req.kv_blob is not None:
                self._install_external(req)
            elif req.prefix_len:
                logits, ks, vs = self._run_suffix(
                    req.prompt, req.prefix_len, self._tables[req.slot])
                self._install_new_pages(req, ks, vs)
            else:
                logits, ks, vs = self._run_prefill(req.prompt)
                self._install(req.slot, ks, vs)
            if self._cache is not None and not req.no_cache:
                self._cache.insert(req.prompt, self._tables[req.slot],
                                   self._incref)
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
        if req.prefilled == 0:
            logits, ks, vs = self._run_prefill(req.prompt[:nxt])
            self._install_pages(row[:math.ceil(nxt / self.page)], ks, vs)
        else:
            logits, ks, vs = self._run_suffix(req.prompt, req.prefilled, row,
                                              upto=nxt)
            self._install_pages(row[req.prefilled // self.page:
                                    math.ceil(nxt / self.page)], ks, vs)
        req.prefilled = nxt
        if nxt >= S:
            del self._prefilling[slot]
            if self._cache is not None and not req.no_cache:
                self._cache.insert(req.prompt, row, self._incref)
            self._lengths[slot] = S
            self._temps[slot] = req.params.temperature
            self._slots[slot] = req
            first = self._sample_host(logits, req.params)
            self._last[slot] = first
            self._emit(req, first)

    def _sample_batch(self, logits_list, params_list) -> List[int]:
        """Sample first tokens for a whole admission wave with one
        device-to-host transfer."""
        lg = torch.stack(logits_list)                     # (N, V) f32
        toks = lg.argmax(-1)
        temps = torch.tensor([p.temperature for p in params_list],
                             dtype=torch.float32, device=lg.device)
        if any(p.temperature > 0 for p in params_list):
            probs = torch.softmax(lg / temps.clamp_min(1e-6)[:, None], -1)
            sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            toks = torch.where(temps > 0, sampled, toks)
        return toks.tolist()                              # the one sync

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
        elif len(req.out) >= p.max_tokens \
                or len(req.prompt) + len(req.out) >= self.max_len - 1:
            req.finished = True
            req.finish_reason = req.finish_reason or "length"
        self._tick_events.append((req.req_id, token, req.finished))

    @torch.no_grad()
    def step(self) -> List[_Request]:
        """Admit waiting requests, advance chunked prefills by one chunk,
        run ONE decode step for all active slots, retire finished requests.
        Returns the requests finished in this step."""
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
        active = np.zeros(self.max_batch, bool)
        active[list(self._slots)] = True
        temps = self._to_device(self._temps) if (self._temps > 0).any() \
            else None
        nxt = _decode_fn(
            self.params, self._pk, self._pv, self._to_device(self._tables),
            self._to_device(self._last), self._to_device(self._lengths),
            self._to_device(active), temps, self._gen, self.cfg, self.page)
        nxt = nxt.cpu().numpy()
        for slot, req in list(self._slots.items()):
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
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._temps[slot] = 0.0
        self._requests.pop(req.req_id, None)

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
