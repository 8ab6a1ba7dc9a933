"""Continuous-batching LLM generation engine in PyTorch.

Port of the local, single-device path of ray_tpu/llm/engine.py: a paged KV
pool shared by all slots (page 0 is the scratch page), bucketed prefill
(pow-2 padding) and one batched decode step for every active slot.
Prefill attention runs through ``ops.flash_attention`` and so, on a GPU,
through the hand-written flash-attention kernel; decode attention is plain
PyTorch, as in the JAX package.

JAX donates the pool to its jitted steps; here the pool is updated in
place. Temperature sampling draws from the engine's ``torch.Generator``
and cannot reproduce ``jax.random``'s bits; greedy decoding is exact.

Not ported yet: the prefix cache (and the KV demotion tier), chunked
prefill, sequence parallelism, meshes, prefill/decode disaggregation,
paged external requests and cancellation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..models.transformer import (TransformerConfig, apply_rope, init_params,
                                  layer_params, rms_norm, rope_angles)
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
    # Why generation ended: "stop" (eos) or "length" (max_tokens/max_len).
    finish_reason: str = ""


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
    # JAX divides the scores by sqrt(D) rounded to the working dtype.
    sqrt_d = float(torch.tensor(math.sqrt(D), dtype=cfg.dtype))

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
# Engine
# --------------------------------------------------------------------------

class LLMEngine:
    """Continuous-batching engine with a paged KV pool on one device."""

    def __init__(self, cfg: TransformerConfig, params=None, *,
                 max_batch: int = 4, max_len: int = 256, seed: int = 0,
                 page_size: int = 64, kv_pages: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        """kv_pages sizes the shared pool (default: enough for every slot
        at max_len; set it lower to oversubscribe: admission then queues
        until pages free up). params default to ``init_params`` drawn from
        ``seed``; given params must already live on ``device``."""
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
        # page -> holder count; a page leaves _free_pages with count 1 and
        # returns when the count hits 0.
        self._page_refs: Dict[int, int] = {}
        self._tables = np.zeros((max_batch, self.pages_per_slot), np.int64)
        self._slots: Dict[int, _Request] = {}
        self._waiting: List[_Request] = []
        self._tick_events: List[Tuple[int, int, bool]] = []
        self._next_id = 0
        self._last = np.zeros(max_batch, np.int64)
        self._lengths = np.zeros(max_batch, np.int64)
        self._temps = np.zeros(max_batch, np.float32)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------ requests --
    def _pages_needed(self, req: _Request) -> int:
        budget = len(req.prompt) + req.params.max_tokens + 1
        return math.ceil(min(budget, self.max_len) / self.page)

    def add_request(self, prompt_tokens: Sequence[int],
                    params: Optional[SamplingParams] = None) -> int:
        if len(prompt_tokens) >= self.max_len:
            raise ValueError(
                f"prompt ({len(prompt_tokens)}) >= max_len ({self.max_len})")
        req = _Request(self._next_id, list(prompt_tokens),
                       params or SamplingParams())
        need = self._pages_needed(req)
        if need > self.n_pages - 1:
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.n_pages - 1}; raise kv_pages or lower max_tokens")
        self._next_id += 1
        self._waiting.append(req)
        return req.req_id

    def take_tick_events(self) -> List[Tuple[int, int, bool]]:
        """(req_id, token, finished) tuples emitted by the last step():
        admission first tokens and decode tokens, in emission order."""
        ev = self._tick_events
        self._tick_events = []
        return ev

    def has_unfinished(self) -> bool:
        return bool(self._waiting or self._slots)

    def kv_pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def kv_pages_total(self) -> int:
        return self.n_pages - 1

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    @property
    def active_requests(self) -> int:
        return len(self._slots)

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

    # ------------------------------------------------------ page refcounts --
    def _alloc_page(self) -> int:
        p = self._free_pages.pop(0)
        self._page_refs[p] = 1
        return p

    def _decref(self, p: int) -> None:
        n = self._page_refs[p] - 1
        if n > 0:
            self._page_refs[p] = n
        else:
            del self._page_refs[p]
            self._free_pages.append(p)

    def _reserve(self, req: _Request) -> bool:
        """Reserve slot + pages for a request; False = wait for capacity."""
        if not self._free_slots:
            return False
        need = self._pages_needed(req)
        if len(self._free_pages) < need:
            return False
        req.slot = self._free_slots.pop(0)
        req.pages = [self._alloc_page() for _ in range(need)]
        row = np.zeros(self.pages_per_slot, np.int64)
        row[:need] = req.pages
        self._tables[req.slot] = row
        return True

    def _install(self, slot: int, ks, vs):
        _install_fn(self._pk, self._pv, ks, vs,
                    self._to_device(self._tables[slot]), self.page)

    def _admit(self):
        admitted = []
        while self._waiting and self._reserve(self._waiting[0]):
            req = self._waiting.pop(0)
            logits, ks, vs = self._run_prefill(req.prompt)
            self._install(req.slot, ks, vs)
            self._lengths[req.slot] = len(req.prompt)
            self._temps[req.slot] = req.params.temperature
            self._slots[req.slot] = req
            admitted.append((req, logits))
        if admitted:
            firsts = self._sample_batch([lg for _, lg in admitted],
                                        [r.params for r, _ in admitted])
            for (req, _), first in zip(admitted, firsts):
                self._last[req.slot] = first
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
        """Admit waiting requests, run ONE decode step for all active
        slots, retire finished requests. Returns the requests finished in
        this step."""
        self._tick_events = []
        self._admit()
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
        """Return a reserved slot's pages + slot to the pool."""
        slot = req.slot
        self._free_slots.append(slot)
        for p in req.pages:
            self._decref(p)
        req.pages = []
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._temps[slot] = 0.0

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
