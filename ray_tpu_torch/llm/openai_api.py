"""OpenAI-compatible serving API over the port's engine, from
ray_tpu/llm/openai_api.py.

``OpenAIServer`` routes /v1/models, /v1/completions and
/v1/chat/completions, with the OpenAI JSON shapes, onto the port's
continuous-batching ``EngineReplica`` (iteration-level admission, paged KV
and prefix cache). Errors are real HTTP statuses (``serve.HTTPResponse``:
400, 404, 405), as OpenAI SDK clients key their exception types off them.
A list of prompts runs concurrently, so its prompts share decode ticks.

``stream: true`` returns a ``serve.StreamingResponse`` naming
``sse_stream``, an async generator of Server-Sent Events: the chat role
frame, one chunk per decoded text delta, a final chunk with the real
``finish_reason`` (``stop`` | ``length`` | ``cancelled``), then
``data: [DONE]``. Closing it early (a client disconnect) closes the
replica's stream, which cancels the request and frees its pages
mid-decode.

The server awaits its own replica, so both live on one event loop: call it
on the loop of the replica's host (``llm.Hosted(server.serving)``), or
under ``asyncio.run``. ``build_openai_app`` returns the port's
``serve.Application`` with the reference's deployment settings; the HTTP
proxy, router and ``serve.run`` that deploy it in the reference are
runtime code and are not ported.

Tokenization is pluggable (``tokenizer=``): anything with
encode(str)->List[int] / decode(List[int])->str. The default is a
dependency-free reversible byte-level tokenizer.
"""

from __future__ import annotations

import asyncio
import codecs
import json
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .. import serve
from .._device import resolve_device
from ..models import PRESETS
from ..models.transformer import TransformerConfig
from .serving import EngineReplica

__all__ = ["ByteTokenizer", "OpenAIServer", "build_openai_app"]


class ByteTokenizer:
    """Reversible byte-level tokenizer: token = byte + offset (ids 0..2
    reserved for pad/bos/eos)."""

    OFFSET = 3

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, tokens: Sequence[int]) -> str:
        return bytes(max(0, min(255, t - self.OFFSET))
                     for t in tokens if t >= self.OFFSET
                     ).decode("utf-8", errors="replace")


class _Detokenizer:
    """Incremental token -> text for streaming deltas.  Byte-level
    tokenizers hold incomplete UTF-8 sequences back (a multi-byte char
    split across chunks must not emit replacement glyphs); generic
    tokenizers fall back to full-decode prefix deltas."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._byte = isinstance(tokenizer, ByteTokenizer)
        if self._byte:
            self._dec = codecs.getincrementaldecoder("utf-8")("replace")
        else:
            self._all: List[int] = []
            self._emitted = ""

    def feed(self, token: int) -> str:
        if self._byte:
            if token < ByteTokenizer.OFFSET:
                return ""
            return self._dec.decode(
                bytes([max(0, min(255, token - ByteTokenizer.OFFSET))]))
        self._all.append(token)
        text = self._tok.decode(self._all)
        delta = text[len(self._emitted):]
        self._emitted = text
        return delta


class OpenAIServer:
    """Ingress: routes the OpenAI surface onto the continuous-batching
    serving replica.

    ``preset`` is a preset name or a ``TransformerConfig``; ``params`` go to
    the replica as they are (default: ``init_params`` from ``seed``);
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, preset: Union[str, TransformerConfig] = "tiny",
                 params=None, model_name: str = "ray-tpu",
                 max_batch: int = 4, max_len: int = 128,
                 tokenizer: Any = None, seed: int = 0,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefix_cache: bool = True, max_queue: int = 64,
                 device: Union[str, torch.device] = "cuda"):
        cfg = PRESETS[preset] if isinstance(preset, str) else preset
        self.model_name = model_name
        self.max_len = max_len
        self.serving = EngineReplica(
            cfg, params, max_batch=max_batch, max_len=max_len,
            page_size=page_size, kv_pages=kv_pages,
            prefix_cache=prefix_cache, max_queue=max_queue, seed=seed,
            device=device)
        self.tokenizer = tokenizer or ByteTokenizer(cfg.vocab_size)
        self._created = int(time.time())

    def __serve_load__(self) -> float:
        return self.serving.__serve_load__()

    # ------------------------------------------------------------ helpers --
    async def _completion(self, prompt: str, max_tokens: int,
                          temperature: float) -> Dict[str, Any]:
        toks = self.tokenizer.encode(prompt)[: self.max_len - 2]
        res = await self.serving.generate(
            toks, {"max_tokens": max_tokens, "temperature": temperature})
        return {
            "text": self.tokenizer.decode(res["tokens"]),
            "finish_reason": res["finish_reason"] or "length",
            "prompt_tokens": len(toks),
            "completion_tokens": len(res["tokens"]),
        }

    @staticmethod
    def _error(code: int, msg: str):
        # A real HTTP status (not 200 + error body): OpenAI SDK clients
        # key their exception types off the status code.
        return serve.HTTPResponse(code, {
            "error": {"message": msg, "type": "invalid_request_error",
                      "code": code}})

    def _stream_response(self, kind: str, prompt: str, max_tokens: int,
                         temperature: float, model: str):
        toks = self.tokenizer.encode(prompt)[: self.max_len - 2]
        return serve.StreamingResponse(
            "sse_stream",
            (kind, toks, {"max_tokens": max_tokens,
                          "temperature": temperature}, model),
            content_type="text/event-stream")

    async def sse_stream(self, kind: str, prompt_tokens: List[int],
                         opts: dict, model: str):
        """Async generator of SSE frames: one chunk per decoded delta, a
        final chunk carrying finish_reason, then [DONE]. Everything it
        needs rides the args."""
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if kind == "chat"
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        created = int(time.time())
        detok = _Detokenizer(self.tokenizer)
        if kind == "chat":
            first = {"id": rid, "object": "chat.completion.chunk",
                     "created": created, "model": model,
                     "choices": [{"index": 0,
                                  "delta": {"role": "assistant"},
                                  "finish_reason": None}]}
            yield f"data: {json.dumps(first)}\n\n"

        def chunk(delta_text: Optional[str], finish: Optional[str]):
            if kind == "chat":
                delta = ({} if delta_text is None
                         else {"content": delta_text})
                choice = {"index": 0, "delta": delta,
                          "finish_reason": finish}
                obj = "chat.completion.chunk"
            else:
                choice = {"index": 0, "text": delta_text or "",
                          "finish_reason": finish}
                obj = "text_completion"
            return ("data: " + json.dumps(
                {"id": rid, "object": obj, "created": created,
                 "model": model, "choices": [choice]}) + "\n\n")

        finish = "length"
        gen = self.serving.stream_generate(prompt_tokens, opts)
        try:
            async for item in gen:
                if isinstance(item, dict):
                    finish = item.get("finish_reason") or finish
                    break
                delta = detok.feed(item)
                if delta:
                    yield chunk(delta, None)
        finally:
            await gen.aclose()
        # On client disconnect this generator is simply closed (the
        # engine request is cancelled typed); terminal frames only go to
        # clients that are still listening.
        yield chunk(None, finish)
        yield "data: [DONE]\n\n"

    # --------------------------------------------------------------- routes --
    async def __call__(self, request):
        path = request.path
        if path.endswith("/models"):
            return {"object": "list", "data": [{
                "id": self.model_name, "object": "model",
                "created": self._created, "owned_by": "ray_tpu"}]}
        if request.method != "POST":
            return self._error(405, f"method {request.method} not allowed")
        try:
            body = request.json() or {}
        except ValueError:
            return self._error(400, "invalid JSON body")
        try:
            # Clients serializing unset fields as null must get a 400,
            # not a 500 from int(None).
            mt = body.get("max_tokens")
            max_tokens = 16 if mt is None else int(mt)
            temperature = float(body.get("temperature") or 0.0)
        except (TypeError, ValueError):
            return self._error(
                400, "max_tokens/temperature must be numbers")
        stream = bool(body.get("stream"))
        model = body.get("model", self.model_name)
        if path.endswith("/chat/completions"):
            msgs = body.get("messages") or []
            if not msgs:
                return self._error(400, "messages is required")
            # The canonical role-tagged flattening (reference renders a
            # chat template; the pluggable tokenizer may bring one).
            prompt = "\n".join(
                f"{m.get('role', 'user')}: {m.get('content', '')}"
                for m in msgs) + "\nassistant:"
            if stream:
                return self._stream_response("chat", prompt, max_tokens,
                                             temperature, model)
            res = await self._completion(prompt, max_tokens, temperature)
            return {
                "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": model,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": res["text"]},
                             "finish_reason": res["finish_reason"]}],
                "usage": {
                    "prompt_tokens": res["prompt_tokens"],
                    "completion_tokens": res["completion_tokens"],
                    "total_tokens": res["prompt_tokens"]
                    + res["completion_tokens"]},
            }
        if path.endswith("/completions"):
            prompt = body.get("prompt")
            if prompt is None:
                return self._error(400, "prompt is required")
            prompts = prompt if isinstance(prompt, list) else [prompt]
            if stream:
                if len(prompts) != 1:
                    return self._error(
                        400, "stream=true supports a single prompt")
                return self._stream_response("text", str(prompts[0]),
                                             max_tokens, temperature,
                                             model)
            # Concurrent: the prompts share decode ticks in one
            # continuous batch instead of running back-to-back.
            results = await asyncio.gather(*[
                self._completion(str(p), max_tokens, temperature)
                for p in prompts])
            choices, pt, ct = [], 0, 0
            for i, res in enumerate(results):
                pt += res["prompt_tokens"]
                ct += res["completion_tokens"]
                choices.append({"index": i, "text": res["text"],
                                "finish_reason": res["finish_reason"]})
            return {
                "id": f"cmpl-{uuid.uuid4().hex[:24]}",
                "object": "text_completion",
                "created": int(time.time()),
                "model": model,
                "choices": choices,
                "usage": {"prompt_tokens": pt, "completion_tokens": ct,
                          "total_tokens": pt + ct},
            }
        return self._error(404, f"no route for {path}")


def build_openai_app(preset: Union[str, TransformerConfig] = "tiny", *,
                     params=None, model_name: str = "ray-tpu",
                     num_replicas: int = 1,
                     max_batch: int = 4, max_len: int = 128,
                     tokenizer: Any = None,
                     ray_actor_options: Optional[dict] = None,
                     autoscaling_config: Optional[dict] = None,
                     device: Union[str, torch.device] = "cuda",
                     **engine_kwargs) -> serve.Application:
    """The reference's OpenAI deployment (name ``openai_<model_name>``,
    route prefix /v1, ``autoscaling_config`` for queue-driven scaling)
    bound to ``OpenAIServer``'s init args, ``params`` and ``device``
    among them. A runtime that hosts it builds ``OpenAIServer(*init_args,
    **init_kwargs)`` per replica."""
    resolve_device(device)
    dep = serve.deployment(
        OpenAIServer, name=f"openai_{model_name}",
        num_replicas=num_replicas,
        ray_actor_options=ray_actor_options or {"num_cpus": 1},
        route_prefix="/v1",
        autoscaling_config=autoscaling_config)
    return dep.bind(preset=preset, params=params, model_name=model_name,
                    max_batch=max_batch, max_len=max_len,
                    tokenizer=tokenizer, device=device, **engine_kwargs)
