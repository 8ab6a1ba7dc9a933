"""Parity of ray_tpu_torch's OpenAIServer with the JAX package's on the CPU.

Both servers run in process, each under its own ``asyncio.run``, and take
the same requests: small objects with ``path``, ``method`` and ``json()``,
as the Serve proxy hands an ingress. The JAX server's replica draws the
``tiny`` params from seed 0; the port's gets the same params converted
(``from_jax_params``), in f32. Bodies and SSE frames must be equal once the
request ids and creation times are removed (each stream's frames share one
id); text, finish reasons, usage, status codes and messages exactly.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from ray_tpu import serve as jax_serve
from ray_tpu.llm import LLMEngine as JaxEngine
from ray_tpu.llm import OpenAIServer as JaxServer
from ray_tpu.llm import build_openai_app as jax_build_openai_app
from ray_tpu.models import PRESETS as JAX_PRESETS
from ray_tpu_torch import serve
from ray_tpu_torch.llm import OpenAIServer, build_openai_app
from ray_tpu_torch.models import PRESETS, from_jax_params

CFG, JCFG = PRESETS["tiny"], JAX_PRESETS["tiny"]
SERVER = dict(max_len=64, model_name="tiny-chat")
SCRIPT_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one thread per core would contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seed-0 ``tiny`` params, as the port's tensors."""
    jeng = JaxEngine(JCFG, max_batch=1, max_len=64, seed=0)
    return from_jax_params(jax.tree.map(np.asarray, jeng.params), CFG, "cpu")


class _Req:
    """An HTTP request as an ingress receives it."""

    def __init__(self, method: str, path: str, body=None, raw: bytes = None):
        self.method = method
        self.path = path
        self.body = raw if raw is not None else json.dumps(body).encode()

    def json(self):
        return json.loads(self.body or b"null")


def _server(jax_side: bool, params, **kw):
    kw = dict(SERVER, **kw)
    if jax_side:
        return JaxServer("tiny", **kw)
    return OpenAIServer(CFG, params, device="cpu", **kw)


def _strip(obj):
    """obj less its creation times and request ids."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k != "created" and not (
                    k == "id" and str(v).startswith(("cmpl-", "chatcmpl-")))}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


async def _frames(agen, limit=None):
    """The SSE frames of ``agen``, parsed ("[DONE]" kept as a string);
    ``limit`` closes the generator after that many."""
    out = []
    try:
        async for frame in agen:
            assert frame.startswith("data: ") and frame.endswith("\n\n")
            body = frame[6:-2]
            out.append(body if body == "[DONE]" else json.loads(body))
            if limit is not None and len(out) == limit:
                break
    finally:
        await agen.aclose()
    return out


async def _answer(server, resp, jax_side: bool):
    """A response as comparable data: ("json", body), ("http", status,
    body, rendered) or ("sse", content type, frames)."""
    mod = jax_serve if jax_side else serve
    if isinstance(resp, mod.HTTPResponse):
        return ("http", resp.status, resp.body, resp.render())
    if isinstance(resp, mod.StreamingResponse):
        frames = await _frames(getattr(server, resp.method)(
            *resp.args, **resp.kwargs))
        ids = {f["id"] for f in frames if isinstance(f, dict)}
        assert len(ids) == 1, ids
        return ("sse", resp.content_type, _strip(frames))
    assert isinstance(resp, dict), type(resp)
    return ("json", _strip(resp))


def _both(params, script, **kw):
    """script(server, jax_side) on each side's server: [JAX's, port's]."""
    async def run(jax_side):
        server = _server(jax_side, params, **kw)
        return await script(server, jax_side)
    return [asyncio.run(asyncio.wait_for(run(j), SCRIPT_TIMEOUT_S))
            for j in (True, False)]


def _route(method, path, body=None, raw=None):
    async def script(server, jax_side):
        resp = await server(_Req(method, path, body, raw))
        return await _answer(server, resp, jax_side)
    return script


def test_models_route_matches_jax(params):
    want, got = _both(params, _route("GET", "/v1/models"))
    assert got == want
    assert got[1]["data"][0]["id"] == "tiny-chat"


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 8}),
    ("/v1/completions", {"prompt": "hey", "max_tokens": None}),
    ("/v1/chat/completions",
     {"messages": [{"role": "system", "content": "be brief"},
                   {"role": "user", "content": "hi"}], "max_tokens": 6,
      "model": "other"}),
], ids=["completion", "max-tokens-null", "chat"])
def test_completions_match_jax(params, path, body):
    want, got = _both(params, _route("POST", path, body))
    assert got == want
    kind, res = got
    assert kind == "json"
    n = 16 if body.get("max_tokens") is None else body["max_tokens"]
    assert res["usage"]["completion_tokens"] == n


def test_a_list_of_prompts_shares_decode_ticks_as_jax(params):
    """Three prompts in one request run concurrently: all three are in
    the batch at once on both sides."""
    async def script(server, jax_side):
        resp = await server(_Req("POST", "/v1/completions", {
            "prompt": ["one", "two two", "three three three"],
            "max_tokens": 5}))
        return (await _answer(server, resp, jax_side),
                (await server.serving.debug_stats())["max_active"])
    want, got = _both(params, script)
    assert got == want
    (_, body), max_active = got
    assert max_active == 3
    assert [c["index"] for c in body["choices"]] == [0, 1, 2]
    assert body["usage"]["prompt_tokens"] == 3 + 7 + 17


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 8,
                         "stream": True}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
      "stream": True}),
], ids=["text", "chat"])
def test_sse_frames_match_jax(params, path, body):
    want, got = _both(params, _route("POST", path, body))
    assert got == want
    kind, ctype, frames = got
    assert kind == "sse" and ctype == "text/event-stream"
    assert frames[-1] == "[DONE]"
    finals = [f["choices"][0]["finish_reason"] for f in frames[:-1]
              if f["choices"][0]["finish_reason"]]
    assert finals == ["length"]
    if "chat" in path:
        assert frames[0]["choices"][0]["delta"] == {"role": "assistant"}


@pytest.mark.parametrize("method,path,body,raw,status,message", [
    ("POST", "/v1/chat/completions", {"messages": []}, None, 400,
     "messages is required"),
    ("POST", "/v1/completions", {"max_tokens": 4}, None, 400,
     "prompt is required"),
    ("POST", "/v1/completions", {"prompt": "x", "max_tokens": "many"},
     None, 400, "max_tokens/temperature must be numbers"),
    ("POST", "/v1/completions", {"prompt": "x", "temperature": "hot"},
     None, 400, "max_tokens/temperature must be numbers"),
    ("POST", "/v1/completions", None, b"{not json", 400,
     "invalid JSON body"),
    ("GET", "/v1/completions", None, b"", 405, "method GET not allowed"),
    ("POST", "/v1/embeddings", {"input": "x"}, None, 404,
     "no route for /v1/embeddings"),
    ("POST", "/v1/completions", {"prompt": ["a", "b"], "stream": True},
     None, 400, "stream=true supports a single prompt"),
], ids=["empty-messages", "no-prompt", "max-tokens-nan", "temperature-nan",
        "not-json", "get-on-post", "unknown-path", "stream-two-prompts"])
def test_errors_match_jax(params, method, path, body, raw, status, message):
    want, got = _both(params, _route(method, path, body, raw))
    assert got == want
    kind, code, err, rendered = got
    assert kind == "http" and code == status
    assert err == {"error": {"message": message,
                             "type": "invalid_request_error",
                             "code": status}}
    assert rendered[0].startswith(str(status))


def test_closing_the_sse_stream_cancels_and_frees_pages_as_jax(params):
    """A client that goes away after two frames: the replica cancels the
    request and every page comes back."""
    async def script(server, jax_side):
        resp = await server(_Req("POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "tell me a story"}],
            "max_tokens": 40, "stream": True}))
        frames = await _frames(getattr(server, resp.method)(
            *resp.args, **resp.kwargs), limit=2)
        for _ in range(200):
            st = await server.serving.debug_stats()
            if st["active"] == 0 and st["queue_depth"] == 0:
                break
            await asyncio.sleep(0.01)
        return _strip(frames), {k: st[k] for k in (
            "cancelled", "completed", "active", "kv_pages_free",
            "kv_pages_total")}
    want, got = _both(params, script, prefix_cache=False)
    assert got == want
    frames, st = got
    assert len(frames) == 2 and frames[0]["choices"][0]["delta"] == {
        "role": "assistant"}
    assert st["cancelled"] == 1 and st["completed"] == 0
    assert st["kv_pages_free"] == st["kv_pages_total"]


def test_build_openai_app_matches_jax(params):
    kw = dict(model_name="m", num_replicas=2, max_batch=3, max_len=96,
              autoscaling_config={"min_replicas": 0, "max_replicas": 2},
              page_size=8)
    want = jax_build_openai_app("tiny", **kw)
    got = build_openai_app("tiny", params=params, device="cpu", **kw)
    assert isinstance(got, serve.Application)
    for attr in ("name", "num_replicas", "ray_actor_options",
                 "route_prefix", "autoscaling_config"):
        assert getattr(got.deployment, attr) \
            == getattr(want.deployment, attr), attr
    assert got.deployment._target.__name__ \
        == want.deployment._target.__name__ == "OpenAIServer"
    assert got.init_args == want.init_args == ()
    extra = {"params": params, "device": "cpu"}
    assert got.init_kwargs == dict(want.init_kwargs, **extra)
    assert got.deployment.ray_actor_options == {"num_cpus": 1}
    with pytest.raises(TypeError, match="serve.run"):
        got.deployment()
    server = got.deployment._target(*got.init_args, **got.init_kwargs)
    assert server.model_name == "m" and server.max_len == 96


def test_server_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OpenAIServer("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_openai_app("tiny")
