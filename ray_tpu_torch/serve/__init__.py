"""The data carriers of ray_tpu/serve that the port's serving apps return.

Copied from ray_tpu/serve/api.py (``Application``, ``Deployment``,
``deployment``) and ray_tpu/serve/_private/proxy.py (``HTTPResponse``,
``StreamingResponse``, ``Request``): plain objects that describe a
deployment, its bound init arguments, an HTTP request and the responses an
ingress returns. ``build_openai_app``, ``build_llm_app`` and
``build_dp_deployment`` return an ``Application``; ``OpenAIServer`` returns
``HTTPResponse`` and ``StreamingResponse``.

Not ported: ``serve.run``, ``start``, ``shutdown``, handles, the controller,
the HTTP proxy, the router and the autoscaler. They are runtime code (actors,
the GCS, sockets) and import no JAX; the port takes runtime services as
callbacks and hosts its replicas in process (``llm.serve_patterns``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional

__all__ = ["Application", "Deployment", "deployment", "HTTPResponse",
           "StreamingResponse", "Request"]


@dataclasses.dataclass
class Application:
    """A deployment bound to its init args (reference: Application from
    Deployment.bind)."""
    deployment: "Deployment"
    init_args: tuple
    init_kwargs: dict


class Deployment:
    def __init__(self, target: Callable, name: str, num_replicas: int = 1,
                 ray_actor_options: Optional[dict] = None,
                 route_prefix: str = "/",
                 autoscaling_config: Optional[dict] = None):
        self._target = target
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = ray_actor_options or {}
        self.route_prefix = route_prefix
        # {"min_replicas", "max_replicas", "target_ongoing_requests",
        #  "upscale_delay_s", "downscale_delay_s"} (reference:
        #  serve AutoscalingConfig, autoscaling_policy.py)
        self.autoscaling_config = autoscaling_config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                ray_actor_options: Optional[dict] = None,
                route_prefix: Optional[str] = None,
                autoscaling_config: Optional[dict] = None) -> "Deployment":
        return Deployment(
            self._target,
            name=self.name if name is None else name,
            num_replicas=(self.num_replicas if num_replicas is None
                          else num_replicas),
            ray_actor_options=(self.ray_actor_options
                               if ray_actor_options is None
                               else ray_actor_options),
            route_prefix=(self.route_prefix if route_prefix is None
                          else route_prefix),
            autoscaling_config=(self.autoscaling_config
                                if autoscaling_config is None
                                else autoscaling_config))

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"deployment {self.name} must be deployed with serve.run("
            f"{self.name}.bind(...)) and called through a handle")


def deployment(_target: Callable = None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               ray_actor_options: Optional[dict] = None,
               route_prefix: str = "/",
               autoscaling_config: Optional[dict] = None):
    """@serve.deployment decorator (reference: serve/api.py)."""
    def deco(target):
        return Deployment(target, name or target.__name__,
                          num_replicas=num_replicas,
                          ray_actor_options=ray_actor_options,
                          route_prefix=route_prefix,
                          autoscaling_config=autoscaling_config)
    if _target is not None:
        return deco(_target)
    return deco


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 422: "Unprocessable Entity",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}


class HTTPResponse:
    """Deployment return value carrying an explicit status code
    (reference: starlette JSONResponse(status_code=...) returns from
    Serve ingress deployments).  body: dict/list (JSON), str, or
    bytes.  `headers` adds extra response headers (e.g. Retry-After on
    a 429)."""

    def __init__(self, status: int, body, content_type: str = None,
                 headers: Optional[Dict[str, str]] = None):
        self.status = int(status)
        self.body = body
        self.content_type = content_type
        self.headers = dict(headers or {})

    def render(self):
        reason = _REASONS.get(self.status, "Status")
        status = f"{self.status} {reason}"
        if isinstance(self.body, bytes):
            return status, self.body, (self.content_type
                                       or "application/octet-stream"), \
                self.headers
        if isinstance(self.body, str):
            return status, self.body.encode(), (self.content_type
                                                or "text/plain"), \
                self.headers
        return (status, json.dumps(self.body).encode(),
                self.content_type or "application/json", self.headers)


class StreamingResponse:
    """Marker an ingress returns to stream a generator call over chunked
    HTTP (SSE when content_type is text/event-stream): the caller
    dispatches ``method`` on the same ingress with ``args``/``kwargs`` and
    writes each yielded str/bytes item as one chunk. Closing that
    generator early (a client disconnect) cancels the request typed; on
    the LLM path its KV pages return to the pool mid-decode.

    A plain data carrier: everything the stream needs rides its args."""

    def __init__(self, method: str, args: tuple = (), kwargs: dict = None,
                 *, content_type: str = "text/event-stream",
                 headers: Optional[Dict[str, str]] = None,
                 backpressure: int = 8):
        self.method = method
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.content_type = content_type
        self.headers = dict(headers or {})
        self.backpressure = int(backpressure)


class Request:
    """What an ingress's __call__ receives for an HTTP request (a plain
    object, not ASGI: no starlette dependency)."""

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return json.loads(self.body or b"null")
