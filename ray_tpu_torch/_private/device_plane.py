"""Device data plane: device tensors as first-class payloads.

Port of ray_tpu/_private/device_plane.py to torch tensors, with the same
names. A payload's device leaves are ``torch.Tensor``s, CPU tensors
included (as the reference counts a ``jax.Array`` on its CPU backend), and
they move along a transport ladder:

  rung 0 (same process): the producer registers the live tensors in an
      in-process table and ships only an 8-byte token and the specs; the
      consumer takes the very same tensors (same ``data_ptr``). No host
      bytes. On a CUDA device the registry records an event on the
      producer's current stream and ``take_local`` makes the consumer's
      current stream wait on it, so a consumer on another thread or stream
      never reads a tensor before it is written.
  rung 1 (across processes): the serializer (``_private.serialization``)
      stages each tensor exactly once. A host view of its bytes travels as
      a pickle-5 out-of-band buffer straight into the destination buffer
      (``write_parts_into``), and the far side uploads it with one blocking
      copy onto the landing device (``set_landing_device``). One host copy
      each way, pinned by the copy audit below.

The host view of a contiguous CPU tensor aliases the tensor (bf16 and every
other dtype alike: the view is of its bytes). A CUDA tensor has no
host-addressable buffer, so its view is one device-to-host copy into pinned
host memory, and a non-contiguous tensor first pays a ``.contiguous()``
copy; both count under ``device_fallback_bytes``, as the reference counts
an array that could not export a zero-copy host view.

Copy audit: ``device_to_host_bytes`` / ``host_to_device_bytes`` are stamped
at every transfer seam. The port has no metrics registry: a callback given
to ``set_metrics_counter`` receives each increment under the reference's
metric names (``METRICS``).

Dtypes and platforms are named as the reference names them (numpy's dtype
names, ``"bfloat16"`` included; ``"gpu:1"`` for a CUDA tensor, ``"cpu:1"``
for a CPU one), so specs compare equal across the two packages. Neither
``ml_dtypes`` nor any runtime module is needed.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device

logger = logging.getLogger("ray_tpu_torch.device_plane")

# -- copy audit ---------------------------------------------------------------

_audit_lock = threading.Lock()
_audit = {
    "device_to_host_bytes": 0,   # staging copies: device buffer -> host view
    "host_to_device_bytes": 0,   # uploads: host view -> device buffer
    "device_fallback_bytes": 0,  # subset of d2h that paid an EXTRA copy
    "device_arrays_staged": 0,
    "device_arrays_local": 0,    # rung-0 handoffs (no bytes moved)
}

# Audit key -> (metric name, description), the reference's metrics.
METRICS = {
    "device_to_host_bytes": ("ray_tpu_device_to_host_bytes_total",
                             "device->host staging bytes (copy audit)"),
    "host_to_device_bytes": ("ray_tpu_host_to_device_bytes_total",
                             "host->device upload bytes (copy audit)"),
    "device_fallback_bytes": (
        "ray_tpu_device_staging_fallback_bytes_total",
        "device staging bytes that paid an extra materialization "
        "(non-contiguous / unaddressable)"),
}

_counter: List[Optional[Callable[[str, str, int], None]]] = [None]


def set_metrics_counter(inc: Optional[Callable[[str, str, int], None]]):
    """Route the audit's byte counts to a metrics registry: ``inc(name,
    description, nbytes)`` is called on every increment of a key of
    ``METRICS``. None (the default) counts only in this module."""
    _counter[0] = inc


def _record(key: str, nbytes: int, count_key: Optional[str] = None):
    with _audit_lock:
        _audit[key] += nbytes
        if count_key:
            _audit[count_key] += 1
    inc = _counter[0]
    if inc is not None and key in METRICS:
        try:
            inc(*METRICS[key], nbytes)
        except Exception:
            # A metrics sink must never break the data path.
            logger.debug("metrics counter failed", exc_info=True)


def device_copy_stats() -> dict:
    """Snapshot of the device copy-audit counters for this process."""
    with _audit_lock:
        return dict(_audit)


def record_d2h(nbytes: int) -> None:
    """Audit a device->host copy made OUTSIDE the serializer (explicit
    host-staging downgrades, e.g. the engine's host-staged KV path): every
    transfer seam counts, not just the automatic ones."""
    _record("device_to_host_bytes", int(nbytes))


def record_h2d(nbytes: int) -> None:
    """Audit a host->device upload made outside the serializer."""
    _record("host_to_device_bytes", int(nbytes))


def _reset_copy_stats():
    """Test helper: zero the audit so deltas can be asserted exactly."""
    with _audit_lock:
        for k in _audit:
            _audit[k] = 0


# -- dtypes -------------------------------------------------------------------

# torch dtype <-> the numpy name the reference prints (str(arr.dtype)).
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def dtype_name(dtype) -> str:
    """The numpy name of a torch dtype, a numpy dtype or a dtype name
    ("bfloat16" needs no ml_dtypes)."""
    if isinstance(dtype, torch.dtype):
        return _DTYPE_NAMES[dtype]
    if isinstance(dtype, str) and dtype in _DTYPES:
        return dtype
    return np.dtype(dtype).name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"no torch dtype for {name!r}") from None


def host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(a host numpy array of ``t``'s bits, ``t``'s dtype name). A CPU
    tensor's array aliases it; a device tensor pays one blocking
    device->host copy. numpy has no bfloat16 without ml_dtypes, so a bf16
    tensor comes back as its int16 bit pattern, and the name says how to
    read it (``from_host_array``)."""
    name = dtype_name(t.dtype)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def from_host_array(a: np.ndarray, name: Optional[str],
                    device: torch.device) -> torch.Tensor:
    """A host array on ``device`` as the dtype ``name`` (the array's own
    when None), bit for bit: the inverse of ``host_array``. An ml_dtypes
    bfloat16 array is read by its bits too."""
    a = np.asarray(a)
    name = name or a.dtype.name
    if not a.flags.writeable:
        a = a.copy()              # torch tensors are writable
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype.name != name:
        raise TypeError(f"a {a.dtype.name} array read as {name}")
    return torch.from_numpy(a).to(device)


# -- leaf detection -----------------------------------------------------------

def is_device_array(x) -> bool:
    """A device leaf: any ``torch.Tensor`` (CPU tensors included)."""
    return isinstance(x, torch.Tensor)


def _platform(t: torch.Tensor) -> str:
    return "gpu" if t.device.type == "cuda" else t.device.type


# -- specs --------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceArraySpec:
    """Negotiable description of a device-tensor payload: what crosses a
    DAG edge is this spec; the bytes ride the ladder."""
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    sharding: str  # fingerprint: platform + participating-device count

    @classmethod
    def of(cls, arr) -> "DeviceArraySpec":
        return cls(dtype=dtype_name(arr.dtype), shape=tuple(arr.shape),
                   nbytes=arr.numel() * arr.element_size(),
                   sharding=f"{_platform(arr)}:1")

    def compatible(self, other: "DeviceArraySpec") -> bool:
        return (self.dtype == other.dtype and self.shape == other.shape)


def spec_of(x) -> Optional[DeviceArraySpec]:
    return DeviceArraySpec.of(x) if is_device_array(x) else None


def _norm_spec(s):
    """A declared payload spec: a DeviceArraySpec as it is, or a (shape,
    dtype) tuple (dtype a name, a numpy or a torch dtype) with any
    sharding (the port of ray_tpu/dag/__init__.py's ``_norm_spec``)."""
    if isinstance(s, DeviceArraySpec):
        return s
    if isinstance(s, tuple) and len(s) == 2:
        shape, dtype = s
        name = dtype_name(dtype)
        n = 1
        for d in shape:
            n *= int(d)
        return DeviceArraySpec(dtype=name, shape=tuple(shape),
                               nbytes=n * torch_dtype(name).itemsize,
                               sharding="any")
    raise TypeError(
        "device payload spec must be a DeviceArraySpec or a "
        f"(shape, dtype) tuple, got {type(s).__name__}")


def validate_against_spec(value, spec: dict, where: str = "?"):
    """Step-time guard for a stage's DECLARED output spec: every device
    leaf of `value` must match the promised shape/dtype."""
    from ..exceptions import DeviceSpecMismatchError
    want_shape = tuple(spec["shape"])
    want_dtype = spec["dtype"]

    def check(arr):
        got = dtype_name(arr.dtype)
        if tuple(arr.shape) != want_shape or got != want_dtype:
            raise DeviceSpecMismatchError(
                f"stage {where!r} produced a device array of "
                f"shape={tuple(arr.shape)} dtype={got}, but its "
                f"declared payload spec is shape={want_shape} "
                f"dtype={want_dtype}")
        return arr

    _map_device_leaves(value, check)


# -- host staging (rung 1) ----------------------------------------------------

def _host_view(arr: torch.Tensor) -> Tuple[np.ndarray, bool]:
    """A flat uint8 host array of `arr`'s bytes. Returns (view,
    zero_copy): zero_copy=True means the view ALIASES the tensor (a
    contiguous CPU tensor: the destination memcpy is then the only copy);
    False means it had to be materialized (a CUDA tensor, copied into
    pinned host memory; a non-contiguous one), counted as
    `device_fallback_bytes`. The CUDA copy is blocking: the bytes exist
    when the pickler takes the view."""
    arr = arr.detach()
    zero_copy = arr.device.type == "cpu" and arr.is_contiguous()
    if arr.device.type != "cpu":
        host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
        host.copy_(arr)
        arr = host
    elif not zero_copy:
        arr = arr.contiguous()
    return arr.reshape(-1).view(torch.uint8).numpy(), zero_copy


class _DeviceLeaf:
    """Serialize-side wrapper substituted for a tensor leaf: pickles as
    (spec, PickleBuffer over a host view) so the payload bytes travel
    out-of-band and land in the destination with exactly one memcpy."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr

    def __reduce_ex__(self, protocol):
        arr = self.arr
        view, zero_copy = _host_view(arr)
        nbytes = int(view.nbytes)
        _record("device_to_host_bytes", nbytes, "device_arrays_staged")
        if not zero_copy:
            _record("device_fallback_bytes", nbytes)
        spec = DeviceArraySpec.of(arr)
        return (_rebuild_device_array,
                (spec, pickle.PickleBuffer(view)))


_tls = threading.local()


def set_landing_device(device) -> None:
    """Where this thread's deserializer rebuilds device leaves: "cuda" (the
    default; raises without a GPU), "cuda:N" or "cpu". Never falls back."""
    _tls.landing = resolve_device(device)


def _landing_device() -> torch.device:
    return resolve_device(getattr(_tls, "landing", "cuda"))


def _rebuild_device_array(spec: DeviceArraySpec, buf):
    """Deserialize-side reconstructor: one blocking upload from the
    (possibly arena-backed) buffer onto the landing device; no
    intermediate host copy, and nothing aliases the buffer after it
    returns."""
    device = _landing_device()
    out = torch.empty(spec.shape, dtype=torch_dtype(spec.dtype),
                      device=device)
    nbytes = out.numel() * out.element_size()
    if nbytes:
        with warnings.catch_warnings():
            # A read-only buffer (bytes, an arena view) is only read here,
            # and copied from before this returns.
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes)
        out.reshape(-1).view(torch.uint8).copy_(src)
    _record("host_to_device_bytes", nbytes)
    _notice_rebuilt(nbytes)
    return out


# -- container walking --------------------------------------------------------

_MAX_DEPTH = 8


def _map_device_leaves(value, fn: Callable, depth: int = _MAX_DEPTH):
    """Rebuild `value` with every tensor leaf replaced by fn(leaf).
    Containers (list/tuple/dict) are walked to a bounded depth; other
    objects pass through untouched (a custom object hiding a tensor falls
    back to torch's own pickle path).  Returns (new, hits)."""
    if is_device_array(value):
        return fn(value), 1
    if depth <= 0:
        return value, 0
    if type(value) is list:
        hits, out = 0, []
        for v in value:
            nv, h = _map_device_leaves(v, fn, depth - 1)
            out.append(nv)
            hits += h
        return (out if hits else value), hits
    if type(value) is tuple:
        hits, out = 0, []
        for v in value:
            nv, h = _map_device_leaves(v, fn, depth - 1)
            out.append(nv)
            hits += h
        return (tuple(out) if hits else value), hits
    if type(value) is dict:
        hits, out = 0, {}
        for k, v in value.items():
            nv, h = _map_device_leaves(v, fn, depth - 1)
            out[k] = nv
            hits += h
        return (out if hits else value), hits
    return value, 0


def has_device_leaves(value) -> bool:
    _, hits = _map_device_leaves(value, lambda a: a)
    return hits > 0


def swap_device_leaves(value) -> Tuple[Any, int]:
    """Serializer pre-pass: substitute `_DeviceLeaf` wrappers so device
    bytes travel out-of-band (one copy).  Returns (value', n_leaves)."""
    return _map_device_leaves(value, _DeviceLeaf)


def split_device_leaves(value):
    """Rung-0 encode: extract the live tensors.  Returns
    (skeleton, leaves, specs) where skeleton has `_LeafRef(i)` markers."""
    leaves: List[Any] = []
    specs: List[DeviceArraySpec] = []

    def grab(arr):
        leaves.append(arr)
        specs.append(DeviceArraySpec.of(arr))
        return _LeafRef(len(leaves) - 1)

    skeleton, _ = _map_device_leaves(value, grab)
    return skeleton, leaves, specs


@dataclass(frozen=True)
class _LeafRef:
    """Placeholder for a device leaf travelling out of band (rung 0)."""
    index: int


def join_device_leaves(skeleton, leaves):
    def back(v, depth=_MAX_DEPTH):
        if isinstance(v, _LeafRef):
            return leaves[v.index]
        if depth <= 0:
            return v
        if type(v) is list:
            return [back(x, depth - 1) for x in v]
        if type(v) is tuple:
            return tuple(back(x, depth - 1) for x in v)
        if type(v) is dict:
            return {k: back(x, depth - 1) for k, x in v.items()}
        return v
    return back(skeleton)


# -- deserialize-from-view safety --------------------------------------------

def detach_host_leaves(value, source: memoryview):
    """After deserializing DIRECTLY from an arena view (so device leaves
    upload straight from it), any host ndarray leaves still alias the
    view; copy them out so the view can be released. Rebuilt tensors never
    alias it (``_rebuild_device_array`` copies)."""
    base = np.frombuffer(source, np.uint8)
    lo = base.ctypes.data
    hi = lo + base.nbytes

    def aliases(v) -> bool:
        b = v
        while b.base is not None and isinstance(b.base, np.ndarray):
            b = b.base
        try:
            ptr = b.__array_interface__["data"][0]
        except Exception:
            return False
        return lo <= ptr < hi

    def walk(v, depth=_MAX_DEPTH):
        if isinstance(v, np.ndarray):
            return v.copy() if aliases(v) else v
        if depth <= 0:
            return v
        if type(v) is list:
            return [walk(x, depth - 1) for x in v]
        if type(v) is tuple:
            return tuple(walk(x, depth - 1) for x in v)
        if type(v) is dict:
            return {k: walk(x, depth - 1) for k, x in v.items()}
        return v
    return walk(value)


# -- serialize/deserialize notices (TLS) -------------------------------------

def _notice_rebuilt(nbytes: int):
    _tls.rebuilt_bytes = getattr(_tls, "rebuilt_bytes", 0) + nbytes
    _tls.rebuilt_n = getattr(_tls, "rebuilt_n", 0) + 1


def take_rebuilt_notice() -> Tuple[int, int]:
    """(n_leaves, bytes) of device tensors rebuilt by THIS thread since the
    last call."""
    n = getattr(_tls, "rebuilt_n", 0)
    b = getattr(_tls, "rebuilt_bytes", 0)
    _tls.rebuilt_n = 0
    _tls.rebuilt_bytes = 0
    return n, b


def note_staged_leaves(n: int):
    _tls.staged_n = getattr(_tls, "staged_n", 0) + n


def take_staged_notice() -> int:
    n = getattr(_tls, "staged_n", 0)
    _tls.staged_n = 0
    return n


# -- rung-0 in-process registry ----------------------------------------------

MAGIC_LOCAL = b"\xffRTDVL\x00\x01"   # 8B: local-token device message
MAGIC_STAGED = b"\xffRTDVS\x00\x01"  # 8B: staged payload, in-place decode ok

_local_lock = threading.Lock()
_local: dict = {}        # token -> [leaves, remaining_takes, cuda events]
_local_seq = [0]


def _made_events(leaves) -> list:
    """One event per CUDA device of ``leaves``, recorded on that device's
    current stream: where the producer's writes to them end."""
    events = []
    for dev in dict.fromkeys(t.device for t in leaves
                             if t.device.type == "cuda"):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append((dev, ev))
    return events


def register_local(leaves: List[Any], nreaders: int) -> bytes:
    """Park live device tensors for same-process consumers; the ring
    carries only the returned 8-byte token.  Refcounted by reader."""
    events = _made_events(leaves)
    with _local_lock:
        _local_seq[0] += 1
        token = struct.pack("<II", os.getpid() & 0xFFFFFFFF,
                            _local_seq[0] & 0xFFFFFFFF)
        _local[token] = [leaves, max(1, int(nreaders)), events]
    with _audit_lock:
        _audit["device_arrays_local"] += len(leaves)
    return token


def take_local(token: bytes) -> List[Any]:
    """The tensors registered under ``token``. On a CUDA device the
    calling thread's current stream first waits for the producer's."""
    with _local_lock:
        ent = _local.get(token)
        if ent is None:
            raise KeyError(f"device-local token {token!r} not registered "
                           "(producer restarted or token already drained)")
        ent[1] -= 1
        if ent[1] <= 0:
            del _local[token]
    for dev, ev in ent[2]:
        torch.cuda.current_stream(dev).wait_event(ev)
    return ent[0]


def local_registry_size() -> int:
    with _local_lock:
        return len(_local)


def drop_local(token: bytes):
    """Unconditionally forget a token (producer-side cleanup on serve
    loop exit; missing tokens — already drained — are a no-op)."""
    with _local_lock:
        _local.pop(token, None)


def local_is_registered(token: bytes) -> bool:
    with _local_lock:
        return token in _local


# -- DAG body encode/decode ---------------------------------------------------

def dag_encode_body(ctx, status: bytes, value, local_ok: bool,
                    nreaders: int):
    """Build a DAG message body as a parts list ([status, ...]); ``ctx`` is
    any object with ``serialize`` (normally ``serialization.get_context()``).

    rung 0 (local_ok, device leaves present): the ring carries
    MAGIC_LOCAL + (token, skeleton, specs): the tensors never leave the
    device.  Returns (parts, token) so the producer can reclaim the
    registry entry if the pipeline tears down before consumers drain it.

    rung 1 (device leaves crossing processes): MAGIC_STAGED marks the
    payload as safe to decode IN PLACE from the arena view (device
    leaves upload straight from it; host leaves are detached).

    Plain host payloads keep the unmarked wire form."""
    if local_ok and has_device_leaves(value):
        skeleton, leaves, specs = split_device_leaves(value)
        token = register_local(leaves, nreaders)
        ser = ctx.serialize((token, skeleton,
                             [s.__dict__ for s in specs]))
        return [status, MAGIC_LOCAL, *ser], token
    take_staged_notice()                    # drain stale notices
    ser = ctx.serialize(value)
    if take_staged_notice():
        return [status, MAGIC_STAGED, *ser], None
    return [status, *ser], None


def dag_decode_body(ctx, body):
    """Decode a DAG message body (its first byte is the status). `body`
    may be bytes (inline) or a pinned arena view: the caller releases it
    AFTER this returns; no reference into the view survives (the uploads
    are blocking, and host leaves are copied out)."""
    payload = memoryview(body)[1:]
    if payload[:8] == MAGIC_LOCAL:
        token, skeleton, _specs = ctx.deserialize(payload[8:])
        return join_device_leaves(skeleton, take_local(token))
    if payload[:8] == MAGIC_STAGED:
        v = ctx.deserialize(payload[8:])
        return detach_host_leaves(v, payload)
    if not isinstance(body, (bytes, bytearray)):
        # Unmarked spilled payload: preserve the copy-out discipline —
        # host ndarray leaves may alias the view as pickle-5 buffers.
        payload = memoryview(bytes(payload))
    return ctx.deserialize(payload)
