"""Experimental APIs: device-resident object transport.

Port of ray_tpu/experimental/__init__.py to torch tensors: a tensor lives
in its producer's device object store and moves peer to peer, never
through a third process:

  * same store: zero transfer: device_get returns the resident tensor;
  * another store: the owner stages the tensor's bytes in 64 MiB chunks
    (``serve_fetch``), each one device->host copy, and the getter uploads
    them once onto its store's device;
  * inside one torch.distributed world, bulk data should move by NCCL
    collectives (``ray_tpu_torch.collective``): this API is for the
    out-of-band actor plane.

    ref = device_put(tensor, owner)          # producer
    ...pass `ref` along (it pickles small)...
    t = device_get(ref, consumer)            # consumer
    device_free(ref, consumer)               # owner memory released

The reference's core worker (its address, its ``device_objects`` table and
its ``device_fetch``/``device_free`` RPCs) is runtime code. Here a
``DeviceObjectStore`` holds the address and the table, and takes the RPCs
as callbacks: ``fetch(owner_addr, object_id, offset)`` returns the owner's
``serve_fetch`` reply (or None once the object is freed) and
``free(owner_addr, object_id)`` calls the owner's ``serve_free``, by
whatever transport the caller has. bf16 travels as raw bytes with its
dtype name; neither ml_dtypes nor a runtime is needed.
"""

from __future__ import annotations

import dataclasses
import logging
import secrets
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from .._device import resolve_device
from .._private import device_plane

__all__ = ["DeviceRef", "DeviceObjectStore", "device_put", "device_get",
           "device_free", "device_transport_stats", "serve_fetch",
           "serve_free"]

logger = logging.getLogger("ray_tpu_torch.experimental")

# One reply carries at most this many bytes (the reference's
# CoreWorker._DEVICE_CHUNK): multi-GB tensors stay under a frame cap.
DEVICE_CHUNK = 64 * 1024 * 1024
OBJECT_ID_BYTES = 20          # the reference's ObjectID.SIZE

# Measured cost model of the host-staging hop: every remote device_get
# records bytes and wall seconds; once cumulative staged bytes cross
# _ADVISE_BYTES the module warns ONCE with the measured GiB/s.
_ADVISE_BYTES = 256 * 1024 * 1024
_stats_lock = threading.Lock()
_stats: Dict[str, float] = {
    "puts": 0, "gets_local": 0, "gets_remote": 0,
    "bytes_staged": 0.0, "seconds_staged": 0.0,
}
_advised = False


def device_transport_stats() -> Dict[str, float]:
    """Cost model of the out-of-graph transport: put/get counts plus the
    measured host-staging volume and rate. `staged_gib_s` is the observed
    device->host->wire->device rate: compare it with the NCCL collectives'
    (``ray_tpu_torch.collective``) on the same cards to decide when data
    movement belongs there instead of on this path."""
    with _stats_lock:
        out = dict(_stats)
    secs = out.pop("seconds_staged")
    out["staged_gib_s"] = (out["bytes_staged"] / (1 << 30) / secs
                          if secs > 0 else 0.0)
    return out


def _record_staged(nbytes: int, seconds: float) -> None:
    global _advised
    with _stats_lock:
        _stats["gets_remote"] += 1
        _stats["bytes_staged"] += nbytes
        _stats["seconds_staged"] += seconds
        total = _stats["bytes_staged"]
        advise = total >= _ADVISE_BYTES and not _advised
        if advise:
            _advised = True
    if advise:
        s = device_transport_stats()
        logger.warning(
            "device-object transport has staged %.1f MiB through host "
            "memory at %.2f GiB/s; for repeated bulk movement between "
            "ranks of one torch.distributed world, prefer the NCCL "
            "collectives of ray_tpu_torch.collective (send/recv, "
            "broadcast), which move device to device",
            s["bytes_staged"] / (1 << 20), s["staged_gib_s"])


@dataclasses.dataclass(frozen=True)
class DeviceRef:
    """Wire handle to a device-resident tensor. Pickles in ~100 bytes
    regardless of the tensor's size."""
    object_id: bytes
    owner_addr: Tuple[str, int]
    shape: Tuple[int, ...]
    dtype: str


class DeviceObjectStore:
    """One process's (or actor's) device objects: its ``address``, the
    ``device_objects`` table {object_id: tensor}, the ``device`` that
    ``device_put`` and remote gets land on ("cuda" unless the caller asks
    for the CPU), and the two RPCs to other owners as callbacks (see the
    module docstring)."""

    def __init__(self, address: Tuple[str, int], *,
                 fetch: Optional[Callable] = None,
                 free: Optional[Callable] = None, device="cuda"):
        self.address = tuple(address)
        self.device = resolve_device(device)
        self.device_objects: Dict[bytes, torch.Tensor] = {}
        self.fetch = fetch
        self.free = free

    def _remote(self, name: str) -> Callable:
        fn = getattr(self, name)
        if fn is None:
            raise RuntimeError(f"this DeviceObjectStore has no {name} "
                               "callback to reach another owner")
        return fn


def device_put(array, store: DeviceObjectStore) -> DeviceRef:
    """Pin a tensor (or anything ``torch.as_tensor`` takes) in ``store``
    and return a tiny transferable handle. A tensor is kept as it is,
    wherever it lies; anything else lands on the store's device."""
    arr = (array if isinstance(array, torch.Tensor)
           else torch.as_tensor(array, device=store.device))
    oid = secrets.token_bytes(OBJECT_ID_BYTES)
    store.device_objects[oid] = arr
    with _stats_lock:
        _stats["puts"] += 1
    return DeviceRef(oid, store.address, tuple(arr.shape),
                     device_plane.dtype_name(arr.dtype))


def device_get(ref: DeviceRef, store: DeviceObjectStore, *,
               timeout: Optional[float] = 60.0) -> torch.Tensor:
    """Resolve a DeviceRef to a tensor on ``store``'s device. Owner-local
    gets are free; remote gets stage through the owner's host once, chunk
    by chunk through ``store.fetch``. Raises KeyError if the object was
    freed, TimeoutError if the chunks take longer than ``timeout``
    seconds in all."""
    if tuple(ref.owner_addr) == store.address:
        arr = store.device_objects.get(ref.object_id)
        if arr is None:
            raise KeyError("device object was freed")
        with _stats_lock:
            _stats["gets_local"] += 1
        return arr
    fetch = store._remote("fetch")
    t0 = time.perf_counter()
    host, offset = None, 0
    while True:
        res = fetch(tuple(ref.owner_addr), ref.object_id, offset)
        if res is None:
            raise KeyError("device object was freed at the owner")
        if host is None:
            host = bytearray(res["total"])
        n = len(res["data"])
        host[offset:offset + n] = res["data"]
        offset += n
        if offset >= res["total"]:
            break
        if timeout is not None and time.perf_counter() - t0 > timeout:
            raise TimeoutError(
                f"device_get: {offset} of {res['total']} bytes in "
                f"{timeout} s")
    out = torch.empty(tuple(res["shape"]),
                      dtype=device_plane.torch_dtype(res["dtype"]),
                      device=store.device)
    if host:
        # One blocking upload of the raw bytes (bf16 included).
        out.reshape(-1).view(torch.uint8).copy_(
            torch.frombuffer(host, dtype=torch.uint8))
    _record_staged(len(host), time.perf_counter() - t0)
    device_plane.record_h2d(len(host))   # unified copy audit
    return out


def device_free(ref: DeviceRef, store: DeviceObjectStore) -> None:
    """Release the owner's pinned tensor (idempotent)."""
    if tuple(ref.owner_addr) == store.address:
        store.device_objects.pop(ref.object_id, None)
        return
    store._remote("free")(tuple(ref.owner_addr), ref.object_id)


def serve_fetch(store: DeviceObjectStore, object_id: bytes,
                offset: int = 0) -> Optional[dict]:
    """The owner's side of a remote get (the reference's
    ``CoreWorker.h_device_fetch``): the chunk of the object's bytes at
    ``offset``, at most DEVICE_CHUNK of them, as {"data", "total",
    "offset", "dtype", "shape"}; None once the object is freed. Each call
    stages only its chunk, one device->host copy, counted by
    ``record_d2h``."""
    entry = store.device_objects.get(object_id)
    if entry is None:
        return None
    flat = entry.detach().contiguous().reshape(-1).view(torch.uint8)
    total = flat.numel()
    chunk = flat[offset:offset + DEVICE_CHUNK].cpu().numpy().tobytes()
    device_plane.record_d2h(len(chunk))
    return {"data": chunk, "total": total, "offset": offset,
            "dtype": device_plane.dtype_name(entry.dtype),
            "shape": list(entry.shape)}


def serve_free(store: DeviceObjectStore, object_id: bytes) -> bool:
    """The owner's side of a remote free (``CoreWorker.h_device_free``)."""
    store.device_objects.pop(object_id, None)
    return True
