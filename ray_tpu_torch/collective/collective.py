"""Collective communication groups over processes.

Port of ray_tpu/collective/collective.py: the same groups, ops and
module-level API, on the port's substrates.

- "host" (``HostCollectiveGroup``, a copy): numpy collectives rendezvoused
  through a key-value store, each op a (group, seq) round in which members
  publish their contributions and read their peers'. The reference's
  store is the GCS KV of its runtime (its ``_KV``); here it is an object
  the caller passes, with ``put``, ``get``, ``wait``, ``delete`` and
  ``delete_prefix`` (``DictKV`` for threads of one process, ``StoreKV``
  over a ``torch.distributed.Store``). The port calls no runtime.
- "nccl" and "gloo" (``TorchCollectiveGroup``, the counterpart of the
  reference's "xla" ``XlaCollectiveGroup``): the ops over a
  ``torch.distributed`` group, NCCL for CUDA tensors and gloo for CPU
  ones. Like the "xla" group it needs a formed world of ``world_size``
  processes (the Train backend, ``train.backend.TorchConfig``, forms
  one). The reference's "gloo" is another name for its host group; the
  port's "gloo" is torch's.

Collective calls must be issued in the same order by every member of a
group, as NCCL requires.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import all_gather_single, reduce_scatter_single

_POLL_S = 0.002


class DictKV:
    """A key-value store in one process's memory, for the host groups of
    threads (the tests' stand-in for the GCS KV)."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._cond = threading.Condition()

    def put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        with self._cond:
            if not overwrite and key in self._data:
                return False
            self._data[key] = value
            self._cond.notify_all()
            return True

    def get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._data.get(key)

    def wait(self, key: str, timeout: float) -> bytes:
        with self._cond:
            if not self._cond.wait_for(lambda: key in self._data, timeout):
                raise TimeoutError(f"collective rendezvous timed out on "
                                   f"{key!r}")
            return self._data[key]

    def delete(self, key: str) -> bool:
        with self._cond:
            return self._data.pop(key, None) is not None

    def delete_prefix(self, prefix: str) -> int:
        with self._cond:
            keys = [k for k in self._data if k.startswith(prefix)]
            for k in keys:
                del self._data[k]
            return len(keys)


class StoreKV:
    """The key-value interface over a ``torch.distributed.Store`` (a
    ``TCPStore`` or ``FileStore`` that every member reaches). A store
    cannot list its keys, so ``delete_prefix`` deletes the keys under the
    prefix that this process wrote or read; the others go with the
    store."""

    def __init__(self, store):
        self.store = store
        self._seen: set = set()

    def put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        if not overwrite and self.store.check([key]):
            return False
        self.store.set(key, value)
        self._seen.add(key)
        return True

    def get(self, key: str) -> Optional[bytes]:
        if not self.store.check([key]):
            return None
        self._seen.add(key)
        return self.store.get(key)

    def wait(self, key: str, timeout: float) -> bytes:
        deadline = time.monotonic() + timeout
        poll = _POLL_S
        while True:
            v = self.get(key)
            if v is not None:
                return v
            if time.monotonic() > deadline:
                raise TimeoutError(f"collective rendezvous timed out on "
                                   f"{key!r}")
            time.sleep(poll)
            poll = min(poll * 1.5, 0.05)

    def delete(self, key: str) -> bool:
        self._seen.discard(key)
        return self.store.delete_key(key)

    def delete_prefix(self, prefix: str) -> int:
        keys = [k for k in self._seen if k.startswith(prefix)]
        for k in keys:
            self.delete(k)
        return len(keys)


REDUCE_OPS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "product": lambda arrs: np.prod(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
}


class HostCollectiveGroup:
    """KV-rendezvous collectives for host (numpy) data, through ``kv``."""

    def __init__(self, group_name: str, world_size: int, rank: int, kv,
                 timeout_s: float = 60.0):
        self.name = group_name
        self.world_size = world_size
        self.rank = rank
        self.kv = kv
        self.timeout_s = timeout_s
        self._seq = 0
        self._p2p_seq: Dict[tuple, int] = {}

    # ------------------------------------------------------------ internals

    def _round(self, payload: bytes, op_tag: str) -> List[bytes]:
        """All-to-all publish + collect for one collective round."""
        self._seq += 1
        base = f"{self.name}/{self._seq}/{op_tag}"
        self.kv.put(f"{base}/{self.rank}", payload)
        out = []
        for r in range(self.world_size):
            out.append(payload if r == self.rank else
                       self.kv.wait(f"{base}/{r}", self.timeout_s))
        # Round N-2 is globally complete once every rank entered round N
        # (all contributions for N are only written after N-1 was read by
        # that rank), so lag-2 cleanup never races slow readers.
        if self.rank == 0 and self._seq >= 3:
            self.kv.delete_prefix(f"{self.name}/{self._seq - 2}/")
        return out

    # ------------------------------------------------------------------ ops

    def allreduce(self, tensor: np.ndarray, op: str = "sum") -> np.ndarray:
        parts = self._round(pickle.dumps(np.asarray(tensor)), "ar")
        return REDUCE_OPS[op]([pickle.loads(p) for p in parts])

    def reduce(self, tensor: np.ndarray, dst_rank: int = 0,
               op: str = "sum") -> np.ndarray:
        """Binomial-tree reduce toward dst_rank: each rank reads at most
        log2(W) partials and writes one."""
        if self.world_size == 1:
            return np.asarray(tensor)
        self._seq += 1
        base = f"{self.name}/{self._seq}/rd"
        acc = np.asarray(tensor)
        # Virtual ranks place dst at 0 so the standard binomial recursion
        # roots there.
        vr = (self.rank - dst_rank) % self.world_size
        mask = 1
        while mask < self.world_size:
            if vr & mask:
                # Leaf for this level: ship the partial up and stop
                # combining.
                self.kv.put(f"{base}/{self.rank}", pickle.dumps(acc))
                break
            child_vr = vr + mask
            if child_vr < self.world_size:
                child = (child_vr + dst_rank) % self.world_size
                part = pickle.loads(
                    self.kv.wait(f"{base}/{child}", self.timeout_s))
                acc = REDUCE_OPS[op]([acc, part])
            mask <<= 1
        if vr == 0:
            out = acc
            # Completion marker: non-dst ranks block on it, which keeps
            # all ranks in lockstep rounds and proves every rank wrote
            # this round before anyone advances (the lag-2 cleanup's
            # precondition).
            self.kv.put(f"{base}/done", b"1")
        else:
            self.kv.wait(f"{base}/done", self.timeout_s)
            out = np.asarray(tensor)
        if self.rank == 0 and self._seq >= 3:
            self.kv.delete_prefix(f"{self.name}/{self._seq - 2}/")
        return out

    def allgather(self, tensor: np.ndarray) -> List[np.ndarray]:
        parts = self._round(pickle.dumps(np.asarray(tensor)), "ag")
        return [pickle.loads(p) for p in parts]

    def broadcast(self, tensor: np.ndarray,
                  src_rank: int = 0) -> np.ndarray:
        self._seq += 1
        base = f"{self.name}/{self._seq}/bc"
        if self.rank == src_rank:
            self.kv.put(f"{base}/src", pickle.dumps(np.asarray(tensor)))
            out = np.asarray(tensor)
        else:
            out = pickle.loads(self.kv.wait(f"{base}/src", self.timeout_s))
        # confirmation half-round so src can't race ahead and delete
        self._round(b"", "bc_ack")
        return out

    def reducescatter(self, tensor: np.ndarray,
                      op: str = "sum") -> np.ndarray:
        """Chunked reduce-scatter: rank r publishes chunk j of its local
        tensor to rank j and reads only chunk r from each peer."""
        x = np.asarray(tensor)
        w = self.world_size
        if w == 1:
            return x
        self._seq += 1
        base = f"{self.name}/{self._seq}/rs"
        chunks = np.array_split(x, w, axis=0)
        for j in range(w):
            if j != self.rank:
                self.kv.put(f"{base}/{self.rank}-{j}",
                            pickle.dumps(chunks[j]))
        mine = [chunks[self.rank]]
        for r in range(w):
            if r != self.rank:
                mine.append(pickle.loads(
                    self.kv.wait(f"{base}/{r}-{self.rank}", self.timeout_s)))
        # Symmetric round (every rank reads a write from every peer), so
        # the same lag-2 cleanup argument as _round applies.
        if self.rank == 0 and self._seq >= 3:
            self.kv.delete_prefix(f"{self.name}/{self._seq - 2}/")
        return REDUCE_OPS[op](mine)

    def barrier(self) -> None:
        self._round(b"", "bar")

    def send(self, tensor: np.ndarray, dst_rank: int) -> None:
        key = (self.rank, dst_rank)
        self._p2p_seq[key] = self._p2p_seq.get(key, 0) + 1
        self.kv.put(f"{self.name}/p2p/{self.rank}-{dst_rank}/"
                    f"{self._p2p_seq[key]}",
                    pickle.dumps(np.asarray(tensor)))

    def recv(self, src_rank: int) -> np.ndarray:
        key = (src_rank, self.rank)
        self._p2p_seq[key] = self._p2p_seq.get(key, 0) + 1
        k = f"{self.name}/p2p/{src_rank}-{self.rank}/{self._p2p_seq[key]}"
        v = self.kv.wait(k, self.timeout_s)
        self.kv.delete(k)
        return pickle.loads(v)

    def destroy(self) -> None:
        if self.rank == 0:
            self.kv.delete_prefix(f"{self.name}/")


_TORCH_OPS = {"sum": "SUM", "product": "PRODUCT", "min": "MIN", "max": "MAX"}
# The dtypes a point-to-point header can name.
_P2P_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
               torch.int64, torch.int32, torch.int16, torch.int8,
               torch.uint8, torch.bool)


class TorchCollectiveGroup:
    """Collectives over a ``torch.distributed`` group of ``backend``
    ("nccl": CUDA tensors on this process's current card; "gloo": CPU
    tensors), the counterpart of the reference's ``XlaCollectiveGroup``
    with its semantics. Inputs may be tensors or arrays; results are
    tensors on the group's device. The group is the world's default one
    where its backend is ``backend``, else a new group over the world's
    ranks (made by every rank, in the same order)."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 backend: str = "nccl"):
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() == world_size
                and dist.get_rank() == rank):
            formed = (f"a world of {dist.get_world_size()} with this "
                      f"process rank {dist.get_rank()}"
                      if dist.is_available() and dist.is_initialized()
                      else "no torch.distributed world")
            raise RuntimeError(
                f"TorchCollectiveGroup({group_name}) needs a formed "
                f"torch.distributed world of {world_size} processes with "
                f"this process rank {rank}; this process has {formed} "
                f"(form it with the Train TorchConfig backend or "
                f"torch.distributed.init_process_group)")
        self.name = group_name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if backend == "nccl" else torch.device("cpu"))
        self._own = dist.get_backend() != backend
        self._pg = (dist.new_group(list(range(world_size)), backend=backend)
                    if self._own else dist.group.WORLD)

    def _on(self, tensor) -> torch.Tensor:
        """A contiguous copy of ``tensor`` on the group's device."""
        return torch.as_tensor(tensor).to(self.device, copy=True
                                           ).contiguous()

    def allreduce(self, tensor, op: str = "sum") -> torch.Tensor:
        t = self._on(tensor)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _TORCH_OPS[op]),
                        group=self._pg)
        return t

    def allgather(self, tensor) -> torch.Tensor:
        """Every rank's tensor, stacked on a new leading axis of size
        world_size in rank order (``process_allgather``)."""
        t = self._on(tensor)
        out = t.new_empty(self.world_size * t.numel())
        all_gather_single(out, t.reshape(-1), group=self._pg)
        return out.view((self.world_size,) + t.shape)

    def broadcast(self, tensor, src_rank: int = 0) -> torch.Tensor:
        t = self._on(tensor)
        dist.broadcast(t, src=src_rank, group=self._pg)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self._pg, device_ids=[self.device.index])
        else:
            dist.barrier(group=self._pg)

    def reducescatter(self, tensor, op: str = "sum") -> torch.Tensor:
        """This rank's chunk of dim 0 of the reduction: one
        reduce-scatter for a sum over a length that divides by
        world_size; otherwise an all-reduce and ``torch.tensor_split``,
        whose chunks are ``np.array_split``'s."""
        t = self._on(tensor)
        w = self.world_size
        if op == "sum" and t.dim() and t.shape[0] % w == 0:
            out = t.new_empty((t.shape[0] // w,) + t.shape[1:])
            reduce_scatter_single(out, t, group=self._pg)
            return out
        return torch.tensor_split(self.allreduce(t, op), w,
                                  dim=0)[self.rank].clone()

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        """The reduction at ``dst_rank``; the input elsewhere."""
        t = self._on(tensor)
        dist.reduce(t, dst=dst_rank,
                    op=getattr(dist.ReduceOp, _TORCH_OPS[op]),
                    group=self._pg)
        return t if self.rank == dst_rank else tensor

    # ------------------------------------------------------------------ p2p
    # Point-to-point ops of the backend (the reference bridges them through
    # the host KV). A header (dtype, ndim, shape) goes first, since the
    # receiver allocates the buffer.

    def send(self, tensor, dst_rank: int) -> None:
        t = self._on(tensor)
        head = torch.tensor([_P2P_DTYPES.index(t.dtype), t.dim()]
                            + list(t.shape), dtype=torch.int64,
                            device=self.device)
        size = torch.tensor([head.numel()], dtype=torch.int64,
                            device=self.device)
        dist.send(size, dst_rank, group=self._pg)
        dist.send(head, dst_rank, group=self._pg)
        dist.send(t, dst_rank, group=self._pg)

    def recv(self, src_rank: int) -> torch.Tensor:
        size = torch.empty(1, dtype=torch.int64, device=self.device)
        dist.recv(size, src_rank, group=self._pg)
        head = torch.empty(int(size), dtype=torch.int64, device=self.device)
        dist.recv(head, src_rank, group=self._pg)
        dtype_i, ndim, *shape = head.tolist()
        t = torch.empty(shape[:ndim], dtype=_P2P_DTYPES[dtype_i],
                        device=self.device)
        dist.recv(t, src_rank, group=self._pg)
        return t

    def destroy(self) -> None:
        if self._own and self._pg is not None:
            dist.destroy_process_group(self._pg)
        self._pg = None


BACKENDS = {"host": HostCollectiveGroup, "nccl": TorchCollectiveGroup,
            "gloo": TorchCollectiveGroup}


class GroupManager:
    """Per-process registry. ``kv`` is the store of host groups and of
    the declarative path; ``actor_id`` returns this process's actor id
    (None outside an actor), the reference's runtime context."""

    def __init__(self, kv=None,
                 actor_id: Optional[Callable[[], Any]] = None):
        self.kv = kv
        self.actor_id = actor_id
        self._groups: Dict[str, Any] = {}

    def _make(self, backend: str, group_name: str, world_size: int,
              rank: int):
        cls = BACKENDS[backend]
        if cls is HostCollectiveGroup:
            if self.kv is None:
                raise RuntimeError("a host collective group needs a KV "
                                   "store: set_runtime(kv=...)")
            return cls(group_name, world_size, rank, self.kv)
        return cls(group_name, world_size, rank, backend)

    def create(self, backend: str, group_name: str, world_size: int,
               rank: int):
        if group_name in self._groups:
            raise ValueError(f"group {group_name!r} already initialized "
                             "in this process")
        g = self._make(backend, group_name, world_size, rank)
        self._groups[group_name] = g
        return g

    def get(self, group_name: str):
        g = self._groups.get(group_name)
        if g is None:
            g = self._lookup_declared(group_name)
        if g is None:
            raise RuntimeError(
                f"collective group {group_name!r} is not initialized in "
                "this process; call init_collective_group() or declare it "
                "with create_collective_group()")
        return g

    def _lookup_declared(self, group_name: str):
        """Declarative path: the launching program stored membership in
        the KV keyed by actor id; the first op inside the actor resolves
        its rank."""
        if self.kv is None or self.actor_id is None:
            return None
        me = self.actor_id()
        if me is None:
            return None
        decl = self.kv.get(f"decl/{group_name}")
        if decl is None:
            return None
        info = pickle.loads(decl)
        try:
            rank = info["actor_ids"].index(me)
        except ValueError:
            return None
        g = self._make(info["backend"], group_name, info["world_size"], rank)
        self._groups[group_name] = g
        return g

    def destroy(self, group_name: str):
        g = self._groups.pop(group_name, None)
        if g is not None:
            g.destroy()


_manager = GroupManager()


# -------------------------------------------------------------- public API


def set_runtime(kv=None, actor_id: Optional[Callable[[], Any]] = None
                ) -> None:
    """Give this process's registry its runtime services: the KV store
    of host groups and declared groups, and the actor-id callback of the
    declarative path."""
    _manager.kv = kv
    _manager.actor_id = actor_id


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default"):
    """Imperative init, called by every member."""
    return _manager.create(backend, group_name, world_size, rank)


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: Optional[List[int]] = None,
                            backend: str = "host",
                            group_name: str = "default") -> None:
    """Declarative init from the launching program: membership (each actor's
    ``_actor_id``, or the actor id itself) is stored in the registry's
    KV; each actor resolves its rank on its first op."""
    if len(actors) != world_size:
        raise ValueError("len(actors) must equal world_size")
    if _manager.kv is None:
        raise RuntimeError("declaring a group needs a KV store: "
                           "set_runtime(kv=...)")
    ranks = ranks or list(range(world_size))
    ordered = [None] * world_size
    for a, r in zip(actors, ranks):
        ordered[r] = getattr(a, "_actor_id", a)
    _manager.kv.put(f"decl/{group_name}", pickle.dumps({
        "backend": backend, "world_size": world_size,
        "actor_ids": ordered}))


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _manager._groups


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy(group_name)


def get_rank(group_name: str = "default") -> int:
    return _manager.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).allreduce(tensor, op)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = "sum"):
    return _manager.get(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).reducescatter(tensor, op)


def barrier(group_name: str = "default") -> None:
    _manager.get(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    _manager.get(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return _manager.get(group_name).recv(src_rank)
