"""Parity of ray_tpu_torch.experimental's device objects with the JAX
package's on the CPU.

The owner's side, ``serve_fetch``, against the JAX core worker's own
``h_device_fetch`` handler (called on a stand-in ``self``, with a small
chunk so that several chunks show); the whole put / get / free sequence
against ``ray_tpu.experimental`` run over a fake core worker (its
``_core`` replaced through monkeypatch; no cluster is started). Bytes,
replies, counts and the copy audit are compared exactly.
"""

import asyncio
import logging
import pickle
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.experimental as jexp
from ray_tpu._private import device_plane as jdp
from ray_tpu._private.core_worker import CoreWorker
from ray_tpu_torch import experimental as texp
from ray_tpu_torch._private import device_plane as tdp

CHUNK = 100                       # bytes a reply carries in these tests
DTYPES = ("float32", "int32", "bfloat16")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Small chunks, fresh transport stats and audits on both sides."""
    monkeypatch.setattr(texp, "DEVICE_CHUNK", CHUNK)
    for mod in (jexp, texp):
        monkeypatch.setattr(mod, "_stats", {
            "puts": 0, "gets_local": 0, "gets_remote": 0,
            "bytes_staged": 0.0, "seconds_staged": 0.0})
        monkeypatch.setattr(mod, "_advised", False)
    jdp._reset_copy_stats()
    tdp._reset_copy_stats()


def _array(dtype, shape=(7, 13), seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * 100
    return a.astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)


def _tensor(a):
    return tdp.from_host_array(a, None, "cpu")


def _stores():
    """An owner store and a consumer store whose RPCs call the owner's
    serve_fetch / serve_free directly."""
    owner = texp.DeviceObjectStore(("10.0.0.1", 7001), device="cpu")
    consumer = texp.DeviceObjectStore(
        ("10.0.0.2", 7002), device="cpu",
        fetch=lambda addr, oid, off: texp.serve_fetch(owner, oid, off),
        free=lambda addr, oid: texp.serve_free(owner, oid))
    return owner, consumer


class _FakeCore:
    """What ray_tpu.experimental and CoreWorker.h_device_fetch read of a
    core worker; its peers are other fakes reached in process."""

    def __init__(self, address, peers: dict):
        self.address = address
        self.device_objects = {}
        self.executor = None
        self._DEVICE_CHUNK = CHUNK
        self._peers = peers
        peers[address] = self

    async def _peer_owner(self, addr):
        owner = self._peers[tuple(addr)]

        class Conn:
            async def call(self, method, p, timeout=None):
                handler = {"device_fetch": CoreWorker.h_device_fetch,
                           "device_free": CoreWorker.h_device_free}[method]
                return await handler(owner, None, p)
        return Conn()

    def _run(self, coro, timeout=None):
        return asyncio.run(asyncio.wait_for(coro, timeout))


def _jax_fetch(entry, offset):
    ns = SimpleNamespace(device_objects={b"o": entry}, executor=None,
                         _DEVICE_CHUNK=CHUNK)
    return asyncio.run(CoreWorker.h_device_fetch(
        ns, None, {"object_id": b"o", "offset": offset}))


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_fetch_replies_equal_the_core_workers(dtype):
    """Every chunk's reply equals h_device_fetch's, key for key and byte
    for byte, and each side counts exactly the chunk bytes it staged."""
    a = _array(dtype)
    owner, _ = _stores()
    owner.device_objects[b"o"] = _tensor(a)
    offset, replies = 0, 0
    while offset < a.nbytes:
        got = texp.serve_fetch(owner, b"o", offset)
        want = _jax_fetch(jnp.asarray(a), offset)
        assert got == want
        assert got["dtype"] == dtype and got["shape"] == [7, 13]
        assert len(got["data"]) == min(CHUNK, a.nbytes - offset)
        offset += len(got["data"])
        replies += 1
    assert replies == -(-a.nbytes // CHUNK) > 1
    assert tdp.device_copy_stats() == jdp.device_copy_stats()
    assert tdp.device_copy_stats()["device_to_host_bytes"] == a.nbytes
    assert texp.serve_fetch(owner, b"missing", 0) is None
    assert texp.serve_free(owner, b"o") is True
    assert texp.serve_fetch(owner, b"o", 0) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_get_between_stores_is_bit_exact(dtype):
    a = _array(dtype, (33, 9), seed=1)
    owner, consumer = _stores()
    t = _tensor(a)
    ref = texp.device_put(t, owner)
    assert len(pickle.dumps(ref)) < 200
    assert (ref.shape, ref.dtype, ref.owner_addr) == (
        (33, 9), dtype, ("10.0.0.1", 7001))
    assert texp.device_get(ref, owner) is t              # owner-local
    got = texp.device_get(ref, consumer)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert tdp.host_array(got)[0].tobytes() == a.tobytes()
    st = tdp.device_copy_stats()
    assert st["device_to_host_bytes"] == st["host_to_device_bytes"] \
        == a.nbytes


def test_transport_stats_match_jax(monkeypatch):
    """The same sequence on both: put, a local get, a remote get, a remote
    free, a get of the freed object; the same keys and counts, the same
    copy audit."""
    a = _array("float32", (20, 11), seed=2)
    peers = {}
    jowner = _FakeCore(("10.0.0.1", 7001), peers)
    jconsumer = _FakeCore(("10.0.0.2", 7002), peers)
    current = [jowner]
    monkeypatch.setattr(jexp, "_core", lambda: current[0])
    owner, consumer = _stores()
    results = []
    for put, get, free, pin, arr, on_consumer in (
            (jexp.device_put, jexp.device_get, jexp.device_free,
             lambda: current.__setitem__(0, jconsumer), jnp.asarray(a),
             None),
            (lambda x: texp.device_put(x, owner),
             lambda r: texp.device_get(r, consumer),
             lambda r: texp.device_free(r, consumer), lambda: None,
             _tensor(a), None)):
        ref = put(arr)
        local = (jexp.device_get(ref) if put is jexp.device_put
                 else texp.device_get(ref, owner))
        assert local is arr
        pin()                          # the JAX side now acts as consumer
        got = get(ref)
        assert np.asarray(got).tobytes() == a.tobytes()
        free(ref)
        with pytest.raises(KeyError, match="freed at the owner"):
            get(ref)
        st = (jexp if put is jexp.device_put else texp) \
            .device_transport_stats()
        assert st.pop("staged_gib_s") > 0
        results.append(st)
    assert results[1] == results[0] == dict(
        puts=1, gets_local=1, gets_remote=1, bytes_staged=a.nbytes)
    assert tdp.device_copy_stats() == jdp.device_copy_stats()
    assert not jowner.device_objects and not owner.device_objects


def test_freed_object_raises_key_error_locally_and_remotely():
    owner, consumer = _stores()
    ref = texp.device_put(torch.arange(10), owner)
    texp.device_free(ref, owner)
    texp.device_free(ref, owner)                        # idempotent
    with pytest.raises(KeyError, match="was freed"):
        texp.device_get(ref, owner)
    with pytest.raises(KeyError, match="freed at the owner"):
        texp.device_get(ref, consumer)


def test_device_put_lands_host_values_on_the_stores_device():
    owner, _ = _stores()
    ref = texp.device_put(np.arange(6, dtype=np.int32).reshape(2, 3), owner)
    t = owner.device_objects[ref.object_id]
    assert t.device.type == "cpu" and t.dtype == torch.int32
    assert (ref.shape, ref.dtype) == ((2, 3), "int32")
    assert len(ref.object_id) == len(jexp.ObjectID.from_random().binary())


def test_cuda_landing_and_missing_callbacks_raise():
    """A store lands on "cuda" unless asked for the CPU and raises without
    a GPU; a store with no fetch callback cannot reach another owner."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texp.DeviceObjectStore(("h", 1))
    owner, _ = _stores()
    lonely = texp.DeviceObjectStore(("h", 2), device="cpu")
    ref = texp.device_put(torch.ones(3), owner)
    with pytest.raises(RuntimeError, match="no fetch callback"):
        texp.device_get(ref, lonely)
    with pytest.raises(RuntimeError, match="no free callback"):
        texp.device_free(ref, lonely)


def test_a_slow_owner_times_out():
    owner, _ = _stores()

    def slow_fetch(addr, oid, off):
        time.sleep(0.05)
        return texp.serve_fetch(owner, oid, off)
    consumer = texp.DeviceObjectStore(("h", 3), device="cpu",
                                      fetch=slow_fetch)
    ref = texp.device_put(torch.ones(100), owner)      # 4 chunks
    with pytest.raises(TimeoutError, match="of 400 bytes"):
        texp.device_get(ref, consumer, timeout=0.01)


def test_staging_advice_is_given_once_and_names_no_tpu(monkeypatch, caplog):
    monkeypatch.setattr(texp, "_ADVISE_BYTES", 64)
    owner, consumer = _stores()
    ref = texp.device_put(torch.ones(40), owner)
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.experimental"):
        texp.device_get(ref, consumer)
        texp.device_get(ref, consumer)
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1
    assert "ray_tpu_torch.collective" in msgs[0]
    assert "ICI" not in msgs[0] and "v5e" not in msgs[0]
