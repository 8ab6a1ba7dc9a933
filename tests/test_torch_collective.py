"""ray_tpu_torch.collective against the JAX package's collective module.

``TorchCollectiveGroup`` runs in gloo worlds of spawned processes (a
``FileStore`` under ``tmp_path``, formed by the port's Train backend) and
must give the values of the reference's two-process "xla" group test
(``tests/test_collective.py:181-223``) and numpy's. The port's
``HostCollectiveGroup`` runs in threads on a dict-backed KV beside the
reference's, whose GCS KV is swapped for a dict inside the test only; the
two must return the same arrays and leave the same keys.

The spawned ranks import this module, so it imports JAX and the JAX
package only inside tests.
"""

import multiprocessing
import pickle
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch import collective as col
from ray_tpu_torch.collective import (DictKV, GroupManager,
                                      HostCollectiveGroup, StoreKV,
                                      TorchCollectiveGroup)
from ray_tpu_torch.train.backend import TorchConfig

JOIN_S = 60


def spawn_ranks(target, world: int, tmp_path, *args) -> list:
    """``target(rank, world, *args)`` in ``world`` spawned processes that
    form a gloo world through the port's Train backend on a FileStore
    under ``tmp_path``; their results in rank order. Every wait is
    bounded; a rank that raises, hangs or exits non-zero fails."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = f"file://{tmp_path}/store-{target.__name__}-{world}"
    procs = [ctx.Process(target=_rank, args=(target, r, world, store, args,
                                             results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = [None] * world
    try:
        for _ in range(world):
            rank, ok, value = results.get(timeout=JOIN_S)
            assert ok, f"rank {rank} raised:\n{value}"
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not alive, f"ranks {alive} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    return out


def _rank(target, rank, world, store, args, results):
    import traceback
    torch.set_num_threads(1)
    backend = TorchConfig("gloo", use_gpu=False).backend_cls()(
        TorchConfig("gloo", use_gpu=False))
    try:
        backend.on_start(dict(world_rank=rank, world_size=world,
                              local_rank=0, init_method=store))
        results.put((rank, True, target(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        backend.on_shutdown()


def _ops(rank, world):
    """The reference's two-process test's ops, generalised to ``world``
    ranks, and the rest of the group's ops against numpy."""
    g = col.init_collective_group(world, rank, backend="gloo",
                                  group_name="t")
    assert (col.get_rank("t"), col.get_collective_group_size("t")) == (
        rank, world)
    out = g.allreduce(np.full((2,), float(rank + 1)))
    bc = g.broadcast(np.asarray([rank]), src_rank=1)
    if rank == 0:
        g.send(np.asarray([42.0]), dst_rank=1)
        p2p = 42.0
    elif rank == 1:
        p2p = float(g.recv(src_rank=0)[0])
    else:
        p2p = None
    rs = g.reducescatter(np.arange(world, dtype=np.float64) * 9.0
                         + 1.0 + rank)
    g.barrier()
    mine = np.arange(6, dtype=np.float32) * (rank + 1) - 2.5
    uneven = np.arange(2 * world + 1, dtype=np.float32) + rank
    got = dict(
        metrics={"sum": float(out[0]), "bc": float(bc[0]), "p2p": p2p,
                 "rs": float(rs[0])},
        ops={op: g.allreduce(mine, op).numpy()
             for op in ("sum", "product", "min", "max")},
        allgather=g.allgather(mine).numpy(),
        reducescatter_uneven=g.reducescatter(uneven).numpy(),
        reduce=np.asarray(col.reduce(mine, dst_rank=world - 1,
                                     group_name="t")),
        bf16_sum=col.allreduce(torch.ones(3, dtype=torch.bfloat16),
                               group_name="t").float().numpy())
    col.destroy_collective_group("t")
    assert not col.is_group_initialized("t")
    return got


@pytest.mark.parametrize("world", [2, 4])
def test_torch_group_ops_give_the_reference_values(world, tmp_path):
    ranks = spawn_ranks(_ops, world, tmp_path)
    if world == 2:
        # tests/test_collective.py:222-223, the reference's "xla" group.
        assert ranks[0]["metrics"] == {"sum": 3.0, "bc": 1.0, "p2p": 42.0,
                                       "rs": 3.0}
    assert ranks[1]["metrics"]["p2p"] == 42.0
    mine = [np.arange(6, dtype=np.float32) * (r + 1) - 2.5
            for r in range(world)]
    uneven = [np.arange(2 * world + 1, dtype=np.float32) + r
              for r in range(world)]
    for r, got in enumerate(ranks):
        assert got["metrics"]["sum"] == world * (world + 1) / 2
        assert got["metrics"]["bc"] == 1.0
        assert got["metrics"]["rs"] == sum(9.0 * r + 1.0 + k
                                           for k in range(world))
        for op, fn in (("sum", np.sum), ("product", np.prod),
                       ("min", np.min), ("max", np.max)):
            np.testing.assert_array_equal(got["ops"][op],
                                          fn(np.stack(mine), axis=0))
        np.testing.assert_array_equal(got["allgather"], np.stack(mine))
        np.testing.assert_array_equal(
            got["reducescatter_uneven"],
            np.array_split(np.sum(uneven, axis=0), world)[r])
        np.testing.assert_array_equal(
            got["reduce"], np.sum(mine, axis=0) if r == world - 1
            else mine[r])
        np.testing.assert_array_equal(got["bf16_sum"], np.full(3, world))


def test_torch_group_needs_a_formed_world():
    with pytest.raises(RuntimeError, match="formed torch.distributed world"
                                           ".*TorchConfig"):
        TorchCollectiveGroup("nope", 2, 0, backend="gloo")
    with pytest.raises(RuntimeError, match="formed"):
        GroupManager().create("nccl", "nope", 1, 0)


# -- the host group, against the reference's ---------------------------------

class _RefKV:
    """The reference's ``_KV`` over a dict (its GCS KV in the runtime)."""
    data: dict = {}

    @staticmethod
    def put(key, value, overwrite=True):
        return DictKV.put(_RefKV.store, key, value, overwrite)

    @staticmethod
    def get(key):
        return DictKV.get(_RefKV.store, key)

    @staticmethod
    def wait(key, timeout):
        return DictKV.wait(_RefKV.store, key, timeout)

    @staticmethod
    def delete_prefix(key):
        return DictKV.delete_prefix(_RefKV.store, key)


class _RefCore:
    """The one runtime call the reference's ``recv`` makes: kv_del."""

    @staticmethod
    def gcs_call(method, args):
        assert method == "kv_del" and not args["prefix"]
        return _RefKV.store.delete(args["key"])


def _host_script(g, world):
    """One rank's sequence of host-group ops; its results."""
    r = g.rank
    x = np.arange(5, dtype=np.float64) * (r + 1) - 3.0
    out = [g.allreduce(x, op) for op in ("sum", "product", "min", "max")]
    out.append(g.reduce(x, dst_rank=world - 1))
    out.append(g.reduce(x, dst_rank=0, op="max"))
    out += list(g.allgather(x))
    out.append(g.broadcast(x, src_rank=1))
    out.append(g.reducescatter(np.arange(2 * world, dtype=np.float64) + r))
    out.append(g.reducescatter(x, op="min"))           # 5 rows, uneven
    g.barrier()
    for k in range(2):
        if r == 0:
            g.send(x + k, dst_rank=1)
        elif r == 1:
            out.append(g.recv(src_rank=0))
    out.append(g.allreduce(x))
    return out


def _in_threads(make, world):
    """The script in one thread per rank; then each group destroyed (rank
    0 deletes the group's keys), once every rank is done reading."""
    outs, errors, groups = [None] * world, [], [None] * world

    def run(r):
        try:
            groups[r] = make(r)
            outs[r] = _host_script(groups[r], world)
        except BaseException as e:       # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for g in groups:
        g.destroy()
    return outs


def test_host_group_equals_the_reference_host_group(monkeypatch):
    import ray_tpu
    import ray_tpu.collective.collective as ref_col
    world = 3
    _RefKV.store = DictKV()
    monkeypatch.setattr(ref_col, "_KV", _RefKV)
    monkeypatch.setattr(ray_tpu, "_core", lambda: _RefCore)
    want = _in_threads(lambda r: ref_col.HostCollectiveGroup(
        "h", world, r, timeout_s=JOIN_S), world)
    kv = DictKV()
    got = _in_threads(lambda r: HostCollectiveGroup("h", world, r, kv,
                                                    timeout_s=JOIN_S), world)
    for g_r, w_r in zip(got, want):
        assert len(g_r) == len(w_r)
        for a, b in zip(g_r, w_r):
            np.testing.assert_array_equal(a, b)
    assert sorted(kv._data) == sorted(_RefKV.store._data)


def test_host_group_over_a_torch_store():
    """StoreKV over a torch.distributed store: the group's values, and
    its own keys gone after destroy."""
    store = torch.distributed.HashStore()
    kv = StoreKV(store)
    assert kv.put("a", b"1") and not kv.put("a", b"2", overwrite=False)
    assert kv.get("a") == b"1" and kv.get("missing") is None
    with pytest.raises(TimeoutError):
        kv.wait("missing", 0.05)
    assert kv.delete("a") and kv.get("a") is None
    kvs = [StoreKV(store) for _ in range(2)]
    outs = _in_threads(lambda r: HostCollectiveGroup("s", 2, r, kvs[r],
                                                     timeout_s=JOIN_S), 2)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[1][-3], np.arange(5) - 3.0)
    np.testing.assert_array_equal(outs[1][-2], np.arange(5) - 2.0)
    assert not [k for k in kvs[0]._seen if k.startswith("s/")]


def test_declared_groups_resolve_their_rank_through_the_kv():
    kv = DictKV()
    col.set_runtime(kv=kv, actor_id=lambda: "actor-b")
    try:
        col.create_collective_group(["actor-a", "actor-b"], 2,
                                    group_name="decl")
        info = pickle.loads(kv.get("decl/decl"))
        assert info == {"backend": "host", "world_size": 2,
                        "actor_ids": ["actor-a", "actor-b"]}
        assert col.get_rank("decl") == 1
        assert col.get_collective_group_size("decl") == 2
        assert col.is_group_initialized("decl")
        col.destroy_collective_group("decl")
        with pytest.raises(ValueError, match="len"):
            col.create_collective_group(["actor-a"], 2)
    finally:
        col.set_runtime()
    with pytest.raises(RuntimeError, match="not initialized"):
        col.get_rank("decl")
    with pytest.raises(RuntimeError, match="needs a KV"):
        col.init_collective_group(2, 0, backend="host", group_name="x")
