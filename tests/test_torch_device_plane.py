"""Parity of ray_tpu_torch's device plane and serializer with the JAX
package's on the CPU.

The same numpy payloads, made from a seed (f32, i32, bf16; nested lists,
tuples and dicts down to depth 9, one level past the walk's bound of 8),
go through ``ray_tpu._private.device_plane`` with
``ray_tpu._private.serialization.get_context()`` as jax.Arrays and through
the port's ``device_plane`` with its own context as CPU tensors. Specs,
skeletons, magic bytes, part layouts, out-of-band buffers and counter
deltas are compared exactly; there is no tolerance anywhere in this file.
No cluster is started.
"""

import pickle
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import device_plane as jdp
from ray_tpu._private import serialization as jser
from ray_tpu.dag import _norm_spec as jax_norm_spec
from ray_tpu.exceptions import DeviceSpecMismatchError as JaxSpecError
from ray_tpu_torch._private import device_plane as tdp
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch.exceptions import DeviceSpecMismatchError

JCTX, TCTX = jser.get_context(), tser.get_context()
DTYPES = ("float32", "int32", "bfloat16")


@pytest.fixture(autouse=True)
def _cpu_landing_and_fresh_audit():
    """Rebuild onto the CPU on this thread and zero both audits, the
    thread's rebuilt and staged notices included: a test file that ran
    earlier in the same worker may have left some."""
    tdp.set_landing_device("cpu")
    jdp._reset_copy_stats()
    tdp._reset_copy_stats()
    for side in (jdp, tdp):
        side.take_rebuilt_notice()
        side.take_staged_notice()
    yield
    tdp._tls.__dict__.pop("landing", None)


def _array(rng, dtype, shape):
    a = rng.standard_normal(shape) * 100
    return a.astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)


def _nest(leaf, depth: int):
    """``leaf`` at ``depth`` below the payload's top dict."""
    for _ in range(depth - 1):
        leaf = [leaf]
    return leaf


def _payload(dtype, seed=0, deep9=True):
    """Device leaves at depths 1-8 among host values, and with ``deep9``
    one at depth 9, past the walk's bound, which stays where it is (and is
    pickled by its own package's reduce, so it is left out where parts are
    compared)."""
    rng = np.random.default_rng(seed)
    value = {"w": _array(rng, dtype, (16, 40)),
             "pair": (_array(rng, dtype, (5,)), "tag", 7),
             "nested": [{"x": _array(rng, dtype, (2, 3, 4))}, None, 1.5],
             "deep8": _nest(_array(rng, dtype, (3,)), 8),
             "host": np.arange(6, dtype=np.int64)}
    if deep9:
        value["deep9"] = _nest(_array(rng, dtype, (2,)), 9)
    return value


def _innermost(nested):
    while isinstance(nested, list):
        nested = nested[0]
    return nested


def _leaf_bytes(value) -> int:
    """The bytes of the walk's device leaves of a payload."""
    return sum(np.asarray(a).nbytes for a in
               (value["w"], value["pair"][0], value["nested"][0]["x"],
                _innermost(value["deep8"])))


def _convert(tree, leaf, depth=0):
    """``tree`` with its device leaves (numpy arrays other than the int64
    host array) mapped by ``leaf``."""
    if isinstance(tree, np.ndarray):
        return tree if tree.dtype == np.int64 else leaf(tree)
    if isinstance(tree, list):
        return [_convert(v, leaf) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_convert(v, leaf) for v in tree)
    if isinstance(tree, dict):
        return {k: _convert(v, leaf) for k, v in tree.items()}
    return tree


def _jax(tree):
    return _convert(tree, jnp.asarray)


def _torch(tree):
    return _convert(tree, lambda a: tdp.from_host_array(a, None, "cpu"))


def _bits(x) -> bytes:
    """The bytes of a jax.Array, a tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        return tdp.host_array(x)[0].tobytes()
    return np.asarray(x).tobytes()


def _shape_of(tree, ref_cls):
    """A comparable form of a skeleton: leaf refs as ("ref", i), arrays
    and tensors as ("array", dtype name, shape)."""
    if isinstance(tree, ref_cls):
        return ("ref", tree.index)
    if isinstance(tree, torch.Tensor):
        return ("array", tdp.dtype_name(tree.dtype), tuple(tree.shape))
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return ("array", str(tree.dtype), tuple(tree.shape))
    if isinstance(tree, list):
        return [_shape_of(v, ref_cls) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_shape_of(v, ref_cls) for v in tree)
    if isinstance(tree, dict):
        return {k: _shape_of(v, ref_cls) for k, v in tree.items()}
    return tree


def _joined(parts) -> bytes:
    return b"".join(bytes(p) for p in parts)


# ------------------------------------------------------------------ specs ---

@pytest.mark.parametrize("dtype", DTYPES)
def test_specs_match_jax(dtype):
    a = _array(np.random.default_rng(1), dtype, (4, 6))
    j, t = jnp.asarray(a), tdp.from_host_array(a, None, "cpu")
    assert tdp.spec_of(t).__dict__ == jdp.spec_of(j).__dict__ == dict(
        dtype=dtype, shape=(4, 6), nbytes=a.nbytes, sharding="cpu:1")
    assert tdp.spec_of("not a tensor") is None
    # Declared (shape, dtype) specs, by name, numpy dtype or torch dtype.
    for decl in (dtype, a.dtype):
        assert tdp._norm_spec(((4, 6), decl)).__dict__ \
            == jax_norm_spec(((4, 6), decl)).__dict__
    assert tdp._norm_spec(((4, 6), t.dtype)) == tdp._norm_spec(((4, 6),
                                                                dtype))
    spec = tdp.spec_of(t)
    assert tdp._norm_spec(spec) is spec
    assert spec.compatible(tdp._norm_spec(((4, 6), dtype)))
    with pytest.raises(TypeError, match="DeviceArraySpec or a"):
        tdp._norm_spec([4, 6])


@pytest.mark.parametrize("case", ["ok", "shape", "dtype"])
def test_validate_against_spec_raises_as_jax_does(case):
    a = np.ones((2, 3), np.float32)
    spec = {"ok": {"shape": (2, 3), "dtype": "float32"},
            "shape": {"shape": (3, 2), "dtype": "float32"},
            "dtype": {"shape": (2, 3), "dtype": "int32"}}[case]
    value = {"out": [a, "meta"]}
    errors = []
    for side, err in ((jdp, JaxSpecError), (tdp, DeviceSpecMismatchError)):
        conv = _jax if side is jdp else _torch
        if case == "ok":
            side.validate_against_spec(conv(value), spec, "stage0")
            continue
        with pytest.raises(err) as ei:
            side.validate_against_spec(conv(value), spec, "stage0")
        errors.append(str(ei.value))
    if errors:
        assert errors[1] == errors[0]


# -------------------------------------------------------- container walk ---

@pytest.mark.parametrize("dtype", DTYPES)
def test_split_and_join_match_jax(dtype):
    """The same skeleton, leaf order and specs; the depth-9 leaf stays in
    the skeleton on both sides; join gives back the very same objects."""
    value = _payload(dtype)
    jv, tv = _jax(value), _torch(value)
    jsk, jleaves, jspecs = jdp.split_device_leaves(jv)
    tsk, tleaves, tspecs = tdp.split_device_leaves(tv)
    assert _shape_of(tsk, tdp._LeafRef) == _shape_of(jsk, jdp._LeafRef)
    assert len(tleaves) == len(jleaves) == 4
    assert [s.__dict__ for s in tspecs] == [s.__dict__ for s in jspecs]
    assert [_bits(t) for t in tleaves] == [_bits(j) for j in jleaves]
    assert tdp.has_device_leaves(tv) and jdp.has_device_leaves(jv)
    assert not tdp.has_device_leaves({"d": tv["deep9"]})
    assert _shape_of(tsk["deep9"], tdp._LeafRef) == _nest(
        ("array", dtype, (2,)), 9)
    assert _shape_of(tsk["deep8"], tdp._LeafRef) == _nest(("ref", 3), 8)
    back = tdp.join_device_leaves(tsk, tleaves)
    assert back["w"] is tv["w"] and back["pair"][0] is tv["pair"][0]
    assert _innermost(back["deep9"]) is _innermost(tv["deep9"])
    assert _innermost(back["deep8"]) is _innermost(tv["deep8"])
    swapped, n = tdp.swap_device_leaves(tv)
    assert n == jdp.swap_device_leaves(jv)[1] == 4
    assert isinstance(swapped["w"], tdp._DeviceLeaf)
    assert tdp.swap_device_leaves({"k": 1}) == ({"k": 1}, 0)


# ------------------------------------------------------------- rung 1 ---

@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_staged_body_matches_jax(dtype):
    """dag_encode_body across processes: MAGIC_STAGED, the same part
    layout, byte-equal out-of-band buffers, exactly equal counter deltas,
    no part copied; the decode gives the payload back on both sides."""
    value = _payload(dtype, seed=2, deep9=False)
    jparts, jtok = jdp.dag_encode_body(JCTX, b"\x00", _jax(value), False, 1)
    tparts, ttok = tdp.dag_encode_body(TCTX, b"\x00", _torch(value), False,
                                       1)
    assert jtok is None and ttok is None
    assert tparts[:2] == jparts[:2] == [b"\x00", tdp.MAGIC_STAGED]
    assert tdp.MAGIC_STAGED == jdp.MAGIC_STAGED
    assert tdp.MAGIC_LOCAL == jdp.MAGIC_LOCAL
    assert len(tparts) == len(jparts)
    # [status, magic, hlen, header, nbufs, (len, buf) * nbufs]
    assert tparts[4] == jparts[4] == (5).to_bytes(8, "little")
    tbufs, jbufs = tparts[5:], jparts[5:]
    assert [bytes(p) for p in tbufs] == [bytes(p) for p in jbufs]
    assert all(isinstance(p, memoryview) for p in tbufs[1::2])
    assert tdp.device_copy_stats() == jdp.device_copy_stats()
    staged = _leaf_bytes(value)
    assert tdp.device_copy_stats()["device_to_host_bytes"] == staged
    assert tser.copied_part_bytes(tparts) == jser.copied_part_bytes(
        jparts) == 0

    # Decode in place from a writable arena-like view.
    for side, ctx, parts in ((jdp, JCTX, jparts), (tdp, TCTX, tparts)):
        arena = bytearray(sum(tser.part_nbytes(p) for p in parts))
        tser.write_parts_into(parts, memoryview(arena))
        got = side.dag_decode_body(ctx, memoryview(arena))
        arena[:] = bytes(len(arena))          # the view is released
        assert _bits(got["w"]) == _bits(value["w"])
        assert _bits(got["nested"][0]["x"]) == _bits(value["nested"][0]["x"])
        assert got["pair"][1:] == ("tag", 7)
        np.testing.assert_array_equal(got["host"], np.arange(6))
    assert isinstance(got["w"], torch.Tensor)
    assert tdp.device_copy_stats() == jdp.device_copy_stats()
    assert tdp.device_copy_stats()["host_to_device_bytes"] == staged
    assert tdp.take_rebuilt_notice() == jdp.take_rebuilt_notice() \
        == (4, staged)


def test_plain_host_values_match_jax():
    """A value without device leaves keeps the unmarked wire form, the
    same constant None, the same numpy buffers, and a deserialize from a
    view copies nothing large out of it."""
    host = {"x": np.arange(4096, dtype=np.float64), "s": "text"}
    jparts, _ = jdp.dag_encode_body(JCTX, b"\x01", host, True, 1)
    tparts, _ = tdp.dag_encode_body(TCTX, b"\x01", host, True, 1)
    assert tparts[0] == jparts[0] == b"\x01"
    assert tparts[1] != tdp.MAGIC_STAGED and tparts[1] != tdp.MAGIC_LOCAL
    assert [bytes(p) for p in tparts[4:]] == [bytes(p) for p in jparts[4:]]
    assert TCTX.none_blob() == JCTX.none_blob()
    assert TCTX.deserialize(memoryview(TCTX.none_blob())) is None
    assert TCTX.total_size(tparts[1:]) == JCTX.total_size(jparts[1:])
    got = tdp.dag_decode_body(TCTX, memoryview(_joined(tparts)))
    np.testing.assert_array_equal(got["x"], host["x"])
    view = memoryview(_joined(tparts[1:]))
    assert tser.copied_get_bytes(TCTX.deserialize(view), view) \
        == jser.copied_get_bytes(JCTX.deserialize(view), view) == 0
    assert tdp.device_copy_stats() == jdp.device_copy_stats() == dict(
        device_to_host_bytes=0, host_to_device_bytes=0,
        device_fallback_bytes=0, device_arrays_staged=0,
        device_arrays_local=0)


def test_bf16_staging_zero_copy_where_jax_pays_a_fallback():
    """The one divergence of the copy audit, not of values: JAX's CPU
    arrays cannot export bf16 through np.from_dlpack ("Unsupported dtype
    in DLTensor"), so JAX materializes them and counts the bytes as
    device_fallback_bytes (and its PickleBuffer then rejects ml_dtypes'
    dtype 'E', so JAX cannot stage the leaf at all); the port's host view
    is of the tensor's bytes, zero-copy, and counts 0."""
    a = _array(np.random.default_rng(3), "bfloat16", (8, 32))
    with pytest.raises(ValueError, match="dtype 'E'"):
        jdp._DeviceLeaf(jnp.asarray(a)).__reduce_ex__(5)
    assert jdp.device_copy_stats()["device_fallback_bytes"] == a.nbytes \
        == 512
    parts = TCTX.serialize({"b": tdp.from_host_array(a, None, "cpu")})
    assert tdp.device_copy_stats()["device_fallback_bytes"] == 0
    assert tdp.device_copy_stats()["device_to_host_bytes"] == a.nbytes
    assert bytes(parts[-1]) == a.tobytes()
    got = TCTX.deserialize(memoryview(_joined(parts)))["b"]
    assert got.dtype == torch.bfloat16 and _bits(got) == a.tobytes()


def test_non_contiguous_tensor_pays_the_counted_extra_copy():
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6).T
    parts = TCTX.serialize([t])
    st = tdp.device_copy_stats()
    assert st["device_to_host_bytes"] == st["device_fallback_bytes"] == 96
    got = TCTX.deserialize(memoryview(_joined(parts)))[0]
    assert torch.equal(got, t) and got.is_contiguous()


def test_host_arrays_round_trip_bit_for_bit():
    rng = np.random.default_rng(4)
    for dtype in DTYPES:
        t = tdp.from_host_array(_array(rng, dtype, (3, 5)), None, "cpu")
        host, name = tdp.host_array(t)
        assert name == dtype
        back = tdp.from_host_array(host, name, "cpu")
        assert back.dtype == t.dtype and _bits(back) == _bits(t)
    with pytest.raises(TypeError, match="read as"):
        tdp.from_host_array(np.zeros(2, np.float32), "int32", "cpu")


# ------------------------------------------------------------- rung 0 ---

@pytest.mark.parametrize("dtype", DTYPES)
def test_local_body_matches_jax(dtype):
    """dag_encode_body in one process: MAGIC_LOCAL, an 8-byte token of the
    same layout, only the host array out of band, no bytes moved; decode
    takes the very same objects back."""
    value = _payload(dtype, seed=5, deep9=False)
    jv, tv = _jax(value), _torch(value)
    jparts, jtok = jdp.dag_encode_body(JCTX, b"\x00", jv, True, 1)
    tparts, ttok = tdp.dag_encode_body(TCTX, b"\x00", tv, True, 1)
    assert tparts[1] == jparts[1] == tdp.MAGIC_LOCAL
    assert len(tparts) == len(jparts) == 7
    assert len(ttok) == len(jtok) == 8
    assert ttok[:4] == jtok[:4]                    # the pid
    assert tparts[4] == jparts[4] == (1).to_bytes(8, "little")
    assert bytes(tparts[6]) == bytes(jparts[6]) == value["host"].tobytes()
    got = tdp.dag_decode_body(TCTX, _joined(tparts))
    assert got["w"] is tv["w"] and got["nested"][0]["x"] is \
        tv["nested"][0]["x"]
    assert jdp.dag_decode_body(JCTX, _joined(jparts))["w"] is jv["w"]
    assert tdp.device_copy_stats() == jdp.device_copy_stats()
    assert tdp.device_copy_stats()["device_arrays_local"] == 4
    assert tdp.device_copy_stats()["device_to_host_bytes"] == 0
    assert not tdp.local_is_registered(ttok)


def test_local_registry_refcounts_and_drops():
    """The port of tests/test_device_channels.py:99, run on both."""
    for side, a in ((jdp, jnp.ones(8)), (tdp, torch.ones(8))):
        tok = side.register_local([a], nreaders=2)
        assert side.local_is_registered(tok)
        assert side.take_local(tok)[0] is a
        assert side.local_is_registered(tok)       # one reader left
        assert side.take_local(tok)[0] is a
        assert not side.local_is_registered(tok)
        with pytest.raises(KeyError, match="not registered"):
            side.take_local(tok)
        tok2 = side.register_local([a], nreaders=4)
        n = side.local_registry_size()
        side.drop_local(tok2)                      # producer-side cleanup
        assert not side.local_is_registered(tok2)
        assert side.local_registry_size() == n - 1
        side.drop_local(tok2)                      # a no-op


# ------------------------------------------------------ landing, metrics ---

def test_cuda_landing_without_a_gpu_raises():
    """A thread that never set a landing device rebuilds onto "cuda", and
    without a GPU that raises; nothing falls back to the CPU."""
    parts = TCTX.serialize([torch.ones(3)])
    body = memoryview(_joined(parts))
    errors = []

    def decode():
        try:
            TCTX.deserialize(body)
        except RuntimeError as e:
            errors.append(str(e))
    th = threading.Thread(target=decode)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    if torch.cuda.is_available():
        assert errors == []
    else:
        assert len(errors) == 1 and "no CUDA device" in errors[0]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdp.set_landing_device("cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        tdp.set_landing_device("meta")


def test_metrics_counter_gets_the_reference_names():
    seen = []
    tdp.set_metrics_counter(lambda name, _help, n: seen.append((name, n)))
    try:
        TCTX.serialize([torch.ones(4), torch.ones(2, 2).T])
        tdp.record_h2d(5)
    finally:
        tdp.set_metrics_counter(None)
    assert seen == [("ray_tpu_device_to_host_bytes_total", 16),
                    ("ray_tpu_device_to_host_bytes_total", 16),
                    ("ray_tpu_device_staging_fallback_bytes_total", 16),
                    ("ray_tpu_host_to_device_bytes_total", 5)]

    def broken(*_):
        raise OSError("registry down")
    tdp.set_metrics_counter(broken)
    try:
        tdp.record_d2h(3)                          # never breaks the path
    finally:
        tdp.set_metrics_counter(None)
    assert tdp.device_copy_stats()["device_to_host_bytes"] == 35


def test_a_pickled_tensor_outside_the_serializer_still_rebuilds():
    """A _DeviceLeaf pickled in-band (no buffer_callback) carries its bytes
    inside the pickle and rebuilds the same."""
    t = torch.arange(5, dtype=torch.int32)
    got = pickle.loads(pickle.dumps(tdp._DeviceLeaf(t), protocol=5))
    assert torch.equal(got, t)
