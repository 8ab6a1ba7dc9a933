"""Object serialization: pickle protocol 5 with out-of-band buffers.

A copy of the data path of ray_tpu/_private/serialization.py: large
buffers (numpy arrays, and the host views of device tensors) travel as
pickle-5 out-of-band buffers, so they are written into (and read from) the
destination buffer without an extra copy.

Wire layout of a serialized object:
  [8B header_len][pickled bytes][8B nbufs][(8B len, payload) * nbufs]

Tensors are staged to host exactly ONCE: a serialize-side pre-pass
(``device_plane.swap_device_leaves``) substitutes each tensor leaf with a
wrapper whose reduce emits a host view of its bytes as an out-of-band
buffer, so the bytes land in the destination via the same single
``write_parts_into`` memcpy as any ndarray. Deserialize re-uploads them to
the thread's landing device (``device_plane.set_landing_device``). Both
seams stamp the device copy audit (see _private/device_plane.py).

Plain ``pickle`` pickles the header: the port has no cloudpickle, so
functions and classes travel by reference (importable names), not by
value. Not copied, because they are runtime code: the ObjectRef hooks
(``ref_hook``, ``ref_factory``, ``capture``), by which the reference's
reference counter records borrows, and ``dumps_code``/``loads_code``,
which ship code to workers.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, List

import numpy as np

from . import device_plane


class SerializationContext:
    """Per-process serializer of values to parts (see the wire layout)."""

    def serialize(self, value: Any) -> List[memoryview | bytes]:
        value, n_dev = device_plane.swap_device_leaves(value)
        if n_dev:
            device_plane.note_staged_leaves(n_dev)
        buffers: List[pickle.PickleBuffer] = []
        header = pickle.dumps(value, protocol=5,
                              buffer_callback=buffers.append)
        parts: List[memoryview | bytes] = [
            struct.pack("<Q", len(header)), header,
            struct.pack("<Q", len(buffers)),
        ]
        for b in buffers:
            raw = b.raw()
            parts.append(struct.pack("<Q", raw.nbytes))
            parts.append(raw)
        return parts

    def total_size(self, parts) -> int:
        return sum(part_nbytes(p) for p in parts)

    _NONE_BLOB: bytes | None = None  # wire form of None (constant)

    def none_blob(self) -> bytes:
        """The constant wire form of a serialized None, shared by the
        serialize-side fast path and the deserialize-side compare below so
        the two can't drift."""
        blob = SerializationContext._NONE_BLOB
        if blob is None:
            blob = b"".join(self.serialize(None))
            SerializationContext._NONE_BLOB = blob
        return blob

    def deserialize(self, data: memoryview) -> Any:
        # None's wire form is a constant: one bytes-compare replaces an
        # unpickle.
        if data == self.none_blob():
            return None
        data = memoryview(data)
        (hlen,) = struct.unpack_from("<Q", data, 0)
        header = data[8:8 + hlen]
        off = 8 + hlen
        (nbufs,) = struct.unpack_from("<Q", data, off)
        off += 8
        bufs = []
        for _ in range(nbufs):
            (blen,) = struct.unpack_from("<Q", data, off)
            off += 8
            bufs.append(data[off:off + blen])
            off += blen
        return pickle.loads(header, buffers=bufs)


def part_nbytes(p) -> int:
    return p.nbytes if isinstance(p, memoryview) else len(p)


def write_parts_into(parts, dest: memoryview) -> int:
    """Scatter serialized parts into a caller-provided buffer (e.g. a shared
    memory view): the single memcpy of the zero-copy put discipline.
    Returns bytes written."""
    off = 0
    for p in parts:
        n = part_nbytes(p)
        dest[off:off + n] = p
        off += n
    return off


def copied_get_bytes(value, source: memoryview,
                     threshold: int = 1 << 12) -> int:
    """Copy-audit helper for the GET/deserialize path, the mirror of
    copied_part_bytes: bytes held in large ndarray leaves of `value` that
    do NOT alias `source` (the view the object was deserialized from),
    i.e. payload bytes that were COPIED out of it instead of travelling as
    pickle-5 views into it (small leaves are exempt: pickle may inline
    them). Containers (list/tuple/set/dict) are walked; other objects are
    ignored. Rebuilt tensors are copies by design and are not counted."""
    base = np.frombuffer(source, np.uint8)
    lo = base.ctypes.data
    hi = lo + base.nbytes
    total = 0
    stack = [value]
    seen: set = set()
    while stack:
        v = stack.pop()
        if id(v) in seen:
            continue
        seen.add(id(v))
        if isinstance(v, np.ndarray):
            if v.nbytes > threshold:
                ptr = v.__array_interface__["data"][0]
                span = v.nbytes if v.flags["C_CONTIGUOUS"] else None
                if span is None:
                    # Strided view: judge by its base allocation.
                    b = v
                    while b.base is not None and isinstance(b.base,
                                                            np.ndarray):
                        b = b.base
                    ptr = b.__array_interface__["data"][0]
                    span = b.nbytes
                if not (lo <= ptr and ptr + span <= hi):
                    total += v.nbytes
        elif isinstance(v, (bytes, bytearray)):
            # bytes always materialize on unpickle; only count big ones
            # (they should have travelled out-of-band as buffers).
            if len(v) > threshold:
                total += len(v)
        elif isinstance(v, (list, tuple, set, frozenset)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return total


def copied_part_bytes(parts, threshold: int = 1 << 12) -> int:
    """Copy-audit helper: bytes held in materialized `bytes` parts above
    `threshold`, i.e. payload bytes that were COPIED out of their source
    buffer instead of travelling as pickle-5 out-of-band memoryviews. The
    zero-copy put discipline keeps this at 0 for large values (small parts,
    the struct headers and the pickle header, are exempt)."""
    return sum(len(p) for p in parts
               if isinstance(p, (bytes, bytearray)) and len(p) > threshold)


_context: SerializationContext | None = None


def get_context() -> SerializationContext:
    global _context
    if _context is None:
        _context = SerializationContext()
    return _context
