"""CRC32 integrity envelope for region payloads.

Region bytes crossing the worker-to-worker data plane are wrapped in a
``("crc32", checksum, value)`` envelope by the sender and verified by
the receiver.  Verification failure is treated exactly like a stale
holder: the receiver drops the payload and re-fetches from an
alternate holder (direct-dial leftover path or coordinator relay).

The sender seals the value it holds (state dicts of CUDA tensors on a
``gpu`` lane); the receiver checks the value the wire codec decoded
(CPU tensors; lists come back as tuples, ``float``/``str`` subclasses
as the builtin types).  So the checksum is canonical and independent
of device: tensors and arrays hash by dtype, shape and the bytes of
their CPU copy, dicts in key order, lists and tuples alike, builtin
scalars by value; anything else through the codec's pickler, which
reduces any tensor inside it to the same (dtype, shape, bytes).  An
``np.ndarray`` hashes exactly as in the JAX package.

``unseal`` passes unsealed legacy payloads through as valid so the
envelope can be introduced without a flag day on mixed deployments.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Tuple

try:  # pragma: no cover - numpy is present in the toolchain image
    import numpy as np
except Exception:  # pragma: no cover
    np = None  # type: ignore[assignment]
import torch

from ..transport.codec import _cpu_bytes, _dumps

_TAG = "crc32"


def _crc(value: Any, crc: int) -> int:
    if np is not None and isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(value)
        header = f"{arr.dtype.str}|{arr.shape}".encode()
        return zlib.crc32(arr.view(np.uint8).reshape(-1), zlib.crc32(header, crc))
    if isinstance(value, torch.Tensor):
        cpu, raw = _cpu_bytes(value)
        header = f"{cpu.dtype}|{tuple(cpu.shape)}".encode()
        return zlib.crc32(raw, zlib.crc32(header, crc))
    if isinstance(value, dict):
        crc = zlib.crc32(b"{%d" % len(value), crc)
        for key in sorted(value, key=repr):
            crc = _crc(value[key], _crc(key, crc))
        return crc
    if isinstance(value, (list, tuple)):
        crc = zlib.crc32(b"[%d" % len(value), crc)
        for item in value:
            crc = _crc(item, crc)
        return crc
    if isinstance(value, (set, frozenset)):
        crc = zlib.crc32(b"<%d" % len(value), crc)
        for item in sorted(value, key=repr):
            crc = _crc(item, crc)
        return crc
    if isinstance(value, bool) or value is None:
        return zlib.crc32(_dumps(value), crc)
    if isinstance(value, int):
        return zlib.crc32(b"i%d" % value, crc)
    if isinstance(value, float):
        return zlib.crc32(b"f" + struct.pack("<d", value), crc)
    if isinstance(value, str):
        return zlib.crc32(b"s" + value.encode("utf-8", "surrogatepass"), crc)
    if isinstance(value, (bytes, bytearray)):
        return zlib.crc32(b"b" + bytes(value), crc)
    return zlib.crc32(_dumps(value), crc)


def region_crc(value: Any) -> int:
    """Canonical CRC32 of a region payload (see the module docstring)."""
    return _crc(value, 0)


def seal(value: Any) -> Tuple[str, int, Any]:
    """Wrap a payload in a checksum envelope for the wire."""
    return (_TAG, region_crc(value), value)


def unseal(obj: Any) -> Tuple[Any, bool]:
    """Return ``(value, ok)``.  Unsealed payloads pass through as valid."""
    if (isinstance(obj, (tuple, list)) and len(obj) == 3 and obj[0] == _TAG
            and isinstance(obj[1], int)):
        value = obj[2]
        return value, region_crc(value) == obj[1]
    return obj, True
