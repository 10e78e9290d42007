"""Wire codec for the cluster transport layer.

Messages crossing a :class:`~repro_torch.transport.bus.MessageBus`
carry arbitrary Python payloads — region values (torch tensors, numpy
arrays, state dicts of both), stage instances, placement metadata.  The codec turns a payload into bytes
and back through a small *codec registry*:

* **tensors** — a ``torch.Tensor`` on any device is encoded as
  ``(dtype name, shape, raw bytes of its contiguous CPU copy)``
  (bfloat16 rides as its ``uint8`` view) and decodes to a **CPU**
  tensor of the same dtype and shape: nothing is ever rebuilt on a card
  by the receiver.  The receiving ``gpu`` variant uploads what it reads;
* **arrays** — numpy arrays are encoded as ``(dtype, shape, raw
  bytes)`` so the receiving side reconstructs them without a pickle
  round-trip and large payloads stay a single contiguous buffer inside
  the msgpack frame (the same bytes as the JAX package's codec);
* **anything else msgpack cannot express** (dataclasses, sets,
  StageInstance graphs) falls back to pickle, wrapped so it still
  travels inside the same frame.

msgpack is preferred (compact, zero-copy ``bin`` fields); when the
module is absent the codec degrades to pure pickle framing — same API,
same tests, slower wire format.  Pickle, both the framing and the
fallback inside a msgpack frame, runs through :class:`_Pickler`, whose
``reducer_override`` sends a tensor through the same encoding, so a
value decodes alike with and without msgpack.  Sequences decode as tuples
(``use_list=False``) so region keys like ``("op", 42)`` survive the
round trip unchanged.
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass
from typing import Any, Callable, Optional

try:  # optional dependency: degrade to pickle framing if absent
    import msgpack
except ModuleNotFoundError:  # pragma: no cover - container has msgpack
    msgpack = None

import numpy as np
import torch

__all__ = ["Codec", "WireCodec", "default_codec"]

_ND = "__nd__"
_PKL = "__pkl__"
_EXT = "__ext__"


@dataclass(frozen=True)
class Codec:
    """One pluggable entry of the codec registry.

    ``matches`` decides whether this codec handles a value; ``encode``
    must return a msgpack-representable dict tagged with ``tag``;
    ``decode`` inverts it.  Registered codecs are tried in order,
    before the pickle fallback.
    """

    tag: str
    matches: Callable[[Any], bool]
    encode: Callable[[Any], dict]
    decode: Callable[[dict], Any]


def _cpu_bytes(value: torch.Tensor) -> tuple[torch.Tensor, np.ndarray]:
    """A tensor's contiguous CPU copy (a CUDA tensor is downloaded
    here) and a ``uint8`` view of its bytes."""
    cpu = value.detach().to("cpu").contiguous()
    return cpu, cpu.reshape(-1).view(torch.uint8).numpy()


def _tensor_parts(value: torch.Tensor) -> tuple[str, list, bytes]:
    """``(dtype name, shape, raw bytes)`` of a tensor's CPU copy."""
    cpu, raw = _cpu_bytes(value)
    return str(cpu.dtype).removeprefix("torch."), list(cpu.shape), raw.tobytes()


def _tensor_from_parts(dtype: str, shape, data: bytes) -> torch.Tensor:
    """Inverse of :func:`_tensor_parts`: a CPU tensor owning its bytes."""
    dt = getattr(torch, dtype)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {dtype!r}")
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else (
        torch.empty(0, dtype=torch.uint8))
    return raw.view(dt).reshape(tuple(shape))


def _is_tensor(value: Any) -> bool:
    return isinstance(value, torch.Tensor)


def _encode_tensor(value: torch.Tensor) -> dict:
    dtype, shape, data = _tensor_parts(value)
    return {"t": dtype, "s": shape, "b": data}


def _decode_tensor(obj: dict) -> torch.Tensor:
    return _tensor_from_parts(obj["t"], obj["s"], obj["b"])


class _Pickler(pickle.Pickler):
    """Pickler that reduces a tensor to :func:`_tensor_parts` (decoded
    as a CPU tensor); everything else pickles as ``pickle.dumps`` would."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            return _tensor_from_parts, _tensor_parts(obj)
        return NotImplemented


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _is_arraylike(value: Any) -> bool:
    return isinstance(value, np.ndarray) or (
        hasattr(value, "__array__") and hasattr(value, "dtype")
        and hasattr(value, "shape") and not np.isscalar(value)
    )


def _encode_array(value: Any) -> dict:
    arr = np.ascontiguousarray(np.asarray(value))
    return {
        "d": arr.dtype.str,
        "s": list(arr.shape),
        "b": arr.tobytes(),
    }


def _decode_array(obj: dict) -> np.ndarray:
    return np.frombuffer(obj["b"], dtype=np.dtype(obj["d"])).reshape(
        tuple(obj["s"])
    ).copy()


#: Tensors first: a tensor also satisfies ``_is_arraylike`` (it has
#: ``__array__``), and ``np.asarray`` raises on a CUDA tensor and has no
#: bfloat16.  Order matters.
_TENSOR_CODEC = Codec("pt", _is_tensor, _encode_tensor, _decode_tensor)
_ARRAY_CODEC = Codec("nd", _is_arraylike, _encode_array, _decode_array)


class WireCodec:
    """Encode/decode whole message frames (lists of message tuples)."""

    def __init__(self, codecs: Optional[list[Codec]] = None):
        self.codecs: list[Codec] = (
            list(codecs) if codecs else [_TENSOR_CODEC, _ARRAY_CODEC]
        )
        # Traffic counters (benchmarks read these).
        self.encoded_bytes = 0
        self.decoded_bytes = 0
        self.pickle_fallbacks = 0

    def register(self, codec: Codec) -> None:
        self.codecs.insert(0, codec)

    # -- msgpack hooks -----------------------------------------------------

    def _default(self, obj: Any) -> Any:
        for codec in self.codecs:
            if codec.matches(obj):
                body = codec.encode(obj)
                body[_EXT] = codec.tag
                return body
        self.pickle_fallbacks += 1
        return {_PKL: _dumps(obj)}

    def _object_hook(self, obj: dict) -> Any:
        tag = obj.get(_EXT)
        if tag is not None:
            for codec in self.codecs:
                if codec.tag == tag:
                    return codec.decode(obj)
        if _PKL in obj:
            return pickle.loads(obj[_PKL])
        return obj

    # -- framing -----------------------------------------------------------

    def encode(self, obj: Any) -> bytes:
        if msgpack is None:  # pure-pickle degradation
            data = _dumps(obj)
        else:
            data = msgpack.packb(obj, default=self._default, use_bin_type=True)
        self.encoded_bytes += len(data)
        return data

    def decode(self, data: bytes) -> Any:
        self.decoded_bytes += len(data)
        if msgpack is None:
            return pickle.loads(data)
        return msgpack.unpackb(
            data,
            object_hook=self._object_hook,
            use_list=False,
            strict_map_key=False,
            raw=False,
        )


def default_codec() -> WireCodec:
    """Fresh codec with the built-in tensor and array handlers registered."""
    return WireCodec()
