"""Binary wire format for the multi-process fleet (counterpart of
``paddle_tpu/inference/fleet/wire.py``, byte for byte).

Everything that crosses a process boundary — RPC requests/replies, the
``extract()``/``inject()`` host-KV snapshots, structured terminal
outcomes — rides ONE frame format::

    magic 'PTF1' | codec u8 | payload_len u32 | crc32 u32 | payload

The payload is the same data model under two interchangeable codecs:
msgpack when the interpreter has it (the default — ext type 1 carries
ndarrays as ``dtype|shape|raw bytes``, ext type 2 preserves tuples,
which matters because int8-KV leaves are ``(codes, scales)`` tuples and
a list round-trip would break the bitwise inject contract), and a
pure-stdlib packer with the identical model as a no-dependency
fallback.  The codec byte travels in the frame header so the two ends
never have to agree out of band.

Arrays round-trip BITWISE: int8 KV codes + per-row f32 scales arrive
exactly as extracted (the EQuARX-style quantized wire — the codes
already halve the bytes a fp16 snapshot would cost).  A truncated or
corrupt frame raises :class:`FrameError` loudly; nothing downstream
ever sees a partially-decoded snapshot.

The port's snapshots are CPU torch tensors.  A tensor (or a numpy
array) is written under the reference's array tag with its dtype's
name (``"float32"``, ``"int8"``, ``"bfloat16"``, ...), its shape and its
raw bytes, so a frame is byte-identical to the reference's for the same
payload; every array tag decodes to a CPU torch tensor, bfloat16
included, with no numpy bfloat16 type.
"""

from __future__ import annotations

import struct
import time
import zlib

import numpy as np
import torch

try:
    import msgpack as _msgpack
except ImportError:  # optional: the stdlib codec is the default then
    _msgpack = None

MAGIC = b"PTF1"
_HEADER = struct.Struct(">4sBII")          # magic, codec, len, crc32
HEADER_SIZE = _HEADER.size
MAX_FRAME = 1 << 31                        # sanity bound, not a limit

CODEC_MSGPACK = 1
CODEC_STDLIB = 2
DEFAULT_CODEC = CODEC_MSGPACK if _msgpack is not None else CODEC_STDLIB


class FrameError(ValueError):
    """A frame failed validation (truncated, bad magic, CRC mismatch,
    malformed payload).  Raised loudly instead of returning garbage."""


def available_codecs():
    return ((CODEC_MSGPACK, CODEC_STDLIB) if _msgpack is not None
            else (CODEC_STDLIB,))


# -- stdlib payload codec ----------------------------------------------------
#
# Tagged, length-prefixed, big-endian.  Tags: N/T/F none+bool, i i64,
# f f64, s str, b bytes, a array, t tuple, l list, d dict.

_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U32 = struct.Struct(">I")


def _array_parts(obj):
    """(dtype name, shape, raw little-endian bytes) of a tensor or a numpy
    array, C order.  A 0-d array travels as shape (1,), as the
    reference's ``np.ascontiguousarray`` makes it."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return name, tuple(t.shape) or (1,), raw
    a = np.ascontiguousarray(obj)
    return str(a.dtype), a.shape, a.tobytes()


def _array_from(name, shape, raw):
    """A CPU tensor of dtype ``name`` (a torch dtype's name, which is the
    numpy name for every dtype a snapshot holds) from raw bytes."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise FrameError(f"wire: unknown array dtype {name!r}")
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def _std_pack_into(obj, out):
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, (int, np.integer)):
        out.append(b"i" + _I64.pack(int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(b"f" + _F64.pack(float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(b"s" + _U32.pack(len(raw)) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(b"b" + _U32.pack(len(raw)) + raw)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        name, shape, raw = _array_parts(obj)
        dt = name.encode("ascii")
        out.append(b"a" + _U32.pack(len(dt)) + dt + _U32.pack(len(shape)))
        for dim in shape:
            out.append(_U32.pack(dim))
        out.append(_U32.pack(len(raw)) + raw)
    elif isinstance(obj, tuple):
        out.append(b"t" + _U32.pack(len(obj)))
        for x in obj:
            _std_pack_into(x, out)
    elif isinstance(obj, list):
        out.append(b"l" + _U32.pack(len(obj)))
        for x in obj:
            _std_pack_into(x, out)
    elif isinstance(obj, dict):
        out.append(b"d" + _U32.pack(len(obj)))
        for k, v in obj.items():
            _std_pack_into(k, out)
            _std_pack_into(v, out)
    else:
        raise TypeError(f"wire: cannot encode {type(obj).__name__!r}")


class _StdUnpacker:
    def __init__(self, buf):
        self.buf = buf
        self.off = 0

    def _take(self, n):
        end = self.off + n
        if end > len(self.buf):
            raise FrameError("wire: truncated payload")
        chunk = self.buf[self.off:end]
        self.off = end
        return chunk

    def _u32(self):
        return _U32.unpack(self._take(4))[0]

    def unpack(self):
        tag = self._take(1)
        if tag == b"N":
            return None
        if tag == b"T":
            return True
        if tag == b"F":
            return False
        if tag == b"i":
            return _I64.unpack(self._take(8))[0]
        if tag == b"f":
            return _F64.unpack(self._take(8))[0]
        if tag == b"s":
            return self._take(self._u32()).decode("utf-8")
        if tag == b"b":
            return bytes(self._take(self._u32()))
        if tag == b"a":
            name = self._take(self._u32()).decode("ascii")
            shape = tuple(self._u32() for _ in range(self._u32()))
            return _array_from(name, shape, self._take(self._u32()))
        if tag == b"t":
            return tuple(self.unpack() for _ in range(self._u32()))
        if tag == b"l":
            return [self.unpack() for _ in range(self._u32())]
        if tag == b"d":
            n = self._u32()
            return {self.unpack(): self.unpack() for _ in range(n)}
        raise FrameError(f"wire: unknown tag {tag!r}")


def _std_encode(obj):
    out = []
    _std_pack_into(obj, out)
    return b"".join(out)


def _std_decode(buf):
    up = _StdUnpacker(buf)
    obj = up.unpack()
    if up.off != len(buf):
        raise FrameError("wire: trailing bytes after payload")
    return obj


# -- msgpack payload codec ---------------------------------------------------

_EXT_NDARRAY = 1
_EXT_TUPLE = 2


def _mp_default(obj):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        name, shape, raw = _array_parts(obj)
        header = _std_encode([name, list(shape)])
        return _msgpack.ExtType(
            _EXT_NDARRAY, _U32.pack(len(header)) + header + raw)
    if isinstance(obj, tuple):
        return _msgpack.ExtType(_EXT_TUPLE, _mp_encode(list(obj)))
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"wire: cannot encode {type(obj).__name__!r}")


def _mp_ext_hook(code, data):
    if code == _EXT_NDARRAY:
        hlen = _U32.unpack(data[:4])[0]
        name, shape = _std_decode(data[4:4 + hlen])
        return _array_from(name, tuple(shape), data[4 + hlen:])
    if code == _EXT_TUPLE:
        return tuple(_mp_decode(data))
    raise FrameError(f"wire: unknown ext type {code}")


def _mp_encode(obj):
    # strict_types so tuples hit the default hook instead of silently
    # becoming lists (the int8 (codes, scales) leaves must stay tuples)
    return _msgpack.packb(obj, default=_mp_default, strict_types=True,
                          use_bin_type=True)


def _mp_decode(buf):
    return _msgpack.unpackb(buf, ext_hook=_mp_ext_hook, raw=False,
                            strict_map_key=False)


# -- frame layer -------------------------------------------------------------

def encode_payload(obj, codec=None):
    codec = DEFAULT_CODEC if codec is None else codec
    if codec == CODEC_MSGPACK:
        if _msgpack is None:
            raise FrameError("wire: msgpack codec unavailable")
        return _mp_encode(obj)
    if codec == CODEC_STDLIB:
        return _std_encode(obj)
    raise FrameError(f"wire: unknown codec {codec}")


def decode_payload(buf, codec):
    try:
        if codec == CODEC_MSGPACK:
            if _msgpack is None:
                raise FrameError("wire: msgpack codec unavailable")
            return _mp_decode(buf)
        if codec == CODEC_STDLIB:
            return _std_decode(buf)
    except FrameError:
        raise
    except Exception as exc:
        raise FrameError(f"wire: malformed payload ({exc!r})") from exc
    raise FrameError(f"wire: unknown codec {codec}")


def encode_frame(obj, codec=None):
    codec = DEFAULT_CODEC if codec is None else codec
    payload = encode_payload(obj, codec)
    return _HEADER.pack(MAGIC, codec, len(payload),
                        zlib.crc32(payload)) + payload


def parse_header(header):
    """Validate a 13-byte frame header -> (codec, payload_len, crc)."""
    if len(header) < HEADER_SIZE:
        raise FrameError(
            f"wire: truncated header ({len(header)}/{HEADER_SIZE} bytes)")
    magic, codec, length, crc = _HEADER.unpack(header[:HEADER_SIZE])
    if magic != MAGIC:
        raise FrameError(f"wire: bad magic {magic!r}")
    if length > MAX_FRAME:
        raise FrameError(f"wire: frame length {length} exceeds bound")
    return codec, length, crc


def decode_frame(buf):
    """Decode one complete frame from ``buf`` (exact size required)."""
    codec, length, crc = parse_header(buf)
    payload = buf[HEADER_SIZE:]
    if len(payload) != length:
        raise FrameError(
            f"wire: truncated frame ({len(payload)}/{length} payload bytes)")
    if zlib.crc32(payload) != crc:
        raise FrameError("wire: CRC mismatch (corrupt frame)")
    return decode_payload(payload, codec)


def read_frame(read_exact):
    """Read one frame via ``read_exact(n) -> bytes`` (pipe/socket)."""
    header = read_exact(HEADER_SIZE)
    codec, length, crc = parse_header(header)
    payload = read_exact(length)
    if len(payload) != length:
        raise FrameError(
            f"wire: truncated frame ({len(payload)}/{length} payload bytes)")
    if zlib.crc32(payload) != crc:
        raise FrameError("wire: CRC mismatch (corrupt frame)")
    return decode_payload(payload, codec)


# -- request serialization ---------------------------------------------------
#
# The migration payload: a live _Request (waiting or extracted-with-KV)
# shipped between replica processes.  ``on_token`` never crosses the
# wire — token streaming is the transport's event channel, and the
# receiving server re-attaches its own buffer callback on inject.
# Deadlines are engine-local perf_counter() absolutes, so they travel
# as remaining-seconds and get re-anchored on the receiving clock.  The
# swapped KV is the engine's host snapshot: CPU tensors [L, Hkv, n,
# page, D] per cache, an int8 cache's leaves a (codes, scales) tuple.

def request_to_wire(req, clock=time.perf_counter):
    d = {
        "rid": int(req.rid),
        "prompt": [int(t) for t in req.prompt],
        "generated": [int(t) for t in req.generated],
        "seq_tokens": [int(t) for t in req.seq_tokens],
        "length": int(req.length),
        "prefill_pos": int(req.prefill_pos),
        "temperature": float(req.temperature),
        "top_k": int(req.top_k),
        "top_p": float(req.top_p),
        "deadline_remaining": (None if req.deadline is None
                               else float(req.deadline - clock())),
        "swapped": None,
    }
    if req.swapped is not None:
        s = req.swapped
        d["swapped"] = {
            "k": s["k"], "v": s["v"], "n": int(s["n"]),
            "prefill_pos": int(s["prefill_pos"]),
            "length": int(s["length"]),
        }
    return d


def request_from_wire(d, clock=time.perf_counter):
    from ..serving import _Request

    req = _Request(int(d["rid"]), d["prompt"],
                   temperature=d["temperature"], top_k=d["top_k"],
                   top_p=d["top_p"])
    req.generated = [int(t) for t in d["generated"]]
    req.seq_tokens = [int(t) for t in d["seq_tokens"]]
    req.length = int(d["length"])
    req.prefill_pos = int(d["prefill_pos"])
    if d.get("deadline_remaining") is not None:
        req.deadline = clock() + float(d["deadline_remaining"])
    s = d.get("swapped")
    if s is not None:
        req.swapped = {"k": s["k"], "v": s["v"], "n": int(s["n"]),
                       "prefill_pos": int(s["prefill_pos"]),
                       "length": int(s["length"])}
    return req
