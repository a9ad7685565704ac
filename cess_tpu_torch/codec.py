"""Canonical deterministic binary codec — the framework's SCALE analog.

The reference serializes everything (extrinsics, blocks, storage) with
SCALE (parity-scale-codec). This framework needs the same property — a
byte-exact, deterministic encoding shared by signing payloads, the
gossip wire, and the on-disk block/state stores — without depending on
Python ``repr`` or pickle (non-canonical / unsafe to decode from
peers).

Encoding: 1-byte tag + payload. Lengths and ints are LEB128 varints
(ints zigzag-encoded, arbitrary precision). Dicts sort entries by
encoded key bytes; sets sort encoded items — so logically equal values
encode identically. Dataclasses are encoded by registered name + field
values in declaration order; decoding an unregistered name is an error
(no arbitrary-object construction from untrusted bytes, unlike pickle).

numpy arrays encode as (dtype, shape, raw bytes) — required for the
PoDR2 proof blobs whose wire size the chain's SIGMA_MAX cap measures.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

_NONE, _FALSE, _TRUE, _INT, _BYTES, _STR, _TUPLE, _LIST, _DICT, _SET, \
    _DATACLASS, _NDARRAY = range(12)

_REGISTRY: dict[str, type] = {}


def register(cls):
    """Class decorator: make a dataclass codec-encodable by name."""
    name = cls.__name__
    if name in _REGISTRY and _REGISTRY[name] is not cls:
        raise ValueError(f"codec name collision: {name}")
    _REGISTRY[name] = cls
    return cls


class CodecError(ValueError):
    pass


# Nesting bound for both encode and decode: a 2 KiB blob (SIGMA_MAX)
# can otherwise nest ~1024 one-element tuples and blow the Python
# recursion limit — RecursionError from a peer-supplied proof must not
# crash the TEE worker or prevent block-log replay. 32 is far above any
# legitimate protocol structure (extrinsics nest ~4 deep).
MAX_DEPTH = 32


# -- varints -----------------------------------------------------------------
def _write_uvarint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return


def _write_varint(out: bytearray, n: int) -> None:
    _write_uvarint(out, (n << 1) ^ (n >> (n.bit_length() + 1)) if n < 0
                   else n << 1)


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(data):
            raise CodecError("truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    u, pos = _read_uvarint(data, pos)
    return (u >> 1) ^ -(u & 1), pos


# -- encode ------------------------------------------------------------------
def _encode_one(obj: Any, depth: int) -> bytes:
    out = bytearray()
    _encode_into(out, obj, depth)
    return bytes(out)


def _encode_into(out: bytearray, obj: Any, depth: int = 0) -> None:
    if depth > MAX_DEPTH:
        raise CodecError("nesting too deep")
    if obj is None:
        out.append(_NONE)
    elif obj is True:
        out.append(_TRUE)
    elif obj is False:
        out.append(_FALSE)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        out.append(_INT)
        _write_varint(out, obj)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_BYTES)
        _write_uvarint(out, len(obj))
        out.extend(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_STR)
        _write_uvarint(out, len(raw))
        out.extend(raw)
    elif isinstance(obj, np.ndarray):
        out.append(_NDARRAY)
        dt = np.dtype(obj.dtype).str.encode()
        _write_uvarint(out, len(dt))
        out.extend(dt)
        _write_uvarint(out, obj.ndim)
        for d in obj.shape:
            _write_uvarint(out, d)
        raw = np.ascontiguousarray(obj).tobytes()
        _write_uvarint(out, len(raw))
        out.extend(raw)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if _REGISTRY.get(name) is not type(obj):
            raise CodecError(f"unregistered dataclass: {name}")
        out.append(_DATACLASS)
        raw = name.encode()
        _write_uvarint(out, len(raw))
        out.extend(raw)
        fields = dataclasses.fields(obj)
        _write_uvarint(out, len(fields))
        for f in fields:
            _encode_into(out, getattr(obj, f.name), depth + 1)
    elif isinstance(obj, tuple):
        out.append(_TUPLE)
        _write_uvarint(out, len(obj))
        for item in obj:
            _encode_into(out, item, depth + 1)
    elif isinstance(obj, list):
        out.append(_LIST)
        _write_uvarint(out, len(obj))
        for item in obj:
            _encode_into(out, item, depth + 1)
    elif isinstance(obj, dict):
        entries = sorted((_encode_one(k, depth + 1), _encode_one(v, depth + 1))
                         for k, v in obj.items())
        out.append(_DICT)
        _write_uvarint(out, len(entries))
        for ek, ev in entries:
            out.extend(ek)
            out.extend(ev)
    elif isinstance(obj, (set, frozenset)):
        entries = sorted(_encode_one(i, depth + 1) for i in obj)
        out.append(_SET)
        _write_uvarint(out, len(entries))
        for e in entries:
            out.extend(e)
    else:
        raise CodecError(f"unencodable type: {type(obj).__name__}")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _encode_into(out, obj)
    return bytes(out)


# -- decode ------------------------------------------------------------------
def _read_raw(data: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = _read_uvarint(data, pos)
    if pos + n > len(data):
        raise CodecError("truncated payload")
    return data[pos:pos + n], pos + n


def _decode_at(data: bytes, pos: int,
               depth: int = 0) -> tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise CodecError("nesting too deep")
    if pos >= len(data):
        raise CodecError("truncated value")
    tag = data[pos]
    pos += 1
    if tag == _NONE:
        return None, pos
    if tag == _TRUE:
        return True, pos
    if tag == _FALSE:
        return False, pos
    if tag == _INT:
        return _read_varint(data, pos)
    if tag == _BYTES:
        return _read_raw(data, pos)
    if tag == _STR:
        raw, pos = _read_raw(data, pos)
        return raw.decode("utf-8"), pos
    if tag == _NDARRAY:
        dt, pos = _read_raw(data, pos)
        ndim, pos = _read_uvarint(data, pos)
        shape = []
        for _ in range(ndim):
            d, pos = _read_uvarint(data, pos)
            shape.append(d)
        raw, pos = _read_raw(data, pos)
        # untrusted input: dtype strings and shape/byte-count mismatches
        # must surface as CodecError, not numpy ValueError/TypeError
        try:
            arr = np.frombuffer(raw, dtype=np.dtype(dt.decode())) \
                .reshape(shape)
        except (ValueError, TypeError) as e:
            raise CodecError(f"bad ndarray: {e}") from None
        return arr.copy(), pos
    if tag == _DATACLASS:
        raw, pos = _read_raw(data, pos)
        cls = _REGISTRY.get(raw.decode())
        if cls is None:
            raise CodecError(f"unknown dataclass: {raw.decode()!r}")
        n, pos = _read_uvarint(data, pos)
        fields = dataclasses.fields(cls)
        if n != len(fields):
            raise CodecError(f"field count mismatch for {raw.decode()}")
        values = []
        for _ in range(n):
            v, pos = _decode_at(data, pos, depth + 1)
            values.append(v)
        return cls(*values), pos
    if tag in (_TUPLE, _LIST, _SET):
        n, pos = _read_uvarint(data, pos)
        items = []
        for _ in range(n):
            v, pos = _decode_at(data, pos, depth + 1)
            items.append(v)
        if tag == _TUPLE:
            return tuple(items), pos
        if tag == _SET:
            return frozenset(items), pos
        return items, pos
    if tag == _DICT:
        n, pos = _read_uvarint(data, pos)
        d = {}
        for _ in range(n):
            k, pos = _decode_at(data, pos, depth + 1)
            v, pos = _decode_at(data, pos, depth + 1)
            d[k] = v
        return d, pos
    raise CodecError(f"unknown tag: {tag}")


def decode(data: bytes) -> Any:
    obj, pos = _decode_at(data, 0)
    if pos != len(data):
        raise CodecError(f"trailing bytes: {len(data) - pos}")
    return obj
