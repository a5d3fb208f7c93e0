"""Minimal protobuf wire-format codec (no google.protobuf dependency).

The reference engine deserializes ONNX with the `onnx-protobuf` Rust crate
(reference: src/main.rs:30). This framework instead ships a tiny hand-rolled
wire codec: enough of proto3 encoding to read and write ONNX ModelProto /
TensorProto messages (schema semantics per the public ONNX spec, vendored in
the reference at models/onnx.proto). Both directions are implemented because
the framework also *synthesizes* ONNX models (the reference checkout is
missing its large model blobs).

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

__all__ = [
    "WireReader",
    "WireWriter",
    "decode_varint",
    "encode_varint",
    "zigzag_decode",
    "zigzag_encode",
]


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode one varint at `pos`; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long / corrupt buffer")


def encode_varint(value: int) -> bytes:
    if value < 0:
        # Negative int32/int64 fields are encoded as 10-byte two's-complement varints.
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag_decode(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def zigzag_encode(value: int) -> int:
    return (value << 1) ^ (value >> 63)


def _to_signed64(value: int) -> int:
    """Varint-decoded ints are unsigned; int32/int64 proto fields are two's complement."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


class WireReader:
    """Streaming reader over one serialized message."""

    def __init__(self, buf: bytes, start: int = 0, end: int | None = None):
        self.buf = buf
        self.pos = start
        self.end = len(buf) if end is None else end

    def __iter__(self) -> Iterator[Tuple[int, int, object]]:
        """Yield (field_number, wire_type, value).

        value is: int for varint (unsigned-decoded; use int64() helpers for
        signedness), bytes(memoryview) for length-delimited, raw 8/4 bytes for
        fixed64/fixed32.
        """
        buf, end = self.buf, self.end
        pos = self.pos
        while pos < end:
            key, pos = decode_varint(buf, pos)
            field, wire = key >> 3, key & 7
            if wire == 0:
                value, pos = decode_varint(buf, pos)
            elif wire == 2:
                length, pos = decode_varint(buf, pos)
                if pos + length > end:
                    # a silent short slice here would "successfully" parse a
                    # truncated file into a partial model; fail loudly instead
                    raise ValueError(
                        f"truncated length-delimited field at byte {pos}")
                value = memoryview(buf)[pos : pos + length]
                pos += length
            elif wire == 5:
                if pos + 4 > end:
                    raise ValueError(f"truncated fixed32 at byte {pos}")
                value = memoryview(buf)[pos : pos + 4]
                pos += 4
            elif wire == 1:
                if pos + 8 > end:
                    raise ValueError(f"truncated fixed64 at byte {pos}")
                value = memoryview(buf)[pos : pos + 8]
                pos += 8
            elif wire in (3, 4):  # group start/end — obsolete, skip silently
                value = None
            else:
                raise ValueError(f"unsupported wire type {wire} at byte {pos}")
            yield field, wire, value
        self.pos = pos

    # -- typed helpers -------------------------------------------------
    @staticmethod
    def as_int64(v: object) -> int:
        return _to_signed64(int(v))  # type: ignore[arg-type]

    @staticmethod
    def as_string(v: object) -> str:
        return bytes(v).decode("utf-8")  # type: ignore[arg-type]

    @staticmethod
    def as_float32(v: object) -> float:
        return struct.unpack("<f", bytes(v))[0]  # type: ignore[arg-type]

    @staticmethod
    def as_float64(v: object) -> float:
        return struct.unpack("<d", bytes(v))[0]  # type: ignore[arg-type]

    @staticmethod
    def packed_varints(v: object) -> List[int]:
        buf = bytes(v)  # type: ignore[arg-type]
        out: List[int] = []
        pos = 0
        while pos < len(buf):
            val, pos = decode_varint(buf, pos)
            out.append(_to_signed64(val))
        return out


class WireWriter:
    """Append-only message builder."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def _key(self, field: int, wire: int) -> None:
        self._parts.append(encode_varint((field << 3) | wire))

    def varint(self, field: int, value: int) -> "WireWriter":
        self._key(field, 0)
        self._parts.append(encode_varint(value))
        return self

    def bytes_field(self, field: int, value: bytes) -> "WireWriter":
        self._key(field, 2)
        self._parts.append(encode_varint(len(value)))
        self._parts.append(value)
        return self

    def string(self, field: int, value: str) -> "WireWriter":
        return self.bytes_field(field, value.encode("utf-8"))

    def message(self, field: int, sub: "WireWriter") -> "WireWriter":
        return self.bytes_field(field, sub.getvalue())

    def float32(self, field: int, value: float) -> "WireWriter":
        self._key(field, 5)
        self._parts.append(struct.pack("<f", value))
        return self

    def packed_varints(self, field: int, values) -> "WireWriter":
        if len(values) == 0:
            return self
        payload = b"".join(encode_varint(int(v)) for v in values)
        return self.bytes_field(field, payload)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)
