"""EBML-style variable-length integers and TLV sections.

Capability parity with the reference's ``Encap`` (SURVEY.md C12,
srcfile:Encap.cpp, sym Encap::setID @0x420720): big-endian varints whose
byte length is marked by the position of the leading 1-bit, used to tag and
size every section so parts of an archive are independently seekable.

1-byte: 0b1xxxxxxx (7-bit payload), 2-byte: 0b01xxxxxx xxxxxxxx (14-bit), ...
up to 8 bytes (56-bit payload).
"""

from __future__ import annotations

import io
from typing import BinaryIO, Tuple


def write_varint(value: int) -> bytes:
    if value < 0:
        raise ValueError("varint must be non-negative")
    for nbytes in range(1, 9):
        payload_bits = 7 * nbytes
        if value < (1 << payload_bits) - 1:  # reserve all-ones as invalid
            marker = 1 << payload_bits
            return (marker | value).to_bytes(nbytes, "big")
    raise ValueError(f"varint too large: {value}")


def read_varint(buf: BinaryIO) -> int:
    first = buf.read(1)
    if not first:
        raise EOFError("varint: unexpected EOF")
    b0 = first[0]
    if b0 == 0:
        raise ValueError("varint: invalid leading zero byte")
    nbytes = 1
    probe = 0x80
    while not (b0 & probe):
        probe >>= 1
        nbytes += 1
    rest = buf.read(nbytes - 1)
    if len(rest) != nbytes - 1:
        raise EOFError("varint: truncated")
    raw = int.from_bytes(first + rest, "big")
    return raw & ~(1 << (7 * nbytes))


def write_tlv(tag: int, payload: bytes) -> bytes:
    return write_varint(tag) + write_varint(len(payload)) + payload


def read_tlv(buf: BinaryIO) -> Tuple[int, bytes]:
    tag = read_varint(buf)
    size = read_varint(buf)
    payload = buf.read(size)
    if len(payload) != size:
        raise EOFError(f"TLV tag {tag}: truncated payload")
    return tag, payload


def iter_tlv(raw: bytes):
    buf = io.BytesIO(raw)
    end = len(raw)
    while buf.tell() < end:
        yield read_tlv(buf)
