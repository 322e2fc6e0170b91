"""Generic protobuf wire-format decoder/encoder (schema-less, tag-based).

Role parity: binary .caffemodel reading/writing (reference:
must_read_binary_proto caffepb.cc:474, write at :773-779) without linking
protobuf codegen: the wire format is parsed into {field_number: [values]}
trees; caffe_io.py interprets field numbers. Packed repeated scalars are
kept as raw bytes and decoded on demand by typed accessors.

The port's copy of boda_tpu/graph/pbwire.py.
"""

from __future__ import annotations

import struct
from typing import Union

import numpy as np

from ..core.error import RtErr


class WireNode:
    """Decoded message: field number → list of (wire_type, value).
    wire types: 0=varint(int), 1=64-bit(bytes), 2=length-delimited(bytes),
    5=32-bit(bytes)."""

    __slots__ = ("fields",)

    def __init__(self):
        self.fields: dict[int, list[tuple[int, Union[int, bytes]]]] = {}

    def add(self, fno: int, wt: int, v) -> None:
        self.fields.setdefault(fno, []).append((wt, v))

    # typed accessors
    def varint(self, fno: int, default=None):
        vs = self.fields.get(fno)
        if not vs:
            return default
        return vs[0][1]

    def varints(self, fno: int) -> list[int]:
        out = []
        for wt, v in self.fields.get(fno, []):
            if wt == 0:
                out.append(v)
            elif wt == 2:  # packed
                out.extend(decode_varints(v))
        return out

    def float_(self, fno: int, default=None):
        vs = self.fields.get(fno)
        if not vs:
            return default
        wt, v = vs[0]
        if wt == 5:
            return struct.unpack("<f", v)[0]
        if wt == 1:
            return struct.unpack("<d", v)[0]
        raise RtErr(f"field {fno}: not a float")

    def floats(self, fno: int) -> np.ndarray:
        chunks = []
        for wt, v in self.fields.get(fno, []):
            if wt == 5:
                chunks.append(np.frombuffer(v, dtype="<f4"))
            elif wt == 2:  # packed
                chunks.append(np.frombuffer(v, dtype="<f4"))
            else:
                raise RtErr(f"field {fno}: unexpected wire type {wt} for floats")
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(chunks)

    def bytes_field(self, fno: int, default: bytes = b"") -> bytes:
        vs = self.fields.get(fno)
        if not vs:
            return default
        return vs[0][1]

    def string(self, fno: int, default=None):
        vs = self.fields.get(fno)
        if not vs:
            return default
        return vs[0][1].decode("utf-8")

    def strings(self, fno: int) -> list[str]:
        return [v.decode("utf-8") for _wt, v in self.fields.get(fno, [])]

    def msg(self, fno: int):
        vs = self.fields.get(fno)
        if not vs:
            return None
        return decode_wire(vs[0][1])

    def msgs(self, fno: int) -> list["WireNode"]:
        return [decode_wire(v) for _wt, v in self.fields.get(fno, [])]

    def has(self, fno: int) -> bool:
        return fno in self.fields


def decode_varints(buf: bytes) -> list[int]:
    out = []
    v = 0
    shift = 0
    for b in buf:
        v |= (b & 0x7F) << shift
        if b & 0x80:
            shift += 7
        else:
            out.append(v)
            v = 0
            shift = 0
    return out


def decode_wire(buf: bytes) -> WireNode:
    node = WireNode()
    i, n = 0, len(buf)
    while i < n:
        # read tag varint
        tag = 0
        shift = 0
        while True:
            if i >= n:
                raise RtErr("pb wire: truncated tag")
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v = 0
            shift = 0
            while True:
                if i >= n:
                    raise RtErr("pb wire: truncated varint")
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            node.add(fno, 0, v)
        elif wt == 1:
            node.add(fno, 1, buf[i:i + 8])
            i += 8
        elif wt == 2:
            ln = 0
            shift = 0
            while True:
                if i >= n:
                    raise RtErr("pb wire: truncated length")
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            if i + ln > n:
                raise RtErr("pb wire: length-delimited field overruns buffer")
            node.add(fno, 2, buf[i:i + ln])
            i += ln
        elif wt == 5:
            node.add(fno, 5, buf[i:i + 4])
            i += 4
        else:
            raise RtErr(f"pb wire: unsupported wire type {wt} (field {fno})")
    return node


# ---- encoding ----


# ---- encoding ----

def enc_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_tag(fno: int, wt: int) -> bytes:
    return enc_varint((fno << 3) | wt)


def enc_field_varint(fno: int, v: int) -> bytes:
    return enc_tag(fno, 0) + enc_varint(int(v))


def enc_field_float(fno: int, v: float) -> bytes:
    return enc_tag(fno, 5) + struct.pack("<f", v)


def enc_field_bytes(fno: int, v: bytes) -> bytes:
    return enc_tag(fno, 2) + enc_varint(len(v)) + v


def enc_field_string(fno: int, s: str) -> bytes:
    return enc_field_bytes(fno, s.encode("utf-8"))


def enc_field_packed_floats(fno: int, arr: np.ndarray) -> bytes:
    return enc_field_bytes(fno, np.asarray(arr, "<f4").tobytes())


def enc_field_packed_varints(fno: int, vals) -> bytes:
    return enc_field_bytes(fno, b"".join(enc_varint(int(v)) for v in vals))
