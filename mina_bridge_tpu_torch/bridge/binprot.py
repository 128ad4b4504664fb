"""bin_prot (Jane Street) wire-format core + declarative type DSL.

The reference deserializes Mina node responses (base64-encoded bin_prot
blobs) with the pinned `mina-p2p-messages` crate (reference
core/src/mina.rs:158-166, 240-248, 307-313; SURVEY §2b). This module is
the TPU framework's host-side replacement: the bin_prot primitive codecs
(Nat0/varint, option, list, variant, versioned wrappers, field elements)
plus a declarative descriptor DSL from which both encoder and decoder are
derived, so Mina's deeply nested OCaml types are *data* (see
mina_types.py), not hand-written parser code.

The port's own copy of mina_bridge_tpu/bridge/binprot.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# --- primitive integer codecs -------------------------------------------

_CODE_INT16 = 0xFE
_CODE_INT32 = 0xFD
_CODE_INT64 = 0xFC
_CODE_NEG_INT8 = 0xFF


def read_nat0(data: bytes, off: int) -> tuple[int, int]:
    b = data[off]
    if b < 0x80:
        return b, off + 1
    if b == _CODE_INT16:
        return int.from_bytes(data[off + 1 : off + 3], "little"), off + 3
    if b == _CODE_INT32:
        return int.from_bytes(data[off + 1 : off + 5], "little"), off + 5
    if b == _CODE_INT64:
        return int.from_bytes(data[off + 1 : off + 9], "little"), off + 9
    raise ValueError(f"bad nat0 code {b:#x}")


def write_nat0(n: int) -> bytes:
    assert n >= 0
    if n < 0x80:
        return bytes([n])
    if n < 0x10000:
        return bytes([_CODE_INT16]) + n.to_bytes(2, "little")
    if n < 1 << 32:
        return bytes([_CODE_INT32]) + n.to_bytes(4, "little")
    return bytes([_CODE_INT64]) + n.to_bytes(8, "little")


def read_int(data: bytes, off: int) -> tuple[int, int]:
    b = data[off]
    if b < 0x80:
        return b, off + 1
    if b == _CODE_NEG_INT8:
        return int.from_bytes(data[off + 1 : off + 2], "little", signed=True), off + 2
    if b == _CODE_INT16:
        return int.from_bytes(data[off + 1 : off + 3], "little", signed=True), off + 3
    if b == _CODE_INT32:
        return int.from_bytes(data[off + 1 : off + 5], "little", signed=True), off + 5
    if b == _CODE_INT64:
        return int.from_bytes(data[off + 1 : off + 9], "little", signed=True), off + 9
    raise ValueError(f"bad int code {b:#x}")


def write_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -0x80 <= n < 0x80:
        return bytes([_CODE_NEG_INT8]) + n.to_bytes(1, "little", signed=True)
    if -0x8000 <= n < 0x8000:
        return bytes([_CODE_INT16]) + n.to_bytes(2, "little", signed=True)
    if -(1 << 31) <= n < 1 << 31:
        return bytes([_CODE_INT32]) + n.to_bytes(4, "little", signed=True)
    return bytes([_CODE_INT64]) + n.to_bytes(8, "little", signed=True)


# --- descriptor DSL ------------------------------------------------------


class Desc:
    """Base descriptor; subclasses implement read/write."""

    def read(self, data: bytes, off: int) -> tuple[Any, int]:
        raise NotImplementedError

    def write(self, value: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        v, off = self.read(data, 0)
        if off != len(data):
            raise ValueError(f"{len(data) - off} trailing bytes")
        return v

    def encode(self, value: Any) -> bytes:
        return self.write(value)


class Int(Desc):
    def read(self, data, off):
        return read_int(data, off)

    def write(self, v):
        return write_int(v)


class Nat0(Desc):
    def read(self, data, off):
        return read_nat0(data, off)

    def write(self, v):
        return write_nat0(v)


class Bool(Desc):
    def read(self, data, off):
        return data[off] != 0, off + 1

    def write(self, v):
        return b"\x01" if v else b"\x00"


class Unit(Desc):
    def read(self, data, off):
        return None, off + 1

    def write(self, v):
        return b"\x00"


class Field(Desc):
    """255-bit field element: 32 bytes little-endian."""

    def read(self, data, off):
        return int.from_bytes(data[off : off + 32], "little"), off + 32

    def write(self, v):
        return int(v).to_bytes(32, "little")


class FixedBytes(Desc):
    def __init__(self, n: int):
        self.n = n

    def read(self, data, off):
        return data[off : off + self.n], off + self.n

    def write(self, v):
        assert len(v) == self.n
        return bytes(v)


class Bytes(Desc):
    def read(self, data, off):
        n, off = read_nat0(data, off)
        return data[off : off + n], off + n

    def write(self, v):
        return write_nat0(len(v)) + bytes(v)


class Str(Bytes):
    def read(self, data, off):
        v, off = super().read(data, off)
        return v.decode(), off

    def write(self, v):
        return super().write(v.encode())


class Option(Desc):
    def __init__(self, inner: Desc):
        self.inner = inner

    def read(self, data, off):
        if data[off] == 0:
            return None, off + 1
        v, off = self.inner.read(data, off + 1)
        return v, off

    def write(self, v):
        if v is None:
            return b"\x00"
        return b"\x01" + self.inner.write(v)


class List(Desc):
    def __init__(self, inner: Desc):
        self.inner = inner

    def read(self, data, off):
        n, off = read_nat0(data, off)
        out = []
        for _ in range(n):
            v, off = self.inner.read(data, off)
            out.append(v)
        return out, off

    def write(self, v):
        out = write_nat0(len(v))
        for x in v:
            out += self.inner.write(x)
        return out


class Tuple(Desc):
    def __init__(self, *inners: Desc):
        self.inners = inners

    def read(self, data, off):
        out = []
        for d in self.inners:
            v, off = d.read(data, off)
            out.append(v)
        return tuple(out), off

    def write(self, v):
        assert len(v) == len(self.inners)
        return b"".join(d.write(x) for d, x in zip(self.inners, v))


class Record(Desc):
    """Ordered named fields; values are plain dicts."""

    def __init__(self, *fields: tuple[str, Desc]):
        self.fields = fields

    def read(self, data, off):
        out = {}
        for name, d in self.fields:
            out[name], off = d.read(data, off)
        return out, off

    def write(self, v):
        return b"".join(d.write(v[name]) for name, d in self.fields)


class Variant(Desc):
    """Sum type: 1-byte constructor tag + payload descriptors."""

    def __init__(self, *ctors: tuple[str, list[Desc]]):
        self.ctors = ctors

    def read(self, data, off):
        tag = data[off]
        off += 1
        name, descs = self.ctors[tag]
        vals = []
        for d in descs:
            v, off = d.read(data, off)
            vals.append(v)
        return (name, vals), off

    def write(self, v):
        name, vals = v
        for tag, (cname, descs) in enumerate(self.ctors):
            if cname == name:
                return bytes([tag]) + b"".join(
                    d.write(x) for d, x in zip(descs, vals)
                )
        raise ValueError(f"unknown constructor {name}")


class Versioned(Desc):
    """Mina `%%versioned` wrapper: a leading version int."""

    def __init__(self, inner: Desc, version: int = 1):
        self.inner = inner
        self.version = version

    def read(self, data, off):
        ver, off = read_int(data, off)
        if ver != self.version:
            raise ValueError(f"version {ver} != {self.version}")
        return self.inner.read(data, off)

    def write(self, v):
        return write_int(self.version) + self.inner.write(v)
