"""Native (C++) host code with ctypes bindings: Keccak-256 and the keccak
batch-Merkle levels.

Counterpart of the keccak half of mina_bridge_tpu/native/__init__.py
(`available`, `keccak256`, `keccak256_batch`, `merkle_levels`), over the
port's own copy of its source (`src/keccak.cpp`, the same C ABI). The
library is built with `g++ -O3 -shared -fPIC` at first use into
`<repo>/build/native/`, named by a hash of the sources and the flags as
kernels.py names the CUDA libraries, so a changed source is rebuilt and
an unchanged one reused. Each process compiles to a name of its own and
renames it into place, so processes that build at once do not collide.

Where no C++ compiler is installed, `available()` is False and the
functions run the pure-Python `bridge/keccak.py::keccak256_py`, which
stays the oracle. A compiler that fails to build the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_DIR = pathlib.Path(__file__).resolve().parent
SRCS = sorted((_DIR / "src").glob("*.cpp"))
BUILD_DIR = _DIR.parents[1] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
COMPILERS = ("g++", "clang++", "c++")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

__all__ = ["available", "keccak256", "keccak256_batch", "merkle_levels"]


def _target() -> pathlib.Path:
    h = hashlib.sha256()
    for src in SRCS:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmbt_native-{h.hexdigest()[:16]}.so"


def _build(cxx: str, out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SRCS)], capture_output=True, text=True, timeout=300
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build the native library:\n{proc.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL | None:
    """The library, built at first use; None where no C++ compiler exists."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        out = _target()
        if not out.exists():
            cxx = next((c for c in COMPILERS if shutil.which(c)), None)
            if cxx is None:
                _tried = True
                return None
            _build(cxx, out)
        lib = ctypes.CDLL(str(out))
        u64 = ctypes.c_uint64
        lib.mbtpu_keccak256.argtypes = [ctypes.c_char_p, u64, ctypes.c_char_p]
        lib.mbtpu_keccak256_batch.argtypes = [ctypes.c_char_p, ctypes.POINTER(u64), u64, ctypes.c_char_p]
        lib.mbtpu_merkle_levels.argtypes = [ctypes.c_char_p, u64, ctypes.c_char_p]
        for fn in (lib.mbtpu_keccak256, lib.mbtpu_keccak256_batch, lib.mbtpu_merkle_levels):
            fn.restype = None
        _lib, _tried = lib, True
        return _lib


def available() -> bool:
    """True when the native library is loaded (a C++ compiler was found)."""
    return _load() is not None


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (Ethereum padding): native if available, else Python."""
    lib = _load()
    if lib is None:
        from ..bridge.keccak import keccak256_py

        return keccak256_py(data)
    out = ctypes.create_string_buffer(32)
    lib.mbtpu_keccak256(data, len(data), out)
    return out.raw


def keccak256_batch(items: list[bytes]) -> list[bytes]:
    """Hash many byte strings in one native call."""
    lib = _load()
    if lib is None:
        from ..bridge.keccak import keccak256_py

        return [keccak256_py(x) for x in items]
    blob = b"".join(items)
    offs = (ctypes.c_uint64 * (len(items) + 1))()
    acc = 0
    for i, x in enumerate(items):
        offs[i] = acc
        acc += len(x)
    offs[len(items)] = acc
    out = ctypes.create_string_buffer(32 * len(items))
    lib.mbtpu_keccak256_batch(blob, offs, len(items), out)
    return [out.raw[32 * i : 32 * (i + 1)] for i in range(len(items))]


def merkle_levels(leaves: list[bytes]) -> list[list[bytes]]:
    """All levels of the keccak batch-Merkle tree above `leaves` (n a power
    of two), level-major: [level n/2, ..., [root]]."""
    n = len(leaves)
    if not n or n & (n - 1):
        raise ValueError(f"merkle_levels needs a power-of-two leaf count, got {n}")
    if n == 1:
        return []
    lib = _load()
    if lib is None:
        from ..bridge.keccak import keccak256_py

        levels, level = [], leaves
        while len(level) > 1:
            level = [keccak256_py(level[i] + level[i + 1]) for i in range(0, len(level), 2)]
            levels.append(level)
        return levels
    out = ctypes.create_string_buffer(32 * (n - 1))
    lib.mbtpu_merkle_levels(b"".join(leaves), n, out)
    raw = out.raw
    levels, cursor, width = [], 0, n // 2
    while width >= 1:
        levels.append([raw[32 * (cursor + i) : 32 * (cursor + i + 1)] for i in range(width)])
        cursor += width
        width //= 2
    return levels
