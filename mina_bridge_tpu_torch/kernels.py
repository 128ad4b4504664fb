"""Build, load and count the port's hand-written CUDA kernels.

Each source in `csrc/` (pow_chain.cu, transcript.cu, points.cu; probe.cu,
a product-latency probe, and k1_sweep.cu and k7_split.cu, K1's
alternatives and K7 split into its parts for scripts/torch_kernel_sweep.py,
and split_timeline.cu, the per-block timeline of K3's weighting and K5's
lane repair for scripts/torch_weight_sweep.py, which no path calls; all
include field.cuh, some also pow_chain.cuh or points.cuh) is compiled by
`nvcc` for sm_90a into a shared library with a plain C interface, loaded
with ctypes.
Builds land in `<repo>/build/kernels/`, named by a hash of the source
and the headers, so a changed source is rebuilt and an unchanged one is
reused. `build_all()` starts one `nvcc` per source at once (all but the
sweeps' three, SWEEP_ONLY, unless asked).

`launches` counts, per kernel, the launches its wrapper made; each
wrapper adds one where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# source stem -> {C function: argtypes}
SOURCES = {
    "pow_chain": {"mbt_pow_chain": [_I, _V, _V, _V, _I, _I, _L, _V]},
    "transcript": {"mbt_transcript": [_I, _V, _V, _V, _V, _V, _I, _I, _I, _V]},
    "points": {
        "mbt_padd": [_I, _V, _V, _V, _L, _V],
        "mbt_pdouble": [_I, _V, _V, _L, _I, _V],
        "mbt_padd_select": [_I, _V, _V, _V, _V, _L, _V],
        "mbt_padd_mixed_select2_scan": [_I, _V, _V, _V, _V, _V, _L, _L, _L, _V],
        "mbt_padd_mixed_select": [_I, _V, _V, _V, _V, _V, _L, _V],
        "mbt_padd_weight_sum": [_I, _V, _V, _V, _L, _L, _L, _L, _V],
        "mbt_padd_fixup": [_I, _V, _V, _V, _L, _L, _L, _L, _V],
        "mbt_padd_at": [_I, _V, _V, _V, _L, _I, _I, _V],
        "mbt_padd_fixup_at": [_I, _V, _V, _V, _L, _L, _L, _L, _I, _I, _V],
        "mbt_padd_select_at": [_I, _V, _V, _V, _V, _L, _I, _I, _V],
        "mbt_padd_select_scan": [_I, _V, _V, _V, _V, _L, _L, _V],
        "mbt_split_launch_info": [_I, _L, _L, _L, _L, _V],
    },
    "probe": {"mbt_product_chain": [_I, _I, _V, _V, _I, _V]},
    "k1_sweep": {"mbt_k1_sweep": [_I, _V, _V, _V, _I, _I, _L, _I, _I, _I, _V]},
    "k7_split": {"mbt_k7_split": [_I, _I, _I, _V, _V, _V, _V, _V, _L, _I, _V]},
    "split_timeline": {"mbt_split_timeline": [_I, _V, _V, _V, _V, _L, _L, _L, _L, _L, _V, _V]},
}
SWEEP_ONLY = ("k1_sweep", "k7_split", "split_timeline")

KERNELS = (
    "pow_const", "transcript_blocks", "padd", "padd_weight_sum", "padd_fixup", "pdouble", "padd_select",
    "padd_select_scan", "padd_mixed_select2", "padd_mixed_select",
)
launches: dict[str, int] = {k: 0 for k in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(stem: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all(stems=tuple(s for s in SOURCES if s not in SWEEP_ONLY)) -> dict[str, pathlib.Path]:
    """Compile every missing library, one nvcc process per source, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {s: _target(s) for s in stems}
    procs = {}
    for stem, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library for csrc/<stem>.cu, building it if needed."""
    with _lock:
        if stem not in _libs:
            path = build_all((stem,))[stem]
            handle = ctypes.CDLL(str(path))
            for fn, argtypes in SOURCES[stem].items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[stem] = handle
        return _libs[stem]


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if the C launcher reported a CUDA error; count the launch otherwise."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    launches[name] += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A wrapper's checks before a launch: CUDA, int64 limbs, contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
