"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface, then bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch_kernels/libfantastic4-<hash>.so \
         src/repro_torch/csrc/fantastic4.cu

No ``--use_fast_math``: the fp32 gate and the bitwise int8 contract need
IEEE division and no reassociation.  The library name carries a hash of
the sources, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs at import time: the CPU tests import every
module of the port and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fantastic4.cu",)
HEADERS = ("fantastic4_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"
# the repo root when the package runs from a checkout (src/repro_torch/...)
_DEFAULT_BUILD_DIR = CSRC.parents[2] / "build" / "repro_torch_kernels"

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # x, packed, omega, alpha1, bias, scale_dev, scale, quant, act, M, K, N, y, stream
    "f4_matmul": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P],
    # x, M, K0, layers, L, dmax, rows_per_cta, y, stream
    "f4_fused_tiled": [_P, _I, _I, _P, _I, _I, _I, _P, _P],
    # x, M, K0, layers, L, dmax, act, y, stream
    "f4_fused_ws": [_P, _I, _I, _P, _I, _I, _P, _P, _P],
    # x, M, K0, layers, L, dmax, block_m, act, wdec, y, stream
    "f4_fused_stream": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P],
}


def build_dir() -> Path:
    return Path(os.environ.get(ENV_BUILD_DIR) or _DEFAULT_BUILD_DIR)


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + NVCC_FLAGS:
        h.update(name.encode())
        path = CSRC / name
        if path.exists():
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return found


def library_path() -> Path:
    return build_dir() / f"libfantastic4-{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (once) and load the kernel library with typed entry points."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (refused launch etc.)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
