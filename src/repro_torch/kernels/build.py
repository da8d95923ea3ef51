"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

The sources are compiled at first use with ``nvcc``, one process per
source, all started together, then linked into one shared library with a
plain C interface and bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <tmp>/<source>.o src/repro_torch/csrc/<source>.cu
    nvcc -shared -o build/repro_torch_kernels/libfantastic4-<hash>.so <tmp>/*.o

No ``--use_fast_math``: the fp32 gate and the bitwise int8 contract need
IEEE division and no reassociation.  The library name carries a hash of
the sources, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs at import time: the CPU tests import every
module of the port and never build.

Launches from several threads and CUDA streams (the serving frontend's
stream workers) need three things every wrapper gets from here:
``COUNT_LOCK`` guards the launch counters; :func:`publish` waits for an
operand built once per pack (a memo fill) before other streams may read
it; :func:`keep_for_stream` ties the memory a launch reads to the stream
it runs on, so a tensor dropped meanwhile (an evicted pack, a memo entry)
is not handed to another allocation before the launch has read it.
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
SOURCES = ("fantastic4.cu", "ecl_quant.cu")
HEADERS = ("fantastic4_common.cuh", "fantastic4_cluster.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-shared",)
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"
# the repo root when the package runs from a checkout (src/repro_torch/...)
_DEFAULT_BUILD_DIR = CSRC.parents[2] / "build" / "repro_torch_kernels"

_lock = threading.Lock()
_lib = None
#: guards every kernel's launch counter (``LAUNCHES``) across threads
COUNT_LOCK = threading.Lock()
#: called as ``fn(name, launches, flops, bytes)`` for a wrapper's launches
#: and their work (``launch/op_analysis.py`` listens while it counts a call)
WORK_LISTENERS: list = []

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # x, codes, omega, alpha1, bias, scale_dev, scale, quant, act, M, K, N,
    # n_slices, slice_w, slice_bytes, rows, ldx, kc, chunk_bytes, pdl, y,
    # stream
    "f4_matmul": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _I, _P, _P],
    # x, M, K0, layers, L, codes, cluster, rows, ldx, slice_max, db, y, stream
    "f4_fused_tiled": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    # x, M, K0, layers, L, codes, cluster, rows, ldx, code_bytes, y, stream
    "f4_fused_ws": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P],
    # x, M, K0, layers, L, codes, rows, ldx, lda, code_region, want, act,
    # arrived, y, ctas (int*), stream
    "f4_fused_stream": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                        _P, ctypes.POINTER(_I), _P],
    # segment rows (w, omega, penalty, codes, w_hat, n) as int64 (a host
    # pointer), count, stream
    "f4_ecl_quant_many": [_P, _I, _P],
}


def note_work(name: str, launches: int, flops: float, nbytes: float) -> None:
    """Report a wrapper's launches and their work (or those of its
    stand-in on the meta device) to whoever listens."""
    for fn in tuple(WORK_LISTENERS):
        fn(name, launches, flops, nbytes)


def build_dir() -> Path:
    return Path(os.environ.get(ENV_BUILD_DIR) or _DEFAULT_BUILD_DIR)


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + NVCC_FLAGS + LINK_FLAGS:
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


def _run_all(cmds) -> None:
    """Run the commands in parallel; after every process has ended, raise
    with the output of each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / s)]
                  for s, obj in zip(SOURCES, objs)])
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)
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


def publish(device) -> None:
    """Wait for the work queued so far on ``device``'s current stream: a
    memoized operand is built by asynchronous copies and kernels on
    whichever stream first needs it, and a launch on another stream must
    not read it before they finish.  Called once per build, before the
    operand goes into its memo."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def keep_for_stream(tensors, device) -> None:
    """Record the current stream on every tensor a launch reads, unless it
    is the device's default stream.  The caching allocator then holds each
    tensor's memory back from reuse until the launch is done, though the
    last reference may be dropped on another thread while the launch is
    in flight.  On the default stream nothing is recorded: single-stream
    serving frees and allocates in stream order."""
    import torch
    stream = torch.cuda.current_stream(device)
    if stream == torch.cuda.default_stream(device):
        return
    for t in tensors:
        if t is not None:
            t.record_stream(stream)
