"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``. The build runs
at first use, one ``nvcc`` per source, all started together, into
``bridgerl_tpu_torch/_build/`` (listed in ``.gitignore``). A library's file
name carries a hash of its source, so an edited kernel is rebuilt. The
build holds a file lock on ``_build/``, so processes that start together
(the ranks of a data-parallel run) build once and load what the first built;
a build that fails raises in every process that needed it.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0. No failure
here falls back to a kernel's plain version.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# C signatures: name -> (library, argtypes); every entry returns int
P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# K1: ..., scale, seed pointer, rows per seed group, keep threshold, 1 / keep, dropout, stream
_K1_FWD = [P, P, P, P, P, I, I, I, I, F, P, I, U, F, I, P]
_K1_BWD = [P, P, P, P, P, P, P, P, I, I, I, I, F, P, I, U, F, I, P]
SIGNATURES = {
    # K1: float32 and bfloat16 q, k, v (dout) and outputs; the bias is float32
    "packed_attention_fwd": ("packed_attention", _K1_FWD),
    "packed_attention_fwd_bf16": ("packed_attention", _K1_FWD),
    "packed_attention_bwd": ("packed_attention_bwd", _K1_BWD),
    "packed_attention_bwd_bf16": ("packed_attention_bwd", _K1_BWD),
    # x, codebook, idx, counts, dw, groups, N, D, K, then ops/vq_kernel.py's K2Plan:
    # tile_rows, cluster, slices_per_block, tiles_per_cluster, smem_bytes, pass_rows
    "vq_assign": ("vq_assign", [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
COUNTERS: Dict[str, "LaunchCounter"] = {}


class LaunchCounter:
    """Number of kernel launches made by one wrapper since the last reset."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS[name] = self

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return found


def _lib_path(src: Path) -> Path:
    """The library's file name hashes its source, the headers of ``csrc/``
    it may include, and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no library yet, all in parallel, then
    load every library. Raises with nvcc's output if any build fails."""
    with _lock:
        if _libs:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)   # one build at a time across processes
            return _build_and_load()


def _build_and_load() -> Dict[str, ctypes.CDLL]:
    """Under the build lock: compile what is missing, then load."""
    sources = sorted(CSRC.glob("*.cu"))
    jobs = []
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, out, proc))
    errors = []
    for src, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    libs = {src.stem: ctypes.CDLL(str(_lib_path(src))) for src in sources}
    for fn, (lib, argtypes) in SIGNATURES.items():
        entry = getattr(libs[lib], fn)
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    _libs.update(libs)
    return _libs


def entry(fn: str):
    """The C entry point ``fn``, building the kernels at first use."""
    lib, _ = SIGNATURES[fn]
    return getattr(build_all()[lib], fn)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(fn: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA error {status} at launch")


def eager_cuda(t: torch.Tensor) -> bool:
    """A plain CUDA tensor outside a trace. There the callers of the custom
    ops run the ops' CUDA implementations themselves: the op's dispatch
    costs ~10-80 µs of host time a call, a tenth of a teacher step (PERF.md
    §6). A trace keeps the op: ``torch.compile`` and ``torch.export`` set
    ``is_compiling``, and their fake and functional tensors are subclasses."""
    return t.is_cuda and type(t) is torch.Tensor and not torch.compiler.is_compiling()
