"""ctypes bindings of the native motiondata runtime (``csrc/motiondata.cpp``).

The C++ library is the host-side data runtime: npy float32 loading,
multithreaded window slicing, normalisation statistics and deterministic
epoch shuffles. It runs on the host only; nothing on the training or
serving path imports it.

:func:`ensure_built` compiles it at first use with ``$CXX`` (``g++`` by
default; ``-O3 -std=c++17 -fPIC -pthread -shared``) into
``bridgerl_tpu_torch/_build/`` beside the CUDA kernels, never into the
source tree. The library's file name hashes its source, the compiler and
the flags, so an edited source is rebuilt. A build that fails raises with
the compiler's message: no function here falls back to numpy on its own.
The numpy versions have names of their own (``*_numpy``); they compute the
same values (the statistics within float rounding) and the tests hold the
library to them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "motiondata.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """``_build/libmotiondata-<hash>.so``: the hash covers the source, the
    compiler and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + _compiler().encode()
                            + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmotiondata-{digest.hexdigest()[:12]}.so"


def ensure_built(rebuild: bool = False) -> Path:
    """Compile the library unless it is built already (or ``rebuild``), and
    return its path. Raises RuntimeError with the compiler's output when the
    build fails or the compiler cannot be run."""
    out = library_path()
    if out.exists() and not rebuild:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".motiondata.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one build at a time across processes
        if out.exists() and not rebuild:
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {cmd[0]!r} "
                               f"(set CXX to pick another): {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built at first use (see :func:`ensure_built`)."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(ensure_built()))
        i64, fp = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        lib.md_load_npy_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(fp), i64 * 4,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.md_load_npy_f32.restype = ctypes.c_int
        lib.md_free.argtypes = [ctypes.c_void_p]
        lib.md_free.restype = None
        lib.md_num_windows.argtypes = [i64, i64, i64]
        lib.md_num_windows.restype = i64
        lib.md_slice_windows.argtypes = [fp, i64, i64, i64, i64, fp]
        lib.md_slice_windows.restype = ctypes.c_int
        lib.md_mean_std.argtypes = [fp, i64, i64, fp, fp, ctypes.c_float]
        lib.md_mean_std.restype = None
        lib.md_shuffle_indices.argtypes = [i64, ctypes.c_uint64, ctypes.POINTER(i64)]
        lib.md_shuffle_indices.restype = None
        lib.md_normalize.argtypes = [fp, i64, i64, fp, fp]
        lib.md_normalize.restype = None
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (the reason it does not is
    in :func:`load_library`'s error)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# md_load_npy_f32's return codes
_LOAD_ERRORS = {1: "cannot open the file",
                2: "not a little-endian float32 C-order npy array of at most 4 dimensions",
                3: "out of memory", 4: "the file is shorter than its header says"}


def load_npy_f32(path: str) -> np.ndarray:
    """A little-endian float32, C-order npy file (v1 or v2, up to 4 dims).
    Any other file raises (``load_npy_f32_numpy`` reads and casts those)."""
    lib = load_library()
    data = ctypes.POINTER(ctypes.c_float)()
    shape = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int(0)
    rc = lib.md_load_npy_f32(os.fsencode(path), ctypes.byref(data), shape, ctypes.byref(ndim))
    if rc == 1:
        raise FileNotFoundError(f"{path}: {_LOAD_ERRORS[1]}")
    if rc != 0:
        raise ValueError(f"{path}: {_LOAD_ERRORS.get(rc, f'error {rc}')} "
                         "(load_npy_f32_numpy reads and casts other arrays)")
    dims = tuple(shape[i] for i in range(ndim.value))
    n = int(np.prod(dims))
    try:
        return np.ctypeslib.as_array(data, shape=(n,)).reshape(dims).copy()
    finally:
        lib.md_free(data)


def load_npy_f32_numpy(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32)


def slice_windows(motion: np.ndarray, window: int, stride: int) -> np.ndarray:
    """(T, D) motion -> (K, window, D) windows at ``stride``, K = (T - window)
    // stride + 1 (0 when T < window)."""
    lib = load_library()
    motion = np.ascontiguousarray(motion, dtype=np.float32)
    T, D = motion.shape
    K = lib.md_num_windows(T, window, stride)
    out = np.empty((max(K, 0), window, D), np.float32)
    if K > 0:
        lib.md_slice_windows(_fptr(motion), T, D, window, stride, _fptr(out))
    return out


def slice_windows_numpy(motion: np.ndarray, window: int, stride: int) -> np.ndarray:
    motion = np.asarray(motion, np.float32)
    starts = range(0, motion.shape[0] - window + 1, stride)
    return np.stack([motion[s:s + window] for s in starts]) if len(starts) else \
        np.empty((0, window, motion.shape[1]), np.float32)


def mean_std(data: np.ndarray, eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dimension mean and (std + eps) over the flattened frames, summed
    in float64."""
    lib = load_library()
    flat = np.ascontiguousarray(data.reshape(-1, data.shape[-1]), dtype=np.float32)
    n, d = flat.shape
    mean = np.empty(d, np.float32)
    std = np.empty(d, np.float32)
    lib.md_mean_std(_fptr(flat), n, d, _fptr(mean), _fptr(std), eps)
    return mean, std


def mean_std_numpy(data: np.ndarray, eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    flat = np.asarray(data, np.float32).reshape(-1, data.shape[-1])
    mean = flat.astype(np.float64).mean(0).astype(np.float32)
    var = ((flat - mean).astype(np.float64) ** 2).mean(0)
    return mean, (np.sqrt(var) + eps).astype(np.float32)


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """A permutation of [0, n): Fisher-Yates driven by splitmix64 from
    ``seed``, the same for a seed on every host."""
    lib = load_library()
    out = np.empty(n, np.int64)
    lib.md_shuffle_indices(n, ctypes.c_uint64(seed % 2 ** 64),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


_MASK = 2 ** 64 - 1
_GOLDEN = 0x9E3779B97F4A7C15


def shuffle_indices_numpy(n: int, seed: int) -> np.ndarray:
    out = np.arange(n, dtype=np.int64)
    x = (seed + _GOLDEN) & _MASK
    for i in range(n - 1, 0, -1):
        x = (x + _GOLDEN) & _MASK
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        j = (z ^ (z >> 31)) % (i + 1)
        out[i], out[j] = out[j], out[i]
    return out


def normalize_inplace(data: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """(data - mean) / std over the last axis, in place when ``data`` is a
    contiguous float32 array (else on a float32 copy); returns the result."""
    lib = load_library()
    data = np.ascontiguousarray(data, dtype=np.float32)
    flat = data.reshape(-1, data.shape[-1])
    lib.md_normalize(_fptr(flat), flat.shape[0], flat.shape[1],
                     _fptr(np.ascontiguousarray(mean, np.float32)),
                     _fptr(np.ascontiguousarray(std, np.float32)))
    return data


def normalize_inplace_numpy(data: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return ((np.asarray(data, np.float32) - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)
