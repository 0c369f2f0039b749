"""Where a K1 window-tile block spends its time, on the card.

    python -m bridgerl_tpu_torch.tools.k1_phases                     # float32, one H100
    python -m bridgerl_tpu_torch.tools.k1_phases --dtype bfloat16    # the bf16 kernels

Builds a copy of ``csrc/packed_attention.cu`` and ``csrc/packed_attention_bwd.cu``
into a temporary directory with a timestamp (``%globaltimer``) taken by
thread 0 of every window-tile block at its start and after each
``__syncthreads()``, launches each kernel once at chip_smoke.py's K1 shapes
(warm, and after writing 128 MB to empty L2), and prints one JSON line per
launch: the span from the first block's start to the last block's end, the
spread of block starts, and the median time of each phase of a block
(stage = copies in flight plus the bias / Philox prologue, logits, softmax
rows, products and stores). ``--dtype bfloat16`` launches the bf16 entry
points on bf16 tensors (whose stage is a plain load and widening, not a
cp.async). The port's own build is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..models.layers import attention_bias
from ..ops import attention, kernels

SHAPES = ((256, 80, 64, 8, 0.1), (2048, 80, 64, 8, 0.0))   # (B*H, S, Dh, packing, dropout)
MAX_BLOCKS = 1 << 16
PHASES = ("stage", "logits", "softmax", "products")
KERNELS = (("packed_attention", "k1_fwd_tiles", "fwd"),
           ("packed_attention_bwd", "k1_bwd_tiles", "bwd"))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MARKS = r"""
__device__ unsigned long long g_k1_marks[5 * 65536];
#define K1_MARK(p)                                                              \
  if (threadIdx.x == 0) {                                                       \
    unsigned long long t;                                                       \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                       \
    g_k1_marks[(p) * 65536 + blockIdx.x] = t;                                   \
  }
"""
_DUMP = r"""
extern "C" int k1_marks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k1_marks, sizeof(unsigned long long) * 5 * 65536);
}
"""


def instrument(src: str, kernel: str) -> str:
    """Mark the start of ``kernel``'s body (0), each of its three
    ``__syncthreads()`` (1-3) and its end (4)."""
    start = src.index(kernel + "(")
    body_at = src.index("{", start) + 1
    end = src.index("\n}\n", body_at)
    body = src[body_at:end]
    n = iter(range(1, 4))
    body = re.sub(r"__syncthreads\(\);", lambda m: f"__syncthreads(); K1_MARK({next(n)});",
                  body)
    body = "\n  K1_MARK(0);" + body + "\n  __syncthreads(); K1_MARK(4);"
    head = src.index('#include "philox.cuh"') + len('#include "philox.cuh"')
    return src[:head] + _MARKS + src[head:body_at] + body + src[end:] + _DUMP


def build(workdir: str, dtype=torch.float32):
    for f in kernels.CSRC.iterdir():
        shutil.copy(f, workdir)
    procs = []
    for lib, kernel, _ in KERNELS:
        path = f"{workdir}/{lib}.cu"
        with open(path) as f:
            src = instrument(f.read(), kernel)
        with open(path, "w") as f:
            f.write(src)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", f"{workdir}/lib{lib}.so", path]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
    out = {}
    for lib, _, direction in KERNELS:
        fn = attention.ENTRY[direction, dtype]
        so = ctypes.CDLL(f"{workdir}/lib{lib}.so")
        entry = getattr(so, fn)
        entry.argtypes, entry.restype = kernels.SIGNATURES[fn][1], ctypes.c_int
        so.k1_marks.argtypes, so.k1_marks.restype = [ctypes.c_void_p], ctypes.c_int
        out[fn] = (entry, so)
    return out


def tile_rows() -> int:
    text = (kernels.CSRC / "k1_tiles.cuh").read_text()
    return int(re.search(r"kTileRows = (\d+)", text).group(1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    dtype = DTYPES[ap.parse_args(argv).dtype]
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases: needs a card")
    libs = build(tempfile.mkdtemp(prefix="k1_phases_"), dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(32 << 20, device="cuda")
    for BH, S, Dh, P, rate in SHAPES:
        W = S // P
        q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
                       for _ in range(4))
        bias, seed = attention_bias(P, W, "cuda"), attention.draw_seed(g, "cuda")
        out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        tail = (attention.keep_threshold(rate), attention._inv_keep(rate), int(rate > 0),
                kernels.stream_ptr(q))
        head = (Dh ** -0.5, seed.data_ptr() if rate > 0 else 0, BH)   # one seed group
        args = {attention.ENTRY["fwd", dtype]: (q, k, v, bias, out),
                attention.ENTRY["bwd", dtype]: (q, k, v, bias, do, dq, dk, dv)}
        G = max(1, tile_rows() // W)
        blocks = -(-(BH * P) // G)
        for fn, (entry, so) in libs.items():
            ptrs = [t.data_ptr() for t in args[fn]]
            for cold in (False, True):
                for _ in range(3):
                    entry(*ptrs, BH, S, W, Dh, *head, *tail)
                if cold:
                    flush.fill_(1.0)
                torch.cuda._sleep(10_000_000)
                status = entry(*ptrs, BH, S, W, Dh, *head, *tail)
                torch.cuda.synchronize()
                marks = np.zeros(5 * MAX_BLOCKS, np.uint64)
                if status or so.k1_marks(marks.ctypes.data):
                    raise RuntimeError(f"{fn}: CUDA error")
                t = marks.reshape(5, MAX_BLOCKS)[:, :blocks].astype(np.int64)
                t0 = t[0].min()
                print(json.dumps({
                    "kernel": fn, "dtype": str(dtype).replace("torch.", ""),
                    "shape": [BH, S, Dh], "window": W, "dropout": rate,
                    "l2": "cold" if cold else "warm", "blocks": blocks,
                    "span_us": (t[4].max() - t0) / 1e3,
                    "block_start_us_p50_max": [float(np.median(t[0] - t0)) / 1e3,
                                               float((t[0] - t0).max()) / 1e3],
                    "block_us_p50": float(np.median(t[4] - t[0])) / 1e3,
                    "phase_us_p50": {name: float(np.median(t[i + 1] - t[i])) / 1e3
                                     for i, name in enumerate(PHASES)},
                    "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
