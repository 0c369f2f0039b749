"""Where K2's two kernels spend their time, on the card.

    python -m bridgerl_tpu_torch.tools.k2_phases      # from the repository root, one H100

Builds a copy of ``csrc/vq_assign.cu`` into a temporary directory with a
timestamp (``%globaltimer``) taken by thread 0 of every block at fixed
points, launches K2 at chip_smoke.py's shapes (warm, and after writing
128 MB to empty L2), and prints one JSON line per kernel and launch: when
its first block started (after the nearest-code kernel's first block), the
span from its first block's start to its last block's end, the spread of
block starts, and the median and largest time of each phase of a block.
Nearest codes: ``stage`` (start to the first x tile and the code slice in
shared memory), ``score`` (norms and scoring of the first tile), ``rest``
(its running minimum and candidates, the push of its winners to the rows'
owners, and every further tile of the cluster), ``barrier`` (the cluster
barrier), ``owner`` (the owner's minimum over the ranks, writing idx).
Statistics: ``wait`` (clearing the bitmaps, then waiting for the
nearest-code kernel to end), ``mark`` (reading idx, setting the bits of the
block's codes), ``sum`` (walking the bitmaps, listing the rows, loading and
adding them). The port's own build is not touched.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..ops import kernels, vq_kernel

SHAPES = ((512, 64, 512), (4096, 64, 512), (6554, 64, 512))   # (N, D, K)
MAX_BLOCKS = 1 << 16
SLOTS = 6
KERNELS = (("vq_assign_nearest", ("stage", "score", "rest", "barrier", "owner")),
           ("vq_assign_stats", ("wait", "mark", "sum")))
_MARKS = r"""
__device__ unsigned long long g_k2_marks[2 * 6 * 65536];
#define K2_MARK(kern, p)                                                        \
  if (threadIdx.x == 0) {                                                       \
    unsigned long long t;                                                       \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                       \
    g_k2_marks[((kern) * 6 + (p)) * 65536 + blockIdx.x + blockIdx.y * gridDim.x] = t; \
  }
"""
_DUMP = r"""
extern "C" int k2_marks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k2_marks, sizeof(g_k2_marks));
}
"""
# (text in csrc/vq_assign.cu, text with its mark); each must occur once
_POINTS = (
    ("bool vec) {\n  constexpr", "bool vec) {\n  K2_MARK(0, 0);\n  constexpr"),
    ("      __syncthreads();\n      if (!keep_codes || t == 0) {",
     "      __syncthreads();\n      if (t == 0) K2_MARK(0, 1);\n      if (!keep_codes || t == 0) {"),
    ("      __syncthreads();  // the norms are in, and the tile has been read\n",
     "      __syncthreads();  // the norms are in, and the tile has been read\n"
     "      if (t == 0) K2_MARK(0, 2);\n"),
    ("  cluster.sync();  // every push has landed",
     "  K2_MARK(0, 3);\n  cluster.sync();\n  K2_MARK(0, 4);  // every push"),
    ("as argmin gives\n  }\n}", "as argmin gives\n  }\n  __syncthreads();\n  K2_MARK(0, 5);\n}"),
    ("int pass_rows) {\n  extern", "int pass_rows) {\n  K2_MARK(1, 0);\n  extern"),
    ("\"griddepcontrol.wait;\" ::: \"memory\");\n    __syncthreads();\n",
     "\"griddepcontrol.wait;\" ::: \"memory\");\n    __syncthreads();\n    K2_MARK(1, 1);\n"),
    ("    __syncthreads();\n    if (k >= K) continue;",
     "    __syncthreads();\n    K2_MARK(1, 2);\n    if (k >= K) continue;"),
    ("counts[k] = (float)n_k;\n  }\n}",
     "counts[k] = (float)n_k;\n  }\n  __syncthreads();\n  K2_MARK(1, 3);\n}"),
)


def instrument(src: str) -> str:
    for old, new in _POINTS:
        if src.count(old) != 1:
            raise RuntimeError(f"k2_phases: the source no longer has {old!r}")
        src = src.replace(old, new)
    head = src.index('#include "k1_tiles.cuh"') + len('#include "k1_tiles.cuh"')
    return src[:head] + _MARKS + src[head:] + _DUMP


def build(workdir: str):
    for f in kernels.CSRC.iterdir():
        shutil.copy(f, workdir)
    path = f"{workdir}/vq_assign.cu"
    with open(path) as f:
        src = instrument(f.read())
    with open(path, "w") as f:
        f.write(src)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", f"{workdir}/libvq_assign.so", path]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    so = ctypes.CDLL(f"{workdir}/libvq_assign.so")
    so.vq_assign.argtypes = kernels.SIGNATURES["vq_assign"][1]
    so.vq_assign.restype = ctypes.c_int
    so.k2_marks.argtypes, so.k2_marks.restype = [ctypes.c_void_p], ctypes.c_int
    return so


def _us(a) -> float:
    return float(a) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k2_phases: needs a card")
    run(build(tempfile.mkdtemp(prefix="k2_phases_")))
    return 0


def run(so) -> None:
    """One JSON line per shape, L2 state and kernel, from the library ``so``
    that ``build`` made."""
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(32 << 20, device="cuda")
    for N, D, K in SHAPES:
        x = torch.randn(N, D, device="cuda", generator=g)
        cb = torch.randn(K, D, device="cuda", generator=g)
        idx = torch.empty(N, dtype=torch.int32, device="cuda")
        counts, dw = torch.empty(K, device="cuda"), torch.empty(K, D, device="cuda")
        p = vq_kernel.k2_plan(N, D, K)
        args = ([t.data_ptr() for t in (x, cb, idx, counts, dw)]
                + [1, N, D, K, p.tile_rows, p.cluster, p.slices_per_block, p.tiles_per_cluster,
                   p.smem_bytes,
                   p.pass_rows, kernels.stream_ptr(x)])
        blocks = (p.clusters * p.cluster, p.stat_grid[0] * p.stat_grid[1])
        for cold in (False, True):
            for _ in range(3):
                so.vq_assign(*args)
            if cold:
                flush.fill_(1.0)
            torch.cuda._sleep(10_000_000)
            status = so.vq_assign(*args)
            torch.cuda.synchronize()
            marks = np.zeros(2 * SLOTS * MAX_BLOCKS, np.uint64)
            if status or so.k2_marks(marks.ctypes.data):
                raise RuntimeError("vq_assign: CUDA error")
            marks = marks.reshape(2, SLOTS, MAX_BLOCKS).astype(np.int64)
            t0 = marks[0, 0, :blocks[0]].min()
            for kern, (name, phases) in enumerate(KERNELS):
                t = marks[kern, :len(phases) + 1, :blocks[kern]]
                start = t[0] - t[0].min()
                d = np.diff(t, axis=0)
                print(json.dumps({
                    "kernel": name, "shape": [N, D, K], "l2": "cold" if cold else "warm",
                    "blocks": blocks[kern],
                    "first_start_us": _us(t[0].min() - t0),
                    "span_us": _us(t[-1].max() - t[0].min()),
                    "block_start_us_p50_max": [_us(np.median(start)), _us(start.max())],
                    "block_us_p50_max": [_us(np.median(t[-1] - t[0])), _us((t[-1] - t[0]).max())],
                    "phase_us_p50_max": {ph: [_us(np.median(d[i])), _us(d[i].max())]
                                         for i, ph in enumerate(phases)},
                    "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
