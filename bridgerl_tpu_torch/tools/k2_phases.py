"""Where K2's kernels spend their time, on the card.

    python -m bridgerl_tpu_torch.tools.k2_phases      # from the repository root, one H100

Builds a copy of ``csrc/vq_assign.cu`` into a temporary directory with a
timestamp (``%globaltimer``) taken by thread 0 of every block at fixed
points, and with ``K2W_PHASES`` defined (``csrc/k2_wide.cuh``'s own marks),
launches K2 at chip_smoke.py's shapes (warm, and after writing 128 MB to
empty L2), and prints one JSON line per kernel and launch.

Up to 512 columns, for each kernel: when its first block started (after
the nearest-code kernel's first block), the span from its first block's
start to its last block's end, the spread of block starts, and the median
and largest time of each phase of a block. Nearest codes: ``stage`` (start
to the first x tile and the code slice in shared memory), ``score`` (norms
and scoring of the first tile), ``rest`` (its running minimum and
candidates, the push of its winners to the rows' owners, and every further
tile of the cluster), ``barrier`` (the cluster barrier), ``owner`` (the
owner's minimum over the ranks, writing idx). Statistics: ``wait``
(clearing the bitmaps, then waiting for the nearest-code kernel to end),
``mark`` (reading idx, setting the bits of the block's codes), ``sum``
(walking the bitmaps, listing the rows, loading and adding them).

Past 512 columns (``vq_assign_wide``; times from the norms kernel's first
block): the norms kernel's span, the wide kernel's block starts, ends and
times, and the median and largest cycles (``clock64``) a block's first
consumer thread spends in ``full_wait`` (waiting for a stage), ``mma``
(the products), ``epilogue`` (a slice's norms and running minimum) and its
producer lane 0 in ``empty_wait`` (waiting for a stage to be freed); and
the statistics kernel's line as above.

Run in the tree of the column-chunk kernel that the wide kernel replaced
(the parent of the commit that added it, with this file copied in), the
nearest-code line past 512 columns carries ``loop_us_p50_max`` instead:
each block's time summed over its column chunks in ``stage`` (issuing the
chunk's copies), ``wait`` (waiting for them and for the block) and
``score`` (its norms and scores). The port's own build is not touched.
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
from .kernel_times import K2_WIDE

SHAPES = ((512, 64, 512), (4096, 64, 512), (6554, 64, 512)) + K2_WIDE   # (N, D, K)
MAX_BLOCKS = 1 << 16
SLOTS = 6
SUMS = ("stage", "wait", "score")   # the column-chunk loop's phases, summed over a block
WIDE = ("full_wait", "mma", "epilogue", "empty_wait")   # k2_wide.cuh's slots 0-3
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
__device__ unsigned long long g_k2_sums[3 * 65536];
__device__ __forceinline__ unsigned long long k2_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K2_SUMS(a)                                                              \
  if (threadIdx.x == 0)                                                         \
    for (int i = 0; i < 3; ++i) g_k2_sums[i * 65536 + blockIdx.x] = (a)[i];
"""
_DUMP = r"""
extern "C" int k2_marks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k2_marks, sizeof(g_k2_marks));
}
extern "C" int k2_sums(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k2_sums, sizeof(g_k2_sums));
}
"""
# (texts in csrc/vq_assign.cu, any one of which occurs once: the text with its mark)
_POINTS = (
    (("bool vec) {\n  constexpr",), "bool vec) {\n  K2_MARK(0, 0);\n  constexpr"),
    (("      __syncthreads();\n      const int D4 = DK",
      "        __syncthreads();\n        const int D4 = DK"), None),
    (("      __syncthreads();  // the norms are in, and the tile has been read\n",),
     "      __syncthreads();  // the norms are in, and the tile has been read\n"
     "      if (t == 0) K2_MARK(0, 2);\n"),
    (("  cluster.sync();  // every push has landed",),
     "  K2_MARK(0, 3);\n  cluster.sync();\n  K2_MARK(0, 4);  // every push"),
    (("as argmin gives\n  }\n}",), "as argmin gives\n  }\n  __syncthreads();\n  K2_MARK(0, 5);\n}"),
    (("int pass_rows) {\n  extern",), "int pass_rows) {\n  K2_MARK(1, 0);\n  extern"),
    (("\"griddepcontrol.wait;\" ::: \"memory\");\n    __syncthreads();\n",),
     "\"griddepcontrol.wait;\" ::: \"memory\");\n    __syncthreads();\n    K2_MARK(1, 1);\n"),
    (("    __syncthreads();\n    if (k >= K) continue;",),
     "    __syncthreads();\n    K2_MARK(1, 2);\n    if (k >= K) continue;"),
    (("counts[k] = (float)n_k;\n  }\n}",),
     "counts[k] = (float)n_k;\n  }\n  __syncthreads();\n  K2_MARK(1, 3);\n}"),
)
# the column-chunk loop of the kernel the wide kernel replaced, applied after _POINTS
_CHUNKED = (
    ("  K2_MARK(0, 0);\n", "  K2_MARK(0, 0);\n  unsigned long long k2_sum[3] = {0, 0, 0};\n"),
    ("      for (int ch = 0; ch < nch; ++ch) {   // column chunks, in order\n",
     "      for (int ch = 0; ch < nch; ++ch) {   // column chunks, in order\n"
     "        unsigned long long k2_a = k2_now(), k2_b, k2_c;\n"),
    ("        if (keep_codes)\n          cp_async_wait<1>();",
     "        k2_b = k2_now();\n        k2_sum[0] += k2_b - k2_a;\n"
     "        if (keep_codes)\n          cp_async_wait<1>();"),
    ("        if (t == 0) K2_MARK(0, 1);\n",
     "        if (t == 0) K2_MARK(0, 1);\n        k2_c = k2_now();\n"
     "        k2_sum[1] += k2_c - k2_b;\n"),
    ("score_tile<RPT>(acc, xr, cr, S, d4);\n        }\n      }\n",
     "score_tile<RPT>(acc, xr, cr, S, d4);\n        }\n"
     "        k2_sum[2] += k2_now() - k2_c;\n      }\n"),
    ("  __syncthreads();\n  K2_MARK(0, 5);\n}",
     "  __syncthreads();\n  K2_SUMS(k2_sum);\n  K2_MARK(0, 5);\n}"),
)
CHUNK_LOOP = "for (int ch = 0; ch < nch; ++ch)"


def _patch(src: str, olds, new) -> str:
    found = [o for o in olds if src.count(o) == 1]
    if len(found) != 1:
        raise RuntimeError(f"k2_phases: the source no longer has {olds[0]!r}")
    old = found[0]
    if new is None:   # mark 1 after the stage's wait, at the text's own indent
        pad = old[:len(old) - len(old.lstrip())]
        new = old.replace("__syncthreads();\n",
                          f"__syncthreads();\n{pad}if (t == 0) K2_MARK(0, 1);\n")
    return src.replace(old, new)


def instrument(src: str) -> str:
    for olds, new in _POINTS:
        src = _patch(src, olds, new)
    if CHUNK_LOOP in src:
        for old, new in _CHUNKED:
            src = _patch(src, (old,), new)
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
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DK2W_PHASES", "-o",
           f"{workdir}/libvq_assign.so", path]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    so = ctypes.CDLL(f"{workdir}/libvq_assign.so")
    so.vq_assign.argtypes = kernels.SIGNATURES["vq_assign"][1]
    so.vq_assign.restype = ctypes.c_int
    for fn in ("k2_marks", "k2_sums", "k2w_phases"):
        if hasattr(so, fn):
            getattr(so, fn).argtypes, getattr(so, fn).restype = [ctypes.c_void_p], ctypes.c_int
    return so


def _us(a) -> float:
    return float(a) / 1e3


def _p50_max(a) -> list:
    return [float(np.median(a)), float(a.max())]


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
    card = torch.cuda.get_device_name(0)
    for N, D, K in SHAPES:
        x = torch.randn(N, D, device="cuda", generator=g)
        cb = torch.randn(K, D, device="cuda", generator=g)
        idx = torch.empty(N, dtype=torch.int32, device="cuda")
        counts, dw = torch.empty(K, device="cuda"), torch.empty(K, D, device="cuda")
        p = vq_kernel.k2_plan(N, D, K)
        wide = getattr(p, "wide", False)
        last = p.chunk if hasattr(p, "chunk") else int(wide)   # the tree's last plan argument
        args = ([t.data_ptr() for t in (x, cb, idx, counts, dw)]
                + [1, N, D, K, p.tile_rows, p.cluster, p.slices_per_block, p.tiles_per_cluster,
                   p.smem_bytes, p.pass_rows, last, kernels.stream_ptr(x)])
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
            sums = np.zeros(len(SUMS) * MAX_BLOCKS, np.uint64)
            phases = np.zeros(8 * MAX_BLOCKS, np.int64)
            if (status or so.k2_marks(marks.ctypes.data) or so.k2_sums(sums.ctypes.data)
                    or (wide and so.k2w_phases(phases.ctypes.data))):
                raise RuntimeError("vq_assign: CUDA error")
            marks = marks.reshape(2, SLOTS, MAX_BLOCKS).astype(np.int64)
            sums = sums.reshape(len(SUMS), MAX_BLOCKS)[:, :blocks[0]].astype(np.int64)
            phases = phases.reshape(8, MAX_BLOCKS)
            line = {"shape": [N, D, K], "l2": "cold" if cold else "warm", "card": card}
            if wide:
                nb, nn = blocks[0], -(-K // 32)
                t0 = phases[6, :nn].min()
                start, end = phases[4, :nb] - t0, phases[5, :nb] - t0
                print(json.dumps({"kernel": "vq_code_norms", **line, "blocks": nn,
                                  "span_us": _us(phases[7, :nn].max() - t0)}), flush=True)
                print(json.dumps({
                    "kernel": "vq_assign_wide", **line, "blocks": nb,
                    "block_start_us_p50_max": [_us(np.median(start)), _us(start.max())],
                    "block_end_us_p50_max": [_us(np.median(end)), _us(end.max())],
                    "block_us_p50_max": [_us(np.median(end - start)), _us((end - start).max())],
                    "phase_cycles_p50_max": {ph: _p50_max(phases[i, :nb])
                                             for i, ph in enumerate(WIDE)}}), flush=True)
                kernel_list = KERNELS[1:]
            else:
                t0 = marks[0, 0, :blocks[0]].min()
                kernel_list = KERNELS
            for name, ph_names in kernel_list:
                kern = 0 if name == KERNELS[0][0] else 1
                t = marks[kern, :len(ph_names) + 1, :blocks[kern]]
                start = t[0] - t[0].min()
                d = np.diff(t, axis=0)
                loop = {ph: [_us(np.median(sums[i])), _us(sums[i].max())]
                        for i, ph in enumerate(SUMS)} if kern == 0 and D > 512 else {}
                print(json.dumps({
                    "kernel": name, **line, **({"loop_us_p50_max": loop} if loop else {}),
                    "blocks": blocks[kern],
                    "first_start_us": _us(t[0].min() - t0),
                    "span_us": _us(t[-1].max() - t[0].min()),
                    "block_start_us_p50_max": [_us(np.median(start)), _us(start.max())],
                    "block_us_p50_max": [_us(np.median(t[-1] - t[0])), _us((t[-1] - t[0]).max())],
                    "phase_us_p50_max": {ph: [_us(np.median(d[i])), _us(d[i].max())]
                                         for i, ph in enumerate(ph_names)}}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
