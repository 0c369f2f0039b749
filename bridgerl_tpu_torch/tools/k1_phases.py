"""Where a K1 block spends its time, on the card, and where the tensor-core
path overtakes the window tiles.

    python -m bridgerl_tpu_torch.tools.k1_phases                     # float32, one H100
    python -m bridgerl_tpu_torch.tools.k1_phases --dtype bfloat16    # the bf16 kernels
    python -m bridgerl_tpu_torch.tools.k1_phases --crossover [--dtype bfloat16]   # W 16-64
    python -m bridgerl_tpu_torch.tools.k1_phases --wide [--dtype bfloat16]   # Dh past 128 only

Builds copies of K1's sources (the kernels of ``csrc/k1_fwd.cuh`` and
``csrc/k1_bwd.cuh``) into a temporary directory with timestamps (``%globaltimer``) taken by thread
0 of every block, launches each kernel once at each shape of SHAPES (warm,
and after writing 128 MB to empty L2), and prints one JSON line per kernel
and launch: the span from the first block's start to the last block's end,
the spread of block starts, the median time of a block and of each of its
phases. Window tiles (W < 32; marks after each ``__syncthreads()``): stage
(copies in flight plus the bias / Philox prologue), logits, softmax rows,
products and stores. Tensor-core path (the ``K1_PHASE`` marks of
``csrc/k1_mma.cuh``, summed over a block's tiles): wait (staging and
waiting for a tile), logits (the products q k^T and dout v^T, bias, masks,
softmax and draws), products (from registers: p v, ds k, p^T dout, ds^T q)
and stores; the bf16 multi-window kernels (W < 32, ``csrc/k1_multi.cuh``, the
same marks; parts ``multi_fwd`` and ``multi_bwd``): stage (the rows' windows,
seeds and keep bits, drawn while the copies fly, and the wait for q, k and
the bias), logits (forward: q k^T, bias, masks, softmax and the wait for v;
backward ``rows``: s, the softmax, the wait for v and dout, dp, D and ds), products
(forward: p_drop v; backward ``dq``: ds k, its stores and p_drop into the
shared tile) and stores (backward ``keys``: dv and dk by key columns, and
their stores); the two-kernel backward's kernels (dq, then dk / dv) each on
its own line, the row-buffered dq kernel (``dq_rows``) with wait, logits
(s, dp and the draws into the row buffers), rows (max, normaliser, D, ds,
the planes written) and products (ds k), and the keys kernel after it
(``keys``: wait, fragments of the planes, products, stores); the window-resident backward (W <= 64, and <= 128 at
Dh <= 64): stage, rows (s and dp, softmax, draws, ds), dq (its product,
p_drop into shared memory) and keys (dv and dk by key columns, and the
stores). The wide kernels of head dims past 128 (``csrc/k1_wide.cuh``, its
``K1_PHASE`` marks; ``--wide`` times only them): staging (copies in flight
and the waits at the ring's barriers), logits (q k^T, dout v^T over the
head dim), softmax (bias, masks, draws, the row statistics and the exchange
tiles) and products (p v, ds k, p^T dout, ds^T q, and the stores), a line
each for the forward, the one-kernel backward (``wide_window``) or the dq
and dk / dv kernels. ``--crossover`` builds the sources as shipped and, in a
copy whose ``kMinWindow`` is 1, with every window on the tensor-core path
(launched with ``ops/attention.py::mma_plan``), and times both paths' forward
and backward (CUDA events, the median of 30 after warm-up) at CROSSOVER_W
windows of one row each, 65,536 positions a call, in both dtypes or the one
``--dtype`` names (below W 32 the shipped bf16 path is the multi-window
kernels): the W at which the tensor-core path wins is the kernels'
``kMinWindow``. The port's own build is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from ..models.layers import attention_bias, causal_bias
from ..ops import attention, kernels

# (B*H, S, Dh, packing, dropout, causal)
SHAPES = ((256, 80, 64, 8, 0.1, False), (2048, 80, 64, 8, 0.0, False),
          (16384, 5, 64, 1, 0.1, True),   # the slot-AR depth stack (W 5)
          (1024, 64, 64, 1, 0.1, False), (1024, 64, 64, 1, 0.0, False),
          (128, 128, 64, 1, 0.1, True),
          # past the window-resident backward at Dh 64 and W <= 128: W 160 at Dh 128,
          # W 200, causal S 160, the prior at 256 positions and at d_model 128 (Dh 32)
          (24, 160, 128, 1, 0.1, False), (48, 200, 64, 1, 0.1, False),
          (32, 160, 64, 1, 0.1, True), (128, 256, 64, 1, 0.1, True),
          (128, 128, 32, 1, 0.1, True),
          # head dims past 128 (the wide kernels of csrc/k1_wide.cuh): W 10 at Dh 256, W 64
          # at Dh 160, the full grid at Dh 256 causal, Dh 512 on a small grid, and the Dh-256
          # prior's backbone and slot-AR depth stack
          (256, 80, 256, 8, 0.1, False), (256, 64, 160, 1, 0.1, False),
          (128, 256, 256, 1, 0.1, True), (8, 64, 512, 1, 0.1, False),
          (64, 96, 256, 1, 0.1, True), (6144, 5, 256, 1, 0.1, True))
CROSSOVER_W = (16, 20, 24, 28, 32, 40, 48, 64)
CROSSOVER_POSITIONS = 65536
MAX_BLOCKS = 1 << 16
TILE_PHASES = ("stage", "logits", "softmax", "products")
MMA_PHASES = ("wait", "logits", "products", "stores")
WINDOW_PHASES = ("stage", "rows", "dq", "keys")   # the window-resident backward
ROWS_PHASES = ("wait", "logits", "rows", "products")   # the row-buffered dq kernel
KEYS_PHASES = ("wait", "fragments", "products", "stores")   # the keys kernel after it
WIDE_PHASES = ("staging", "logits", "softmax", "products")   # the wide kernels
MULTI_PHASES = {"multi_fwd": ("stage", "logits", "products", "stores"),   # bf16 below W 32
                "multi_bwd": ("stage", "rows", "dq", "keys")}
KERNELS = (("k1_fwd.cuh", "k1_fwd_tiles", "fwd"), ("k1_bwd.cuh", "k1_bwd_tiles", "bwd"))
MIN_WINDOW = "constexpr int kMinWindow = {};"   # k1_mma.cuh's W*, which the copy rewrites
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
# the tensor-core kernels' marks: per block, 4 phase sums and the block's span,
# kernel 0 (forward, dq) and kernel 1 (dk / dv)
_PHASE_HEADER = r"""
#pragma once
__device__ unsigned long long g_k1_phases[2 * 5 * 65536];
__device__ __forceinline__ unsigned long long k1_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K1_PHASE_BEGIN() \
  unsigned long long k1_t_ = k1_now(), k1_t0_ = k1_t_, k1_acc_[4] = {0, 0, 0, 0}
#define K1_PHASE(p)                                 \
  do {                                              \
    const unsigned long long n_ = k1_now();         \
    k1_acc_[p] += n_ - k1_t_;                       \
    k1_t_ = n_;                                     \
  } while (0)
#define K1_PHASE_END(kernel)                                                       \
  if (threadIdx.x == 0 && blockIdx.x < 65536) {                                    \
    for (int p_ = 0; p_ < 4; ++p_)                                                 \
      g_k1_phases[((kernel) * 5 + p_) * 65536 + blockIdx.x] = k1_acc_[p_];         \
    g_k1_phases[((kernel) * 5 + 4) * 65536 + blockIdx.x] = k1_now() - k1_t0_;      \
  }
"""
_DUMP = r"""
extern "C" int k1_marks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k1_marks, sizeof(unsigned long long) * 5 * 65536);
}
extern "C" int k1_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k1_phases,
                                   sizeof(unsigned long long) * 2 * 5 * 65536);
}
"""
# the wide kernels' libraries (csrc/k1_wide.cuh) hold only the tensor-core marks
_WIDE_DUMP = r"""
extern "C" int k1_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k1_phases,
                                   sizeof(unsigned long long) * 2 * 5 * 65536);
}
"""


def instrument(src: str, kernel: str) -> str:
    """Mark the start of the window-tile ``kernel``'s body (0), each of its
    three ``__syncthreads()`` (1-3) and its end (4)."""
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


def _rewrite(path: str, edit) -> None:
    with open(path) as f:
        text = f.read()
    new = edit(text)
    if new == text:
        raise RuntimeError(f"{path}: nothing to rewrite; the source has changed")
    with open(path, "w") as f:
        f.write(new)


def build(workdir: str, dtype=torch.float32, mma_everywhere: bool = False):
    """Instrumented libraries of both directions' ``dtype`` entry points,
    built in ``workdir``; with ``mma_everywhere`` every window takes the
    tensor-core path."""
    for f in kernels.CSRC.iterdir():
        shutil.copy(f, workdir)
    with open(f"{workdir}/k1_phase_marks.h", "w") as f:
        f.write(_PHASE_HEADER)
    for src, kernel, _ in KERNELS:
        _rewrite(f"{workdir}/{src}", lambda text: instrument(text, kernel))
    if mma_everywhere:
        _rewrite(f"{workdir}/k1_mma.cuh", lambda text: text.replace(
            MIN_WINDOW.format(attention.MIN_MMA_WINDOW), MIN_WINDOW.format(1)))
    names = [attention.ENTRY["fwd", dtype], attention.ENTRY["bwd", dtype],
             attention.LONG_ENTRY[dtype], attention.WIDE_ENTRY["fwd", dtype],
             attention.WIDE_ENTRY["bwd", dtype]]
    for dtype_ in attention.DTYPES:
        with open(f"{workdir}/{kernels.SIGNATURES[attention.WIDE_ENTRY['fwd', dtype_]][0]}.cu",
                  "a") as f:
            f.write(_WIDE_DUMP)
    procs = []
    for lib in dict.fromkeys(kernels.SIGNATURES[fn][0] for fn in names):
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-include", f"{workdir}/k1_phase_marks.h",
               "-o", f"{workdir}/lib{lib}.so", f"{workdir}/{lib}.cu"]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
    out = {}
    for fn in names:
        so = ctypes.CDLL(f"{workdir}/lib{kernels.SIGNATURES[fn][0]}.so")
        entry = getattr(so, fn)
        entry.argtypes, entry.restype = kernels.SIGNATURES[fn][1], ctypes.c_int
        for dump in ("k1_marks", "k1_phases"):
            if not hasattr(so, dump):   # the wide kernels' library: k1_phases alone
                continue
            getattr(so, dump).argtypes = [ctypes.c_void_p]
            getattr(so, dump).restype = ctypes.c_int
        out[fn] = (entry, so)
    return out


class Call:
    """One K1 launch through a library of :func:`build`, with its plan."""

    def __init__(self, g, dtype, BH, S, Dh, P, rate, causal, mma_everywhere=False):
        W = S // P
        self.q, self.k, self.v, self.do = (
            torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype) for _ in range(4))
        self.bias = causal_bias(S, "cuda") if causal else attention_bias(P, W, "cuda")
        self.seed = attention.draw_seed(g, "cuda")
        self.out, self.dq, self.dk, self.dv = (torch.empty_like(self.q) for _ in range(4))
        self.stats = None   # the backward's scratch, sized by its plan below
        self.dims = (BH, S, W, Dh)
        self.layout = attention.RowLayout.contiguous(S, Dh)   # the 3-D op's rows
        self.head = (Dh ** -0.5, self.seed.data_ptr() if rate > 0 else 0, BH)   # one group
        self.tail = (attention.keep_threshold(rate), attention._inv_keep(rate), int(rate > 0),
                     int(causal))
        plan = attention.mma_plan if mma_everywhere else attention.k1_plan
        self.plans = {d: plan(BH, S, W, Dh, dtype, d, causal) for d in ("fwd", "bwd")}
        self.dtype = dtype
        self.stats = torch.empty(max(attention.backward_scratch(self.plans["bwd"]), 1),
                                 device="cuda")

    def entry_name(self, direction) -> str:
        """The C entry point of the launch: the backward's two kernels and the
        wide kernels (head dims past 128) have their own."""
        if self.plans[direction].path == "wide":
            return attention.WIDE_ENTRY[direction, self.dtype]
        if direction == "bwd" and self.plans["bwd"].blocks_kv:
            return attention.LONG_ENTRY[self.dtype]
        return attention.ENTRY[direction, self.dtype]

    def __call__(self, direction, entry) -> int:
        plan = self.plans[direction]
        mma = attention.PATH_CODE[plan.path]
        t = lambda *ts: [x.data_ptr() for x in ts]   # noqa: E731
        if direction == "fwd":
            return entry(*t(self.q, self.k, self.v, self.bias, self.out), *self.dims,
                         *self.layout.args("fwd"), *self.head, *self.tail, mma, plan.blocks,
                         plan.smem_bytes, plan.copy_bytes, kernels.stream_ptr(self.q))
        return entry(*t(self.q, self.k, self.v, self.bias, self.do, self.dq, self.dk, self.dv,
                        self.stats), *self.dims, *self.layout.args("bwd"), *self.head,
                     *self.tail, mma, plan.blocks, plan.smem_bytes, plan.blocks_kv,
                     plan.smem_kv, plan.copy_bytes, kernels.stream_ptr(self.q))


def _median_ms(fn, iters: int = 30) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(10_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phases(dtype, wide_only: bool = False) -> None:
    libs = build(tempfile.mkdtemp(prefix="k1_phases_"), dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(32 << 20, device="cuda")
    card = torch.cuda.get_device_name(0)
    for BH, S, Dh, P, rate, causal in SHAPES:
        if wide_only and Dh <= 128:
            continue
        call = Call(g, dtype, BH, S, Dh, P, rate, causal)
        for direction in ("fwd", "bwd"):
            entry, so = libs[call.entry_name(direction)]
            plan = call.plans[direction]
            for cold in (False, True):
                for _ in range(3):
                    call(direction, entry)
                if cold:
                    flush.fill_(1.0)
                torch.cuda._sleep(10_000_000)
                status = call(direction, entry)
                torch.cuda.synchronize()
                if status:
                    raise RuntimeError(f"{direction}: CUDA error {status}")
                line = {"kernel": call.entry_name(direction),
                        "dtype": str(dtype).replace("torch.", ""), "shape": [BH, S, Dh],
                        "window": S // P, "dropout": rate, "causal": causal, "path": plan.path,
                        "l2": "cold" if cold else "warm", "card": card}
                for part, blocks, t in _spans(so, plan):
                    print(json.dumps({**line, "part": part, "blocks": blocks,
                                      **_span_fields(t, plan.path),
                                      **_phase_medians(t, plan.path, part)}), flush=True)


def _spans(so, plan):
    """(part, blocks, (5, blocks) times) of each kernel the launch ran: the
    tile kernel's marks, or each tensor-core or wide kernel's start-relative
    phase sums (row 0 the start, rows 1-4 cumulative; the wide kernels'
    parts ``wide_fwd``, ``wide_window``, or ``wide_dq`` and ``wide_dkv``)."""
    if plan.path == "tiles":
        marks = np.zeros(5 * MAX_BLOCKS, np.uint64)
        if so.k1_marks(marks.ctypes.data):
            raise RuntimeError("k1_marks: CUDA error")
        return [("tiles", plan.blocks,
                 marks.reshape(5, MAX_BLOCKS)[:, :min(plan.blocks, MAX_BLOCKS)].astype(np.int64))]
    raw = np.zeros(2 * 5 * MAX_BLOCKS, np.uint64)
    if so.k1_phases(raw.ctypes.data):
        raise RuntimeError("k1_phases: CUDA error")
    raw = raw.reshape(2, 5, MAX_BLOCKS).astype(np.int64)
    if plan.path == "wide":   # the forward; the one-kernel backward (W <= 64); dq, dk / dv
        parts = ([("wide_fwd", plan.blocks, raw[0])] if plan.direction == "fwd" else
                 [("wide_window", plan.blocks, raw[0])] if not plan.blocks_kv else
                 [("wide_dq", plan.blocks, raw[0]), ("wide_dkv", plan.blocks_kv, raw[1])])
    elif plan.path == "multi":
        parts = [(f"multi_{plan.direction}", plan.blocks, raw[0])]
    elif plan.direction == "fwd":
        parts = [("fwd", plan.blocks, raw[0])]
    elif plan.blocks_kv:
        rows = plan.rows < attention.MMA_ROWS   # the row-buffered dq kernel, then keys
        parts = [("dq_rows" if rows else "dq", plan.blocks, raw[0]),
                 ("keys" if rows else "dkv", plan.blocks_kv, raw[1])]
    else:
        parts = [("window", plan.blocks, raw[0])]
    out = []
    for part, blocks, r in parts:
        n = min(blocks, MAX_BLOCKS)
        acc = r[:4, :n]
        out.append((part, blocks, np.vstack([np.zeros((1, n), np.int64),
                                             np.cumsum(acc, axis=0)])))
    return out


def _span_fields(t, path) -> dict:
    """The span (first start to last end) and block starts from the tile
    kernels' absolute marks; the tensor-core kernels' rows are relative."""
    if path != "tiles":
        return {"block_us_p50": float(np.median(t[4])) / 1e3}
    t0 = t[0].min()
    return {"span_us": (t[4].max() - t0) / 1e3,
            "block_start_us_p50_max": [float(np.median(t[0] - t0)) / 1e3,
                                       float((t[0] - t0).max()) / 1e3],
            "block_us_p50": float(np.median(t[4] - t[0])) / 1e3}


def _phase_medians(t, path, part) -> dict:
    names = (TILE_PHASES if path == "tiles" else MULTI_PHASES[part] if path == "multi"
             else WIDE_PHASES if part.startswith("wide")
             else WINDOW_PHASES if part == "window"
             else ROWS_PHASES if part == "dq_rows" else KEYS_PHASES if part == "keys"
             else MMA_PHASES)
    return {"phase_us_p50": {name: float(np.median(t[i + 1] - t[i])) / 1e3
                             for i, name in enumerate(names)}}


def crossover(dtypes) -> None:
    """Both paths' times at CROSSOVER_W, dropout 0.1, in each of ``dtypes``."""
    work = tempfile.mkdtemp(prefix="k1_crossover_")
    builds = {}
    for dtype in dtypes:
        for mma in (False, True):
            d = f"{work}/{str(dtype)[6:]}_{int(mma)}"
            os.makedirs(d)
            builds[dtype, mma] = build(d, dtype, mma)
    g = torch.Generator(device="cuda").manual_seed(0)
    card = torch.cuda.get_device_name(0)
    for dtype in dtypes:
        for W in CROSSOVER_W:
            line = {"crossover": W, "dtype": str(dtype)[6:], "card": card,
                    "shape": [CROSSOVER_POSITIONS // W, W, 64], "dropout": 0.1}
            for mma, key in ((False, "shipped"), (True, "mma")):
                call = Call(g, dtype, CROSSOVER_POSITIONS // W, W, 64, 1, 0.1, False, mma)
                libs = builds[dtype, mma]
                for direction in ("fwd", "bwd"):
                    line[f"{direction}_{key}_path"] = call.plans[direction].path
                    line[f"{direction}_{key}_ms"] = _median_ms(
                        lambda: call(direction, libs[call.entry_name(direction)][0]))
            print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="default float32 (--crossover: both)")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--wide", action="store_true", help="only the head dims past 128")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases: needs a card")
    if args.crossover:
        crossover([DTYPES[args.dtype]] if args.dtype else list(DTYPES.values()))
    else:
        phases(DTYPES[args.dtype or "float32"], args.wide)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
