"""Warm device times of K1 and K2 at fixed shapes, on the card, in the tree it
runs from: the way to compare two versions of the kernels in one call.

    python -m bridgerl_tpu_torch.tools.kernel_times TAG [--build] [--k2]   # one H100

prints one JSON line per case (``tree`` = TAG): K1's forward and backward
(float32 and bf16, dropout 0.1) at the token prior's, the towers' and the
two-kernel backward's shapes, the window tiles' (bf16: the multi-window
kernels') serving, artifact, latent and seed-group shapes, and K2 at the
flagship's and the zoo's and
past 512 columns (``K2_WIDE``, chip_smoke.py's as well; with its plain version's
time and a cold time, L2 emptied before each call). Each time is the median
of 50 CUDA-event timings after 5 warm-up calls, with a ~5 ms spin queued
before each so that the events bracket the device work
(``chip_smoke.py::time_ms``'s method). ``--build`` only builds the kernels;
``--k2`` times K2 alone.

To compare a parent commit with a change, unpack the parent into a
directory that ``.gitignore`` lists (``git archive``), build both trees
together, then run parent, change, change, parent in one call, each from
its own tree's root with ``PYTHONPATH`` at that root.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from ..models.layers import attention_bias, causal_bias
from ..ops import attention, codebook, kernels, vq_kernel

# (B*H, S, W, Dh, causal): the towers' W 10 (packing 8) and W 64, the prior at 128 and 256
# positions and at d_model 128, the backward's two-kernel shapes, the slot-AR depth stack;
# past Dh 128 (csrc/k1_wide.cuh): W 10 at Dh 256, W 64 at Dh 160, the full grid at Dh 256
# causal, Dh 512 on a small grid, and the Dh-256 prior's backbone and depth stack; head dims
# off the instantiated widths beside the native rows at the same shape (Dh 8 and 24 beside
# 16 and 32 at W 10, 48 beside 64 at W 64), the Dh-48 and d384L6 priors' backbones, and
# rows staged in narrower copies (Dh 50 and 12; 100 on the row-buffered backward; 130 and
# 300 on the wide kernels)
K1_SHAPES = ((256, 80, 10, 64, False), (2048, 80, 10, 64, False), (1024, 64, 64, 64, False),
             (128, 128, 128, 64, True), (128, 128, 128, 32, True), (24, 160, 160, 128, False),
             (48, 200, 200, 64, False), (32, 160, 160, 64, True), (128, 256, 256, 64, True),
             (16384, 5, 5, 64, True),
             (256, 80, 10, 256, False), (256, 64, 64, 160, False), (128, 256, 256, 256, True),
             (8, 64, 64, 512, False), (64, 96, 96, 256, True), (6144, 5, 5, 256, True),
             (256, 80, 10, 8, False), (256, 80, 10, 16, False), (256, 80, 10, 24, False),
             (256, 80, 10, 32, False), (256, 64, 64, 48, False), (256, 64, 64, 64, False),
             (128, 96, 96, 48, True), (12288, 5, 5, 48, True), (128, 96, 96, 96, True),
             (256, 80, 10, 50, False), (256, 64, 64, 12, False), (24, 160, 160, 100, False),
             (64, 96, 96, 130, True), (256, 64, 64, 300, False),
             # below W 32 (bf16: the multi-window kernels): serving's 256 windows, the
             # artifact's 16384, the latent batches, the d384L6 prior's depth stack
             (256, 10, 10, 64, False), (16384, 10, 10, 64, False),
             (128, 80, 10, 64, False), (176, 10, 10, 64, False), (12288, 5, 5, 96, True))
# (B*H, S, W, Dh, seed groups): the stacked multi-seed step's K1 (4 seeds x 1024 rows)
K1_GROUPED = ((4096, 80, 10, 64, 4),)
# (N, D, K): serving, training, validation, the zoo's K 1024, the studies' teacher, and two
# other widths
K2_SHAPES = ((4096, 64, 512), (512, 64, 512), (6554, 64, 512), (4096, 64, 1024),
             (16384, 64, 1024), (16384, 64, 512), (1000, 512, 100), (5000, 128, 1024))
# past 512 columns (chip_smoke.py's too): hidden_dim 640 and 1024 at training's and serving's N
K2_WIDE = ((512, 640, 512), (4096, 640, 512), (512, 1024, 512), (4096, 1024, 512))
LEAD_CYCLES = 10_000_000
L2_FLUSH_FLOATS = 32 << 20   # 128 MB written before each cold call: over twice the L2


def time_ms(fn, warmup: int = 5, iters: int = 50, cold: bool = False) -> float:
    flush = torch.empty(L2_FLUSH_FLOATS, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cold:
            flush.fill_(1.0)
        torch.cuda._sleep(LEAD_CYCLES)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a card")
    kernels.build_all()
    if "--build" in argv:
        return 0
    tag = argv[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in () if "--k2" in argv else attention.DTYPES:
        for BH, S, W, Dh, causal, groups in [*((*c, 1) for c in K1_SHAPES),
                                             *((*c[:4], False, c[4]) for c in K1_GROUPED)]:
            q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            bias = causal_bias(S, "cuda") if causal else attention_bias(S // W, W, "cuda")
            seed = (attention.draw_seed(g, "cuda") if groups == 1 else torch.randint(
                0, attention.SEED_HIGH, (groups,), device="cuda", generator=g, dtype=torch.int32))
            scale = Dh ** -0.5
            fwd = lambda: attention.attention_fwd(q, k, v, bias, scale, seed, 0.1, W, causal)
            bwd = lambda: attention.attention_bwd(q, k, v, bias, do, scale, seed, 0.1, W,
                                                  causal)
            print(json.dumps({"tree": tag, "kernel": "k1", "dtype": str(dtype)[6:],
                              "shape": [BH, S, W, Dh], "causal": causal, "seed_groups": groups,
                              "head_width": attention.head_width(Dh),
                              "fwd_ms": time_ms(fwd), "bwd_ms": time_ms(bwd)}), flush=True)
    for N, D, K in K2_SHAPES + K2_WIDE:
        x = torch.randn(N, D, device="cuda", generator=g)
        cb = torch.randn(K, D, device="cuda", generator=g)
        row = {"tree": tag, "kernel": "k2", "shape": [N, D, K],
               "ms": time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb))}
        if D > 512:
            row.update(ms_cold=time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb), cold=True),
                       plain_ms=time_ms(lambda: codebook.nearest_codes_plain(x, cb)))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
