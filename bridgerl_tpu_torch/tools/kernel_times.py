"""Warm device times of K1 and K2 at fixed shapes, on the card, in the tree it
runs from: the way to compare two versions of the kernels in one call.

    python -m bridgerl_tpu_torch.tools.kernel_times TAG [--build] [--k2] [--layout]   # one H100
    python -m bridgerl_tpu_torch.tools.kernel_times TAG --regs SOURCE [SOURCE ...]

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

``--layout`` times what the attention's layout moves, in both dtypes, in
place of the kernels: one ``SelfAttention`` forward and backward at the
training shape (``ATTN_SHAPE``: device time as above, and the host's wall
time a call); at each of ``LAYOUT_SHAPES`` K1's 3-D launch alone on
contiguous (B*H, S, Dh) rows (``fwd_3d_ms``, ``bwd_3d_ms``), the attention
call as a model made it before the fused layout (``folded_*_ms``: the fold
of q, k and v out of the (B, S, 3d) projection, the 3-D launch and the
unfold of out; backward: dout folded, dq, dk and dv unfolded and
concatenated) and, where the tree has it, the fused launch on the
projection's buffer as it is (``qkv_*_ms``); the flagship's teacher
optimizer step (32 microbatches of 512) after a warm-up step,
``STEP_PROFILES`` steps each under its own torch.profiler (device
launches, device and wall ms, the card's idle share, and the card's SM
clock, power draw, temperature and clock-limiting reasons from
``nvidia-smi`` read just after the step) and ``retarget`` at b = 1 (median
ms of ``REQUESTS`` requests). It imports only what both trees have, so
that a parent tree runs the change's copy.

``--regs`` compiles the named ``csrc/`` sources (``packed_attention_wide``,
say) as the build does, with ptxas's report (``-Xptxas -v``), and prints one
line per kernel: its registers, stack frame and spill stores and loads.

To compare a parent commit with a change, unpack the parent into a
directory that ``.gitignore`` lists (``git archive``), build both trees
together, then run parent, change, change, parent in one call, each from
its own tree's root with ``PYTHONPATH`` at that root.
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

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
# (B, S, d, heads): the flagship's SelfAttention at a training microbatch (W 10, packing 8)
ATTN_SHAPE = (64, 80, 256, 4)
# (B, H, S, W, Dh, causal) of --layout's K1 rows: the training microbatch; the artifact's
# retarget at b = 4096 (unpacked, S = W = 10) and the slot-AR depth stack (32 x 128 tokens,
# 5 slots), whose fused blocks cross from one row to the next; the long-window prior's
# backbone (the two-kernel backward) and the Dh-256 prior's depth stack (the wide kernels)
LAYOUT_SHAPES = ((64, 4, 80, 10, 64, False), (4096, 4, 10, 10, 64, False),
                 (4096, 4, 5, 5, 64, True), (32, 4, 256, 256, 64, True),
                 (3072, 2, 5, 5, 256, True))
STEP_BATCH, STEP_ACCUM, STEP_PROFILES, REQUESTS = 16384, 32, 3, 50
CARD_STATE = "clocks.sm,power.draw,temperature.gpu"
# the clock-limiting reasons' field, by its newer name and its older one
CLOCK_REASONS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")
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


def _wall_ms(fn, warmup: int = 5, iters: int = 50) -> float:
    """Median host wall time of a synchronised call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _card_state() -> str:
    """The card's SM clock (MHz), power draw, temperature and clock-limiting
    reasons (a bit mask, 0 where nothing limits the clock), as nvidia-smi
    prints them."""
    out = []
    for fields in (CARD_STATE, *CLOCK_REASONS):
        r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                           capture_output=True, text=True)
        if r.returncode == 0:
            out.append(r.stdout.strip())
            if fields != CARD_STATE:
                break
    return ", ".join(out)


def _step_profile(dtype: torch.dtype) -> dict:
    """STEP_PROFILES teacher optimizer steps of the flagship after a warm-up
    step, each under torch.profiler: device launches, device ms, wall ms,
    idle share, and the card's state just after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..config import make_experiment
    from ..models import init_model
    from ..train.trainer import make_optimizer, make_train_epoch

    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                          batch_size=STEP_BATCH, accum_chunks=STEP_ACCUM,
                          compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    model = init_model(exp.model, 0, device="cuda")
    opt = make_optimizer(model, exp)
    g = torch.Generator(device="cuda").manual_seed(3)
    robot = torch.randn(STEP_BATCH, 10, exp.model.robot_input_dim, device="cuda", generator=g)
    human = torch.randn(STEP_BATCH, 10, exp.model.human_input_dim, device="cuda", generator=g)
    idx = torch.arange(STEP_BATCH, device="cuda")[None]
    step = make_train_epoch(exp)
    step(model, opt, robot, human, idx, g)
    steps = []
    for _ in range(STEP_PROFILES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(model, opt, robot, human, idx, g)
            wall = (time.perf_counter() - t0) * 1e3
        card = _card_state()
        rows = [(ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]
        busy = sum(r[0] for r in rows)
        steps.append({"device_launches": sum(r[1] for r in rows), "device_ms": busy,
                      "wall_ms": wall, "idle_share": 1.0 - busy / wall, "card": card})
    return {"steps": steps,
            **{k: statistics.mean(st[k] for st in steps)
               for k in ("device_launches", "device_ms", "wall_ms", "idle_share")}}


def _retarget_p50(dtype: torch.dtype) -> float:
    import numpy as np

    from ..config import make_experiment
    from ..export.server import ServingApp
    from ..export.serving import build_serving_module
    from ..models import init_model

    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                          compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    app = ServingApp(build_serving_module(init_model(exp.model, 0, device="cuda"), exp))
    x = np.random.default_rng(0).normal(size=(1, 10, exp.model.human_input_dim))
    x = x.astype(np.float32)
    for _ in range(5):
        app.call("retarget", x)
    ms = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        app.call("retarget", x)   # numpy out: a sync
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _fold(x: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, H Dh) -> (B*H, S, Dh), as a model folded the heads before the
    fused layout (a copy)."""
    B, S, d = x.shape
    return x.reshape(B, S, H, d // H).transpose(1, 2).reshape(B * H, S, d // H)


def _unfold(x: torch.Tensor, H: int) -> torch.Tensor:
    BH, S, Dh = x.shape
    return x.reshape(BH // H, H, S, Dh).transpose(1, 2).reshape(BH // H, S, H * Dh)


def _layout_row(tag: str, g: torch.Generator, dtype, B, H, S, W, Dh, causal) -> None:
    """One of ``--layout``'s K1 lines (module docstring)."""
    d = H * Dh
    qkv = torch.randn(B, S, 3 * d, device="cuda", generator=g).to(dtype)
    do = torch.randn(B, S, d, device="cuda", generator=g).to(dtype)
    bias = causal_bias(S, "cuda") if causal else attention_bias(S // W, W, "cuda")
    seed = attention.draw_seed(g, "cuda")
    args = (Dh ** -0.5, seed, 0.1, W, causal)
    q, k, v = (_fold(t, H) for t in qkv.chunk(3, dim=-1))
    do3 = _fold(do, H)

    def folded_fwd():
        parts = (_fold(t, H) for t in qkv.chunk(3, dim=-1))
        return _unfold(attention.attention_fwd(*parts, bias, *args), H)

    def folded_bwd():
        parts = (_fold(t, H) for t in qkv.chunk(3, dim=-1))
        grads = attention.attention_bwd(*parts, bias, _fold(do, H), *args)
        return torch.cat([_unfold(t, H) for t in grads], dim=-1)

    row = {"tree": tag, "kernel": "k1_layout", "dtype": str(dtype)[6:],
           "shape": [B, H, S, W, Dh], "causal": causal,
           "fwd_3d_ms": time_ms(lambda: attention.attention_fwd(q, k, v, bias, *args)),
           "bwd_3d_ms": time_ms(lambda: attention.attention_bwd(q, k, v, bias, do3, *args)),
           "folded_fwd_ms": time_ms(folded_fwd), "folded_bwd_ms": time_ms(folded_bwd)}
    if hasattr(attention, "attention_qkv"):
        row.update(qkv_fwd_ms=time_ms(lambda: attention.attention_qkv(qkv, H, bias, *args)),
                   qkv_bwd_ms=time_ms(lambda: attention.attention_qkv_bwd(qkv, H, bias, do,
                                                                          *args)))
    print(json.dumps(row), flush=True)


def regs_rows(tag: str, sources) -> None:
    """``--regs``'s lines (module docstring)."""
    def report(name: str) -> str:
        with tempfile.TemporaryDirectory() as tmp:
            r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                f"{tmp}/{name}.so", str(kernels.CSRC / f"{name}.cu")],
                               capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
        return r.stdout + r.stderr

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        reports = dict(zip(sources, pool.map(report, sources)))
    for name, text in reports.items():
        for row in ptxas_rows(text):
            print(json.dumps({"tree": tag, "kernel": "regs", "source": name, **row}), flush=True)


def ptxas_rows(text: str):
    """Each kernel of a ptxas ``-v`` report: its (mangled) name, registers,
    stack frame and spill stores and loads, in bytes."""
    row = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            row = {"function": m.group(1)}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and row is not None:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and row is not None:
            yield {**row, "registers": int(m.group(1))}
            row = None


def layout_rows(tag: str, g: torch.Generator) -> None:
    """``--layout``'s lines (module docstring)."""
    from ..models.layers import SelfAttention

    B, S, d, H = ATTN_SHAPE
    for dtype in attention.DTYPES:
        name = str(dtype)[6:]
        attn = SelfAttention(d, H, dtype).cuda()
        torch.nn.init.xavier_uniform_(attn.in_proj_weight)
        x = torch.randn(B, S, d, device="cuda", generator=g).to(dtype).requires_grad_()
        dy = torch.randn(B, S, d, device="cuda", generator=g).to(dtype)
        bias = attention_bias(8, 10, "cuda")
        call = lambda: attn(x, bias, 0.1, g, window=10).backward(dy)   # noqa: E731
        print(json.dumps({"tree": tag, "kernel": "self_attention", "dtype": name,
                          "shape": [B, S, d], "heads": H, "ms": time_ms(call),
                          "wall_ms": _wall_ms(call)}), flush=True)
        for shape in LAYOUT_SHAPES:
            _layout_row(tag, g, dtype, *shape)
        print(json.dumps({"tree": tag, "kernel": "teacher_step", "dtype": name,
                          **_step_profile(dtype)}), flush=True)
        print(json.dumps({"tree": tag, "kernel": "retarget_b1", "dtype": name,
                          "p50_ms": _retarget_p50(dtype), "requests": REQUESTS}), flush=True)


def main(argv) -> int:
    if "--regs" in argv:
        regs_rows(argv[0], argv[argv.index("--regs") + 1:])
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a card")
    kernels.build_all()
    if "--build" in argv:
        return 0
    tag = argv[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    if "--layout" in argv:
        layout_rows(tag, g)
        return 0
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
