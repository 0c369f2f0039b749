"""Host cost of reaching the kernels through the ``torch.library`` custom ops,
on the card.

    python -m bridgerl_tpu_torch.tools.dispatch_cost     # from the repository root, one H100

A trace (the serving artifact) reaches K1 and K2 through the custom ops
``bridgerl::packed_attention_qkv_fwd`` / ``_bwd`` (the models' attention on the
projection's layout; the 3-D ``bridgerl::packed_attention_fwd`` / ``_bwd``
below dispatch alike) and ``bridgerl::nearest_codes``:
the dispatcher and autograd's ``setup_context`` run on the host before each
launch. The eager path (the live model, the trainer) calls the ops' CUDA
implementations without that dispatch (``ops/kernels.py::eager_cuda``). This
tool prints one JSON line per measurement, each with the ops (``op``: as a
trace would, ``eager_cuda`` made false in this process only) and without
them (``eager``: as shipped):

- ``call``: host microseconds to enqueue one call of ``attention_fwd`` (also
  under autograd), ``attention_bwd`` and ``nearest_codes``, on tensors small
  enough that the card keeps up with the host;
- ``end_to_end``: the flagship's teacher optimizer step (16384 windows in 32
  microbatches, as ``chip_smoke.py`` trains it) in float32 and bf16, and
  ``retarget`` requests at b = 4096 and b = 1.

Each measurement alternates op, eager, eager, op rounds and reports the
median of each.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..config import make_experiment
from ..export.server import ServingApp
from ..export.serving import build_serving_module
from ..models import init_model
from ..models.layers import attention_bias
from ..ops import attention, codebook, kernels
from ..train.trainer import make_optimizer, make_train_epoch

CALLS, CALL_ROUNDS = 200, 8
STEP_WINDOWS, STEP_ACCUM, STEPS, STEP_ROUNDS = 16384, 32, 3, 2
REQUEST_ROUNDS, REQUESTS_B4096, REQUESTS_B1 = 2, 20, 50
ORDER = ("op", "eager", "eager", "op")


@contextlib.contextmanager
def through_ops():
    """Inside, CUDA tensors go through the custom ops, as in a trace."""
    saved = kernels.eager_cuda
    kernels.eager_cuda = lambda t: False
    try:
        yield
    finally:
        kernels.eager_cuda = saved


def _rounds(fn, rounds: int) -> dict:
    """Median of ``fn()`` (a time) in each mode over ``rounds`` passes of
    ORDER."""
    got = {"op": [], "eager": []}
    for _ in range(rounds):
        for mode in ORDER:
            with through_ops() if mode == "op" else contextlib.nullcontext():
                got[mode].append(fn())
    return {m: statistics.median(v) for m, v in got.items()}


def _enqueue_us(call) -> float:
    """Host microseconds a call, over CALLS calls enqueued back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        call()
    us = (time.perf_counter() - t0) * 1e6 / CALLS
    torch.cuda.synchronize()
    return us


def call_costs() -> list:
    g = torch.Generator(device="cuda").manual_seed(0)
    BH, S, Dh = 8, 10, 64
    q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=g) for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    bias = attention_bias(1, S, "cuda")
    scale = Dh ** -0.5
    x = torch.randn(64, 64, device="cuda", generator=g)
    cb = torch.randn(512, 64, device="cuda", generator=g)
    cases = {
        "k1_fwd": lambda: attention.attention_fwd(q, k, v, bias, scale, None, 0.0, S),
        "k1_fwd_autograd": lambda: attention.attention_fwd(qg, kg, vg, bias, scale, None,
                                                           0.0, S),
        "k1_bwd": lambda: attention.attention_bwd(q, k, v, bias, do, scale, None, 0.0, S),
        "k2": lambda: codebook.nearest_codes(x, cb),
    }
    lines = []
    for name, call in cases.items():
        for _ in range(3):   # builds the kernels, warms the dispatcher's caches
            call()
        us = _rounds(lambda: _enqueue_us(call), CALL_ROUNDS)
        lines.append({"measure": "call", "case": name, "host_us_op": us["op"],
                      "host_us_eager": us["eager"], "host_us_added": us["op"] - us["eager"],
                      "calls": CALLS, "rounds": CALL_ROUNDS})
    return lines


def _flagship(dtype: str, **over):
    return make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                           compute_dtype=dtype, **over)


def teacher_step(dtype: str) -> dict:
    """Seconds of one teacher optimizer step of the flagship on random data."""
    exp = _flagship(dtype, batch_size=STEP_WINDOWS, accum_chunks=STEP_ACCUM)
    model = init_model(exp.model, 0, device="cuda")
    opt = make_optimizer(model, exp)
    train_epoch = make_train_epoch(exp)
    g = torch.Generator(device="cuda").manual_seed(1)
    robot = torch.randn(STEP_WINDOWS, 10, exp.model.robot_input_dim, device="cuda",
                        generator=g)
    human = torch.randn(STEP_WINDOWS, 10, exp.model.human_input_dim, device="cuda",
                        generator=g)

    def steps() -> float:
        idx = torch.randperm(STEP_WINDOWS, generator=g, device="cuda").reshape(1, -1)
        t0 = time.perf_counter()
        for _ in range(STEPS):
            train_epoch(model, opt, robot, human, idx, g)   # reads its losses: a sync
        return (time.perf_counter() - t0) / STEPS

    steps()   # builds the kernels and warms the allocator
    s = _rounds(steps, STEP_ROUNDS)
    return {"measure": "end_to_end", "case": f"teacher_step_{dtype}",
            "ms_op": s["op"] * 1e3, "ms_eager": s["eager"] * 1e3,
            "added_share": s["op"] / s["eager"] - 1.0, "steps": STEPS,
            "rounds": STEP_ROUNDS}


def requests(dtype: str) -> list:
    """Median ms of a retarget request at b = 4096 and at b = 1."""
    exp = _flagship(dtype)
    app = ServingApp(build_serving_module(init_model(exp.model, 0, device="cuda"), exp))
    rng = np.random.default_rng(0)
    lines = []
    for b, reps in ((4096, REQUESTS_B4096), (1, REQUESTS_B1)):
        x = rng.normal(size=(b, 10, exp.model.human_input_dim)).astype(np.float32)
        for _ in range(3):
            app.call("retarget", x)

        def timed() -> float:
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                app.call("retarget", x)   # numpy out: a sync
                ms.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ms)

        s = _rounds(timed, REQUEST_ROUNDS)
        lines.append({"measure": "end_to_end", "case": f"retarget_b{b}_{dtype}",
                      "ms_op": s["op"], "ms_eager": s["eager"],
                      "added_share": s["op"] / s["eager"] - 1.0, "requests": reps,
                      "rounds": REQUEST_ROUNDS})
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_cost: needs a card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    lines = call_costs()
    for dtype in ("float32", "bfloat16"):
        lines += requests(dtype)
        lines.append(teacher_step(dtype))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
