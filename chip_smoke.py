#!/usr/bin/env python3
"""Drive the PyTorch port (``bridgerl_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py             # from the repository root, on a machine with a card
    python3 chip_smoke.py --profile   # adds a device-time breakdown of retarget at b=4096

Phases, each printed as one JSON line; any failed check raises and the
script exits non-zero:

1. ``device``: the card's name and power limit (``nvidia-smi``), and the time
   to build the CUDA kernels from ``bridgerl_tpu_torch/csrc/``.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it, with its time (median of CUDA-event timings
   after warm-up), the least time the card could take for the same work
   (``bound_ms``), the plain version's time and, for attention, the time of
   ``scaled_dot_product_attention`` as a yardstick the port never calls.
3. The main path: the flagship retargeting model (full width, weights from a
   fixed seed) served through the port's ``ServingApp``: ``retarget`` at
   b = 1, 5, 64, 512, 4096, ``robot_recon`` and ``motion_codes`` at b = 64, one
   ``retarget`` over HTTP with the port's client, and a 3,000-frame
   overlap-add. Every answer is checked for shape, dtype and finiteness, for
   8 attention and 4 nearest-code launches per model call, and against the
   same weights run on the CPU through the plain versions.
4. The ``kernels`` line (every kernel with its launches on the main path),
   then, last, ``{"ok": true, "device": {...}}``.

It exits non-zero and prints no result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.export.client import ServingClient
from bridgerl_tpu_torch.export.reconstruct import reconstruct_long_sequence
from bridgerl_tpu_torch.export.server import ServingApp, make_server
from bridgerl_tpu_torch.export.serving import build_serving_module
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models.layers import attention_bias
from bridgerl_tpu_torch.ops import attention, codebook, kernels, vq_kernel

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
K1_SHAPES = ((2048, 80, 64, 8), (256, 10, 64, 1))   # (B*H, S, Dh, packing)
K2_SHAPE = (4096, 64, 512)                          # (N, D, K)
K1_ATOL = 1e-4
K2_TIE = 1e-5
K2_DW_RTOL = 1e-4
SERVE_ATOL = 1e-3
CODES_AGREE = 0.999
RETARGET_BATCHES = (1, 5, 64, 512, 4096)
K1_PER_CALL, K2_PER_CALL = 8, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, warmup: int = 5, iters: int = 30) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def launches() -> dict:
    return {name: c.count for name, c in kernels.COUNTERS.items()}


# ---------------------------------------------------------------- phase 2

def check_k1(g: torch.Generator) -> dict:
    cases = []
    for BH, S, Dh, P in K1_SHAPES:
        q, k, v = (torch.randn(BH, S, Dh, device="cuda", generator=g) for _ in range(3))
        bias = attention_bias(P, S // P, "cuda")
        scale = 1.0 / Dh ** 0.5
        out = attention.packed_attention(q, k, v, bias, scale)
        torch.cuda.synchronize()
        ref = attention.packed_attention_reference(q, k, v, bias, scale)
        err = (out - ref).abs().max().item()
        require(torch.isfinite(out).all().item() and err <= K1_ATOL,
                f"K1 {BH, S, Dh}: max abs error {err} > {K1_ATOL}")
        b_ms, b_by = bound(4 * (4 * BH * S * Dh + S * S), 4 * BH * S * S * Dh)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        case = {
            "shape": [BH, S, Dh], "packing": P, "max_abs_err": err,
            "ms": time_ms(lambda: attention.packed_attention(q, k, v, bias, scale)),
            "plain_ms": time_ms(
                lambda: attention.packed_attention_reference(q, k, v, bias, scale)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale)),
        }
        emit({"phase": "kernel", "name": "packed_attention_fwd", **case})
        cases.append(case)
    main, rest = cases[0], cases[1:]
    return {
        "name": "packed_attention_fwd", "route": "cuda",
        "source": "bridgerl_tpu_torch/csrc/packed_attention.cu",
        "replaces": "bridgerl_tpu/ops/pallas/attention.py:143",
        **main, "kernel_ms": main["ms"], "cases": rest,
    }


def check_k2(g: torch.Generator) -> dict:
    N, D, K = K2_SHAPE
    x = torch.randn(N, D, device="cuda", generator=g)
    cb = torch.randn(K, D, device="cuda", generator=g)
    idx, counts, dw = vq_kernel.nearest_codes_cuda(x, cb)
    torch.cuda.synchronize()
    # the plain distances: rows whose best two codes lie within the tie
    # tolerance may go either way
    dist = torch.sum(cb * cb, dim=1)[None, :] - 2.0 * (x @ cb.t())
    two = torch.topk(dist, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) <= K2_TIE * (1.0 + two[:, 0].abs())
    idx0, _, _ = codebook.nearest_codes_plain(x, cb)
    mismatch = (idx != idx0) & ~near_tie
    require(not mismatch.any().item(), f"K2: {int(mismatch.sum())} rows disagree")
    require(counts.sum().item() == N, f"K2: counts sum {counts.sum().item()} != {N}")
    own_counts, own_dw = codebook.assignment_stats(x, idx, K)
    require(torch.equal(counts, own_counts), "K2: counts differ from its own indices")
    err = (dw - own_dw).abs().max().item()
    rel = err / own_dw.abs().max().item()
    require(rel <= K2_DW_RTOL, f"K2: dw relative error {rel} > {K2_DW_RTOL}")
    b_ms, b_by = bound(4 * (N * D + K * D + N + K + K * D), 2 * N * K * D + 2 * K * D + N * D)
    case = {
        "shape": [N, D, K], "max_abs_err": err, "dw_rel_err": rel,
        "idx_mismatch_near_ties": int((idx != idx0).sum()),
        "ms": time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb)),
        "plain_ms": time_ms(lambda: codebook.nearest_codes_plain(x, cb)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit({"phase": "kernel", "name": "vq_assign", **case})
    return {
        "name": "vq_assign", "route": "cuda",
        "source": "bridgerl_tpu_torch/csrc/vq_assign.cu",
        "replaces": "bridgerl_tpu/ops/pallas/vq_kernel.py:106",
        **case, "kernel_ms": case["ms"],
    }


# ---------------------------------------------------------------- phase 3

def _numpy(out):
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out.cpu().numpy()


def _check_answer(name: str, got, want) -> dict:
    """Shape, dtype, finiteness and agreement with the CPU run."""
    if isinstance(want, dict):
        require(sorted(got) == sorted(want), f"{name}: streams {sorted(got)}")
        for k in want:
            require(got[k].shape == want[k].shape and got[k].dtype == np.int32,
                    f"{name}/{k}: {got[k].shape} {got[k].dtype}")
        same = np.all([got[k] == want[k] for k in want], axis=0).reshape(-1)
        agree = float(same.mean())
        require(agree >= CODES_AGREE, f"{name}: codes agree on {agree} of rows")
        return {"codes_agree": agree}
    require(got.shape == want.shape and got.dtype == np.float32,
            f"{name}: {got.shape} {got.dtype}, want {want.shape}")
    require(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    err = float(np.abs(got - want).max())
    require(err <= SERVE_ATOL, f"{name}: max abs error vs CPU {err} > {SERVE_ATOL}")
    return {"max_abs_err_vs_cpu": err}


def _expect_launches(name: str, before: dict, calls: int) -> dict:
    now = launches()
    delta = {k: now[k] - before[k] for k in now}
    want = {"packed_attention_fwd": K1_PER_CALL * calls, "vq_assign": K2_PER_CALL * calls}
    require(delta == want, f"{name}: launches {delta}, want {want}")
    return delta


def main_path(exp, profile: bool = False) -> dict:
    cfg = exp.model
    W = cfg.window_size
    module = build_serving_module(init_model(cfg, SEED, device="cuda"), exp)
    cpu = build_serving_module(init_model(cfg, SEED, device="cpu"), exp)
    app = ServingApp(module)
    rng = np.random.default_rng(SEED)
    dims = {"retarget": cfg.human_input_dim, "robot_recon": cfg.robot_input_dim,
            "motion_codes": cfg.human_input_dim}
    requests = [("retarget", b) for b in RETARGET_BATCHES]
    requests += [("robot_recon", 64), ("motion_codes", 64)]

    kernels.reset_counters()
    for fn, b in requests:
        x = rng.normal(size=(b, W, dims[fn])).astype(np.float32)
        before = launches()
        got = app.call(fn, x)
        delta = _expect_launches(f"{fn} b={b}", before, 1)
        emit({"phase": "request", "fn": fn, "b": b, "launches": delta,
              **_check_answer(f"{fn} b={b}", got, _numpy(cpu.fns[fn](x)))})

    srv = make_server(module, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address
        client = ServingClient(f"http://{host}:{port}")
        health = client.health()
        require(health["ok"] and health["device"].startswith("cuda"), f"healthz {health}")
        x = rng.normal(size=(64, W, cfg.human_input_dim)).astype(np.float32)
        before = launches()
        got = client.retarget(x)
        delta = _expect_launches("HTTP retarget", before, 1)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    emit({"phase": "request", "fn": "retarget", "b": 64, "via": "http",
          "healthz": health, "launches": delta,
          **_check_answer("HTTP retarget", got, _numpy(cpu.fns["retarget"](x)))})

    seq = rng.normal(size=(3000, cfg.robot_input_dim)).astype(np.float32)
    mean = np.zeros(cfg.robot_input_dim, np.float32)
    std = np.ones(cfg.robot_input_dim, np.float32)
    before = launches()
    got = reconstruct_long_sequence(module.fns["robot_recon"], seq, W, 5, mean, std,
                                    device="cuda")
    delta = _expect_launches("overlap-add", before, 1)
    want = reconstruct_long_sequence(cpu.fns["robot_recon"], seq, W, 5, mean, std,
                                     device="cpu")
    emit({"phase": "request", "fn": "reconstruct_long_sequence", "frames": 3000,
          "step": 5, "launches": delta,
          **_check_answer("overlap-add", got, want)})
    counts = launches()
    require(all(counts[k] > 0 for k in counts), f"a kernel never ran: {counts}")

    # serving speed, through the same ServingApp
    x4096 = rng.normal(size=(4096, W, cfg.human_input_dim)).astype(np.float32)
    x1 = x4096[:1].copy()
    for _ in range(3):
        app.call("retarget", x4096)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        app.call("retarget", x4096)
    wps = reps * 4096 / (time.perf_counter() - t0)
    lat = []
    for _ in range(5):
        app.call("retarget", x1)
    for _ in range(50):
        t0 = time.perf_counter()
        app.call("retarget", x1)
        lat.append((time.perf_counter() - t0) * 1e3)
    out = {"launches": counts, "retarget_windows_per_s_b4096": wps,
           "retarget_p50_ms_b1": statistics.median(lat)}
    if profile:
        out["profile"] = device_breakdown(app, x4096)
    return out


def device_breakdown(app: ServingApp, x: np.ndarray, reps: int = 3) -> dict:
    """Device time by kernel over ``reps`` retarget requests, from
    torch.profiler, and the share of the requests' wall time the card idled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    app.call("retarget", x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            app.call("retarget", x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    require(busy_ms > 0, "the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    return {"b": x.shape[0], "requests": reps, "wall_ms_per_request": wall_ms / reps,
            "device_ms_per_request": busy_ms / reps, "idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"kernel": name[:90], "ms_per_request": ms / reps,
                     "launches_per_request": n / reps, "share": ms / busy_ms}
                    for name, ms, n in rows[:15]]}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s})
    print(smi, flush=True)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    table = [check_k1(g), check_k2(g)]

    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8)
    t0 = time.perf_counter()
    serve = main_path(exp, profile="--profile" in argv)
    breakdown = serve.pop("profile", None)
    emit({"phase": "serve", "card": smi, **serve,
          "main_path_s": time.perf_counter() - t0})
    if breakdown is not None:
        emit({"phase": "profile", "card": smi, **breakdown})
    for row in table:
        row["launches"] = serve["launches"][row["name"]]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
