#!/usr/bin/env python3
"""Drive the PyTorch port (``bridgerl_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py             # from the repository root, on a machine with a card
    python3 chip_smoke.py --profile   # adds device-time breakdowns of retarget at b=4096
                                      # and of one teacher optimizer step

Phases, each printed as one JSON line; any failed check raises and the
script exits non-zero:

1. ``device``: the card's name and power limit (``nvidia-smi``), and the time
   to build the CUDA kernels from ``bridgerl_tpu_torch/csrc/``.
2. ``kernel`` lines: each kernel against its plain PyTorch version on the
   card, at the shapes the serving and training paths give it, with its
   time (median of CUDA-event timings after warm-up), the least time the
   card could take for the same work (``bound_ms``), the plain version's
   time and, where one PyTorch call computes the same function, its time as
   a yardstick the port never calls (``scaled_dot_product_attention``
   forward, and its backward through autograd). K1 runs with dropout 0 and
   0.1; with dropout its keep mask must equal the plain Philox mask bit for
   bit in both directions, and its kept share lie within 4 sigma of 0.9.
3. The serving path: the flagship retargeting model (full width, weights
   from a fixed seed) served through the port's ``ServingApp``: ``retarget``
   at b = 1, 5, 64, 512, 4096, ``robot_recon`` and ``motion_codes`` at b = 64,
   one ``retarget`` over HTTP with the port's client, and a 3,000-frame
   overlap-add. Every answer is checked for shape, dtype and finiteness, for
   8 attention and 4 nearest-code launches per model call, and against the
   same weights run on the CPU through the plain versions.
4. The training path: the flagship's teacher trains through the port's
   ``Trainer`` (batch 16384 in 32 microbatches of 512, dropout 0.1, seeded
   normal windows as the JAX package's bench makes them), then the student
   from the teacher's best checkpoint. Losses must be finite, the
   checkpoints and histories must carry the reference's names and keys, and
   every microbatch must launch exactly 8 K1 forwards, 8 K1 backwards and
   4 K2 (teacher) or 16, 4 and 8 (student); validation launches forwards
   only. Windows/s after a warm-up epoch.
5. ``train_agree``: one optimizer batch of 512 at dropout 0 from one seed,
   on the card and on the CPU: loss within 1e-4 relative, every parameter's
   gradient within 1e-3 in relative norm.
6. The ``kernels`` line (every kernel with its launches on each path), then,
   last, ``{"ok": true, "device": {...}}``.

It exits non-zero and prints no result when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from bridgerl_tpu_torch.config import HISTORY_KEYS, make_experiment
from bridgerl_tpu_torch.data.dataset import PairedDataset
from bridgerl_tpu_torch.export.client import ServingClient
from bridgerl_tpu_torch.export.reconstruct import reconstruct_long_sequence
from bridgerl_tpu_torch.export.server import ServingApp, make_server
from bridgerl_tpu_torch.export.serving import build_serving_module
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models.layers import attention_bias
from bridgerl_tpu_torch.ops import attention, codebook, kernels, vq_kernel
from bridgerl_tpu_torch.train.trainer import (
    Trainer,
    accumulate_grads,
    make_optimizer,
    make_train_epoch,
)

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# (B*H, S, Dh, packing, dropout): serving at b=4096 and b=64 unpacked, and the
# training microbatch of 512 windows packed 8 to a row
K1_SHAPES = ((2048, 80, 64, 8, 0.0), (256, 10, 64, 1, 0.0), (256, 80, 64, 8, 0.0),
             (256, 80, 64, 8, 0.1))
K1_BWD_SHAPES = ((256, 80, 64, 8, 0.1), (256, 80, 64, 8, 0.0), (2048, 80, 64, 8, 0.0),
                 (2048, 80, 64, 8, 0.1))
K2_SHAPES = ((4096, 64, 512), (512, 64, 512))        # (N, D, K): serving, training
DROPOUT = 0.1
K1_ATOL = 1e-4
K2_TIE = 1e-5
K2_DW_RTOL = 1e-4
SERVE_ATOL = 1e-3
CODES_AGREE = 0.999
RETARGET_BATCHES = (1, 5, 64, 512, 4096)
K1_PER_CALL, K2_PER_CALL = 8, 4
TRAIN_WINDOWS, TRAIN_BATCH, TRAIN_ACCUM = 65536, 16384, 32
TEACHER_EPOCHS, STUDENT_EPOCHS = 3, 2
# launches per microbatch (train) and per validation batch: K1 fwd, K1 bwd, K2
PER_MICROBATCH = {"teacher": (8, 8, 4), "student": (16, 4, 8)}
PER_VAL_BATCH = {"teacher": (8, 0, 4), "student": (16, 0, 8)}
AGREE_BATCH, AGREE_LOSS_RTOL, AGREE_GRAD_RTOL = 512, 1e-4, 1e-3


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

def _k1_inputs(g, BH, S, Dh, P):
    q, k, v = (torch.randn(BH, S, Dh, device="cuda", generator=g) for _ in range(3))
    seed = attention.draw_seed(g, "cuda")
    return q, k, v, attention_bias(P, S // P, "cuda"), 1.0 / Dh ** 0.5, seed


def check_k1(g: torch.Generator) -> dict:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for BH, S, Dh, P, rate in K1_SHAPES:
        q, k, v, bias, scale, seed = _k1_inputs(g, BH, S, Dh, P)
        out = attention.attention_fwd(q, k, v, bias, scale, seed, rate)
        torch.cuda.synchronize()
        ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate)
        err = (out - ref).abs().max().item()
        require(torch.isfinite(out).all().item() and err <= K1_ATOL,
                f"K1 {BH, S, Dh} dropout {rate}: max abs error {err} > {K1_ATOL}")
        b_ms, b_by = bound(4 * (4 * BH * S * Dh + S * S), 4 * BH * S * S * Dh)
        case = {
            "shape": [BH, S, Dh], "packing": P, "dropout": rate, "max_abs_err": err,
            "ms": time_ms(lambda: attention.attention_fwd(q, k, v, bias, scale, seed, rate)),
            "plain_ms": time_ms(lambda: attention.packed_attention_reference(
                q, k, v, bias, scale, seed, rate)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale,
                                               dropout_p=rate)),
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


def check_k1_mask(g: torch.Generator) -> dict:
    """With v = I (Dh >= S) the forward returns p_drop, and with dout = I the
    backward's dv is p_drop^T: both kernels' keep bits, read inside each
    window (where p > 0), must equal the plain Philox mask exactly."""
    BH, S, Dh, P = 256, 80, 128, 8
    q, k, _, bias, scale, seed = _k1_inputs(g, BH, S, Dh, P)
    eye = torch.eye(S, Dh, device="cuda").expand(BH, S, Dh).contiguous()
    fwd = attention.attention_fwd(q, k, eye, bias, scale, seed, DROPOUT)[:, :, :S] > 0
    _, _, dv = attention.attention_bwd(q, k, eye, bias, eye, scale, seed, DROPOUT)
    bwd = dv[:, :S, :S].transpose(1, 2) > 0
    torch.cuda.synchronize()
    inside = attention_bias(P, S // P, "cuda") == 0
    want = attention.attention_dropout_mask(seed, BH, S, DROPOUT, "cuda") & inside
    require(torch.equal(fwd, want), f"K1 fwd keep mask differs in {int((fwd != want).sum())}")
    require(torch.equal(bwd, want), f"K1 bwd keep mask differs in {int((bwd != want).sum())}")
    n = int(inside.sum()) * BH
    share = fwd.sum().item() / n
    sigma = math.sqrt(DROPOUT * (1 - DROPOUT) / n)
    require(abs(share - (1 - DROPOUT)) <= 4 * sigma,
            f"K1 kept share {share} is not within 4 sigma ({sigma}) of {1 - DROPOUT}")
    out = {"phase": "kernel_mask", "shape": [BH, S, Dh], "packing": P,
           "dropout": DROPOUT, "kept_share": share, "sigma": sigma, "elements": n,
           "mask_equal_fwd": True, "mask_equal_bwd": True}
    emit(out)
    return out


def check_k1_bwd(g: torch.Generator) -> dict:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for BH, S, Dh, P, rate in K1_BWD_SHAPES:
        q, k, v, bias, scale, seed = _k1_inputs(g, BH, S, Dh, P)
        do = torch.randn(BH, S, Dh, device="cuda", generator=g)
        got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate)
        torch.cuda.synchronize()
        want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        require(all(torch.isfinite(a).all().item() for a in got) and err <= K1_ATOL,
                f"K1 bwd {BH, S, Dh} dropout {rate}: max abs error {err} > {K1_ATOL}")
        # the JAX cost model of the backward (attention.py:179)
        b_ms, b_by = bound(7 * BH * S * Dh * 4, 10 * BH * S * S * Dh)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(qg, kg, vg, attn_mask=bias, scale=scale, dropout_p=rate)
        case = {
            "shape": [BH, S, Dh], "packing": P, "dropout": rate, "max_abs_err": err,
            "ms": time_ms(lambda: attention.attention_bwd(q, k, v, bias, do, scale, seed,
                                                          rate)),
            "plain_ms": time_ms(lambda: attention.packed_attention_bwd_reference(
                q, k, v, bias, do, scale, seed, rate)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), do, retain_graph=True)),
        }
        emit({"phase": "kernel", "name": "packed_attention_bwd", **case})
        cases.append(case)
    main, rest = cases[0], cases[1:]
    return {
        "name": "packed_attention_bwd", "route": "cuda",
        "source": "bridgerl_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "bridgerl_tpu/ops/pallas/attention.py:164",
        **main, "kernel_ms": main["ms"], "cases": rest,
    }


def check_k2(g: torch.Generator) -> dict:
    cases = []
    for N, D, K in K2_SHAPES:
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
        b_ms, b_by = bound(4 * (N * D + K * D + N + K + K * D),
                           2 * N * K * D + 2 * K * D + N * D)
        case = {
            "shape": [N, D, K], "max_abs_err": err, "dw_rel_err": rel,
            "idx_mismatch_near_ties": int((idx != idx0).sum()),
            "ms": time_ms(lambda: vq_kernel.nearest_codes_cuda(x, cb)),
            "plain_ms": time_ms(lambda: codebook.nearest_codes_plain(x, cb)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        emit({"phase": "kernel", "name": "vq_assign", **case})
        cases.append(case)
    main, rest = cases[0], cases[1:]
    return {
        "name": "vq_assign", "route": "cuda",
        "source": "bridgerl_tpu_torch/csrc/vq_assign.cu",
        "replaces": "bridgerl_tpu/ops/pallas/vq_kernel.py:106",
        **main, "kernel_ms": main["ms"], "cases": rest,
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
    want = {"packed_attention_fwd": K1_PER_CALL * calls, "packed_attention_bwd": 0,
            "vq_assign": K2_PER_CALL * calls}
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
    require(counts["packed_attention_fwd"] > 0 and counts["vq_assign"] > 0,
            f"a serving kernel never ran: {counts}")

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


# ---------------------------------------------------------------- phase 4

def _train_exp(workdir: str, **over):
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8,
                          batch_size=TRAIN_BATCH, accum_chunks=TRAIN_ACCUM, seeds=(SEED,),
                          **over)
    return dataclasses.replace(exp, log_dir=os.path.join(workdir, "results"),
                               checkpoint_dir=os.path.join(workdir, "checkpoints"))


def _expected_train_launches(trainer: Trainer, n: int, epochs: int) -> dict:
    exp = trainer.exp
    mode = exp.train.mode
    n_train = int((1.0 - exp.train.val_fraction) * n)
    micro = (n_train // TRAIN_BATCH) * TRAIN_ACCUM
    val_batches = max((n - n_train) // min(TRAIN_BATCH, n - n_train), 1)
    names = ("packed_attention_fwd", "packed_attention_bwd", "vq_assign")
    return {name: epochs * (micro * m + val_batches * v)
            for name, m, v in zip(names, PER_MICROBATCH[mode], PER_VAL_BATCH[mode])}


def _run_stage(exp, ds: PairedDataset, epochs: int) -> dict:
    trainer = Trainer(exp, device="cuda", verbose=False)
    kernels.reset_counters()
    hist = trainer.run(ds)[SEED]
    counts = launches()
    mode = exp.train.mode
    want = _expected_train_launches(trainer, len(ds), epochs)
    require(counts == want, f"{mode}: launches {counts}, want {want}")
    require(sorted(hist) == sorted(HISTORY_KEYS), f"{mode}: history keys {sorted(hist)}")
    require(len(hist["train_loss"]) == epochs
            and all(math.isfinite(x) for k in ("train_loss", "val_loss") for x in hist[k]),
            f"{mode}: losses {hist['train_loss']} {hist['val_loss']}")
    for kind in ("best", "last", "final"):
        path = trainer.ckpt_path(SEED, kind)
        require(os.path.basename(path) == f"{exp.run_name(SEED)}_{kind}.pth"
                and os.path.exists(path), f"{mode}: no checkpoint {path}")
    for name in (exp.log_name(SEED), f"log_{exp.name}_{mode}_seed_{SEED}.json"):
        with open(os.path.join(exp.log_dir, name)) as f:
            require(sorted(json.load(f)) == sorted(HISTORY_KEYS), f"{mode}: {name}")
    timed = trainer.train_seconds[1:]          # the first epoch is the warm-up
    windows = sum(w for _, w, _ in timed)
    seconds = sum(t for _, _, t in timed)
    return {"mode": mode, "epochs": epochs, "launches": counts,
            "microbatch": TRAIN_BATCH // TRAIN_ACCUM,
            "windows_per_s": windows / seconds, "timed_windows": windows,
            "timed_seconds": seconds, "epoch_seconds": [t for _, _, t in trainer.train_seconds],
            "train_loss": hist["train_loss"], "val_loss": hist["val_loss"],
            "ckpt_best": trainer.ckpt_path(SEED, "best")}


def train_path(smi: str) -> dict:
    """Teacher, then student from the teacher's best checkpoint, through
    the port's Trainer at full width; files go to a temporary directory."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        W = 10
        ds = PairedDataset(torch.randn(TRAIN_WINDOWS, W, 29, device="cuda", generator=g),
                           torch.randn(TRAIN_WINDOWS, W, 126, device="cuda", generator=g))
        teacher = _run_stage(_train_exp(workdir, epochs=TEACHER_EPOCHS), ds, TEACHER_EPOCHS)
        emit({"phase": "train", "card": smi, **teacher})
        student = _run_stage(_train_exp(workdir, mode="student", epochs=STUDENT_EPOCHS,
                                        teacher_ckpt=teacher["ckpt_best"]),
                             ds, STUDENT_EPOCHS)
        emit({"phase": "train", "card": smi, **student})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    total = {k: teacher["launches"][k] + student["launches"][k] for k in teacher["launches"]}
    require(all(v > 0 for v in total.values()), f"a kernel never ran in training: {total}")
    return {"launches": total, "teacher_windows_per_s": teacher["windows_per_s"],
            "student_windows_per_s": student["windows_per_s"]}


def train_agree() -> dict:
    """One optimizer batch at dropout 0, from one seed, on the card and on
    the CPU (plain versions): the loss and every parameter's gradient."""
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8, dropout=0.0,
                          batch_size=AGREE_BATCH, accum_chunks=1)
    rng = np.random.default_rng(SEED + 2)
    robot = rng.normal(size=(AGREE_BATCH, 10, 29)).astype(np.float32)
    human = rng.normal(size=(AGREE_BATCH, 10, 126)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = init_model(exp.model, SEED, device=dev)
        opt = make_optimizer(model, exp)
        opt.zero_grad(set_to_none=True)
        logs = accumulate_grads(model, exp, torch.from_numpy(robot).to(dev),
                                torch.from_numpy(human).to(dev),
                                torch.arange(AGREE_BATCH, device=dev), None)
        out[dev] = (float(logs["train_loss"]),
                    {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    require(loss_rel <= AGREE_LOSS_RTOL, f"train_agree: loss {l_gpu} vs {l_cpu}")
    require(sorted(g_gpu) == sorted(g_cpu) and g_cpu, "train_agree: gradient sets differ")
    worst, worst_name = 0.0, ""
    for name, gc in g_cpu.items():
        rel = ((g_gpu[name] - gc).norm() / gc.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    require(worst <= AGREE_GRAD_RTOL, f"train_agree: {worst_name} gradient off by {worst}")
    res = {"phase": "train_agree", "batch": AGREE_BATCH, "loss_cuda": l_gpu,
           "loss_cpu": l_cpu, "loss_rel_err": loss_rel, "params_compared": len(g_cpu),
           "worst_grad_rel_norm_err": worst, "worst_param": worst_name}
    emit(res)
    return res


def train_breakdown(reps: int = 1) -> dict:
    """Device time by kernel over one teacher optimizer step (32
    microbatches of 512) from torch.profiler, after one warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    exp = _train_exp(tempfile.gettempdir())
    model = init_model(exp.model, SEED, device="cuda")
    opt = make_optimizer(model, exp)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    robot = torch.randn(TRAIN_BATCH, 10, 29, device="cuda", generator=g)
    human = torch.randn(TRAIN_BATCH, 10, 126, device="cuda", generator=g)
    idx = torch.arange(TRAIN_BATCH, device="cuda")[None]
    step = make_train_epoch(exp)
    step(model, opt, robot, human, idx, g)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(model, opt, robot, human, idx, g)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    require(busy_ms > 0, "the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    return {"what": "teacher optimizer step", "batch": TRAIN_BATCH,
            "microbatches": TRAIN_ACCUM, "steps": reps, "wall_ms_per_step": wall_ms / reps,
            "device_ms_per_step": busy_ms / reps, "idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches_per_step": sum(r[2] for r in rows) / reps,
            "top": [{"kernel": name[:90], "ms_per_step": ms / reps,
                     "launches_per_step": n / reps, "share": ms / busy_ms}
                    for name, ms, n in rows[:20]]}


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
    table = [check_k1(g), check_k1_bwd(g), check_k2(g)]
    check_k1_mask(g)

    profile = "--profile" in argv
    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8)
    t0 = time.perf_counter()
    serve = main_path(exp, profile=profile)
    breakdown = serve.pop("profile", None)
    emit({"phase": "serve", "card": smi, **serve,
          "main_path_s": time.perf_counter() - t0})
    if breakdown is not None:
        emit({"phase": "profile", "card": smi, **breakdown})

    t0 = time.perf_counter()
    train = train_path(smi)
    emit({"phase": "train_summary", "card": smi, **train,
          "train_path_s": time.perf_counter() - t0})
    train_agree()
    if profile:
        emit({"phase": "profile", "card": smi, **train_breakdown()})

    for row in table:
        by_path = {"serve": serve["launches"][row["name"]],
                   "train": train["launches"][row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
