"""Prior-coherence A/B: factorized heads against the slot-AR depth head, with
and without corpus phase augmentation, in one process.

    python -m bridgerl_tpu_torch.cli.exp_prior_ar \
        --ckpt checkpoints/Exp_transformer_W64_K4_hybrid_teacher_seed_42_best.pth \
        --out_dir abruns/prior_ar

The protocol, flags, defaults, file names and JSON keys of
``scripts/exp_prior_ar.py``: the full-raw W64 takes are tokenized through a
trained teacher on the raw pipeline (stride 32, max_len 96), each prior arm
trains with the take-grouped split, and its samples are scored against the
data: velocity and jerk RMS ratios, range coverage, static fraction, the
adjacent-window overlap disagreement the stitch averages away, code
novelty and the nearest data window. The decode+stitch ceiling (the data's
own codes round-tripped) bounds what any prior over this tokenizer can
reach. Writes ``prior_<arm>.ckpt`` (the port's prior payload),
``gen_<arm>_idx<i>.npy`` and ``summary.json`` into ``--out_dir``.

``--ckpt`` is a port checkpoint; samples are the port's Philox-Gumbel draws
from ``--seed``. ``--device`` (default ``cuda``) picks the device; without
a card the run stops unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import cli_device
from ..eval.generation import (
    code_novelty,
    compare_to_data,
    format_report,
    nearest_data_distance,
    overlap_disagreement,
)
from ..eval.studies import (
    RAW_MEAN,
    RAW_STD,
    decode_ceiling,
    load_takes,
    load_teacher,
    phase_offsets,
    window_bank,
)
from ..train.prior import (
    PriorTrainConfig,
    extract_code_grids,
    load_prior_checkpoint,
    sample_motion,
    save_prior_checkpoint,
    train_prior,
)

PROG = "exp_prior_ar"
ARMS = {
    "fact": dict(slot_ar=False, phases=1),
    "ar": dict(slot_ar=True, phases=1),
    "ar_ph4": dict(slot_ar=True, phases=4),
    "fact_ph4": dict(slot_ar=False, phases=4),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="trained VQ-VAE teacher checkpoint (.pth)")
    p.add_argument("--data_dir", default="data/dense_w64")
    p.add_argument("--out_dir", default="abruns/prior_ar")
    p.add_argument("--stride", type=int, default=32)
    p.add_argument("--max_len", type=int, default=96)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--patience", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--positions", type=int, default=64)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--arms", default="fact,ar,ar_ph4",
                   help="comma list from {fact, ar, ar_ph4, fact_ph4}")
    p.add_argument("--select", default="train", choices=["train", "val"],
                   help="checkpoint selection metric: 'val' (grouped-val CE) returns a "
                        "near-init prior on a memorization-scale corpus; 'train' fits the "
                        "corpus, and the novelty metrics guard against verbatim copying")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(PROG, args.device)
    if device is None:
        return 2
    unknown = [a for a in args.arms.split(",") if a not in ARMS]
    if unknown:
        print(f"{PROG}: unknown arms {unknown}; choose from {sorted(ARMS)}", file=sys.stderr)
        return 2
    loaded = load_teacher(PROG, args.ckpt, device)
    if loaded is None:
        return 2
    model, exp = loaded
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    W = exp.model.window_size
    seqs = load_takes(args.data_dir)
    print(f"[INFO] {len(seqs)} takes, W={W}, stride={args.stride}", flush=True)

    def tokenize(n_phases):
        return extract_code_grids(model, exp, seqs, RAW_MEAN, RAW_STD, args.stride,
                                  max_len=args.max_len,
                                  phases=phase_offsets(args.stride, n_phases))

    grids1, mask1, pcfg1, ids1 = tokenize(1)
    print(f"[INFO] phases=1: {grids1.shape[0]} grids, {int(mask1.sum())} positions, "
          f"{len(pcfg1.vocab_sizes)} slots", flush=True)

    # the decode+stitch ceiling: the data's own codes, round-tripped
    ceiling = decode_ceiling(model, exp, grids1, mask1, pcfg1, seqs, args.stride)
    # raw data windows on the stride grid: the novelty yardstick
    data_wins = window_bank(seqs, W, args.stride)
    print("[CEILING] data codes -> decode+stitch:", flush=True)
    print(format_report(ceiling), flush=True)
    print(f"  overlap disagreement RMS {ceiling['overlap_disagreement']:.4f}", flush=True)

    summary = {"ceiling": dict(ceiling), "arms": {}}
    for arm in args.arms.split(","):
        spec = ARMS[arm]
        t0 = time.time()
        if spec["phases"] == 1:
            grids, mask, pcfg, ids = grids1, mask1, pcfg1, ids1
        else:
            grids, mask, pcfg, ids = tokenize(spec["phases"])
        pcfg = dataclasses.replace(pcfg, slot_ar=spec["slot_ar"])
        tcfg = PriorTrainConfig(epochs=args.epochs, patience=args.patience,
                                batch_size=args.batch_size, seed=args.seed, select=args.select)
        print(f"=== arm {arm}: {grids.shape[0]} grids, slot_ar={spec['slot_ar']} ===",
              flush=True)
        prior, history = train_prior(grids, mask, pcfg, tcfg, seq_ids=ids, verbose=True,
                                     device=device)
        ck = out / f"prior_{arm}.ckpt"
        save_prior_checkpoint(str(ck), prior, pcfg, history=history)
        prior_model, _ = load_prior_checkpoint(str(ck), device=device)
        motions, windows, gen_grid = sample_motion(
            model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=args.n_samples,
            n_positions=args.positions, temperature=args.temperature, seed=args.seed,
            return_windows=True, return_grid=True)
        rep = compare_to_data(motions, seqs)
        rep["overlap_disagreement"] = float(np.mean(
            [overlap_disagreement(w, args.stride) for w in windows]))
        rep.update(code_novelty(gen_grid, grids, mask))
        rep.update(nearest_data_distance(windows, data_wins))
        rep["best_val_ce"] = float(min(history["val_loss"]))
        rep["best_train_ce"] = float(min(history["train_loss"]))
        rep["epochs_run"] = len(history["val_loss"])
        rep["train_s"] = round(time.time() - t0, 1)
        summary["arms"][arm] = rep
        for i, m in enumerate(motions):
            np.save(out / f"gen_{arm}_idx{i}.npy", m)
        print(f"[ARM {arm}] train CE {rep['best_train_ce']:.3f} "
              f"val CE {rep['best_val_ce']:.3f} | vel ratio {rep['vel_ratio']:.3f} | "
              f"coverage {rep['range_coverage_mean']:.2f} | "
              f"overlap dis {rep['overlap_disagreement']:.4f} | "
              f"novel pos {rep['position_novel_frac']:.2f} "
              f"bigram {rep['bigram_novel_frac']:.2f} | nn_mse {rep['nn_mse_mean']:.4f} | "
              f"{rep['train_s']}s", flush=True)

    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"[INFO] summary -> {out / 'summary.json'}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
