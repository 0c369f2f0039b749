"""Prior corpus-scaling experiment: is the coherence limit really data?

    python -m bridgerl_tpu_torch.cli.exp_prior_scaling \
        --ckpt checkpoints/Exp_transformer_W64_K4_hybrid_teacher_seed_42_best.pth

The flags, defaults, arm keys, file names and JSON keys of
``scripts/exp_prior_scaling.py``. The take pool grows with fresh takes of
the same distribution (``data/synthetic.py::synth_robot_takes``) beyond the
pinned ones, each arm a superset of the last. Per arm (take count N, tagged
with ``--tag``): tokenize through the frozen teacher (stride 32, 4 phases,
slot-AR unless ``--factorized``), train the prior with the take-grouped
split, then score the grouped-val CE trajectory; free-run samples against
the arm's takes (novelty, the nearest train-take window); held-out
prompted continuation at P = ``--prompt_len`` (``continuation_curves``);
and two floors: ``recon_floor`` (a val take's aligned windows round-tripped
through the tokenizer) and ``val_nn_floor`` (real val windows' nearest
train-take window). Results accumulate in ``<out_dir>/scaling.json``; an
arm already there is skipped.

``--ckpt`` is a port checkpoint; samples are the port's Philox-Gumbel draws
from ``--seed``. ``--device`` (default ``cuda``) picks the device; without
a card the run stops unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import cli_device
from ..data.synthetic import synth_robot_takes
from ..eval.generation import (
    code_novelty,
    compare_to_data,
    continuation_curves,
    nearest_data_distance,
    overlap_disagreement,
)
from ..eval.studies import (
    RAW_MEAN,
    RAW_STD,
    decode_grid_rows,
    grouped_val_takes,
    held_out_rows,
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
    stitch_windows,
    train_prior,
)

PROG = "exp_prior_scaling"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="VQ-VAE teacher checkpoint (.pth)")
    p.add_argument("--data_dir", default="data/dense_w64")
    p.add_argument("--out_dir", default="abruns/prior_scale")
    p.add_argument("--arms", default="64,160,320",
                   help="comma list of take counts (64 = pinned corpus only)")
    p.add_argument("--extra_seed", type=int, default=9000,
                   help="rng seed for the fresh takes (not the pinned 0)")
    p.add_argument("--min_len", type=int, default=6000)
    p.add_argument("--max_len_frames", type=int, default=6400)
    p.add_argument("--stride", type=int, default=32)
    p.add_argument("--max_len", type=int, default=96)
    p.add_argument("--n_phases", type=int, default=4)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--positions", type=int, default=64)
    p.add_argument("--prompt_len", type=int, default=8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--d_model", type=int, default=256,
                   help="prior width (capacity sweep at fixed corpus)")
    p.add_argument("--n_layers", type=int, default=4)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--prior_dropout", type=float, default=0.1)
    p.add_argument("--tag", default="",
                   help="suffix for the arm key and checkpoint (e.g. _d384L6), so capacity "
                        "arms do not collide with take-count arms")
    p.add_argument("--scheduled_sampling", type=float, default=0.0,
                   help="max scheduled-sampling prob (tag the arm, e.g. --tag _ss25)")
    p.add_argument("--factorized", action="store_true",
                   help="disable the within-position slot-AR depth head "
                        "(A/B arm: tag it, e.g. --tag _factorized)")
    p.add_argument("--select", default="train", choices=["train", "val"],
                   help="prior checkpoint selection: 'train' fits the corpus (generative "
                        "regime), 'val' early-stops on grouped-val CE")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(PROG, args.device)
    if device is None:
        return 2
    loaded = load_teacher(PROG, args.ckpt, device)
    if loaded is None:
        return 2
    model, exp = loaded
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    W = exp.model.window_size

    pinned = load_takes(args.data_dir)
    arm_counts = [int(x) for x in args.arms.split(",")]
    extra = synth_robot_takes(max(0, max(arm_counts) - len(pinned)), args.min_len,
                              args.max_len_frames, args.extra_seed)
    pool = pinned + extra
    print(f"[INFO] pool: {len(pinned)} pinned + {len(extra)} fresh takes, W={W}", flush=True)
    phases = phase_offsets(args.stride, args.n_phases)

    results_path = out / "scaling.json"
    results = json.loads(results_path.read_text()) if results_path.exists() else {}

    for n_takes in arm_counts:
        arm = f"takes{n_takes}{args.tag}"
        if arm in results:
            print(f"[SKIP] {arm} already done", flush=True)
            continue
        t0 = time.time()
        seqs = pool[:n_takes]
        grids, mask, pcfg, ids = extract_code_grids(model, exp, seqs, RAW_MEAN, RAW_STD,
                                                    args.stride, max_len=args.max_len,
                                                    phases=phases)
        pcfg = dataclasses.replace(
            pcfg, slot_ar=not args.factorized, d_model=args.d_model, ff_dim=2 * args.d_model,
            n_layers=args.n_layers, n_heads=args.n_heads, dropout=args.prior_dropout)
        print(f"=== {arm}: {grids.shape[0]} grids, {int(mask.sum())} positions ===",
              flush=True)

        tcfg = PriorTrainConfig(epochs=args.epochs, patience=args.patience,
                                batch_size=args.batch_size, seed=args.seed, select=args.select,
                                scheduled_sampling=args.scheduled_sampling)
        prior, history = train_prior(grids, mask, pcfg, tcfg, seq_ids=ids, verbose=True,
                                     device=device)
        ck = out / f"prior_{arm}.ckpt"
        save_prior_checkpoint(str(ck), prior, pcfg, history=history)
        prior_model, _ = load_prior_checkpoint(str(ck), device=device)

        # train_prior's take-grouped split, and the train-take window bank
        # (val takes excluded: the nearest-window yardstick)
        val_takes = grouped_val_takes(ids, tcfg.seed, tcfg.val_fraction)
        is_val = np.asarray([int(s) in val_takes for s in ids])
        train_bank = window_bank(seqs, W, args.stride,
                                 [si for si in range(n_takes) if si not in val_takes])
        val_wins = window_bank(seqs, W, args.stride, sorted(val_takes))

        rep = {
            "n_grids": int(grids.shape[0]),
            "n_positions": int(mask.sum()),
            "n_val_takes": len(val_takes),
            "best_train_ce": float(min(history["train_loss"])),
            "val_ce_epoch0": float(history["val_loss"][0]),
            "val_ce_best": float(min(history["val_loss"])),
            "val_ce_best_epoch": int(np.argmin(history["val_loss"])),
            "val_ce_final": float(history["val_loss"][-1]),
            "epochs_run": len(history["val_loss"]),
        }

        # floors: the frozen tokenizer's recon on val takes, real val windows' nn
        sel, n_pos = held_out_rows(is_val, mask, args.positions, args.n_samples)
        true_wins = decode_grid_rows(model, exp, pcfg, grids[sel, :n_pos])
        # recon floor: a val take's own phase-0 windows round-tripped through
        # the tokenizer (grid rows may carry phase or chunk offsets, so one
        # aligned prefix a val take is tokenized again)
        errs = []
        for si in sorted(val_takes)[:args.n_samples]:
            s = np.asarray(seqs[si], np.float32)
            n_w = min(args.positions, (s.shape[0] - W) // args.stride + 1)
            raw = np.stack([s[i * args.stride:i * args.stride + W] for i in range(n_w)])
            g1, _, pc1, _ = extract_code_grids(model, exp, [s[:(n_w - 1) * args.stride + W]],
                                               RAW_MEAN, RAW_STD, args.stride, max_len=n_w)
            dec = decode_grid_rows(model, exp, pc1, g1[:, :n_w])[0]
            errs.append(float(np.mean((dec - raw) ** 2)))
        rep["recon_floor"] = float(np.mean(errs))
        rep["val_nn_floor"] = nearest_data_distance(val_wins, train_bank)["nn_mse_mean"]

        # free-run sample
        motions, wins, grid = sample_motion(
            model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=args.n_samples,
            n_positions=n_pos, temperature=args.temperature, seed=args.seed,
            return_windows=True, return_grid=True)
        free = compare_to_data(motions, seqs)
        free["overlap_disagreement"] = float(np.mean(
            [overlap_disagreement(w, args.stride) for w in wins]))
        free.update(code_novelty(grid, grids, mask))
        free.update(nearest_data_distance(wins, train_bank))
        rep["free_run"] = free

        # held-out prompted continuation
        P = args.prompt_len
        _, wins_p, grid_p = sample_motion(
            model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=len(sel), n_positions=n_pos,
            temperature=args.temperature, seed=args.seed, prompt=grids[sel, :P],
            return_windows=True, return_grid=True)
        cont = wins_p[:, P:]
        pr = compare_to_data([stitch_windows(w, args.stride) for w in cont], seqs)
        pr.update(code_novelty(grid_p[:, P:], grids, mask))
        pr.update(continuation_curves(cont, true_wins[:, P:], train_bank))
        rep[f"prompted_val_P{P}"] = pr

        rep["arm_s"] = round(time.time() - t0, 1)
        results[arm] = rep
        results_path.write_text(json.dumps(results, indent=1))
        print(f"[ARM {arm}] train CE {rep['best_train_ce']:.3f} "
              f"val CE {rep['val_ce_epoch0']:.3f}->{rep['val_ce_best']:.3f}"
              f"@{rep['val_ce_best_epoch']} | free vel {free['vel_ratio']:.2f} "
              f"nn {free['nn_mse_mean']:.4f} | "
              f"prompted nn@off {['%.3f' % v for v in pr['nn_mse_by_offset']]} truth@off "
              f"{['%.3f' % v for v in pr['truth_mse_by_offset']]} | "
              f"floors recon {rep['recon_floor']:.4f} val_nn {rep['val_nn_floor']:.4f} | "
              f"{rep['arm_s']}s", flush=True)

    print(f"[INFO] scaling results -> {results_path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
