"""Action-conditioned prior at scale: does conditioning become real with data?

    python -m bridgerl_tpu_torch.cli.exp_prior_conditioned \
        --ckpt checkpoints/Exp_transformer_W64_K4_hybrid_teacher_seed_42_best.pth

The flags, defaults, arm keys, file names and JSON keys of
``scripts/exp_prior_conditioned.py``: takes labelled by construction
(``data/synthetic.py::synth_labeled_takes``, one frequency band an action)
at ``--arms`` takes per class, one held-out take per class
(``train_prior``'s ``val_take_ids``), and three readouts an arm: the
conditioning gain (best grouped-val CE of the class-conditioned prior
against an unconditioned control on the same grids and split), the prior
as a classifier of the held-out takes' grids (``classify_grids``, chance
1/7), and the code-space histogram match of conditioned free-run samples
against each class's train histogram (``class_histogram_match``), with
each class's velocity ratio against its own takes. Results accumulate in
``<out_dir>/conditioned.json``; an arm already there is skipped.

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
from ..data.synthetic import ACTION_BANDS, synth_labeled_takes
from ..eval.generation import class_histogram_match, compare_to_data
from ..eval.studies import RAW_MEAN, RAW_STD, load_teacher, phase_offsets
from ..train.prior import (
    PriorTrainConfig,
    classify_grids,
    extract_code_grids,
    load_prior_checkpoint,
    sample_motion,
    save_prior_checkpoint,
    train_prior,
)

PROG = "exp_prior_conditioned"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="VQ-VAE teacher checkpoint (.pth)")
    p.add_argument("--out_dir", default="abruns/prior_cond")
    p.add_argument("--arms", default="3,12,48", help="comma list of takes per class")
    p.add_argument("--take_seed", type=int, default=9100,
                   help="rng seed for the labeled takes (class streams are superset-monotone "
                        "across arms under one seed)")
    p.add_argument("--min_len", type=int, default=6000)
    p.add_argument("--max_len_frames", type=int, default=6400)
    p.add_argument("--stride", type=int, default=32)
    p.add_argument("--max_len", type=int, default=96)
    p.add_argument("--n_phases", type=int, default=4)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--gen_per_class", type=int, default=6)
    p.add_argument("--positions", type=int, default=64)
    p.add_argument("--temperature", type=float, default=1.0)
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
    actions = tuple(ACTION_BANDS)
    C = len(actions)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    arm_counts = [int(x) for x in args.arms.split(",")]
    pool, labels = synth_labeled_takes(max(arm_counts), args.min_len, args.max_len_frames,
                                       args.take_seed, actions=actions)
    print(f"[INFO] pool: {len(pool)} labeled takes ({max(arm_counts)}/class x {C} classes)",
          flush=True)
    phases = phase_offsets(args.stride, args.n_phases)

    results_path = out / "conditioned.json"
    results = json.loads(results_path.read_text()) if results_path.exists() else {}

    for n_per in arm_counts:
        arm = f"perclass{n_per}"
        if arm in results:
            print(f"[SKIP] {arm} already done", flush=True)
            continue
        t0 = time.time()
        n_takes = n_per * C   # the generator interleaves classes: [a0_0..a6_0, ...]
        seqs, labs = pool[:n_takes], labels[:n_takes]
        grids, mask, pcfg, ids = extract_code_grids(model, exp, seqs, RAW_MEAN, RAW_STD,
                                                    args.stride, max_len=args.max_len,
                                                    phases=phases)
        class_ids = np.asarray([actions.index(labs[i]) for i in ids], np.int32)
        # one held-out take per class: the generator's first C takes are one of
        # each class in every arm, so every arm validates on the same takes
        val_take_ids = list(range(C))
        base = dataclasses.replace(pcfg, slot_ar=True, d_model=256, ff_dim=512, n_layers=4,
                                   n_heads=4, dropout=0.1)
        tcfg = PriorTrainConfig(epochs=args.epochs, patience=args.patience,
                                batch_size=args.batch_size, seed=args.seed, select="val")
        print(f"=== {arm}: {grids.shape[0]} grids, {int(mask.sum())} positions ===",
              flush=True)

        cond_cfg = dataclasses.replace(base, class_names=actions)
        cond, cond_hist = train_prior(grids, mask, cond_cfg, tcfg, seq_ids=ids,
                                      class_ids=class_ids, val_take_ids=val_take_ids,
                                      verbose=True, device=device)
        ck = out / f"prior_{arm}_cond.ckpt"
        save_prior_checkpoint(str(ck), cond, cond_cfg, history=cond_hist)
        prior_model, _ = load_prior_checkpoint(str(ck), device=device)
        _, uncond_hist = train_prior(grids, mask, base, tcfg, seq_ids=ids,
                                     val_take_ids=val_take_ids, verbose=True, device=device)

        rep = {
            "n_takes": n_takes,
            "n_grids": int(grids.shape[0]),
            "cond_val_ce_best": float(min(cond_hist["val_loss"])),
            "cond_val_ce_epoch0": float(cond_hist["val_loss"][0]),
            "uncond_val_ce_best": float(min(uncond_hist["val_loss"])),
            "uncond_val_ce_epoch0": float(uncond_hist["val_loss"][0]),
        }
        rep["conditioning_gain_nats"] = rep["uncond_val_ce_best"] - rep["cond_val_ce_best"]

        # the prior as a classifier of the held-out takes' grids (chance 1/C)
        is_val = np.isin(ids, val_take_ids)
        pred, _ = classify_grids(prior_model, grids[is_val], mask[is_val])
        truth = class_ids[is_val]
        rep["classifier_accuracy_val"] = float(np.mean(pred == truth))
        rep["classifier_confusion"] = {
            actions[c]: {actions[k]: int(np.sum(pred[truth == c] == k))
                         for k in range(C) if np.sum(pred[truth == c] == k)}
            for c in range(C)}
        # on the train grids: the upper bound, what the prior memorized
        pred_tr, _ = classify_grids(prior_model, grids[~is_val], mask[~is_val])
        rep["classifier_accuracy_train"] = float(np.mean(pred_tr == class_ids[~is_val]))

        # conditioned free-run: gen_per_class samples of every class in one call
        gen_cls = np.repeat(np.arange(C, dtype=np.int32), args.gen_per_class)
        motions, _, gen_grid = sample_motion(
            model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=len(gen_cls),
            n_positions=args.positions, temperature=args.temperature, seed=args.seed,
            class_ids=gen_cls, return_windows=True, return_grid=True)
        hm = class_histogram_match(gen_grid, gen_cls, grids[~is_val], class_ids[~is_val],
                                   cond_cfg.vocab_sizes, data_mask=mask[~is_val])
        hm["predicted"] = {actions[c]: actions[k] for c, k in hm["predicted"].items()}
        hm["margins"] = {actions[c]: round(v, 4) for c, v in hm["margins"].items()}
        rep["histogram_match"] = hm

        # each class's dynamics against its own takes
        vel = {}
        for c in range(C):
            own = [seqs[i] for i in range(n_takes) if labs[i] == actions[c]]
            sel = [m for m, g in zip(motions, gen_cls) if g == c]
            vel[actions[c]] = round(compare_to_data(sel, own)["vel_ratio"], 3)
        rep["vel_ratio_by_class"] = vel

        rep["arm_s"] = round(time.time() - t0, 1)
        results[arm] = rep
        results_path.write_text(json.dumps(results, indent=1))
        print(f"[ARM {arm}] cond val CE {rep['cond_val_ce_best']:.3f} vs "
              f"uncond {rep['uncond_val_ce_best']:.3f} "
              f"(gain {rep['conditioning_gain_nats']:.3f} nats) | "
              f"classifier val {rep['classifier_accuracy_val']:.2f} "
              f"train {rep['classifier_accuracy_train']:.2f} | "
              f"hist match {hm['accuracy']:.2f} ({hm['n_classes']} classes) "
              f"| {rep['arm_s']}s", flush=True)

    print(f"[INFO] conditioned results -> {results_path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
