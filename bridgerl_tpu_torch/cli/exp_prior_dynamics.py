"""Training-side free-run dynamics A/B: energy-tilted prior CE.

    python -m bridgerl_tpu_torch.cli.exp_prior_dynamics \
        --ckpt checkpoints/Exp_transformer_W64_K4_hybrid_teacher_seed_42_best.pth \
        --takes 1280 --lams 0.0,0.75 --seeds 42,43

The flags, defaults, arm keys, file names and JSON keys of
``scripts/exp_prior_dynamics.py``: the exponential energy tilt
(``train/prior.py::energy_tilt_weights``: fit the prior to
p(x)·e^{lam·window_speed}/Z instead of the raw token distribution) at a
fixed corpus, over trainer seeds. Each arm ``lam{L}_seed{S}`` trains at
``--takes`` takes with CE weights tilted by L and is scored under the same
fixed sampling policies: free-run unguided at T 1.0, free-run guided
(``--guide`` candidates, ``--guide_dyn``), and held-out prompted
continuation at P = ``--prompt_len`` (the tilt must not wreck the
continuation's truth MSE). Results accumulate in
``<out_dir>/dynamics.json``; an arm already there is skipped.

``--ckpt`` is a port checkpoint; samples are the port's Philox-Gumbel draws
from each arm's seed. ``--device`` (default ``cuda``) picks the device;
without a card the run stops unless ``--device cpu`` asks for the CPU.
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
    energy_tilt_weights,
    extract_code_grids,
    load_prior_checkpoint,
    sample_motion,
    save_prior_checkpoint,
    stitch_windows,
    train_prior,
)

PROG = "exp_prior_dynamics"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="VQ-VAE teacher checkpoint (.pth)")
    p.add_argument("--data_dir", default="data/dense_w64")
    p.add_argument("--out_dir", default="abruns/prior_dynamics")
    p.add_argument("--takes", type=int, default=1280)
    p.add_argument("--lams", default="0.0,0.75",
                   help="comma list of energy-tilt lambdas (0.0 = baseline)")
    p.add_argument("--seeds", default="42,43", help="comma list of trainer seeds")
    p.add_argument("--extra_seed", type=int, default=9000,
                   help="rng seed for fresh takes (exp_prior_scaling's pool recipe)")
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
    p.add_argument("--guide", type=int, default=8)
    p.add_argument("--guide_dyn", type=float, default=0.2)
    p.add_argument("--select", default="val", choices=["train", "val"])
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
    extra = synth_robot_takes(max(0, args.takes - len(pinned)), args.min_len,
                              args.max_len_frames, args.extra_seed)
    seqs = (pinned + extra)[:args.takes]
    print(f"[INFO] corpus: {len(seqs)} takes, W={W}", flush=True)

    grids, mask, pcfg, ids, energy = extract_code_grids(
        model, exp, seqs, RAW_MEAN, RAW_STD, args.stride, max_len=args.max_len,
        phases=phase_offsets(args.stride, args.n_phases), return_energy=True)
    pcfg = dataclasses.replace(pcfg, slot_ar=True)
    print(f"[INFO] {grids.shape[0]} grids, {int(mask.sum())} positions", flush=True)

    results_path = out / "dynamics.json"
    results = json.loads(results_path.read_text()) if results_path.exists() else {}

    lams = [float(x) for x in args.lams.split(",")]
    for seed in [int(x) for x in args.seeds.split(",")]:
        # the take-grouped split depends on the seed: the yardsticks are
        # rebuilt per seed (train_prior's generator and draw)
        val_takes = grouped_val_takes(ids, seed)
        is_val = np.asarray([int(s) in val_takes for s in ids])
        train_bank = window_bank(seqs, W, args.stride,
                                 [si for si in range(len(seqs)) if si not in val_takes])
        sel, n_pos = held_out_rows(is_val, mask, args.positions, args.n_samples)
        true_wins = decode_grid_rows(model, exp, pcfg, grids[sel, :n_pos])

        for lam in lams:
            arm = f"lam{lam:g}_seed{seed}"
            if arm in results:
                print(f"[SKIP] {arm} already done", flush=True)
                continue
            t0 = time.time()
            weights = energy_tilt_weights(energy, mask, lam) if lam else None
            tcfg = PriorTrainConfig(epochs=args.epochs, patience=args.patience,
                                    batch_size=args.batch_size, seed=seed, select=args.select)
            prior, history = train_prior(grids, mask, pcfg, tcfg, seq_ids=ids, verbose=True,
                                         pos_weights=weights, device=device)
            ck = out / f"prior_{arm}.ckpt"
            save_prior_checkpoint(str(ck), prior, pcfg, history=history)
            prior_model, _ = load_prior_checkpoint(str(ck), device=device)

            rep = {
                "lam": lam, "seed": seed,
                "n_grids": int(grids.shape[0]),
                "best_train_ce": float(min(history["train_loss"])),
                "val_ce_epoch0": float(history["val_loss"][0]),
                "val_ce_best": float(min(history["val_loss"])),
                "val_ce_best_epoch": int(np.argmin(history["val_loss"])),
                "epochs_run": len(history["val_loss"]),
            }

            # the same two free-run policies for every arm
            for key, kw in [("free_unguided", {}),
                            ("free_guided", dict(guide_candidates=args.guide,
                                                 guide_dyn=args.guide_dyn))]:
                ts = time.time()
                motions, wins, grid = sample_motion(
                    model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=args.n_samples,
                    n_positions=n_pos, temperature=1.0, seed=seed, return_windows=True,
                    return_grid=True, **kw)
                free = compare_to_data(motions, seqs)
                free["overlap_disagreement"] = float(np.mean(
                    [overlap_disagreement(w, args.stride) for w in wins]))
                free.update(code_novelty(grid, grids, mask))
                free.update(nearest_data_distance(wins, train_bank))
                free["frames"] = int(sum(m.shape[0] for m in motions))
                free["sample_s"] = round(time.time() - ts, 1)
                rep[key] = free

            # the held-out continuation guard (prompted, unguided)
            P = args.prompt_len
            _, wins_p, grid_p = sample_motion(
                model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=len(sel),
                n_positions=n_pos, temperature=1.0, seed=seed, prompt=grids[sel, :P],
                return_windows=True, return_grid=True)
            cont = wins_p[:, P:]
            pr = compare_to_data([stitch_windows(w, args.stride) for w in cont], seqs)
            pr.update(code_novelty(grid_p[:, P:], grids, mask))
            pr.update(continuation_curves(cont, true_wins[:, P:], train_bank))
            rep[f"prompted_val_P{P}"] = pr

            rep["arm_s"] = round(time.time() - t0, 1)
            results[arm] = rep
            results_path.write_text(json.dumps(results, indent=1))
            fg, fu = rep["free_guided"], rep["free_unguided"]
            print(f"[ARM {arm}] val CE {rep['val_ce_best']:.3f} | "
                  f"guided vel {fg['vel_ratio']:.3f} overlap {fg['overlap_disagreement']:.3f} | "
                  f"unguided vel {fu['vel_ratio']:.3f} "
                  f"overlap {fu['overlap_disagreement']:.3f} | truth@off "
                  f"{['%.3f' % v for v in pr['truth_mse_by_offset'][:4]]} | {rep['arm_s']}s",
                  flush=True)

    print(f"[INFO] dynamics results -> {results_path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
