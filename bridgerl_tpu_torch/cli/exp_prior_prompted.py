"""Prompted-continuation evaluation over trained motion-token priors.

    python -m bridgerl_tpu_torch.cli.exp_prior_prompted \
        --ckpt checkpoints/Exp_transformer_W64_K4_hybrid_teacher_seed_42_best.pth \
        --priors abruns/prior_ar/prior_ar_ph4.ckpt,abruns/prior_ar/prior_fact.ckpt

The flags, defaults, row keys and output file of
``scripts/exp_prior_prompted.py``. For each prior and each prompt length P
it anchors ``--n_samples`` rollouts on prefixes of held-out takes (the
take-grouped validation split of the prior's own training run, reproduced
from ``--split_seed``; ``--prompt_split train`` is the memorization
control) and scores the continuation (positions >= P) only: its statistics
against the data, the overlap disagreement across the prompt->generated
seam and inside the continuation, the nearest data window overall and at
probe offsets (the error-compounding curve), the divergence from the
take's true continuation decoded through the same tokenizer, and code
novelty. P = 0 rows are the free-running baseline under the same protocol.
A file that exists at ``--out`` is merged into, the new rows winning.

``--priors`` are the port's prior payloads; samples are the port's
Philox-Gumbel draws from ``--seed``. ``--device`` (default ``cuda``) picks
the device; without a card the run stops unless ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import cli_device
from ..eval.generation import (
    code_novelty,
    compare_to_data,
    nearest_data_distance,
    overlap_disagreement,
)
from ..eval.studies import (
    RAW_MEAN,
    RAW_STD,
    decode_grid_rows,
    grouped_val_takes,
    load_priors,
    load_takes,
    load_teacher,
    window_bank,
)
from ..train.prior import extract_code_grids, sample_motion, stitch_windows

PROG = "exp_prior_prompted"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="VQ-VAE teacher checkpoint (.pth)")
    p.add_argument("--priors", required=True, help="comma list of prior checkpoints")
    p.add_argument("--data_dir", default="data/dense_w64")
    p.add_argument("--out", default="abruns/prior_ar/prompted.json")
    p.add_argument("--prompt_positions", default="0,4,8,16",
                   help="comma list; 0 = free-running baseline")
    p.add_argument("--positions", type=int, default=64)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--guide_dyn", type=float, default=0.0,
                   help="dynamics-preserving guide weight (needs --guide>=2)")
    p.add_argument("--guide", type=int, default=0,
                   help="overlap-consistency guided sampling candidates "
                        "(0 = off; key rows get a |gN suffix)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--split_seed", type=int, default=42,
                   help="PriorTrainConfig.seed of the priors' training run "
                        "(reproduces the take-grouped val split for prompts)")
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--prompt_split", default="val", choices=["val", "train"],
                   help="which takes provide prompts: 'val' (held-out) tests "
                        "generalization; 'train' is the memorization control")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(PROG, args.device)
    if device is None:
        return 2
    loaded = load_teacher(PROG, args.ckpt, device)
    priors = loaded and load_priors(PROG, args.priors.split(","), device)
    if not priors:
        return 2
    model, exp = loaded
    seqs = load_takes(args.data_dir)
    W = exp.model.window_size
    prompt_lens = [int(x) for x in args.prompt_positions.split(",")]

    results = {}
    cache = {}
    for name, prior_model, pcfg in priors:
        stride, max_len = pcfg.stride, pcfg.max_len
        if (stride, max_len) not in cache:
            grids, mask, _, ids = extract_code_grids(model, exp, seqs, RAW_MEAN, RAW_STD, stride,
                                                     max_len=max_len)
            cache[stride, max_len] = (grids, mask, ids, window_bank(seqs, W, stride))
        grids, mask, ids, data_wins = cache[stride, max_len]

        # the priors' take-grouped validation split -> held-out prompts
        val_takes = grouped_val_takes(ids, args.split_seed, args.val_fraction)
        in_split = ((lambda s: s in val_takes) if args.prompt_split == "val"
                    else (lambda s: s not in val_takes))
        eligible = [i for i in range(grids.shape[0])
                    if in_split(int(ids[i])) and int(mask[i].sum()) >= args.positions]
        if len(eligible) < args.n_samples:   # any long-enough row
            eligible = [i for i in range(grids.shape[0]) if int(mask[i].sum()) >= args.positions]
        sel = np.asarray(eligible)[np.linspace(0, len(eligible) - 1,
                                               args.n_samples).astype(int)]
        print(f"[{name}] stride={stride} val_takes={sorted(val_takes)} "
              f"prompt rows={sel.tolist()}", flush=True)
        true_wins = decode_grid_rows(model, exp, pcfg, grids[sel, :args.positions])

        for P in prompt_lens:
            t0 = time.time()
            prompt = grids[sel, :P] if P > 0 else None
            motions, wins, grid = sample_motion(
                model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=args.n_samples,
                n_positions=args.positions, temperature=args.temperature, seed=args.seed,
                prompt=prompt, guide_candidates=args.guide, guide_dyn=args.guide_dyn,
                return_windows=True, return_grid=True)
            cont = wins[:, P:]                      # continuation windows
            rep = compare_to_data([stitch_windows(w, stride) for w in cont], seqs)
            rep["overlap_disagreement_seam"] = float(np.mean(
                [overlap_disagreement(w[max(P - 1, 0):], stride) for w in wins]))
            rep["overlap_disagreement_cont"] = float(np.mean(
                [overlap_disagreement(w, stride) for w in cont]))
            rep.update(code_novelty(grid[:, P:], grids, mask))
            rep.update(nearest_data_distance(cont, data_wins))
            # the error-compounding curve: nn_mse and truth divergence by offset
            n_off = args.positions - P
            probe = sorted({0, 1, 2, 3, 7, 15, 31, n_off - 1} & set(range(n_off)))
            rep["offsets"] = probe
            rep["nn_mse_by_offset"] = [
                nearest_data_distance(cont[:, j], data_wins)["nn_mse_mean"] for j in probe]
            rep["truth_mse_by_offset"] = [
                float(np.mean((cont[:, j] - true_wins[:, P + j]) ** 2)) for j in probe]
            rep["sample_s"] = round(time.time() - t0, 1)
            row = (f"{name}|P{P}" + (f"|g{args.guide}" if args.guide else "")
                   + (f"|d{args.guide_dyn:g}" if args.guide_dyn else ""))
            results[row] = rep
            print(f"[{row}] vel {rep['vel_ratio']:.3f} | cov {rep['range_coverage_mean']:.2f} | "
                  f"seam {rep['overlap_disagreement_seam']:.4f} "
                  f"cont {rep['overlap_disagreement_cont']:.4f} | "
                  f"nn_mse {rep['nn_mse_mean']:.4f} | "
                  f"nn@off {['%.3f' % v for v in rep['nn_mse_by_offset']]} | "
                  f"truth@off {['%.3f' % v for v in rep['truth_mse_by_offset']]}", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():   # merge: guided and unguided passes share one file
        results = {**json.loads(out.read_text()), **results}
    out.write_text(json.dumps(results, indent=1))
    print(f"[INFO] prompted eval -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
