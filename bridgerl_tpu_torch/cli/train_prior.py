"""Train an autoregressive prior over a trained VQ-VAE's motion tokens.

    python -m bridgerl_tpu_torch.cli.train_prior \
        --ckpt checkpoints/Exp_transformer_W10_hybrid_teacher_seed_42_best.pth \
        --data_dir data/processed --epochs 300 --out checkpoints/prior.ckpt

The flags, defaults and output names of ``scripts/train_prior.py``: the
full-raw robot sequences are tokenized through the checkpoint's robot
encoder and quantizer (``train/prior.py::extract_code_grids``), and a
causal transformer is trained on the code grids (``train_prior``). The VQ
checkpoint is the port's ``.pth``; the prior checkpoint is the port's torch
payload (``save_prior_checkpoint``), with its history beside it as
``<out>.history.json``. ``--device`` (default ``cuda``) picks the device;
without a card the run stops unless ``--device cpu`` asks for the CPU.
``--prng`` (JAX's generator, which the port does not have) stops the run
with a message that names ``ROADMAP.md`` unless it is left at its default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

DEFAULT_PRNG = "threefry2x32"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="trained VQ-VAE checkpoint (.pth)")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--out", default="checkpoints/prior.ckpt")
    p.add_argument("--stride", type=int, default=None,
                   help="window stride on the motion timeline (default W//2)")
    p.add_argument("--max_len", type=int, default=128,
                   help="max positions (windows) per sequence")
    p.add_argument("--phases", type=int, default=1,
                   help="tokenize each take at N evenly spaced start offsets in [0, stride)")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--n_layers", type=int, default=4)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--ff_dim", type=int, default=512)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--slot_ar", action="store_true",
                   help="within-position slot autoregression (depth transformer)")
    p.add_argument("--depth_layers", type=int, default=2,
                   help="depth-transformer layers (slot_ar only)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--energy_weight", type=float, default=0.0,
                   help="exponential tilt of the train CE toward lively windows; 0 = off")
    p.add_argument("--scheduled_sampling", type=float, default=0.0,
                   help="max prob of replacing context positions with the model's own "
                        "samples (linear ramp; 0 = pure teacher forcing)")
    p.add_argument("--select", default="val", choices=["val", "train"],
                   help="checkpoint-selection metric: grouped-val CE or train CE")
    p.add_argument("--prng", default=DEFAULT_PRNG,
                   choices=["threefry2x32", "rbg", "unsafe_rbg"])
    p.add_argument("--labeled_dir", default=None,
                   help="dir of {action}_{i}.npz files (joint_pos key) -> "
                        "class-conditioned prior")
    p.add_argument("--ref_normalize", action="store_true",
                   help="tokenize (x-mean)/std windows like the reference deployment "
                        "(models train on raw windows). Default: raw")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def load_sequences(data_dir: str, warn: bool = True):
    """The full-raw robot takes, or the sliced windows as short takes."""
    import numpy as np

    full_raw = Path(data_dir) / "g1_train_full_raw.npy"
    if full_raw.exists():
        return list(np.load(full_raw, allow_pickle=True))
    if warn:
        print("[WARN] no g1_train_full_raw.npy; falling back to sliced windows")
    return list(np.load(Path(data_dir) / "g1_train.npy"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.prng != DEFAULT_PRNG:
        print(f"--prng {args.prng} is not ported to bridgerl_tpu_torch: the port draws its "
              "samples from Philox (ROADMAP.md)", file=sys.stderr)
        return 2

    import numpy as np

    from ..export.motion_export import load_model_from_checkpoint, load_stats
    from ..train.prior import (
        PriorTrainConfig,
        energy_tilt_weights,
        extract_code_grids,
        save_prior_checkpoint,
        train_prior,
    )

    try:
        model, exp = load_model_from_checkpoint(args.ckpt, device=args.device)
    except RuntimeError as e:
        print(f"train_prior: {e}", file=sys.stderr)
        return 2
    W = exp.model.window_size
    stride = args.stride or max(1, W // 2)
    if args.ref_normalize:
        mean, std = load_stats(args.data_dir)
    else:
        mean, std = np.zeros(1, np.float32), np.ones(1, np.float32)

    labels = None
    if args.labeled_dir:
        files = sorted(Path(args.labeled_dir).glob("*.npz"))
        seqs, labels = [], []
        for f in files:
            seqs.append(np.load(f)["joint_pos"].reshape(-1, exp.model.robot_input_dim))
            labels.append(f.stem.rsplit("_", 1)[0])
        print(f"[INFO] {len(seqs)} labeled sequences, actions: {sorted(set(labels))}")
    else:
        seqs = load_sequences(args.data_dir)
    phases = sorted({round(i * stride / args.phases)
                     for i in range(args.phases)} & set(range(stride))) or [0]
    print(f"[INFO] tokenizing {len(seqs)} sequences (W={W}, stride={stride}, phases={phases})")
    grids, mask, pcfg, seq_ids, energy = extract_code_grids(
        model, exp, seqs, mean, std, stride, max_len=args.max_len, phases=phases,
        return_energy=True)
    class_ids = None
    if labels is not None:
        names = tuple(sorted(set(labels)))
        class_ids = np.asarray([names.index(labels[i]) for i in seq_ids], np.int32)
        pcfg = dataclasses.replace(pcfg, class_names=names)
    pcfg = dataclasses.replace(
        pcfg, d_model=args.d_model, n_layers=args.n_layers, n_heads=args.n_heads,
        ff_dim=args.ff_dim, dropout=args.dropout, slot_ar=args.slot_ar,
        depth_layers=args.depth_layers)
    n_tokens = int(mask.sum()) * len(pcfg.vocab_sizes)
    print(f"[INFO] {grids.shape[0]} grids, {int(mask.sum())} positions, {n_tokens} tokens, "
          f"{len(pcfg.vocab_sizes)} slots/position")

    tcfg = PriorTrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, patience=args.patience, seed=args.seed,
        select=args.select, scheduled_sampling=args.scheduled_sampling,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    pos_weights = None
    if args.energy_weight:
        pos_weights = energy_tilt_weights(energy, mask, args.energy_weight)
        print(f"[INFO] energy tilt lam={args.energy_weight}: weight range "
              f"[{pos_weights[mask > 0].min():.3f}, {pos_weights[mask > 0].max():.3f}]")
    prior, history = train_prior(grids, mask, pcfg, tcfg, class_ids=class_ids,
                                 seq_ids=seq_ids, pos_weights=pos_weights, device=args.device)
    save_prior_checkpoint(args.out, prior, pcfg, history=history)
    with open(str(Path(args.out).with_suffix(".history.json")), "w") as f:
        json.dump(history, f)
    print(f"[INFO] best val CE {min(history['val_loss']):.4f} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
