"""Export a port checkpoint as a reference-format PyTorch checkpoint.

    python -m bridgerl_tpu_torch.cli.export_torch_ckpt \
        --ckpt checkpoints/Exp_transformer_W10_hybrid_teacher_seed_42_best.pth \
        --out exported_for_torch.pth

The reverse of ``import_torch_ckpt``, with the flags of
``scripts/export_torch_ckpt.py`` and the payload it writes: ``epoch``, the
learned tensors under ``model_state_dict``, an empty
``optimizer_state_dict``, ``best_loss`` and the reference's plain ``config``
dict with ``id`` and ``name``. The reference's own torch consumers
(export_motion.py, analyze_latent_space.py) load it with ``strict=False`` and
rebuild the constant buffers at init. Only ``tf_tokens`` 1 exports: the
reference model always pools a window to one token. Runs on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="the port's .pth checkpoint")
    p.add_argument("--out", required=True, help="output .pth path")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from ..export.torch_import import export_reference_state_dict
    from ..train.checkpoint import load_checkpoint, reference_config

    ck = load_checkpoint(args.ckpt)
    exp = ck["config"]
    if exp is None:
        print(f"export_torch_ckpt: {args.ckpt} carries no config; cannot export",
              file=sys.stderr)
        return 1
    try:
        sd = export_reference_state_dict(ck["model_state_dict"], exp)
    except ValueError as e:
        print(f"export_torch_ckpt: {e}", file=sys.stderr)
        return 1
    m = exp.model
    payload = {
        "epoch": ck["epoch"], "model_state_dict": sd, "optimizer_state_dict": {},
        "best_loss": ck["best_loss"],
        # the dict the reference's train driver embeds (train_ablation.py:276-284, 399-418)
        "config": {**reference_config(exp), "id": exp.id, "name": exp.name},
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(payload, args.out)
    print(f"wrote {args.out} ({len(sd)} tensors, {m.arch}+{m.method} W{m.window_size})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
