"""Convert a reference PyTorch checkpoint into the port's ``.pth``.

    python -m bridgerl_tpu_torch.cli.import_torch_ckpt --pth ref_best.pth \
        --out checkpoints/imported_best.pth --check
    python -m bridgerl_tpu_torch.cli.export_serving --ckpt checkpoints/imported_best.pth ...

The migration path for users of the reference repository, with the flags of
``scripts/import_torch_ckpt.py``: any trained ``{run}_last/best/final.pth``
(a wrapper with a plain ``config`` dict, DataParallel's ``module.`` keys, or
a bare ``_final.pth`` state dict) becomes a checkpoint that every surface of
the port takes unchanged (``export_serving``, ``export_motion``,
``serve_http``, ``play_g1_npy``, ``analyze_latent_space``, ``train_ablation
--teacher_ckpt``): the same tensors, the ``ExperimentConfig`` JSON and the
reference's ``config`` dict, ``epoch`` and ``best_loss``. ``--window`` is
needed only where the file embeds no config (a bare ``_final.pth``).
``--check`` runs one forward of the imported model on ``--device`` (default
``cuda``; without a card the run stops unless ``--device cpu`` asks for the
CPU).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from . import cli_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pth", required=True, help="reference torch checkpoint")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--window", type=int, default=None,
                   help="window size (required for bare state_dicts)")
    p.add_argument("--check", action="store_true",
                   help="run one forward through the imported model")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device("import_torch_ckpt", args.device)
    if device is None:
        return 1
    import torch

    from ..export.torch_import import import_torch_checkpoint, load_pth
    from ..train.checkpoint import save_checkpoint

    try:
        exp, model, meta = import_torch_checkpoint(load_pth(args.pth), window=args.window,
                                                   device=device)
    except ValueError as e:
        print(f"import_torch_ckpt: {e}", file=sys.stderr)
        return 1
    m = exp.model
    print(f"imported {m.arch}+{m.method} W{m.window_size} (hidden {m.hidden_dim}, human "
          f"{m.human_input_dim} -> robot {m.robot_input_dim}) @ epoch {meta['epoch']}")
    if args.check:
        W = m.window_size
        with torch.inference_mode():
            out = model(torch.zeros(2, W, m.robot_input_dim, device=device),
                        torch.zeros(2, W, m.human_input_dim, device=device))
        recon, ret = out["robot"]["recon"], out["human"]["retargeted"]
        if not (torch.isfinite(recon).all() and torch.isfinite(ret).all()):
            print("check failed: non-finite model output", file=sys.stderr)
            return 1
        print(f"check ok: recon {tuple(recon.shape)}, retargeted {tuple(ret.shape)} "
              f"on {device}")
    save_checkpoint(args.out, epoch=meta["epoch"], model=model, best_loss=meta["best_loss"],
                    config=exp)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
