"""Export ground-truth and reconstructed motions from a checkpoint.

    python -m bridgerl_tpu_torch.cli.export_motion \
        --ckpt checkpoints/Exp_resnet_no_down_W10_hybrid_teacher_seed_42_best.pth --num_samples 2

The flags and defaults of ``scripts/export_motion.py`` (the reference's
``scripts/deployment/export_motion.py``), over the port's ``.pth``: arch,
method and window come from the config inside the checkpoint, and the files
carry the reference's names (``export/motion_export.py``). ``--device``
(default ``cuda``) picks the device; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="./data/processed")
    p.add_argument("--output_dir", type=str, default="./motions")
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--step_size", type=int, default=None,
                   help="Sliding-window stride; default window // 2")
    p.add_argument("--max_len", type=int, default=-1)
    p.add_argument("--ref_normalize", action="store_true",
                   help="normalize windows at inference as the reference deployment does; "
                        "models train on raw windows. Default: raw")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ..export.motion_export import export_motions

    export_motions(args.ckpt, data_dir=args.data_dir, output_dir=args.output_dir,
                   start_idx=args.start_idx, num_samples=args.num_samples,
                   step_size=args.step_size, max_len=args.max_len,
                   ref_normalize=args.ref_normalize, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
