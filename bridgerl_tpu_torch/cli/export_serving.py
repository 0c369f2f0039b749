"""Freeze a trained checkpoint into a serving artifact, and optionally check it.

    python -m bridgerl_tpu_torch.cli.export_serving \
        --ckpt checkpoints/Exp_transformer_W10_hybrid_teacher_seed_42_best.pth \
        --out serving/flagship.zip --check

The flags and defaults of ``scripts/export_serving.py``; the artifact holds
``torch.export`` programs (``export/serialize.py``) for each platform of
``--platforms`` (default ``cpu,cuda``; ``cuda`` needs a card). ``--check``
loads the artifact back on ``--device`` (default ``cuda``; nothing falls
back to the CPU) and runs ``retarget`` on a 2-window batch. ``--prior`` (the
generator artifact) stops the run with a message that names ``ROADMAP.md``;
the generator flags are accepted for the same command lines.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out", type=str, required=True, help="output .zip path")
    p.add_argument("--data_dir", type=str, default="./data/processed",
                   help="normalization stats source (mean/std npy)")
    p.add_argument("--platforms", type=str, default="cpu,cuda",
                   help="comma-separated platforms to export programs for")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and run a 2-window smoke batch")
    p.add_argument("--prior", type=str, default=None,
                   help="token-prior checkpoint for a generator artifact (not ported)")
    p.add_argument("--positions", type=int, default=32, help="generator: windows per motion")
    p.add_argument("--num", type=int, default=4, help="generator: motions per call")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--guide_dyn", type=float, default=0.0)
    p.add_argument("--guide", type=int, default=0)
    p.add_argument("--ref_normalize", action="store_true",
                   help="bake (x-mean)/std normalization into the programs, as the reference "
                        "deployment does; models train on raw windows. Default: raw in, raw out")
    p.add_argument("--device", type=str, default="cuda",
                   help="where --check loads the artifact: cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.prior:
        print("--prior (the generator artifact) is not ported to bridgerl_tpu_torch yet "
              "(ROADMAP.md)", file=sys.stderr)
        return 2

    import numpy as np

    from ..export.serialize import export_serving_artifact, load_serving_artifact

    platforms = tuple(s.strip() for s in args.platforms.split(",") if s.strip())
    meta = export_serving_artifact(args.ckpt, args.out, data_dir=args.data_dir,
                                   platforms=platforms, ref_normalize=args.ref_normalize)
    for name, sig in meta["functions"].items():
        print(f"  {name}: {sig['input']} -> {sig['output']}")
    print(f"wrote {args.out} (platforms={meta['platforms']})")
    if args.check:
        mod = load_serving_artifact(args.out, device=args.device)
        W = mod.window_size
        h_dim = mod.meta["functions"]["retarget"]["input"][2]
        out = mod.retarget(np.zeros((2, W, h_dim), np.float32)).cpu().numpy()
        if not np.all(np.isfinite(out)):
            print("check failed: non-finite serving output", file=sys.stderr)
            return 1
        print(f"check ok: retarget (2, {W}, {h_dim}) -> {tuple(out.shape)} on {mod.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
