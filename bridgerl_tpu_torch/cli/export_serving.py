"""Freeze a trained checkpoint into a serving artifact, and optionally check it.

    python -m bridgerl_tpu_torch.cli.export_serving \
        --ckpt checkpoints/Exp_transformer_W10_hybrid_teacher_seed_42_best.pth \
        --out serving/flagship.zip --check

The flags and defaults of ``scripts/export_serving.py``; the artifact holds
``torch.export`` programs (``export/serialize.py``) for each platform of
``--platforms`` (default ``cpu,cuda``; ``cuda`` needs a card). ``--check``
loads the artifact back on ``--device`` (default ``cuda``; nothing falls
back to the CPU) and runs ``retarget`` on a 2-window batch. ``--prior`` exports
a generator artifact instead (a seed in, ``--num`` motions of ``--positions``
windows out; ``--guide`` / ``--guide_dyn`` / ``--temperature`` / ``--top_k``
fix its sampling), and ``--check`` then generates from seed 0.

    python -m bridgerl_tpu_torch.cli.export_serving --ckpt CKPT.pth \
        --prior checkpoints/prior.ckpt --out serving/generator.zip --check
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
                   help="token-prior checkpoint: export a generator artifact (seed -> "
                        "novel motion) instead of the retargeter")
    p.add_argument("--positions", type=int, default=32, help="generator: windows per motion")
    p.add_argument("--num", type=int, default=4, help="generator: motions per call")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--guide_dyn", type=float, default=0.0,
                   help="generator: dynamics-preserving guide weight")
    p.add_argument("--guide", type=int, default=0,
                   help="generator: overlap-consistency guided sampling candidates per "
                        "position (0/1 = off)")
    p.add_argument("--ref_normalize", action="store_true",
                   help="bake (x-mean)/std normalization into the programs, as the reference "
                        "deployment does; models train on raw windows. Default: raw in, raw out")
    p.add_argument("--device", type=str, default="cuda",
                   help="where --check loads the artifact: cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from ..export.serialize import (
        export_generator_artifact,
        export_serving_artifact,
        load_serving_artifact,
    )

    platforms = tuple(s.strip() for s in args.platforms.split(",") if s.strip())
    if args.prior:
        try:
            meta = export_generator_artifact(
                args.ckpt, args.prior, args.out, data_dir=args.data_dir,
                n_positions=args.positions, n_samples=args.num, temperature=args.temperature,
                top_k=args.top_k, guide_candidates=args.guide, guide_dyn=args.guide_dyn,
                platforms=platforms, ref_normalize=args.ref_normalize)
        except ValueError as e:
            print(f"export_serving: {e}", file=sys.stderr)
            return 1
    else:
        meta = export_serving_artifact(args.ckpt, args.out, data_dir=args.data_dir,
                                       platforms=platforms, ref_normalize=args.ref_normalize)
    for name, sig in meta["functions"].items():
        print(f"  {name}: {sig['input']} -> {sig['output']}")
    print(f"wrote {args.out} (platforms={meta['platforms']}, export seconds "
          f"{meta['export_seconds']})")
    if args.check and args.prior:
        mod = load_serving_artifact(args.out, device=args.device)
        name = sorted(mod.fns)[0]
        action = name[len("generate_"):] if name != "generate" else None
        out = mod.generate(0, action=action).cpu().numpy()
        if not np.all(np.isfinite(out)):
            print("check failed: non-finite generator output", file=sys.stderr)
            return 1
        print(f"check ok: {name}(seed=0) -> {tuple(out.shape)} on {mod.device}")
    elif args.check:
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
