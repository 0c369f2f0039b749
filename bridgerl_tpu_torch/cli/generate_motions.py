"""Sample novel G1 motion from a trained motion-token prior.

    python -m bridgerl_tpu_torch.cli.generate_motions \
        --ckpt checkpoints/Exp_transformer_W10_hybrid_teacher_seed_42_best.pth \
        --prior checkpoints/prior.ckpt --num 4 --positions 32 --out_dir motions/generated

The flags, defaults and file names of ``scripts/generate_motions.py``: the
prior (``cli.train_prior``) samples token grids, plain, prompted on a take
(``--prompt_take``), class-conditioned (``--action``) or overlap-guided
(``--guide``, ``--guide_dyn``), and the VQ-VAE's decoder turns them into
joint trajectories, one ``.npy`` a sample; ``--eval`` prints the statistics
of ``eval/generation.py`` against the training data. ``--device`` (default
``cuda``) picks the device; without a card the run stops unless ``--device
cpu`` asks for the CPU. ``--render`` replays each sample through the G1
scene on the device and writes a GIF beside its ``.npy`` (``sim/render.py``:
the line skeleton, the collision volumes with ``--volumetric``, the vendor
meshes with ``--mesh``, the volumes where none are found); it needs
matplotlib and imageio.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from . import have_packages
from ..utils.optional import RENDER_MODULES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="trained VQ-VAE checkpoint (.pth)")
    p.add_argument("--prior", required=True, help="token-prior checkpoint")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--out_dir", default="motions/generated")
    p.add_argument("--num", type=int, default=4, help="motions to sample")
    p.add_argument("--positions", type=int, default=32,
                   help="windows per motion (length = stride*(N-1)+W frames)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None,
                   help="nucleus sampling: keep the smallest token set with this mass")
    p.add_argument("--guide_dyn", type=float, default=0.0,
                   help="dynamics-preserving guide weight (needs --guide>=2)")
    p.add_argument("--guide", type=int, default=0,
                   help="overlap-consistency guided sampling: candidates per position "
                        "(0/1 = off, e.g. 8)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render", action="store_true", help="render each sample to a GIF")
    p.add_argument("--volumetric", action="store_true",
                   help="with --render: draw the collision-primitive body volumes")
    p.add_argument("--mesh", action="store_true",
                   help="with --render: draw the vendor STL meshes (--volumetric where none "
                        "are found)")
    p.add_argument("--fps", type=int, default=20, help="assumed motion fps")
    p.add_argument("--eval", action="store_true",
                   help="report motion statistics vs the training data")
    p.add_argument("--action", default=None,
                   help="action class for a conditioned prior; all samples use it")
    p.add_argument("--prompt_take", type=int, default=None,
                   help="prompted continuation: anchor each sample's first "
                        "--prompt_positions positions on this full_raw take's tokens")
    p.add_argument("--prompt_positions", type=int, default=8,
                   help="prompt length in positions (with --prompt_take)")
    p.add_argument("--ref_normalize", action="store_true",
                   help="treat decoder output as normalized, like the reference deployment")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.render and not have_packages("generate_motions", "--render", *RENDER_MODULES):
        return 2

    import numpy as np

    from ..export.motion_export import load_model_from_checkpoint, load_stats
    from ..train.prior import extract_code_grids, load_prior_checkpoint, sample_motion
    from .train_prior import load_sequences

    try:
        vq_model, exp = load_model_from_checkpoint(args.ckpt, device=args.device)
    except RuntimeError as e:
        print(f"generate_motions: {e}", file=sys.stderr)
        return 2
    prior, pcfg = load_prior_checkpoint(args.prior, device=args.device)
    if pcfg.source_experiment and pcfg.source_experiment != exp.id:
        print(f"[WARN] prior was trained on '{pcfg.source_experiment}', "
              f"decoding through '{exp.id}'")
    if args.ref_normalize:
        mean, std = load_stats(args.data_dir)
    else:
        mean, std = np.zeros(1, np.float32), np.ones(1, np.float32)

    class_ids = None
    if pcfg.class_names:
        if args.action is None:
            print(f"--action required; one of {pcfg.class_names}", file=sys.stderr)
            return 1
        if args.action not in pcfg.class_names:
            print(f"unknown action {args.action!r}; choose from {pcfg.class_names}",
                  file=sys.stderr)
            return 1
        class_ids = np.full(args.num, pcfg.class_names.index(args.action), np.int32)
    elif args.action is not None:
        print("--action given but the prior is unconditioned", file=sys.stderr)
        return 1

    prompt = None
    if args.prompt_take is not None:
        seqs = list(np.load(Path(args.data_dir) / "g1_train_full_raw.npy", allow_pickle=True))
        if not 0 <= args.prompt_take < len(seqs):
            print(f"--prompt_take {args.prompt_take} outside [0, {len(seqs)})", file=sys.stderr)
            return 1
        grids, gmask, _, _ = extract_code_grids(vq_model, exp, [seqs[args.prompt_take]], mean,
                                                std, pcfg.stride, max_len=pcfg.max_len)
        avail = int(gmask[0].sum())
        if args.prompt_positions >= args.positions:
            print("--prompt_positions must be < --positions", file=sys.stderr)
            return 1
        if avail < args.prompt_positions:
            print(f"take {args.prompt_take} has only {avail} positions "
                  f"(< {args.prompt_positions})", file=sys.stderr)
            return 1
        prompt = grids[0, :args.prompt_positions]
        print(f"[INFO] prompting on take {args.prompt_take}: "
              f"{args.prompt_positions}/{args.positions} positions anchored")

    motions, windows = sample_motion(
        vq_model, exp, prior, mean, std, n_samples=args.num, n_positions=args.positions,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, seed=args.seed,
        guide_candidates=args.guide, guide_dyn=args.guide_dyn, class_ids=class_ids,
        prompt=prompt, return_windows=True)

    if args.eval:
        from ..eval.generation import compare_to_data, format_report, overlap_disagreement

        ref = load_sequences(args.data_dir, warn=False)
        print(format_report(compare_to_data(motions, ref)))
        dis = np.mean([overlap_disagreement(w, pcfg.stride) for w in windows])
        print(f"  window overlap disagreement RMS {dis:.4f} (data windows: 0 by construction)")

    scene = None
    if args.render:
        from ..sim import G1ReplayScene
        from ..sim.render import render_scene

        scene = G1ReplayScene(device=args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, m in enumerate(motions):
        tag = f"_{args.action}" if args.action else ""
        if args.prompt_take is not None:
            tag += f"_p{args.prompt_take}x{args.prompt_positions}"
        path = out_dir / (f"gen_{exp.id}{tag}_N{args.positions}"
                          f"_T{args.temperature:g}_seed{args.seed}_idx{i}.npy")
        np.save(path, m)
        print(f"[INFO] sample {i}: {m.shape[0]} frames "
              f"({m.shape[0] / args.fps:.1f}s @ {args.fps}fps) -> {path}")
        if scene is not None:
            scene.load(m, args.fps, args.fps)
            gif = render_scene(scene, str(path.with_suffix(".gif")), min(args.fps, 25),
                               volumetric=args.volumetric, mesh=args.mesh)
            print(f"[INFO] rendered {gif}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
