"""Train one ablation experiment, teacher or student, on the card.

    python -m bridgerl_tpu_torch.cli.train_ablation --arch resnet_no_down --method hybrid \
        --window 10 --epochs 3
    python -m bridgerl_tpu_torch.cli.train_ablation --arch resnet_no_down --method hybrid \
        --window 10 --mode student --epochs 2 \
        --teacher_ckpt checkpoints/Exp_resnet_no_down_W10_hybrid_teacher_seed_42_best.pth

The flags, defaults and artifact names of ``scripts/train_ablation.py``;
checkpoints are the reference's ``.pth`` files where the JAX CLI writes
``.ckpt``, and ``--teacher_ckpt`` takes the port's ``.pth``. Several seeds
train one after another, or with ``--multiseed`` all at once as one stacked
model (``train/multiseed.py``), as ``scripts/train_ablation.py`` does.
``--lambda_fk`` adds the world-space FK loss to the teacher loss, and
``--int8_ff`` runs the transformer blocks' feed-forward products in int8
(straight-through backward). ``--device`` (default ``cuda``) picks the device:
without a card the run stops unless ``--device cpu`` asks for the CPU.
``--profile DIR`` writes a ``torch.profiler`` trace of the run to
``DIR/trace.json``. ``--fused_attention`` is accepted: the port's attention
always follows the fused kernel. ``--prng`` (JAX's generator, which the
port does not have) stops the run with a message that names ``ROADMAP.md``.

``--data_parallel`` does nothing on one card, as the JAX CLI's ``mesh=None``.
With N > 1 cards visible it runs one process a card (``parallel.launch``,
NCCL) and scales the batch by N, as the JAX CLI scales it: each optimizer
batch is split over the cards, and the run computes what one process
computes at the scaled batch (``train/trainer.py``). With ``--multiseed``
the seeds are split over the cards instead, where N divides their number
(``train/multiseed.py``). A rank that fails ends the run with exit code 1,
naming the rank. Where ``RANK`` and ``WORLD_SIZE`` are set (a launcher such
as ``torchrun`` started this process), the process joins that rendezvous as
its rank instead (NCCL on ``--device cuda``, gloo on ``cpu``).

    python -m bridgerl_tpu_torch.cli.train_ablation --arch transformer --method hybrid \
        --data_parallel            # 4 cards: batch 1024, one process a card

Several seeds as one stacked program, with the FK loss and int8 FF:

    python -m bridgerl_tpu_torch.cli.train_ablation --arch transformer --method hybrid \
        --multiseed --seed 1 2 3 --lambda_fk 1 --int8_ff

The W64-transformer recipe: pretrain ``ae``, then train ``hybrid`` from it:

    python -m bridgerl_tpu_torch.cli.train_ablation --arch transformer --method ae
    python -m bridgerl_tpu_torch.cli.train_ablation --arch transformer --method hybrid \
        --init_from checkpoints/Exp_transformer_W64_ae_teacher_seed_42_best.pth \
        --codebook_data_init --cheap_dropout --reuse_dropout_mask --accum_chunks 4
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional, Sequence

DEFAULT_PRNG = "threefry2x32"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", type=str, default="hybrid")
    p.add_argument("--arch", type=str, default="transformer")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--seed", type=int, nargs="+", default=[42])
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--patience", type=int, default=-1)
    p.add_argument("--mode", type=str, default="teacher", choices=["teacher", "student"])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--teacher_ckpt", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="data/processed")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--tf_tokens", type=int, default=1,
                   help="Transformer latent tokens per window; must divide --window")
    p.add_argument("--multiseed", action="store_true",
                   help="Train all seeds at once, stacked into one model")
    p.add_argument("--data_parallel", "--force_multi_gpu", action="store_true",
                   dest="data_parallel",
                   help="One process a visible card (NCCL), batch scaled by their number; "
                        "a no-op on one card")
    p.add_argument("--lambda_fk", type=float, default=0.0,
                   help="World-space FK loss weight (teacher stage)")
    p.add_argument("--profile", type=str, default=None,
                   help="Write a torch.profiler trace of the run to DIR/trace.json")
    p.add_argument("--accum_chunks", type=int, default=1,
                   help="Microbatches per optimizer batch (summed gradients, one step)")
    p.add_argument("--attn_packing", type=int, default=1,
                   help="Pack P windows per attention call under a block-diagonal mask")
    p.add_argument("--fused_attention", action="store_true",
                   help="Accepted; the port's attention always follows the fused kernel")
    p.add_argument("--prng", type=str, default=DEFAULT_PRNG,
                   choices=["threefry2x32", "rbg", "unsafe_rbg"],
                   help="JAX's PRNG (the port draws from Philox and torch generators)")
    p.add_argument("--ref_exact", action="store_true",
                   help="Reference semantics: channel-axis velocity, torch inits, cold EMA")
    p.add_argument("--torch_init", action=argparse.BooleanOptionalAction, default=None,
                   help="torch kaiming/xavier-uniform kernel inits; --no-torch_init: "
                        "lecun-normal")
    p.add_argument("--cold_ema", action="store_true",
                   help="The reference's cold EMA-state init only")
    p.add_argument("--ref_exact_vel", action=argparse.BooleanOptionalAction, default=None,
                   help="Channel-axis velocity difference (the default); "
                        "--no-ref_exact_vel: time axis")
    p.add_argument("--log_dir", type=str, default="results")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (float32 weights and codebook math)")
    p.add_argument("--fsq_bounded", action=argparse.BooleanOptionalAction, default=None,
                   help="tanh-bounded FSQ (the default); --no-fsq_bounded: unbounded round")
    p.add_argument("--save_every", type=int, default=1,
                   help="Epochs between `_last` checkpoint writes")
    p.add_argument("--cheap_dropout", action="store_true",
                   help="8-bit dropout masks in the transformer blocks (K1 keeps its own)")
    p.add_argument("--int8_ff", action="store_true",
                   help="int8 forward for the transformer FF products (straight-through "
                        "backward)")
    p.add_argument("--reuse_dropout_mask", action="store_true",
                   help="One dropout draw for all microbatches of an optimizer step")
    p.add_argument("--lfq_norm", action=argparse.BooleanOptionalAction, default=None,
                   help="LFQ pre-sign LayerNorm (the default); --no-lfq_norm: reference")
    p.add_argument("--entropy_weight", type=float, default=0.1,
                   help="LFQ entropy regularization weight")
    p.add_argument("--init_from", type=str, default=None,
                   help="Teacher init from a .pth's matching weights (path or {seed} pattern)")
    p.add_argument("--vq_norm", action=argparse.BooleanOptionalAction, default=None,
                   help="Parameter-free LayerNorm before the quantizer")
    p.add_argument("--codebook_data_init", action=argparse.BooleanOptionalAction,
                   default=None, help="Seed first-stage EMA codebooks from encoder outputs")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu; nothing falls back to the CPU")
    return p


def unported(args) -> Optional[str]:
    """The first flag the port cannot run yet, or None."""
    if args.prng != DEFAULT_PRNG:
        return f"--prng {args.prng}"
    return None


def make_exp(args, robot_dim: int, human_dim: int):
    """The ExperimentConfig the flags ask for, assembled as the JAX CLI does."""
    from .. import parallel
    from ..config import make_experiment, ref_exact

    opt = {k: v for k, v in (("fsq_bounded", args.fsq_bounded), ("lfq_norm", args.lfq_norm),
                             ("codebook_data_init", args.codebook_data_init),
                             ("vq_norm", args.vq_norm)) if v is not None}
    exp = make_experiment(
        args.arch, args.method, window=args.window, mode=args.mode, seeds=tuple(args.seed),
        epochs=args.epochs, batch_size=args.batch_size, patience=args.patience,
        resume=args.resume, teacher_ckpt=args.teacher_ckpt, init_from=args.init_from,
        save_every=args.save_every,
        learning_rate=args.lr, hidden_dim=args.hidden_dim, lambda_fk=args.lambda_fk,
        tf_tokens=args.tf_tokens, int8_ff=args.int8_ff,
        attn_packing=args.attn_packing, accum_chunks=args.accum_chunks,
        fused_attention=args.fused_attention, cheap_dropout=args.cheap_dropout,
        reuse_dropout_mask=args.reuse_dropout_mask, entropy_loss_weight=args.entropy_weight,
        human_input_dim=human_dim, robot_input_dim=robot_dim,
        compute_dtype="bfloat16" if args.bf16 else "float32", **opt)
    exp = dataclasses.replace(exp, log_dir=args.log_dir, checkpoint_dir=args.checkpoint_dir)
    if args.ref_exact:
        if parallel.is_main():
            print("!!! ref-exact mode: channel-axis velocity diff, torch inits, cold EMA init !!!")
        return ref_exact(exp)
    model_over, train_over = {}, {}
    if args.torch_init is not None and args.torch_init != exp.model.torch_init:
        model_over["torch_init"] = args.torch_init
    if args.cold_ema:
        model_over["ema_warm_start"] = False
    if args.ref_exact_vel is not None and args.ref_exact_vel != exp.train.ref_exact_vel:
        train_over["ref_exact_vel"] = args.ref_exact_vel
    if model_over or train_over:
        if parallel.is_main():
            print(f"!!! single-flag arm(s): {sorted({**model_over, **train_over})} !!!")
        exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, **model_over),
                                  train=dataclasses.replace(exp.train, **train_over))
    return exp


def _run(exp, ds, device, profile_dir: Optional[str], multiseed: bool) -> None:
    from ..train.multiseed import MultiSeedTrainer
    from ..train.trainer import Trainer

    trainer = (MultiSeedTrainer if multiseed and len(exp.train.seeds) > 1 else Trainer)
    if profile_dir is None:
        trainer(exp, device=device).run(ds)
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        trainer(exp, device=device).run(ds)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    print(f"Profile: {os.path.join(profile_dir, 'trace.json')}")


def data_parallel_world(args, device) -> int:
    """The number of ranks ``--data_parallel`` asks for: the visible cards
    (a rendezvous in the environment: its ``WORLD_SIZE``), or 1."""
    import torch

    if not args.data_parallel:
        return 1
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return torch.cuda.device_count() if device.type == "cuda" else 1


def train(args, device) -> int:
    """Load the data onto ``device`` and train: the whole run in one
    process, or this rank's part of it under the active group, whose
    ranks scale the batch by their number."""
    import torch

    from .. import parallel
    from ..data.dataset import PairedDataset
    from ..data.pipeline import load_artifacts

    if device.type == "cuda":   # float32 means float32: no TF32 in GEMMs or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    main_rank = parallel.is_main()
    arrays = load_artifacts(args.data_dir)
    ds = PairedDataset.from_numpy(arrays["g1_train.npy"], arrays["human_train.npy"],
                                  device=device)
    if main_rank:
        print(f"Dataset loaded. Dim: R={ds.robot_dim}/H={ds.human_dim}, "
              f"N={len(ds)}, Batch={args.batch_size}")
    exp = make_exp(args, ds.robot_dim, ds.human_dim)
    if parallel.world_size() > 1:
        exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, batch_size=args.batch_size * parallel.world_size()))
    _run(exp, ds, device, args.profile if main_rank else None, args.multiseed)
    if main_rank:
        for seed in args.seed:
            print(f"Success: {exp.name} | Mode: {args.mode} | Seed: {seed}")
    return 0


def rank_main(argv: Sequence[str]) -> int:
    """One rank of ``--data_parallel`` (``parallel.launch``'s target)."""
    from .. import parallel

    return train(build_parser().parse_args(argv), parallel.active().device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    flag = unported(args)
    if flag is not None:
        print(f"{flag} is not ported to bridgerl_tpu_torch yet (ROADMAP.md)", file=sys.stderr)
        return 2

    from .. import parallel
    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train_ablation: {e}", file=sys.stderr)
        return 1
    world = data_parallel_world(args, device)
    if world == 1:
        return train(args, device)
    if int(os.environ.get("RANK", 0)) == 0:
        # the global batch scales by the card count, as the JAX CLI mirrors
        # the reference's DataParallel
        print(f"!!! Data-parallel over {world} devices; scaling batch size to "
              f"{args.batch_size * world} !!!")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        group = parallel.init_from_env(backend, args.device)
        try:
            with parallel.use_group(group):
                return train(args, group.device)
        finally:
            dist.destroy_process_group()
    try:
        parallel.launch(rank_main, world, backend, args=(argv,))
    except parallel.RankFailure as e:
        print(f"train_ablation: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
