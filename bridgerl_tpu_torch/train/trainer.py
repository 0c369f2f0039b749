"""Training: the accumulated optimizer step, epochs, and the teacher/student
host loop with early stopping, resume and the full-schema history.

Counterpart of ``bridgerl_tpu/train/trainer.py``, run eagerly:

- an optimizer batch is ``accum_chunks`` microbatches (clamped to a divisor
  of the batch as the JAX package clamps it); each microbatch runs the model
  in train mode, so the EMA codebooks and the BatchNorm statistics fold once
  per microbatch and carry to the next; gradients are summed over the
  microbatches, divided by their number, and AdamW steps once;
- the teacher trains every parameter on the teacher loss (robot branch
  only), a ``standard`` VQ's codebook included; the student loads the
  teacher minus its human encoder and trains only the human encoder on the
  alignment loss, while both branches run in train mode (the frozen robot
  encoder still drops out, both branches fold the shared codebooks, and the
  frozen towers' BatchNorm statistics still move: the robot decoder's fold
  twice a microbatch, robot branch first), as the JAX package's student
  step does;
- with ``lambda_fk`` > 0 and a 29-dim robot, the teacher loss adds
  ``lambda_fk`` times the world-space FK loss (``losses.fk_loss`` over the
  G1 chain, ``sim/kinematics.py``), as the JAX package's does;
- AdamW (lr 2e-4, weight decay 1e-4, betas 0.9/0.999, eps 1e-8) decays
  every parameter it updates, biases and LayerNorm included, as
  ``optax.adamw`` does; frozen parameters get neither update nor decay.

All random numbers of an epoch (its shuffle and every dropout) come from one
``torch.Generator`` on the device, seeded from (seed, epoch), so a resumed
run repeats the epochs it had not finished. With ``reuse_dropout_mask`` every
microbatch of an optimizer step starts from the generator state the step
started from, so all of them draw the same dropout masks and the same K1
seed; the EMA codebooks and BatchNorm statistics still fold once a
microbatch.

A fresh teacher run (not a resume) can start from another checkpoint's
matching weights (``init_from``, :func:`~.checkpoint.merge_matching_variables`)
and then seed its first-stage EMA codebooks from the robot encoder's outputs
on the first ``batch_size`` training windows (``codebook_data_init``,
``train/codebook_seed.py``), both before the optimizer is built.

Data-parallel (an active ``parallel`` group, one process a card), a run at
world size R, global batch B and ``accum_chunks`` A computes what one
process computes at B and A, up to summation order, as the JAX package does
over its ``data`` mesh: each microbatch of B / A windows is split into R
contiguous shares (``parallel.shard_rows``), the EMA codebooks and
BatchNorm statistics fold batch-global statistics (``ops/quantizers.py``,
``models/layers.py``), the gradients are summed over the ranks once an
optimizer step and divided by R, and the logs and validation metrics are
global means. The model is broadcast from rank 0 before the first epoch,
so the parameters stay bit-equal on every rank. Every rank draws the
epoch's shuffle; after it, rank r > 0 draws its dropout (and K1's seeds)
from a stream of its own (:func:`fork_for_rank`). Only rank 0 writes
checkpoints, histories and logs; the others wait for it at the end of each
seed, so that a resume or a student reads complete files.
"""

from __future__ import annotations

import functools
import json
import math
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..config import HISTORY_KEYS, ExperimentConfig
from ..data.dataset import (
    PairedDataset,
    epoch_batch_indices,
    require_split,
    train_val_split,
)
from ..device import resolve_device
from ..models.dual_vqvae import init_model
from ..utils.logging import TermColor, epoch_log
from .checkpoint import (
    load_checkpoint,
    merge_matching_variables,
    merge_teacher_into_student,
    resolve_teacher_ckpt,
    save_checkpoint,
    save_state_dict,
    trainable_mask,
)
from .codebook_seed import seed_codebooks
from .losses import eval_metrics, fk_loss, student_loss, teacher_loss

Logs = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=1)
def _g1_positions():
    """(B, W, 29) joint windows -> (B, W, 30, 3) G1 link positions."""
    from ..sim import load_g1_chain, make_batched_fk

    return make_batched_fk(load_g1_chain())


def fk_fn(exp: ExperimentConfig):
    """The FK of the teacher loss's ``lambda_fk`` term, or None when the
    term is off: ``lambda_fk`` is 0, or the robot is not the 29-joint G1."""
    if exp.train.lambda_fk > 0.0 and exp.model.robot_input_dim == 29:
        return _g1_positions()
    return None


def make_optimizer(model: nn.Module, exp: ExperimentConfig) -> torch.optim.AdamW:
    """AdamW over the parameters the mode trains. The others are frozen
    (``requires_grad=False``) and stay out of the optimizer."""
    mask = trainable_mask(model, exp.train.mode)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return torch.optim.AdamW(params, lr=exp.train.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=exp.train.weight_decay)


def microbatch_loss(model: nn.Module, exp: ExperimentConfig, x_r: torch.Tensor,
                    x_h: Optional[torch.Tensor], generator: Optional[torch.Generator]
                    ) -> Tuple[torch.Tensor, Logs]:
    """The mode's loss on one microbatch, the model in train mode."""
    tcfg = exp.train
    out = model(x_robot=x_r, x_human=x_h, train=True, generator=generator)
    if tcfg.mode == "teacher":
        parts = teacher_loss(out["robot"]["recon"], x_r, out["robot"]["loss_vq"],
                             tcfg.lambda_recon, tcfg.lambda_vq, tcfg.lambda_vel,
                             ref_exact_vel=tcfg.ref_exact_vel)
        fk = fk_fn(exp)
        if fk is not None:
            parts["loss"] = parts["loss"] + tcfg.lambda_fk * fk_loss(out["robot"]["recon"],
                                                                     x_r, fk)
        logs = {"train_loss": parts["loss"], "train_recon_loss": parts["recon_loss"],
                "train_vq_loss": parts["vq_loss"]}
    else:
        parts = student_loss(out["human"]["z_e"], out["robot"]["z_e"], tcfg.lambda_align)
        logs = {"train_loss": parts["loss"], "train_align": parts["align_loss"]}
    return parts["loss"], logs


def _mean_logs(logs: List[Logs]) -> Logs:
    return {k: torch.stack([l[k] for l in logs]).mean() for k in logs[0]}


def _global_logs(logs: Logs) -> Logs:
    """Each rank's means of equal shares -> the global means (one
    all-reduce; the logs themselves without a group)."""
    parallel.all_reduce_mean_(list(logs.values()))
    return logs


def microbatches(n: int, accum: int) -> int:
    """The number of microbatches of an optimizer batch of ``n``:
    ``accum``, or where it does not divide ``n`` the largest common divisor,
    as the JAX package clamps it."""
    accum = max(accum, 1)
    return accum if n % accum == 0 else math.gcd(accum, n)


def accumulate_grads(model: nn.Module, exp: ExperimentConfig, robot: torch.Tensor,
                     human: torch.Tensor, idx: torch.Tensor,
                     generator: Optional[torch.Generator]) -> Logs:
    """Leave in ``.grad`` the gradient of one optimizer batch ``idx``: the sum
    over its microbatches divided by their number. Returns the logs
    averaged over the microbatches (device tensors). With
    ``reuse_dropout_mask`` each microbatch draws its dropout from the
    generator state the batch started from. Data-parallel, each microbatch
    row of ``idx`` is global: this rank takes its share, and the gradient
    left in ``.grad`` is the global batch's (summed over the ranks once,
    divided by their number); the logs stay this rank's."""
    n = idx.shape[0]
    acc = microbatches(n, exp.train.accum_chunks)
    student = exp.train.mode == "student"
    reuse = exp.train.reuse_dropout_mask and generator is not None
    start = generator.get_state() if reuse else None
    logs = []
    for mb in idx.reshape(acc, n // acc):
        if reuse:
            generator.set_state(start)
        mb = parallel.shard_rows(mb)
        loss, mb_logs = microbatch_loss(model, exp, robot[mb],
                                        human[mb] if student else None, generator)
        loss.backward()
        logs.append({k: v.detach() for k, v in mb_logs.items()})
    if acc > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(acc)
    parallel.all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None])
    return _mean_logs(logs)


def make_train_epoch(exp: ExperimentConfig) -> Callable:
    """``train_epoch(model, opt, robot, human, idx_mat, generator)``: one
    optimizer step per row of the (steps, batch) index matrix; returns the
    logs averaged over the steps (and the ranks), as floats."""

    def train_epoch(model, opt, robot, human, idx_mat, generator) -> Dict[str, float]:
        logs = []
        for idx in idx_mat:
            opt.zero_grad(set_to_none=False)
            logs.append(accumulate_grads(model, exp, robot, human, idx, generator))
            # optax.adamw sees a zero gradient for a parameter outside the
            # loss (the teacher's human encoder) and still decays it
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            opt.step()
        return {k: float(v) for k, v in _global_logs(_mean_logs(logs)).items()}

    return train_epoch


@torch.no_grad()
def eval_epoch(model: nn.Module, robot: torch.Tensor, human: torch.Tensor,
               idx_mat: torch.Tensor, mode: str = "student") -> Dict[str, float]:
    """Validation in eval mode, averaged over the batches. The teacher
    evaluates the robot branch only (its human branch is untrained); the
    student evaluates both, for the cross and alignment metrics.
    Data-parallel, each rank evaluates its contiguous share of every batch
    (shares one row apart where the ranks do not divide it) and the metrics
    are global means, weighted by the shares' rows."""
    metrics = []
    for idx in idx_mat:
        rows = parallel.shard_rows(idx, even=False)
        x_r = robot[rows]
        x_h = None if mode == "teacher" else human[rows]
        metrics.append(eval_metrics(model(x_robot=x_r, x_human=x_h), x_r))
    means = _mean_logs(metrics)
    # shares may differ by a row: weight each rank's means by its rows
    # (a factor of exactly 1 where the shares are equal)
    weight = len(rows) * parallel.world_size() / idx_mat.shape[1]
    if weight != 1.0:
        means = {k: v * weight for k, v in means.items()}
    return {k: float(v) for k, v in _global_logs(means).items()}


def val_index_matrix(n_val: int, batch_size: int) -> np.ndarray:
    """Deterministic chunking of the val set (drop remainder; at least 1 batch)."""
    vb = min(batch_size, n_val)
    nb = max(n_val // vb, 1)
    return np.arange(nb * vb).reshape(nb, vb)


def empty_history() -> Dict[str, list]:
    return {k: [] for k in HISTORY_KEYS}


def record_epoch(history: Dict[str, list], logs: Mapping[str, float],
                 val: Mapping[str, float], cur: float) -> None:
    """Append one epoch's train logs, validation metrics and monitored
    validation loss ``cur`` to ``history`` (the reference's schema)."""
    history["train_loss"].append(logs["train_loss"])
    history["train_recon_loss"].append(logs.get("train_recon_loss", 0.0))
    history["train_vq_loss"].append(logs.get("train_vq_loss", 0.0))
    history["val_loss"].append(cur)
    for k in ("val_recon", "val_cross_recon", "val_align", "val_vel", "val_jerk",
              "perplexity", "dcr", "rvq_ppl"):
        if k in val:
            history[k].append(val[k])
    history["dead_code_ratio"].append(val.get("dcr", 0.0))


def prepare_seed_model(exp: ExperimentConfig, seed: int, device, train_robot: torch.Tensor,
                       resume_ck: Optional[Dict], verbose: bool = False) -> nn.Module:
    """Seed ``seed``'s model before its first epoch: ``init_model``, then the
    resumed weights (``resume_ck``), or the teacher transfer (student), or
    ``init_from`` and codebook seeding from the head of ``train_robot``,
    the seed's training windows (a fresh teacher; the dataset's head would
    leak validation windows into the codebook)."""
    tcfg = exp.train
    model = init_model(exp.model, seed, device=device)
    if resume_ck is not None:
        model.load_state_dict(resume_ck["model_state_dict"])
        return model
    if tcfg.mode == "student":
        tpath = resolve_teacher_ckpt(tcfg.teacher_ckpt or "", seed)
        if not tpath or not os.path.exists(tpath):
            raise ValueError(f"Student mode requires a valid teacher_ckpt "
                             f"(resolved: {tpath!r})")
        teacher = load_checkpoint(tpath)["model_state_dict"]
        model.load_state_dict(merge_teacher_into_student(model.state_dict(), teacher))
        if verbose:
            print(f"{TermColor.BLUE}    [Student] Loaded teacher: {tpath}{TermColor.ENDC}")
        return model
    if tcfg.init_from:
        ipath = resolve_teacher_ckpt(tcfg.init_from, seed)
        source = load_checkpoint(ipath)["model_state_dict"]
        model.load_state_dict(merge_matching_variables(model.state_dict(), source))
        if verbose:
            print(f"{TermColor.CYAN}    [InitFrom] {ipath}{TermColor.ENDC}")
    if tcfg.codebook_data_init:
        seed_codebooks(model, train_robot[: tcfg.batch_size])
        if verbose:
            print(f"{TermColor.CYAN}    [Seed] codebook data init "
                  f"({min(len(train_robot), tcfg.batch_size)} windows){TermColor.ENDC}")
    return model


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch's shuffle and dropout, from (seed, epoch)."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def fork_for_rank(generator: torch.Generator, seed: int, epoch: int) -> torch.Generator:
    """The dropout stream of this rank, after the epoch's shuffle: rank 0
    (and a process without a group) goes on with ``generator``; rank r > 0
    draws from a generator of its own, seeded from (seed, epoch, r), so that
    the ranks' shares do not all get the same masks. (The JAX package's mask
    is one draw over the global batch, which no rank split reproduces.)"""
    group = parallel.active()
    if group is None or group.rank == 0:
        return generator
    state = np.random.SeedSequence([seed, epoch, group.rank]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(state))


class Trainer:
    """Host-level orchestration of one experiment across its seeds.

    ``train_seconds`` records, for every epoch run, (epoch, windows trained,
    seconds of ``train_epoch``); the epoch ends by reading its losses on the
    host, which waits for the device."""

    def __init__(self, exp: ExperimentConfig, device=None, verbose: bool = True):
        self.exp = exp
        self.device = resolve_device(device)
        self.verbose = verbose and parallel.is_main()   # logs print on rank 0 only
        self.train_seconds: List[Tuple[int, int, float]] = []
        os.makedirs(exp.log_dir, exist_ok=True)
        os.makedirs(exp.checkpoint_dir, exist_ok=True)

    # ---- paths (reference naming, train_ablation.py:124-126, 142, 289, 363) ----
    def _log_path(self, seed: int) -> str:
        return os.path.join(self.exp.log_dir, self.exp.log_name(seed))

    def _mode_log_path(self, seed: int) -> str:
        return os.path.join(
            self.exp.log_dir, f"log_{self.exp.name}_{self.exp.train.mode}_seed_{seed}.json")

    def ckpt_path(self, seed: int, kind: str) -> str:
        return os.path.join(self.exp.checkpoint_dir, self.exp.ckpt_name(seed, kind) + ".pth")

    def train_seed(self, ds: PairedDataset, seed: int) -> Dict[str, list]:
        exp, tcfg = self.exp, self.exp.train
        mode = tcfg.mode
        if self.verbose:
            print(f"{TermColor.HEADER}Start: {exp.run_name(seed)} | Mode: {mode.upper()} | "
                  f"Device: {self.device}{TermColor.ENDC}")
        train_ds, val_ds = train_val_split(ds, tcfg.val_fraction, seed)
        if len(train_ds) == 0 or len(val_ds) == 0:
            raise ValueError(
                f"val_fraction={tcfg.val_fraction} splits {len(ds)} windows "
                f"into train={len(train_ds)}/val={len(val_ds)}; both must be non-empty")

        # ---- resume / student transfer (train_ablation.py:152-180) ----
        start_epoch = 0
        best_val = float("inf")
        patience_counter = 0
        history = empty_history()
        resumed_opt_state = None
        last_path = self.ckpt_path(seed, "last")
        ck = load_checkpoint(last_path) if tcfg.resume and os.path.exists(last_path) else None
        model = prepare_seed_model(exp, seed, self.device, train_ds.robot, ck, self.verbose)
        # rank 0's weights, its data-seeded codebooks included, on every rank
        parallel.broadcast_module(model)
        if ck is not None:
            resumed_opt_state = ck["optimizer_state_dict"] or None
            try:
                with open(self._log_path(seed)) as f:
                    loaded = json.load(f)
                history.update({k: v for k, v in loaded.items() if k in history})
            except (OSError, ValueError):
                pass
            if ck["config"] is not None and ck["config"].train.mode == mode:
                start_epoch = ck["epoch"] + 1
                best_val = ck["best_loss"]
                patience_counter = ck["patience_counter"]
            # the history JSON may run ahead of `_last` (save_every > 1)
            history = {k: v[:start_epoch] for k, v in history.items()}
            if self.verbose:
                print(f"{TermColor.CYAN}    [Resume] {last_path} @ epoch {start_epoch}"
                      f"{TermColor.ENDC}")

        opt = make_optimizer(model, exp)
        if resumed_opt_state is not None:
            # the AdamW moments, where the parameter groups still match
            try:
                opt.load_state_dict(resumed_opt_state)
            except (ValueError, KeyError):
                pass

        n_train = len(train_ds)
        batch = min(tcfg.batch_size, n_train)
        idx_val = torch.as_tensor(val_index_matrix(len(val_ds), tcfg.batch_size),
                                  device=self.device)
        require_split(batch // microbatches(batch, tcfg.accum_chunks), "a microbatch")
        main = parallel.is_main()
        train_epoch = make_train_epoch(exp)
        patience = tcfg.patience
        t0 = time.time()

        # a resume past tcfg.epochs runs no epoch; the final save still needs one
        epoch = max(start_epoch - 1, 0)
        for epoch in range(start_epoch, tcfg.epochs):
            g = epoch_generator(seed, epoch, self.device)
            idx_mat = epoch_batch_indices(g, n_train, batch)
            g = fork_for_rank(g, seed, epoch)
            t_epoch = time.perf_counter()
            logs = train_epoch(model, opt, train_ds.robot, train_ds.human, idx_mat, g)
            self.train_seconds.append((epoch, idx_mat.numel(), time.perf_counter() - t_epoch))
            val = eval_epoch(model, val_ds.robot, val_ds.human, idx_val, mode)
            cur = val["val_recon"] if mode == "teacher" else val["val_align"]

            record_epoch(history, logs, val, cur)

            if self.verbose and (epoch % 5 == 0 or epoch == tcfg.epochs - 1):
                done = epoch - start_epoch + 1
                eta = (tcfg.epochs - epoch - 1) * ((time.time() - t0) / done)
                epoch_log(epoch, logs["train_loss"], cur,
                          "Recon" if mode == "teacher" else "Align", eta)

            # best first, so that `_last` records the post-epoch best
            improved = cur < best_val
            if improved:
                best_val = cur
                patience_counter = 0
                if main:
                    save_checkpoint(self.ckpt_path(seed, "best"), epoch=epoch, model=model,
                                    optimizer=opt, best_loss=best_val, config=exp)
            else:
                patience_counter += 1
            if main and (epoch % max(tcfg.save_every, 1) == 0 or epoch == tcfg.epochs - 1):
                save_checkpoint(last_path, epoch=epoch, model=model, optimizer=opt,
                                best_loss=best_val, config=exp,
                                patience_counter=patience_counter)
            if main:
                with open(self._log_path(seed), "w") as f:
                    json.dump(history, f, indent=4)

            if not improved and patience > 0 and patience_counter >= patience:
                if self.verbose:
                    print(f"{TermColor.RED}!!! Early stopping at epoch {epoch} "
                          f"(no improvement for {patience}) !!!{TermColor.ENDC}")
                break

        if main:
            save_state_dict(self.ckpt_path(seed, "final"), model)
            with open(self._mode_log_path(seed), "w") as f:
                json.dump(history, f, indent=4)
        parallel.barrier()   # rank 0's files are complete before any rank reads them
        return history

    def run(self, ds: PairedDataset) -> Dict[int, Dict[str, list]]:
        return {seed: self.train_seed(ds, seed) for seed in self.exp.train.seeds}
