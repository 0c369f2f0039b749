"""Several seeds of one experiment trained as one stacked program.

Counterpart of ``bridgerl_tpu/train/multiseed.py``, where S seeds train as
one ``jax.vmap``-ed program over a shared dataset. Here the S models are
stacked on a seed axis (``models/stacked.py``) and trained eagerly: each
microbatch is one forward and one backward over S seed-major groups of
windows, so each K1 and K2 call site launches once for all seeds (K1 with
one dropout seed per group, K2 over a group axis), the dense layers are
batched products over the seed axis, and one ``torch.optim.AdamW`` over the
stacked parameters is S independent ones (it is elementwise).

Seed s of the stacked run is the sequential ``Trainer``'s seed s, up to
summation order:

- it starts from ``init_model(exp.model, s)``, with the sequential path's
  resume, teacher transfer (a shared teacher or a ``{seed}`` pattern),
  ``init_from`` and codebook seeding applied to that seed's model before
  the seeds are stacked;
- its split is ``split_indices(n, val_fraction, s)``, every seed's train and
  validation lists cut to the shortest (as the JAX package cuts them;
  equal-sized splits lose nothing);
- each epoch's shuffle and every dropout draw come from
  ``epoch_generator(s, epoch)``, drawn in the order a single-seed run draws
  them, so its masks and K1 seeds are that run's.

As in the JAX package: a resume needs every seed's ``_last`` checkpoint (a
partial set is an error; checkpoints of another stage are ignored); the
best state of each seed is tracked on the device and its ``_best`` written
at the end, with ``_last`` every ``save_every`` epochs and ``_final``; the
run stops early when every seed has run out of patience.

Data-parallel (an active ``parallel`` group of R ranks), the seeds are
split, as the JAX package lays the seed axis over its mesh when the device
count divides S: each rank trains a stacked model of its S / R whole seeds
with no collective in the hot loop (one all-reduce an epoch decides the
early stop over every seed), writes its seeds' files, and ``run`` returns
every seed's history on every rank. Where R does not divide S the seeds
stay unsplit on rank 0, as the JAX package keeps them unsharded, and the
other ranks return at once.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..config import ExperimentConfig
from ..data.dataset import PairedDataset, epoch_batch_indices, split_indices
from ..device import resolve_device
from ..models.stacked import (
    seed_optimizer_state,
    seed_state_dict,
    stack_models,
    stack_optimizer_states,
)
from ..utils.logging import TermColor
from .checkpoint import load_checkpoint, save_checkpoint, save_state_dict
from .losses import eval_metrics, mse, student_loss, teacher_loss
from .trainer import (
    empty_history,
    epoch_generator,
    fk_fn,
    make_optimizer,
    prepare_seed_model,
    record_epoch,
    val_index_matrix,
)

Logs = Dict[str, torch.Tensor]


def _split(t: torch.Tensor, S: int) -> torch.Tensor:
    """(S * B, ...) seed-major -> (S, B, ...)."""
    return t.reshape(S, -1, *t.shape[1:])


def _per_seed(v: torch.Tensor, S: int) -> torch.Tensor:
    """A quantity of every seed as (S,): a 0-d one (a method without a loss
    or a metric, the same for every seed) is repeated."""
    return v.expand(S) if v.ndim == 0 else v


def stacked_loss(model: nn.Module, exp: ExperimentConfig, x_r: torch.Tensor,
                 x_h: Optional[torch.Tensor], generators, S: int):
    """Each seed's loss (S,) and logs on one stacked microbatch (S seed-major
    groups), the model in train mode: the sequential ``microbatch_loss`` of
    every seed, the losses taken per seed by ``torch.func.vmap``."""
    tcfg = exp.train
    out = model(x_robot=x_r, x_human=x_h, train=True, generator=generators)
    vmap = torch.func.vmap
    if tcfg.mode == "teacher":
        robot = out["robot"]
        parts = vmap(lambda r, x, lv: teacher_loss(
            r, x, lv, tcfg.lambda_recon, tcfg.lambda_vq, tcfg.lambda_vel,
            ref_exact_vel=tcfg.ref_exact_vel))(
            _split(robot["recon"], S), _split(x_r, S), _per_seed(robot["loss_vq"], S))
        fk = fk_fn(exp)
        if fk is not None:
            # FK on the folded batch, its MSE per seed
            pos = fk(robot["recon"].float()), fk(x_r.float())
            l_fk = vmap(mse)(*(_split(p, S) for p in pos))
            parts["loss"] = parts["loss"] + tcfg.lambda_fk * l_fk
        logs = {"train_loss": parts["loss"], "train_recon_loss": parts["recon_loss"],
                "train_vq_loss": parts["vq_loss"]}
    else:
        parts = vmap(lambda h, r: student_loss(h, r, tcfg.lambda_align))(
            _split(out["human"]["z_e"], S), _split(out["robot"]["z_e"], S))
        logs = {"train_loss": parts["loss"], "train_align": parts["align_loss"]}
    return parts["loss"], logs


def _mean_logs(logs: List[Logs]) -> Logs:
    return {k: torch.stack([l[k] for l in logs]).mean(dim=0) for k in logs[0]}


def stacked_accumulate_grads(model: nn.Module, exp: ExperimentConfig, robot: torch.Tensor,
                             human: torch.Tensor, idx: torch.Tensor, generators) -> Logs:
    """``trainer.accumulate_grads`` for S seeds: ``idx`` (S, batch) rows of
    the shared dataset, one row of indices a seed; each microbatch takes
    every seed's share at once. Logs are (S,)."""
    S, n = idx.shape
    accum = max(exp.train.accum_chunks, 1)
    acc = accum if n % accum == 0 else math.gcd(accum, n)
    student = exp.train.mode == "student"
    reuse = exp.train.reuse_dropout_mask and generators is not None
    starts = [g.get_state() for g in generators] if reuse else None
    logs = []
    for j, rows in enumerate(idx.reshape(S, acc, n // acc).unbind(1)):
        if reuse:
            for g, st in zip(generators, starts):
                g.set_state(st)
        rows = rows.reshape(-1)                           # seed-major
        loss, mb_logs = stacked_loss(model, exp, robot[rows],
                                     human[rows] if student else None, generators, S)
        loss.sum().backward()                             # seeds share no parameter
        logs.append({k: v.detach() for k, v in mb_logs.items()})
    if acc > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(acc)
    return _mean_logs(logs)


def make_stacked_train_epoch(exp: ExperimentConfig):
    """``train_epoch(model, opt, robot, human, idx_stack, generators)``: one
    optimizer step per batch of the (S, steps, batch) index stack; returns
    each log as an (S,) numpy array averaged over the steps."""

    def train_epoch(model, opt, robot, human, idx_stack, generators) -> Dict[str, np.ndarray]:
        logs = []
        for idx in idx_stack.unbind(1):
            opt.zero_grad(set_to_none=False)
            logs.append(stacked_accumulate_grads(model, exp, robot, human, idx, generators))
            for group in opt.param_groups:       # optax.adamw decays unused parameters too
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            opt.step()
        return {k: v.cpu().numpy() for k, v in _mean_logs(logs).items()}

    return train_epoch


@torch.no_grad()
def stacked_eval_epoch(model: nn.Module, robot: torch.Tensor, human: torch.Tensor,
                       vidx: torch.Tensor, mode: str = "student") -> Dict[str, np.ndarray]:
    """``trainer.eval_epoch`` for S seeds over the (S, batches, batch) index
    stack: each metric as an (S,) numpy array."""
    S = vidx.shape[0]
    metrics = []
    for rows in vidx.unbind(1):
        rows = rows.reshape(-1)
        x_r = robot[rows]
        out = model(x_robot=x_r, x_human=None if mode == "teacher" else human[rows])
        per = {"robot": {"recon": _split(out["robot"]["recon"], S),
                         "z_e": _split(out["robot"]["z_e"], S),
                         "metrics": {k: _per_seed(v, S)
                                     for k, v in out["robot"]["metrics"].items()}}}
        if "human" in out:
            per["human"] = {"retargeted": _split(out["human"]["retargeted"], S),
                            "z_e": _split(out["human"]["z_e"], S)}
        metrics.append(torch.func.vmap(eval_metrics)(per, _split(x_r, S)))
    return {k: v.cpu().numpy() for k, v in _mean_logs(metrics).items()}


class MultiSeedTrainer:
    """All seeds of an experiment trained at once, stacked; the host loop of
    ``bridgerl_tpu/train/multiseed.py``. ``train_seconds`` records (epoch,
    windows trained over all seeds, seconds of the epoch's training)."""

    def __init__(self, exp: ExperimentConfig, device=None, verbose: bool = True):
        self.exp = exp
        self.device = resolve_device(device)
        self.verbose = verbose and parallel.is_main()   # logs print on rank 0 only
        self.train_seconds: List = []
        os.makedirs(exp.log_dir, exist_ok=True)
        os.makedirs(exp.checkpoint_dir, exist_ok=True)

    def ckpt_path(self, seed: int, kind: str) -> str:
        return os.path.join(self.exp.checkpoint_dir, self.exp.ckpt_name(seed, kind) + ".pth")

    def _resume_checkpoints(self, seeds: Sequence[int]) -> Optional[List[Dict]]:
        """Every seed's ``_last`` checkpoint when all exist and belong to this
        stage; None when none exists (or they are another stage's); a
        partial set raises."""
        if not self.exp.train.resume:
            return None
        paths = [self.ckpt_path(s, "last") for s in seeds]
        have = [p for p in paths if os.path.exists(p)]
        if not have:
            return None
        if len(have) < len(paths):
            raise ValueError(
                f"--resume with only {len(have)}/{len(paths)} per-seed `_last` checkpoints "
                f"present; a partial multiseed resume is ambiguous: delete the stragglers or "
                f"train the missing seeds with the sequential Trainer")
        cks = [load_checkpoint(p) for p in paths]
        if any(ck["config"] is not None and ck["config"].train.mode != self.exp.train.mode
               for ck in cks):
            return None
        return cks

    def _save_seed(self, path: str, state: Dict, opt_state: Dict, i: int,
                   epoch: int, best_loss: float, patience_counter: int) -> None:
        save_checkpoint(path, epoch=epoch, model=seed_state_dict(state, i),
                        optimizer=seed_optimizer_state(opt_state, i), best_loss=best_loss,
                        config=self.exp, patience_counter=patience_counter)

    def run(self, ds: PairedDataset) -> Dict[int, Dict[str, list]]:
        seeds = list(self.exp.train.seeds)
        group = parallel.active()
        if group is None:
            return self._run(ds, seeds, seeds, lambda stalled: stalled)
        R = group.world_size
        if len(seeds) % R:
            if group.rank != 0:
                return {}
            print(f"!!! {len(seeds)} seeds do not split over {R} ranks: they stay unsplit "
                  f"on rank 0 !!!")
            with parallel.use_group(None):
                return self._run(ds, seeds, seeds, lambda stalled: stalled)
        share = len(seeds) // R
        mine = seeds[group.rank * share:(group.rank + 1) * share]

        def all_stalled(stalled: bool) -> bool:
            with parallel.use_group(group):
                return parallel.all_reduce_sum(
                    torch.tensor([0.0 if stalled else 1.0], device=group.device)).item() == 0

        with parallel.use_group(None):          # whole seeds a rank: no collective
            histories = self._run(ds, seeds, mine, all_stalled)
        with parallel.use_group(group):
            gathered = parallel.gather_json(list(histories.items()))
        merged = {int(s): h for part in gathered for s, h in part}
        return {s: merged[s] for s in seeds}

    def _run(self, ds: PairedDataset, all_seeds: Sequence[int], seeds: Sequence[int],
             all_stalled) -> Dict[int, Dict[str, list]]:
        """Train ``seeds`` stacked; splits are cut to the shortest over
        ``all_seeds``; ``all_stalled(bool)`` is whether every seed of the run
        (this process's and any other's) has run out of patience."""
        exp, tcfg = self.exp, self.exp.train
        seeds = list(seeds)
        S, mode, dev = len(seeds), tcfg.mode, self.device
        if self.verbose:
            print(f"{TermColor.HEADER}Multi-seed: {exp.name} x {S} seeds, stacked | "
                  f"Mode: {mode.upper()} | Device: {dev}{TermColor.ENDC}")
        resume_cks = self._resume_checkpoints(seeds)

        # per-seed splits, every seed's lists cut to the shortest of the run's
        n = len(ds)
        cuts = [split_indices(n, tcfg.val_fraction, s) for s in all_seeds]
        n_train = min(len(tr) for tr, _ in cuts)
        n_val = min(len(va) for _, va in cuts)
        if n_train == 0 or n_val == 0:
            raise ValueError(f"val_fraction={tcfg.val_fraction} splits {n} windows into "
                             f"train={n_train}/val={n_val}; both must be non-empty")
        splits = [cuts[list(all_seeds).index(s)] for s in seeds]
        train_idx = torch.as_tensor(np.stack([tr[:n_train] for tr, _ in splits]), device=dev)
        val_idx = torch.as_tensor(np.stack([va[:n_val] for _, va in splits]), device=dev)

        models = [prepare_seed_model(exp, s, dev, ds.robot[train_idx[i, :tcfg.batch_size]],
                                     resume_cks[i] if resume_cks else None, self.verbose)
                  for i, s in enumerate(seeds)]
        model = stack_models(models)
        del models
        opt = make_optimizer(model, exp)

        histories = {s: empty_history() for s in seeds}
        best = {s: float("inf") for s in seeds}
        best_epoch = {s: 0 for s in seeds}
        patience = {s: 0 for s in seeds}
        start_epoch = 0
        if resume_cks is not None:
            try:
                opt.load_state_dict(stack_optimizer_states(
                    [ck["optimizer_state_dict"] for ck in resume_cks]))
            except (ValueError, KeyError, IndexError):
                pass
            start_epoch = min(ck["epoch"] for ck in resume_cks) + 1
            for s, ck in zip(seeds, resume_cks):
                best[s], patience[s] = ck["best_loss"], ck["patience_counter"]
                try:
                    with open(os.path.join(exp.log_dir, exp.log_name(s))) as f:
                        loaded = json.load(f)
                    histories[s].update({k: v[:start_epoch] for k, v in loaded.items()
                                         if k in histories[s]})
                except (OSError, ValueError):
                    pass
            if self.verbose:
                print(f"{TermColor.CYAN}    [Resume] {S} per-seed `_last` checkpoints @ "
                      f"epoch {start_epoch}{TermColor.ENDC}")

        # each seed's best state, kept on the device and written at the end
        best_model = {k: v.detach().clone() for k, v in model.state_dict().items()}
        best_opt = _clone_state(opt.state_dict())
        if resume_cks is not None:
            for i, s in enumerate(seeds):
                bp = self.ckpt_path(s, "best")
                if os.path.exists(bp):
                    bck = load_checkpoint(bp)
                    best_epoch[s] = bck["epoch"]
                    for k, v in bck["model_state_dict"].items():
                        best_model[k][i].copy_(v)

        batch = min(tcfg.batch_size, n_train)
        vmat = torch.as_tensor(val_index_matrix(n_val, tcfg.batch_size), device=dev)
        vidx = val_idx[:, vmat]                                     # (S, batches, batch)
        train_epoch = make_stacked_train_epoch(exp)
        t0 = time.time()
        last_epoch = max(start_epoch - 1, 0)
        for epoch in range(start_epoch, tcfg.epochs):
            last_epoch = epoch
            gens = [epoch_generator(s, epoch, dev) for s in seeds]
            idx_stack = torch.stack([train_idx[i][epoch_batch_indices(g, n_train, batch)]
                                     for i, g in enumerate(gens)])  # (S, steps, batch)
            t_epoch = time.perf_counter()
            logs = train_epoch(model, opt, ds.robot, ds.human, idx_stack, gens)
            self.train_seconds.append((epoch, idx_stack.numel(),
                                       time.perf_counter() - t_epoch))
            vals = stacked_eval_epoch(model, ds.robot, ds.human, vidx, mode)

            improved = np.zeros(S, dtype=bool)
            stalled = True
            for i, s in enumerate(seeds):
                h = histories[s]
                cur = float(vals["val_recon"][i] if mode == "teacher" else vals["val_align"][i])
                record_epoch(h, {k: float(v[i]) for k, v in logs.items()},
                             {k: float(v[i]) for k, v in vals.items()}, cur)
                if cur < best[s]:
                    best[s], best_epoch[s], patience[s] = cur, epoch, 0
                    improved[i] = True
                else:
                    patience[s] += 1
                if tcfg.patience <= 0 or patience[s] < tcfg.patience:
                    stalled = False
                with open(os.path.join(exp.log_dir, exp.log_name(s)), "w") as f:
                    json.dump(h, f, indent=4)

            if improved.any():
                keep = torch.as_tensor(improved, device=dev)
                _select(best_model, model.state_dict(), keep)
                _select_opt(best_opt, opt.state_dict(), keep)
            if epoch % max(tcfg.save_every, 1) == 0 or epoch == tcfg.epochs - 1:
                state = opt.state_dict()
                for i, s in enumerate(seeds):
                    self._save_seed(self.ckpt_path(s, "last"), model.state_dict(), state, i,
                                    epoch, best[s], patience[s])

            if self.verbose and (epoch % 5 == 0 or epoch == tcfg.epochs - 1):
                vkey = "val_recon" if mode == "teacher" else "val_align"
                eta = (tcfg.epochs - epoch - 1) * (time.time() - t0) / (epoch - start_epoch + 1)
                print(f"Ep {epoch}: mean train {float(np.mean(logs['train_loss'])):.4f} | "
                      f"mean {vkey} {float(np.mean(vals[vkey])):.4f} | "
                      f"{TermColor.CYAN}ETA {int(eta)}s{TermColor.ENDC}")
            if tcfg.patience > 0 and all_stalled(stalled):
                if self.verbose:
                    print(f"{TermColor.RED}!!! All seeds early-stopped at epoch {epoch} !!!"
                          f"{TermColor.ENDC}")
                break

        state, opt_state = model.state_dict(), opt.state_dict()
        for i, s in enumerate(seeds):
            self._save_seed(self.ckpt_path(s, "best"), best_model, best_opt, i, best_epoch[s],
                            best[s], patience[s])
            self._save_seed(self.ckpt_path(s, "last"), state, opt_state, i, last_epoch,
                            best[s], patience[s])
            save_state_dict(self.ckpt_path(s, "final"), seed_state_dict(state, i))
            with open(os.path.join(exp.log_dir, f"log_{exp.name}_{mode}_seed_{s}.json"),
                      "w") as f:
                json.dump(histories[s], f, indent=4)
        return histories


def _clone_state(state: Dict) -> Dict:
    return {"state": {k: {n: (t.detach().clone() if torch.is_tensor(t) else t)
                          for n, t in st.items()} for k, st in state["state"].items()},
            "param_groups": state["param_groups"]}


def _select(best: Dict[str, torch.Tensor], cur: Dict[str, torch.Tensor],
            keep: torch.Tensor) -> None:
    """best[k][i] = cur[k][i] for the seeds i that ``keep``, in place."""
    for k, b in best.items():
        m = keep.reshape(-1, *([1] * (b.ndim - 1)))
        b.copy_(torch.where(m, cur[k], b))


def _select_opt(best: Dict, cur: Dict, keep: torch.Tensor) -> None:
    for k, st in best["state"].items():
        for n, b in st.items():
            if torch.is_tensor(b) and b.ndim:
                m = keep.reshape(-1, *([1] * (b.ndim - 1)))
                b.copy_(torch.where(m, cur["state"][k][n], b))
            else:
                st[n] = cur["state"][k][n].clone() if torch.is_tensor(b) else cur["state"][k][n]
