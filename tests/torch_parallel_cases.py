"""What each rank runs in ``tests/test_torch_port_parallel.py``.

The ranks are new processes started by ``parallel.launch``; they import
this module (torch and the port only, no JAX) by name. Every case also runs
without a group, in the test's own process, as the one-process reference.
Results travel back pickled, as numpy.
"""

import dataclasses
import os

import torch

from bridgerl_tpu_torch import parallel
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.data.dataset import PairedDataset
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.ops import attention
from bridgerl_tpu_torch.train.checkpoint import load_checkpoint
from bridgerl_tpu_torch.train.multiseed import MultiSeedTrainer
from bridgerl_tpu_torch.train.trainer import (
    Trainer,
    epoch_generator,
    fork_for_rank,
    make_optimizer,
    make_train_epoch,
)


def experiment(arch, method, over, workdir=None):
    exp = make_experiment(arch, method, **over)
    if workdir is not None:
        exp = dataclasses.replace(exp, log_dir=os.path.join(workdir, "results"),
                                  checkpoint_dir=os.path.join(workdir, "checkpoints"))
    return exp


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def steps(spec):
    """``spec["idx"].shape[0]`` optimizer steps of ``make_train_epoch`` from
    ``spec["state"]`` (or seed 0's init), one call a step: the logs of each
    step, the gradients left by the first, and the final state."""
    exp = experiment(spec["arch"], spec["method"], spec["over"])
    dev = parallel.active().device if parallel.active() else torch.device(
        spec.get("device", "cpu"))
    model = init_model(exp.model, 0, device=dev)
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()})
    parallel.broadcast_module(model)
    opt = make_optimizer(model, exp)
    train_epoch = make_train_epoch(exp)
    robot, human = (torch.as_tensor(spec[k], device=dev) for k in ("robot", "human"))
    idx = torch.as_tensor(spec["idx"], device=dev)
    gen = fork_for_rank(epoch_generator(0, 0, dev), 0, 0)
    seeds = []
    draw = attention.draw_seed

    def recording_draw(generator, device):
        out = draw(generator, device)
        seeds.append(int(out.reshape(-1)[0]))
        return out

    attention.draw_seed = recording_draw
    try:
        logs, grads = [], None
        for step in range(idx.shape[0]):
            logs.append(train_epoch(model, opt, robot, human, idx[step:step + 1], gen))
            if grads is None:
                grads = _numpy({n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None and p.requires_grad})
    finally:
        attention.draw_seed = draw
    return {"logs": logs, "grads": grads, "state": _numpy(model.state_dict()),
            "k1_seeds": seeds}


def trainer(spec):
    """``Trainer.run`` in ``spec["workdir"]``: each seed's history and final
    state, and which files this process found after the run."""
    exp = experiment(spec["arch"], spec["method"], spec["over"], spec["workdir"])
    dev = parallel.active().device if parallel.active() else torch.device("cpu")
    ds = PairedDataset.from_numpy(spec["robot"], spec["human"], device=dev)
    t = Trainer(exp, device=dev, verbose=False)
    history = t.run(ds)
    final = load_checkpoint(t.ckpt_path(exp.train.seeds[0], "last"))["model_state_dict"]
    return {"history": history, "last": _numpy(final),
            "files": sorted(os.listdir(exp.checkpoint_dir))}


def multiseed(spec):
    exp = experiment(spec["arch"], spec["method"], spec["over"], spec["workdir"])
    dev = parallel.active().device if parallel.active() else torch.device("cpu")
    ds = PairedDataset.from_numpy(spec["robot"], spec["human"], device=dev)
    return MultiSeedTrainer(exp, device=dev, verbose=False).run(ds)


CASES = {"steps": steps, "trainer": trainer, "multiseed": multiseed}


def run(cases):
    """Each ``(name, spec)`` in turn, torch on one thread: their results."""
    torch.set_num_threads(1)
    return [CASES[name](spec) for name, spec in cases]


def fails_on_rank_1():
    if parallel.active().rank == 1:
        raise ValueError("rank 1 fails on purpose")
    parallel.barrier()   # rank 0 waits on a collective that never completes


def hangs():
    import time
    time.sleep(600)
