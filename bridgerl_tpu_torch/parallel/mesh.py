"""Data parallelism over processes: the port's distribution layer.

Counterpart of ``bridgerl_tpu/parallel/mesh.py``. The JAX package runs one
program over a ``data`` mesh: parameters replicated, each batch sharded on
its first axis, and ``jit`` makes gradients, BatchNorm statistics, the EMA
codebook statistics and the codebook metrics batch-global. The port runs one
process a card (a rank), each holding the whole model and the whole
dataset, and makes the same quantities global with ``torch.distributed``:

- a :class:`Group` (rank, world size, device, process group) and a
  module-level *active group*, set by :func:`use_group`; with no active
  group every helper here is a no-op, the counterpart of ``mesh=None``;
- :func:`all_reduce_sum`, and :func:`all_reduce_sum_differentiable`, whose
  backward all-reduces the gradient (SyncBatchNorm's statistics);
- :func:`shard_rows`, the rank's contiguous share of a global index row, as
  ``shard_batch`` splits a batch over the ``data`` axis;
- :func:`broadcast_module`, rank 0's parameters and buffers on every rank
  (``put_replicated``);
- :func:`launch`, which starts the ranks (one process each, a free local
  port, ``cuda:{rank}`` under NCCL), joins them under a timeout and raises,
  naming the rank and its traceback, when one fails or hangs; and
  :func:`init_from_env`, which joins a rendezvous that the environment
  describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), the
  counterpart of ``jax.distributed.initialize``.

On CUDA tensors only ``all_reduce`` and ``broadcast`` are used: gloo
supports those two there, so two ranks can share one card over gloo. Byte
payloads travel as float32 for the same reason.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import pickle
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from ..device import local_rank_device, resolve_device

# a collective that waits longer than this raises on its rank; launch's own
# timeout, where given, ends the ranks sooner
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=30)
TERMINATE_GRACE_S = 5.0


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    process_group: Any = None   # a torch.distributed group; None: the default group


_active: Optional[Group] = None


def active() -> Optional[Group]:
    """The active group, or None (one process: every helper a no-op)."""
    return _active


@contextlib.contextmanager
def use_group(group: Optional[Group]) -> Iterator[Optional[Group]]:
    """Make ``group`` (None: no group) the active one inside the block."""
    global _active
    previous, _active = _active, group
    try:
        yield group
    finally:
        _active = previous


def is_main() -> bool:
    """True on rank 0, and in a process without a group."""
    return _active is None or _active.rank == 0


def world_size() -> int:
    return 1 if _active is None else _active.world_size


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    g = _active
    if g is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g.process_group)
    return t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    g = _active
    if g is not None:
        dist.broadcast(t, src=src, group=g.process_group)
    return t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise largest ``t`` over the ranks, in place; returns ``t``."""
    g = _active
    if g is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.process_group)
    return t


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce of a flat buffer per dtype."""
    g = _active
    if g is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in group]))
        flat.div_(g.world_size)
        _unflatten(flat, group)


def _unflatten(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of x is the sum over ranks of
    the gradient of y, so every rank's loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.process_group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group.process_group)
        return g, None


def all_reduce_sum_differentiable(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, as a new tensor that gradients flow
    through (``t`` itself without a group)."""
    g = _active
    return t if g is None else _AllReduceSum.apply(t, g)


def share(n: int, even: bool = True) -> Tuple[int, int]:
    """[start, stop) of this rank's contiguous share of ``n`` rows: rank r
    of R takes rows [r n / R, (r + 1) n / R), and R must divide ``n``; with
    ``even=False`` the first n % R ranks take one row more."""
    g = _active
    if g is None:
        return 0, n
    R, r = g.world_size, g.rank
    if even and n % R:
        raise ValueError(
            f"a batch of {n} rows does not split over {R} ranks: choose a batch size "
            f"(and accum_chunks) whose microbatch is a multiple of {R}")
    if n < R:
        raise ValueError(f"a batch of {n} rows leaves ranks of {R} without a row")
    base, extra = divmod(n, R)
    start = r * base + min(r, extra)
    return start, start + base + (r < extra)


def shard_rows(idx: torch.Tensor, even: bool = True) -> torch.Tensor:
    """This rank's contiguous share (:func:`share`) of the global index
    row(s) ``idx`` (last axis), as ``shard_batch`` splits a batch over the
    ``data`` axis; ``idx`` itself without a group."""
    if _active is None:
        return idx
    start, stop = share(idx.shape[-1], even)
    return idx[..., start:stop]


def _tensors(module: nn.Module) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in [*module.parameters(), *module.buffers()]:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank, in place: one
    broadcast of a flat buffer per dtype."""
    g = _active
    if g is None:
        return
    by_dtype = {}
    for t in _tensors(module):
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = broadcast(torch.cat([t.detach().reshape(-1) for t in tensors]), src)
        _unflatten(flat, tensors)


def barrier() -> None:
    """Wait until every rank has reached this point (an all-reduce, which
    gloo also runs on CUDA tensors)."""
    g = _active
    if g is not None:
        all_reduce_sum(torch.zeros(1, device=g.device)).item()


def gather_json(obj) -> list:
    """Every rank's JSON-serialisable ``obj``, in rank order, on every rank
    (``[obj]`` without a group). The bytes travel as float32 in one
    broadcast from each rank."""
    g = _active
    if g is None:
        return [obj]
    out = []
    mine = json.dumps(obj).encode()
    for src in range(g.world_size):
        n = int(broadcast(torch.tensor([float(len(mine))], device=g.device), src).item())
        buf = broadcast(torch.tensor(list(mine), dtype=torch.float32, device=g.device)
                        if src == g.rank else torch.empty(n, device=g.device), src)
        out.append(json.loads(bytes(buf.to(torch.uint8).tolist()).decode()))
    return out


def pad_to_multiple(n: int, k: int) -> int:
    """The least multiple of ``k`` that is at least ``n``."""
    return -(-n // k) * k


# ---------------------------------------------------------------- processes

def rank_device(backend: str, rank: int, device: Optional[str]) -> torch.device:
    """A rank's device: ``cuda:{rank}`` under NCCL; under gloo the card
    ``rank % count`` (ranks may share one), or the CPU when ``device`` asks
    for it. Raises without a card unless the CPU is asked for."""
    if backend == "nccl":
        return local_rank_device(rank)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_group(backend: str, rank: int, world: int, init_method: str,
               device: Optional[str] = None, local_rank: Optional[int] = None,
               timeout: datetime.timedelta = PROCESS_GROUP_TIMEOUT) -> Group:
    """Join the process group and return this rank's :class:`Group`; its
    device is that of ``local_rank`` (default: ``rank``) on this host."""
    dev = rank_device(backend, rank if local_rank is None else local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    return Group(rank=rank, world_size=world, device=dev)


def init_from_env(backend: str, device: Optional[str] = None) -> Group:
    """Join the rendezvous that ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` describe (a launcher such as ``torchrun``); under NCCL the
    rank's card is ``LOCAL_RANK`` (default: the rank)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return init_group(backend, rank, world, "env://", device,
                      local_rank=int(os.environ.get("LOCAL_RANK", rank)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankFailure(RuntimeError):
    """A rank raised, died or did not finish in time."""


def _rank_main(rank: int, fn: Callable, args: Sequence, world_size: int, backend: str,
               device: Optional[str], init_method: str, outdir: str) -> None:
    """One rank (``start_processes``' target): join the group, run ``fn``
    with it active and leave its return value, or its traceback, in
    ``outdir``. A failed rank exits 1 at once, without tearing down a group
    whose other ranks may be waiting on it."""
    path = os.path.join(outdir, f"rank{rank}.pkl")
    try:
        group = init_group(backend, rank, world_size, init_method, device)
        with use_group(group):
            out = fn(*args)
    except BaseException:
        out = traceback.format_exc()
        with open(path, "wb") as f:
            pickle.dump(out, f)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)   # written by this launch's own ranks


def _stop(procs: Sequence) -> None:
    """End the ranks still running: SIGTERM, then SIGKILL after the grace."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + TERMINATE_GRACE_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
        if p.is_alive():
            p.kill()
            p.join()


def launch(fn: Callable, world_size: int, backend: str = "gloo", args: Sequence = (),
           device: Optional[str] = None, timeout: Optional[float] = None) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a new process
    (``torch.multiprocessing`` spawn: ``fn`` must be importable by name)
    with the group active, and return their return values in rank order
    (they travel pickled: return CPU objects).

    The ranks rendezvous on a free local port. Under NCCL rank r runs on
    ``cuda:{r}``; under gloo on the card ``r % count``, or on the CPU with
    ``device="cpu"``; without a card anything else raises here. When a rank
    raises or exits non-zero, the others are stopped and
    :class:`RankFailure` names the rank and carries its traceback; when
    ``timeout`` seconds pass first, it names the ranks that had not
    finished. Nothing is retried elsewhere."""
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, not {world_size}")
    if backend != "nccl":
        resolve_device(device)
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="bridgerl_launch_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), world_size, backend, device,
                              f"tcp://localhost:{free_port()}", tmp),
            nprocs=world_size, join=False)
        try:
            while not ctx.join(None if deadline is None
                               else max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    hung = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                    raise RankFailure(f"rank(s) {hung} of {world_size} did not finish "
                                      f"within {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            r = e.error_index
            path = os.path.join(tmp, f"rank{r}.pkl")
            detail = _load(path) if os.path.exists(path) else ""
            raise RankFailure(f"rank {r} of {world_size} failed (exit code "
                              f"{ctx.processes[r].exitcode})"
                              + (":\n" + detail if detail else "")) from None
        finally:
            _stop(ctx.processes)
        return [_load(os.path.join(tmp, f"rank{r}.pkl")) for r in range(world_size)]
