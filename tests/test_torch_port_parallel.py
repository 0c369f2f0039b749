"""Data-parallel training over processes (``bridgerl_tpu_torch/parallel/``)
on the CPU: two ranks on gloo, started by ``parallel.launch``, against one
process at the global batch and against the JAX package's epoch.

Small widths (d_model 32, one block, K 32, hidden 16), global batch 32 in
``accum_chunks`` 2 (each rank takes 8 rows of a microbatch of 16), dropout
0, torch on one thread in every rank. One launch runs every training case
(``torch_parallel_cases.py``); its ranks and the one-process runs are shared
by the tests below. The bands are ``tests/test_sharding.py``'s, used as
upper limits: losses within 2e-4 relative (measured ~2e-7), the gradients
of the first step within 1e-5 * (1 + max|g|) (measured ~4e-7), EMA and
BatchNorm state within 2e-3 (measured ~6e-5, BatchNorm's running variance;
the EMA ~6e-8), multiseed histories within 5e-4 relative; the parameters
bit-equal on both ranks after every run.

- (a) the helpers without a group (the counterpart of ``mesh=None``), and
  ``shard_rows`` / ``pad_to_multiple`` against JAX's;
- (b) the transformer + hybrid teacher, two steps; (c) ``resnet_no_down`` +
  ``ema`` with its BatchNorm statistics; FSQ and LFQ, whose distinct-code
  counts come from a histogram summed over the ranks; (d) one student step;
- the ``Trainer`` (codebook seeding, then rank 0's model on every rank, a validation batch of 9
  split 5 and 4 over the ranks, rank 0's files), and dropout 0.1 (the ranks draw other K1 seeds
  and keep equal parameters);
- (e) multiseed, four seeds over two ranks against one stacked process, and
  three seeds, which stay unsplit on rank 0;
- (f) the two-rank run against ``make_train_epoch`` of the JAX package on
  the same weights (``convert.state_dict_from_jax``) and index matrix, over
  conftest's eight virtual devices;
- (g) a rank that raises or hangs fails the launch within its timeout,
  naming the rank; ``train_ablation --data_parallel`` joins a rendezvous
  from the environment.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from bridgerl_tpu.parallel import make_mesh
from bridgerl_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import make_optimizer as jax_make_optimizer
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch import parallel
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.data.dataset import require_split
from bridgerl_tpu_torch.ops.quantizers import code_range, global_unique_count, unique_count
from bridgerl_tpu_torch.train.trainer import epoch_generator, fork_for_rank

import torch_parallel_cases as cases
from test_torch_port_train_ops import fresh_pair

RANKS, BATCH, STEPS = 2, 32, 2
LAUNCH_TIMEOUT_S = 240
LOSS_RTOL, GRAD_ATOL, STATE_ATOL, MULTISEED_RTOL = 2e-4, 1e-5, 2e-3, 5e-4
TF = dict(window=10, hidden_dim=16, d_model=32, n_tf_layers=1, n_heads=2, ff_dim=64,
          attn_packing=2, dropout=0.0, batch_size=BATCH, accum_chunks=2)
BN = dict(window=10, hidden_dim=16, codebook_size=32, num_res_layers=1, dropout=0.0,
          batch_size=BATCH, accum_chunks=2)
STEP_CASES = {"transformer-hybrid": ("transformer", "hybrid", TF),
              "resnet_no_down-ema": ("resnet_no_down", "ema", BN),
              "resnet_no_down-fsq": ("resnet_no_down", "fsq", BN),
              "resnet_no_down-fsq-unbounded": ("resnet_no_down", "fsq",
                                               {**BN, "fsq_bounded": False}),
              "resnet_no_down-lfq": ("resnet_no_down", "lfq", BN),
              "student": ("transformer", "hybrid", {**TF, "mode": "student"})}
TF_LR = 2e-4   # the default learning rate
STATE_KEYS = ("ema_w", "ema_cluster_size", "embedding.weight", "running_mean", "running_var")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 10, 29)).astype(np.float32),
            rng.normal(size=(n, 10, 126)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_start():
    """The JAX model, its (perturbed) variables and the same weights as a
    port state dict: the transformer + hybrid case starts from them."""
    over = {k: v for k, v in TF.items() if k != "window"}
    exp, jmodel, variables, texp, _ = fresh_pair(window=10, **over)
    state = {k: v.numpy() for k, v in state_dict_from_jax(variables, texp.model).items()}
    return exp, jmodel, variables, state


@pytest.fixture(scope="module")
def runs(jax_start, tmp_path_factory):
    """Every case on two ranks (one launch) and in this process: (ranks'
    results, one process's results, the cases)."""
    robot, human = _windows(BATCH * STEPS, seed=0)
    idx = np.random.default_rng(1).permutation(BATCH * STEPS).reshape(STEPS, BATCH)
    todo = {}
    for name, (arch, method, over) in STEP_CASES.items():
        state = jax_start[3] if name == "transformer-hybrid" else None
        todo[name] = ("steps", dict(arch=arch, method=method, over=over, robot=robot,
                                    human=human, state=state,
                                    idx=idx[:1] if name == "student" else idx))
    todo["dropout"] = ("steps", dict(arch="transformer", method="hybrid",
                                     over={**TF, "dropout": 0.1}, robot=robot, human=human,
                                     idx=idx))
    trainer_data = _windows(90, seed=2)   # 9 validation windows: shares of 5 and 4
    ms_data = _windows(60, seed=3)
    dirs = {}
    for who in ("ranks", "one"):
        d = tmp_path_factory.mktemp(who)
        dirs[who] = {"trainer": str(d / "trainer"), "multiseed": str(d / "multiseed"),
                     "unsplit": str(d / "unsplit")}

    def trainer_spec(workdir):
        return ("trainer", dict(arch="transformer", method="hybrid", workdir=workdir,
                                over={**TF, "epochs": 2, "codebook_data_init": True},
                                robot=trainer_data[0], human=trainer_data[1]))

    def multiseed_spec(workdir, seeds):
        return ("multiseed", dict(arch="transformer", method="hybrid", workdir=workdir,
                                  over={**TF, "epochs": 2, "seeds": seeds},
                                  robot=ms_data[0], human=ms_data[1]))

    def all_cases(who):
        return {**todo, "trainer": trainer_spec(dirs[who]["trainer"]),
                "multiseed": multiseed_spec(dirs[who]["multiseed"], (3, 5, 7, 9)),
                "unsplit": multiseed_spec(dirs[who]["unsplit"], (3, 5, 7))}

    names = list(all_cases("one"))
    per_rank = parallel.launch(cases.run, RANKS, "gloo",
                               args=([all_cases("ranks")[n] for n in names],),
                               device="cpu", timeout=LAUNCH_TIMEOUT_S)
    one = cases.run([all_cases("one")[n] for n in names])
    return ([dict(zip(names, r)) for r in per_rank], dict(zip(names, one)),
            {"idx": idx, "robot": robot, "human": human, "dirs": dirs})


# ---------------------------------------------------------------- (a) helpers

@pytest.mark.parametrize("shape", [(32,), (4, 32), (7,)])
def test_shard_rows_without_a_group_is_the_row(shape):
    idx = torch.arange(int(np.prod(shape))).reshape(shape)
    assert parallel.shard_rows(idx) is idx


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 32, 33, 1000])
@pytest.mark.parametrize("k", [1, 2, 8, 128])
def test_pad_to_multiple_matches_jax(n, k):
    assert parallel.pad_to_multiple(n, k) == jax_pad_to_multiple(n, k)


def test_helpers_without_a_group_are_no_ops():
    t = torch.arange(6.0)
    assert parallel.active() is None and parallel.is_main() and parallel.world_size() == 1
    assert parallel.all_reduce_sum(t) is t and torch.equal(t, torch.arange(6.0))
    assert parallel.all_reduce_max(t) is t and parallel.broadcast(t) is t
    assert parallel.all_reduce_sum_differentiable(t) is t
    parallel.all_reduce_mean_([t])
    assert torch.equal(t, torch.arange(6.0))
    assert parallel.gather_json({"a": [1.5]}) == [{"a": [1.5]}]
    parallel.barrier()
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    parallel.broadcast_module(model)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 3)])
def test_shard_rows_takes_the_ranks_contiguous_share(world, rank):
    """As shard_batch splits a batch over the data axis: rank r of R takes
    rows [r n / R, (r + 1) n / R); the same for each row of a matrix."""
    group = parallel.Group(rank=rank, world_size=world, device=torch.device("cpu"))
    idx = torch.arange(64).reshape(2, 32)
    with parallel.use_group(group):
        got = parallel.shard_rows(idx)
        assert parallel.is_main() == (rank == 0) and parallel.world_size() == world
    share = 32 // world
    assert torch.equal(got, idx[:, rank * share:(rank + 1) * share])
    assert parallel.active() is None


@pytest.mark.parametrize("rows", [10, 33])
def test_a_batch_the_ranks_do_not_divide_raises(rows):
    with parallel.use_group(parallel.Group(rank=0, world_size=4, device=torch.device("cpu"))):
        with pytest.raises(ValueError, match="does not split over 4 ranks"):
            parallel.shard_rows(torch.arange(rows))
        with pytest.raises(ValueError, match="does not split over 4 ranks"):
            require_split(rows, "a microbatch")


@pytest.mark.parametrize("n,world,want", [(47, 2, [(0, 24), (24, 47)]),
                                          (9, 4, [(0, 3), (3, 5), (5, 7), (7, 9)]),
                                          (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)])])
def test_uneven_shares_differ_by_a_row_at_most(n, world, want):
    """A validation batch the ranks do not divide: contiguous shares, the
    first n % R ranks one row more."""
    got = []
    for rank in range(world):
        with parallel.use_group(parallel.Group(rank=rank, world_size=world,
                                               device=torch.device("cpu"))):
            got.append(parallel.share(n, even=False))
            if n % world:
                with pytest.raises(ValueError):
                    parallel.share(n)
    assert got == want


def test_fork_for_rank_keeps_rank_0_and_forks_the_others():
    """Rank 0 and one process go on with the epoch's generator; rank r > 0
    draws from a stream of its own, the same in every run."""
    g = epoch_generator(42, 3, "cpu")
    assert fork_for_rank(g, 42, 3) is g
    draws = {}
    for rank in (0, 1, 2):
        group = parallel.Group(rank=rank, world_size=3, device=torch.device("cpu"))
        with parallel.use_group(group):
            draws[rank] = [torch.rand(4, generator=fork_for_rank(
                epoch_generator(42, 3, "cpu"), 42, 3)) for _ in range(2)]
        assert torch.equal(*draws[rank])
    assert torch.equal(draws[0][0], torch.rand(4, generator=epoch_generator(42, 3, "cpu")))
    assert not torch.equal(draws[0][0], draws[1][0])
    assert not torch.equal(draws[1][0], draws[2][0])


@pytest.mark.parametrize("seeds", [None, 3])
@pytest.mark.parametrize("kind", ["fsq", "lfq", "wide"])
def test_the_code_histogram_counts_what_unique_count_counts(kind, seeds):
    """One process: the histogram count equals the sort count, for bounded
    FSQ's codes (from -(L // 2) per digit), LFQ's 2**10 and a range found
    by code_range."""
    rng = np.random.default_rng(5)
    low, n = {"fsq": (-4 - 2 * 8 - 2 * 40 - 2 * 200, 1000), "lfq": (0, 1024),
              "wide": (None, None)}[kind]
    if kind == "wide":
        codes = torch.as_tensor(rng.integers(-5000, 7000, size=(6, 40)), dtype=torch.int32)
        low, n = code_range(codes)
        assert (low, n) == (int(codes.min()), int(codes.max() - codes.min()) + 1)
    else:
        codes = torch.as_tensor(rng.integers(low, low + n, size=(6, 40)), dtype=torch.int32)
        codes[0, :5] = low
    want = unique_count(codes, seeds)
    got = global_unique_count(codes, low, n, seeds)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- (b)-(d) steps

@pytest.mark.parametrize("case", STEP_CASES)
def test_two_ranks_match_one_process_losses(runs, case):
    ranks, one, _ = runs
    for rank in ranks:
        for got, want in zip(rank[case]["logs"], one[case]["logs"]):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=1e-7,
                                           err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_ranks_match_one_process_gradients(runs, case):
    """The first step's gradient of every trained parameter; the student
    trains the human encoder only."""
    ranks, one, _ = runs
    want = one[case]["grads"]
    assert want and (case != "student" or all(k.startswith("human_encoder.") for k in want))
    for rank in ranks:
        got = rank[case]["grads"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(got[k], w, atol=GRAD_ATOL * (1.0 + scale),
                                       err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_ranks_match_one_process_ema_and_batchnorm_state(runs, case):
    ranks, one, _ = runs
    want = one[case]["state"]
    keys = [k for k in want if k.endswith(STATE_KEYS)]
    if STEP_CASES[case][1] in ("hybrid", "ema"):
        assert any("ema_w" in k for k in keys)
    if STEP_CASES[case][0] == "resnet_no_down":
        assert any("running_var" in k for k in keys)
    for k in keys:
        np.testing.assert_allclose(ranks[0][case]["state"][k], want[k], atol=STATE_ATOL,
                                   err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", [*STEP_CASES, "dropout"])
def test_parameters_are_bit_equal_on_every_rank(runs, case):
    ranks, _, _ = runs
    a, b = ranks[0][case]["state"], ranks[1][case]["state"]
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{case} {k}"


def test_dropout_draws_differ_between_ranks(runs):
    """At dropout 0.1 rank 1 draws from its own stream: other K1 seeds, and
    so other keep masks; the losses stay finite."""
    ranks, _, _ = runs
    s0, s1 = ranks[0]["dropout"]["k1_seeds"], ranks[1]["dropout"]["k1_seeds"]
    assert len(s0) == len(s1) > 0 and s0 != s1
    assert all(np.isfinite(l["train_loss"]) for r in ranks for l in r["dropout"]["logs"])


# ---------------------------------------------------------------- Trainer

def test_trainer_on_two_ranks_matches_one_process(runs):
    """Histories (train and validation metrics: perplexity, DCR, rvq_ppl
    from batch-global counts) and the `_last` weights; the same files."""
    ranks, one, _ = runs
    want = one["trainer"]
    for rank in ranks:
        got = rank["trainer"]
        assert got["files"] == want["files"]
        for seed, hist in want["history"].items():
            for k, v in hist.items():
                np.testing.assert_allclose(got["history"][seed][k], v, rtol=LOSS_RTOL,
                                           atol=1e-6, err_msg=k)
        assert len(want["history"][42]["perplexity"]) == 2
        for k, v in want["last"].items():
            # Adam turns rounding residue into steps of at most lr: 4 steps
            atol = STATE_ATOL if k.endswith(STATE_KEYS) else 2 * 4 * TF_LR
            np.testing.assert_allclose(got["last"][k], v, atol=atol, err_msg=k)


# ---------------------------------------------------------------- (e) multiseed

def test_multiseed_splits_the_seeds_over_the_ranks(runs):
    """Four seeds, two a rank: every seed's history on both ranks, within
    5e-4 relative of one stacked process, and every seed's files."""
    ranks, one, meta = runs
    for rank in ranks:
        assert list(rank["multiseed"]) == [3, 5, 7, 9]
        for seed, hist in one["multiseed"].items():
            for k in ("train_loss", "val_recon", "perplexity", "rvq_ppl"):
                np.testing.assert_allclose(rank["multiseed"][seed][k], hist[k],
                                           rtol=MULTISEED_RTOL, atol=1e-6, err_msg=f"{seed} {k}")
    files = os.listdir(os.path.join(meta["dirs"]["ranks"]["multiseed"], "checkpoints"))
    assert sorted(files) == sorted(os.listdir(
        os.path.join(meta["dirs"]["one"]["multiseed"], "checkpoints")))


def test_multiseed_seeds_the_ranks_do_not_divide_stay_on_rank_0(runs):
    ranks, one, _ = runs
    assert ranks[1]["unsplit"] == {}
    for seed, hist in one["unsplit"].items():
        np.testing.assert_allclose(ranks[0]["unsplit"][seed]["train_loss"],
                                   hist["train_loss"], rtol=MULTISEED_RTOL)


# ---------------------------------------------------------------- (f) JAX

def test_two_ranks_match_the_jax_epoch(runs, jax_start):
    """The same weights and index matrix through JAX's make_train_epoch,
    over the eight virtual devices' data mesh where they exist: the port's
    two-rank losses within 2e-4 relative, its EMA state within 2e-3."""
    ranks, _, meta = runs
    exp, jmodel, variables, _ = jax_start
    params, rest = split_variables(variables)
    tx = jax_make_optimizer(exp, params)
    state = TrainState(params, rest, tx.init(params))
    mesh = make_mesh() if len(jax.devices()) >= 8 else None
    jfn = jax_make_train_epoch(jmodel, tx, exp, mesh=mesh)
    idx = meta["idx"]
    for step in range(STEPS):
        state, jlogs = jfn(state, meta["robot"], meta["human"], idx[step:step + 1],
                           jax.random.split(jax.random.key(step), 1))
        for k, v in jlogs.items():
            np.testing.assert_allclose(ranks[0]["transformer-hybrid"]["logs"][step][k],
                                       float(v), rtol=LOSS_RTOL, err_msg=f"{step} {k}")
    texp = cases.experiment("transformer", "hybrid", TF)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()),
                               texp.model)
    got = ranks[0]["transformer-hybrid"]["state"]
    keys = [k for k in want if k.endswith(("ema_w", "ema_cluster_size"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=STATE_ATOL, err_msg=k)


# ---------------------------------------------------------------- (g) failure, CLI

def test_a_failing_rank_fails_the_launch_naming_it():
    t0 = time.monotonic()
    with pytest.raises(parallel.RankFailure, match="rank 1 of 2 failed") as err:
        parallel.launch(cases.fails_on_rank_1, 2, "gloo", device="cpu", timeout=60)
    assert "rank 1 fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < 60


def test_a_hung_rank_fails_the_launch_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(parallel.RankFailure, match=r"rank\(s\) \[0, 1\] of 2 did not finish"):
        parallel.launch(cases.hangs, 2, "gloo", device="cpu", timeout=3)
    assert time.monotonic() - t0 < 3 + parallel.mesh.TERMINATE_GRACE_S + 10


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_a_launch_without_the_cpu_asked_for_runs_on_the_card_or_raises(backend):
    """The port's device rule: a rank runs on the card unless the caller
    asks for the CPU; without a card the launch raises, nothing falls back."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, parallel.RankFailure), match="CUDA is not available"):
        parallel.launch(cases.hangs, 2, backend, timeout=60)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("device,want", [("cpu", "cpu"), (None, "cuda"), ("cuda", "cuda")])
def test_a_gloo_rank_takes_the_cpu_only_when_asked(device, want):
    if want == "cpu":
        assert parallel.mesh.rank_device("gloo", 1, device) == torch.device("cpu")
    elif torch.cuda.is_available():
        got = parallel.mesh.rank_device("gloo", 1, device)
        assert got == torch.device("cuda", 1 % torch.cuda.device_count())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parallel.mesh.rank_device("gloo", 1, device)


def test_cli_data_parallel_joins_a_rendezvous_from_the_environment(tmp_path, monkeypatch):
    """Two train_ablation processes with RANK / WORLD_SIZE set train one
    data-parallel run on the CPU: the batch scaled by 2, rank 0's files and
    lines only."""
    from bridgerl_tpu_torch.cli import process_data

    monkeypatch.chdir(tmp_path)
    assert process_data.main(["--synthetic", "--window", "10", "--step", "2",
                              "--n_sequences", "2"]) == 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = [sys.executable, "-m", "bridgerl_tpu_torch.cli.train_ablation", "--data_parallel",
            "--device", "cpu", "--arch", "resnet_no_down", "--method", "ema", "--window", "10",
            "--hidden_dim", "16", "--batch_size", "64", "--epochs", "1", "--seed", "42"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1", PYTHONPATH=repo)
        procs.append(subprocess.Popen(args, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "Data-parallel over 2 devices; scaling batch size to 128" in outs[0][0]
    assert "Success: Exp_resnet_no_down_W10 | Mode: teacher | Seed: 42" in outs[0][0]
    assert "Success" not in outs[1][0] and "Data-parallel" not in outs[1][0]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        f"Exp_resnet_no_down_W10_ema_teacher_seed_42_{k}.pth" for k in ("best", "final", "last")]
