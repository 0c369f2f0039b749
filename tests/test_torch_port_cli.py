"""The port's command-line drive on the CPU (``--device cpu``, tiny sizes):
``process_data --synthetic``, a teacher for 2 epochs and a student for 1
(``resnet_no_down``, ``ae``, hidden 16) through ``train_ablation``, with the
reference's file names; the teacher's ``.pth`` read by the JAX package's
``import_torch_checkpoint`` gives the port's outputs within 1e-5;
``--multiseed`` with several seeds, ``--lambda_fk`` and ``--int8_ff`` train
(the stacked trainer, the FK term, the int8 feed-forward) and build the JAX
CLI's config; ``--prng``, which the port does not run, exits non-zero
naming ROADMAP.md; ``--data_parallel`` over two cards that its ranks do not
find exits non-zero naming the rank."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from bridgerl_tpu.export.torch_import import import_torch_checkpoint
from bridgerl_tpu.models import init_model as jax_init_model
from bridgerl_tpu_torch.cli import process_data, train_ablation
from bridgerl_tpu_torch.config import HISTORY_KEYS
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.train.checkpoint import load_checkpoint

RUN = ["--arch", "resnet_no_down", "--method", "ae", "--window", "10", "--hidden_dim", "16",
       "--batch_size", "256", "--seed", "42", "--device", "cpu"]
TEACHER = "checkpoints/Exp_resnet_no_down_W10_ae_teacher_seed_42_best.pth"


def test_cli_teacher_then_student_and_the_jax_import(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert process_data.main(["--synthetic", "--window", "10", "--step", "2",
                              "--n_sequences", "2"]) == 0
    assert sorted(os.listdir("data/processed")) == sorted(
        ["g1_train.npy", "human_train.npy", "g1_train_full_raw.npy", "mean.npy", "std.npy",
         "human_mean.npy", "human_std.npy"])
    assert train_ablation.main(RUN + ["--epochs", "2"]) == 0
    assert train_ablation.main(RUN + ["--epochs", "1", "--mode", "student",
                                      "--teacher_ckpt", TEACHER]) == 0
    out = capsys.readouterr().out
    assert "Success: Exp_resnet_no_down_W10 | Mode: student | Seed: 42" in out
    assert sorted(os.listdir("checkpoints")) == sorted(
        f"Exp_resnet_no_down_W10_ae_{m}_seed_42_{k}.pth"
        for m in ("teacher", "student") for k in ("best", "last", "final"))
    with open("results/log_resnet_no_down_ae_seed_42.json") as f:
        hist = json.load(f)
    assert sorted(hist) == sorted(HISTORY_KEYS) and len(hist["train_loss"]) == 2
    assert all(np.isfinite(hist["train_loss"]))
    with open("results/log_resnet_no_down_ae_student_seed_42.json") as f:
        assert len(json.load(f)["val_align"]) == 1

    ck = load_checkpoint(TEACHER)
    model = init_model(ck["config"].model, 0, device="cpu")
    model.load_state_dict(ck["model_state_dict"], strict=True)
    jexp, jvars, meta = import_torch_checkpoint(
        torch.load(TEACHER, map_location="cpu", weights_only=True))
    assert (jexp.model.arch, jexp.model.method, jexp.model.window_size) == (
        "resnet_no_down", "ae", 10)
    jmodel, _ = jax_init_model(jexp.model, jax.random.key(0))
    rng = np.random.default_rng(0)
    xr = rng.normal(size=(8, 10, 29)).astype(np.float32)
    xh = rng.normal(size=(8, 10, 126)).astype(np.float32)
    ref = jmodel.apply(jvars, x_robot=xr, x_human=xh, train=False)
    with torch.no_grad():
        got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh))
    for branch, key in (("robot", "recon"), ("human", "retargeted")):
        np.testing.assert_allclose(got[branch][key].numpy(), np.asarray(ref[branch][key]),
                                   atol=1e-5, err_msg=branch)


@pytest.mark.parametrize("flags", [["--prng", "rbg"]],
                         ids=lambda f: f[0].strip("-"))
def test_unported_flags_exit_non_zero(flags, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert train_ablation.main(flags + ["--device", "cpu"]) != 0
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not os.path.exists("checkpoints")


def test_data_parallel_over_several_cards_exits(monkeypatch, capsys):
    """With two cards visible --data_parallel launches one NCCL rank a card
    and scales the batch; here the ranks find no card, and the run exits
    non-zero naming the failed rank (nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert train_ablation.main(["--data_parallel"]) != 0
    captured = capsys.readouterr()
    assert "Data-parallel over 2 devices; scaling batch size to 512" in captured.out
    assert "of 2 failed" in captured.err and "CUDA is not available" in captured.err


def test_no_card_without_device_cpu_exits(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_ablation.main(["--window", "10"]) != 0
    assert "device='cpu'" in capsys.readouterr().err


def test_flags_build_the_jax_cli_config():
    """The flags give the JAX CLI's ExperimentConfig, with --ref_exact and
    the single-flag arms applied the same way."""
    from bridgerl_tpu.config import make_experiment as jax_make_experiment
    from bridgerl_tpu.config import ref_exact as jax_ref_exact

    p = train_ablation.build_parser()
    args = p.parse_args(["--arch", "resnet", "--method", "lfq", "--bf16", "--no-lfq_norm",
                         "--accum_chunks", "2", "--lr", "1e-3"])
    exp = train_ablation.make_exp(args, 29, 126)
    want = jax_make_experiment("resnet", "lfq", window=64, mode="teacher", seeds=(42,),
                               epochs=400, batch_size=256, patience=-1, resume=False,
                               teacher_ckpt=None, save_every=1, learning_rate=1e-3,
                               hidden_dim=64, tf_tokens=1, attn_packing=1, accum_chunks=2,
                               fused_attention=False, entropy_loss_weight=0.1,
                               human_input_dim=126, robot_input_dim=29,
                               compute_dtype="bfloat16", lfq_norm=False)
    assert exp.to_json() == want.to_json()
    args = p.parse_args(["--arch", "simple", "--method", "ema", "--ref_exact"])
    ours = train_ablation.make_exp(args, 29, 126)
    assert ours.model.torch_init and not ours.model.ema_warm_start and ours.train.ref_exact_vel
    assert ours.to_json() == jax_ref_exact(jax_make_experiment(
        "simple", "ema", window=64, epochs=400, batch_size=256,
        human_input_dim=126, robot_input_dim=29)).to_json()
    args = p.parse_args(["--no-torch_init", "--cold_ema", "--no-ref_exact_vel"])
    arm = train_ablation.make_exp(args, 29, 126)
    assert (arm.model.torch_init, arm.model.ema_warm_start, arm.train.ref_exact_vel) == (
        False, False, False)


def test_module_entry_points_run_as_python_m(tmp_path):
    """``python -m`` runs both entry points with the repository on
    PYTHONPATH: process_data writes its artifacts, and an unported training
    flag stops before any work. (The modules load no JAX:
    test_torch_port_imports.py.)"""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    run = lambda *args: subprocess.run([sys.executable, "-m", *args], cwd=tmp_path, env=env,
                                       capture_output=True, text=True, timeout=120)
    r = run("bridgerl_tpu_torch.cli.process_data", "--synthetic", "--window", "8",
            "--n_sequences", "2")
    assert r.returncode == 0, r.stderr
    assert os.path.exists(tmp_path / "data" / "processed" / "g1_train.npy")
    r = run("bridgerl_tpu_torch.cli.train_ablation", "--prng", "rbg")
    assert r.returncode == 2 and "ROADMAP.md" in r.stderr


def test_multiseed_fk_and_int8_flags_build_the_jax_cli_config():
    from bridgerl_tpu.config import make_experiment as jax_make_experiment

    args = train_ablation.build_parser().parse_args(
        ["--arch", "transformer", "--method", "hybrid", "--multiseed", "--seed", "1", "2", "3",
         "--lambda_fk", "1.5", "--int8_ff"])
    exp = train_ablation.make_exp(args, 29, 126)
    assert train_ablation.unported(args) is None
    want = jax_make_experiment("transformer", "hybrid", window=64, mode="teacher",
                               seeds=(1, 2, 3), epochs=400, batch_size=256, patience=-1,
                               resume=False, teacher_ckpt=None, save_every=1,
                               learning_rate=2e-4, hidden_dim=64, lambda_fk=1.5, tf_tokens=1,
                               attn_packing=1, accum_chunks=1, fused_attention=False,
                               int8_ff=True, entropy_loss_weight=0.1, human_input_dim=126,
                               robot_input_dim=29)
    assert exp.to_json() == want.to_json()


@pytest.fixture()
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    torch's default of one thread a core oversubscribes it (tens of times
    slower for the full-width model of the test below)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_multiseed_with_fk_and_int8(tmp_path, monkeypatch, capsys, one_torch_thread):
    """--multiseed --seed 1 2 --lambda_fk 1 --int8_ff trains both seeds as one
    stacked model, then the student from a {seed} teacher pattern: each
    seed's files, with other weights per seed."""
    monkeypatch.chdir(tmp_path)
    assert process_data.main(["--synthetic", "--window", "10", "--step", "10",
                              "--n_sequences", "2"]) == 0
    run = ["--arch", "transformer", "--method", "hybrid", "--window", "10", "--hidden_dim",
           "16", "--batch_size", "64", "--device", "cpu", "--multiseed", "--seed", "1", "2",
           "--int8_ff", "--epochs", "1"]
    assert train_ablation.main(run + ["--lambda_fk", "1"]) == 0
    pattern = "checkpoints/Exp_transformer_W10_hybrid_teacher_seed_{seed}_best.pth"
    assert train_ablation.main(run + ["--mode", "student", "--teacher_ckpt", pattern]) == 0
    out = capsys.readouterr().out
    assert out.count("Multi-seed: Exp_transformer_W10 x 2 seeds") == 2
    for mode in ("teacher", "student"):
        finals = [load_checkpoint(f"checkpoints/Exp_transformer_W10_hybrid_{mode}_seed_{s}"
                                  f"_final.pth")["model_state_dict"] for s in (1, 2)]
        key = "human_encoder.input_proj.weight"
        assert not torch.equal(finals[0][key], finals[1][key])
        for s in (1, 2):
            assert f"Success: Exp_transformer_W10 | Mode: {mode} | Seed: {s}" in out
            with open(f"results/log_Exp_transformer_W10_{mode}_seed_{s}.json") as f:
                hist = json.load(f)
            assert sorted(hist) == sorted(HISTORY_KEYS)
            assert np.isfinite(hist["train_loss"]).all() and len(hist["train_loss"]) == 1
    ck = load_checkpoint("checkpoints/Exp_transformer_W10_hybrid_teacher_seed_2_last.pth")
    assert ck["config"].train.lambda_fk == 1.0 and ck["config"].model.int8_ff
