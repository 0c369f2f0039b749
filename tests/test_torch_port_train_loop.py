"""The port's train step, checkpoints and Trainer on the CPU.

- ``make_train_epoch`` against the JAX package's for a teacher and a student:
  three optimizer steps of two microbatches, dropout 0, the same index
  matrix fed to both sides (``jax.random`` shuffles cannot be matched).
  Per-step losses within 1e-5 relative; final parameters and EMA state as
  stated in the test.
- A ``.pth`` the port writes, read by the JAX package's
  ``import_torch_checkpoint``, gives the same forward within 1e-5.
- The ``Trainer``: teacher then student, the reference's file names, the
  history schema, resume and early stopping.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from bridgerl_tpu.export.torch_import import import_torch_checkpoint
from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import make_optimizer as jax_make_optimizer
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch.config import HISTORY_KEYS, make_experiment
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.data.dataset import PairedDataset
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.train import checkpoint
from bridgerl_tpu_torch.train import trainer as trainer_mod
from bridgerl_tpu_torch.train.trainer import Trainer, make_optimizer, make_train_epoch

from test_torch_port_train_ops import TRAIN_SMALL, fresh_pair

BATCH, STEPS = 32, 3


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 10, 29)).astype(np.float32),
            rng.normal(size=(n, 10, 126)).astype(np.float32))


@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_train_epoch_matches_jax(mode):
    """Losses 1e-5 relative per step. Parameters 1e-5 absolute, a 60th of
    what 3 Adam steps can move them (Adam's update is about lr * g / |g|, so
    an element with a small gradient turns a few ulps of difference in g
    into a visible one), except the key rows of each in_proj: softmax ignores a shift of a row's logits, so
    the key bias has a true gradient of exactly 0, and the key weight of the
    decoder's first block (whose 10 frames share one latent and differ only
    by the positional table) nearly so. Adam divides such a gradient, a
    rounding residue, by its own RMS, so its update is of order lr with a
    sign that is noise: those rows are held at 2 * 3 * lr, the gap between
    two runs that each move them by at most lr a step, in opposite
    directions. EMA state 1e-5 relative (and 1e-6 absolute)."""
    over = dict(mode=mode, dropout=0.0, batch_size=BATCH, accum_chunks=2)
    exp, jmodel, variables, texp, model = fresh_pair(**over)
    robot, human = _windows(BATCH * STEPS)
    idx = np.random.default_rng(1).permutation(BATCH * STEPS).reshape(STEPS, BATCH)

    params, rest = split_variables(variables)
    tx = jax_make_optimizer(exp, params)
    state = TrainState(params, rest, tx.init(params))
    jfn = jax_make_train_epoch(jmodel, tx, exp, mesh=None)
    opt = make_optimizer(model, texp)
    tfn = make_train_epoch(texp)
    tr, th = torch.from_numpy(robot), torch.from_numpy(human)
    for step in range(STEPS):
        state, jlogs = jfn(state, robot, human, idx[step:step + 1],
                           jax.random.split(jax.random.key(step), 1))
        logs = tfn(model, opt, tr, th, torch.from_numpy(idx[step:step + 1]), None)
        assert sorted(logs) == sorted(jlogs)
        for k, v in jlogs.items():
            np.testing.assert_allclose(logs[k], float(v), rtol=1e-5, err_msg=f"{step} {k}")

    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()),
                               texp.model)
    got = model.state_dict()
    lr = texp.train.learning_rate
    for name, w in want.items():
        g = got[name].numpy()
        w = w.numpy()
        if name.endswith(("in_proj_bias", "in_proj_weight")):
            d = w.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d], atol=2 * STEPS * lr,
                                       err_msg=name)
            g, w = (np.delete(a, np.s_[d:2 * d], axis=0) for a in (g, w))
        if "quantizer.vq" in name:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    if mode == "student":
        init = fresh_pair(**over)[4].state_dict()
        for name, p in model.named_parameters():
            if not name.startswith("human_encoder."):
                assert torch.equal(p.detach(), init[name]), name


def _exp(tmp_path, **over):
    kw = {**TRAIN_SMALL, "batch_size": 32, "accum_chunks": 2, "epochs": 2, **over}
    exp = make_experiment("transformer", "hybrid", **kw)
    return dataclasses.replace(exp, log_dir=str(tmp_path / "results"),
                               checkpoint_dir=str(tmp_path / "checkpoints"))


def _dataset(n=110):
    return PairedDataset.from_numpy(*_windows(n, seed=3), device="cpu")


def test_port_checkpoint_imports_into_the_jax_package(tmp_path):
    """The `_best.pth` and the bare `_final.pth` load through
    import_torch_checkpoint; the JAX forward of the imported weights equals
    the port's forward of the file within 1e-5."""
    exp = _exp(tmp_path, epochs=1)
    trainer = Trainer(exp, device="cpu", verbose=False)
    trainer.run(_dataset())
    xr, xh = _windows(8, seed=9)
    for kind in ("best", "final"):
        path = trainer.ckpt_path(42, kind)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        jexp, jvars, meta = import_torch_checkpoint(
            {k: v for k, v in payload.items()}, window=10,
            overrides={"n_heads": 2, "attn_packing": 2, "fsq_bounded": True})
        from bridgerl_tpu.models import init_model as jax_init_model
        jmodel, _ = jax_init_model(jexp.model, jax.random.key(0))
        ref = jmodel.apply(jvars, x_robot=xr, x_human=xh, train=False)
        model = init_model(exp.model, 0, device="cpu")
        model.load_state_dict(checkpoint.load_checkpoint(path)["model_state_dict"])
        with torch.no_grad():
            got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh))
        for branch, key in (("robot", "recon"), ("human", "retargeted")):
            np.testing.assert_allclose(got[branch][key].numpy(), np.asarray(ref[branch][key]),
                                       atol=1e-5, err_msg=f"{kind} {branch}")
        if kind == "best":
            assert sorted(payload) == ["best_loss", "config", "config_json", "epoch",
                                       "model_state_dict", "optimizer_state_dict",
                                       "patience_counter"]
            assert payload["config"]["mode"] == "teacher" and meta["epoch"] == 0
            assert payload["model_state_dict"]["quantizer.fsq.project_in.weight"].ndim == 3


def test_trainer_teacher_then_student(tmp_path):
    ds = _dataset()
    teacher = Trainer(_exp(tmp_path), device="cpu", verbose=False)
    hist = teacher.run(ds)[42]
    assert sorted(hist) == sorted(HISTORY_KEYS)
    assert len(hist["train_loss"]) == 2 and all(np.isfinite(hist["train_loss"]))
    assert hist["val_cross_recon"] == [] and len(hist["rvq_ppl"]) == 2
    assert [w for _, w, _ in teacher.train_seconds] == [96, 96]   # 3 batches of 32

    student_exp = _exp(tmp_path, mode="student", epochs=1,
                       teacher_ckpt=str(tmp_path / "checkpoints" /
                                        "Exp_transformer_W10_hybrid_teacher_seed_{seed}_best.pth"))
    student = Trainer(student_exp, device="cpu", verbose=False)
    shist = student.run(ds)[42]
    assert len(shist["val_align"]) == 1 and len(shist["val_cross_recon"]) == 1
    names = sorted(os.listdir(tmp_path / "checkpoints"))
    assert names == sorted(f"Exp_transformer_W10_hybrid_{m}_seed_42_{k}.pth"
                           for m in ("teacher", "student") for k in ("best", "last", "final"))
    assert sorted(os.listdir(tmp_path / "results")) == [
        "log_Exp_transformer_W10_student_seed_42.json",
        "log_Exp_transformer_W10_teacher_seed_42.json",
        "log_transformer_hybrid_seed_42.json", "log_transformer_hybrid_student_seed_42.json"]
    # the student started from the teacher minus its human encoder
    t_sd = checkpoint.load_checkpoint(teacher.ckpt_path(42, "final"))["model_state_dict"]
    s_sd = checkpoint.load_checkpoint(student.ckpt_path(42, "final"))["model_state_dict"]
    for k in t_sd:
        if k.split(".")[0] in ("robot_encoder", "robot_decoder") or "fsq" in k:
            assert torch.equal(t_sd[k], s_sd[k]), k


def test_student_needs_a_teacher(tmp_path):
    with pytest.raises(ValueError, match="teacher_ckpt"):
        Trainer(_exp(tmp_path, mode="student"), device="cpu", verbose=False).run(_dataset())


def test_trainer_resumes_where_it_stopped(tmp_path):
    ds = _dataset()
    first = Trainer(_exp(tmp_path, epochs=2), device="cpu", verbose=False).run(ds)[42]
    resumed = Trainer(_exp(tmp_path, epochs=3, resume=True), device="cpu", verbose=False)
    hist = resumed.run(ds)[42]
    assert [e for e, _, _ in resumed.train_seconds] == [2]
    assert hist["train_loss"][:2] == first["train_loss"] and len(hist["train_loss"]) == 3
    with open(tmp_path / "results" / "log_transformer_hybrid_seed_42.json") as f:
        assert json.load(f)["train_loss"] == hist["train_loss"]
    assert checkpoint.load_checkpoint(resumed.ckpt_path(42, "last"))["epoch"] == 2


def test_trainer_stops_early(tmp_path, monkeypatch):
    """A validation loss that never improves after epoch 0 stops the run
    after `patience` more epochs."""
    monkeypatch.setattr(trainer_mod, "eval_epoch",
                        lambda *a, **k: {"val_recon": 1.0, "dcr": 0.0})
    trainer = Trainer(_exp(tmp_path, epochs=10, patience=2), device="cpu", verbose=False)
    hist = trainer.run(_dataset())[42]
    assert len(hist["train_loss"]) == 3
    ck = checkpoint.load_checkpoint(trainer.ckpt_path(42, "last"))
    assert ck["patience_counter"] == 2 and ck["best_loss"] == 1.0


def test_merge_and_mask_follow_the_human_encoder():
    model = init_model(make_experiment("transformer", "hybrid", **TRAIN_SMALL).model, 0,
                       device="cpu")
    mask = checkpoint.trainable_mask(model, "student")
    assert mask and all(v == k.startswith("human_encoder.") for k, v in mask.items())
    assert all(checkpoint.trainable_mask(model, "teacher").values())
    s = {"human_encoder.a": torch.zeros(1), "robot_encoder.a": torch.zeros(1)}
    t = {"human_encoder.a": torch.ones(1), "robot_encoder.a": torch.ones(1)}
    merged = checkpoint.merge_teacher_into_student(s, t)
    assert merged["human_encoder.a"].item() == 0 and merged["robot_encoder.a"].item() == 1
    assert checkpoint.resolve_teacher_ckpt("t_{seed}.pth", 3) == "t_3.pth"
