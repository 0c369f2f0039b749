"""Several seeds trained as one stacked model (``train/multiseed.py``,
``models/stacked.py``) against the JAX package's vmapped epoch and the
port's own sequential ``Trainer``.

- seed i of the stacked init is ``init_model(seed_i)`` exactly;
- one stacked optimizer step (2 microbatches, dropout 0, index matrices
  passed in) against ``jax.vmap(make_train_epoch(..., jit=False))`` per
  seed, for the flagship (transformer + hybrid) and a conv arch with
  BatchNorm (resnet + ema): logs within 1e-5 relative, gradients (read from
  Adam's first moment) within 1e-4 in relative norm, EMA and BatchNorm state
  within 1e-5 relative and 1e-6 absolute (the zoo tests' tolerances; biases
  that feed a BatchNorm and the key rows of in_proj have a true gradient of
  0 and are held at 1e-5 of the largest gradient norm);
- ``MultiSeedTrainer`` against the sequential ``Trainer`` per seed, at
  dropout 0 and 0.1 (each seed's dropout draws are its own generator's, in
  the sequential order): histories within 1e-5 relative (1e-4 for the conv
  arch, whose grouped convolutions sum in another order), final weights
  within 2 * steps * lr absolute (Adam turns rounding residue into steps of
  at most lr);
- the grouped plain K1 (each group's mask, forward and backward that of a
  call of its own) and K2 (each group's dw bit-equal to
  ``assignment_stats``);
- resume, the partial-resume error, the student with ``{seed}`` and shared
  teachers, the reference's file names, and the stop when every seed has
  stalled.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.models import DualMotionVQVAE as JaxModel
from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import make_optimizer as jax_make_optimizer
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch.config import ExperimentConfig, make_experiment
from bridgerl_tpu_torch.convert import (
    state_dict_from_jax,
    state_dicts_from_stacked_jax,
    stacked_state_dict_from_jax,
)
from bridgerl_tpu_torch.data.dataset import PairedDataset
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models.stacked import (
    seed_optimizer_state,
    seed_state_dict,
    stack_models,
    stack_optimizer_states,
)
from bridgerl_tpu_torch.ops import attention, codebook
from bridgerl_tpu_torch.train import checkpoint
from bridgerl_tpu_torch.train import multiseed as ms
from bridgerl_tpu_torch.train.trainer import Trainer, make_optimizer

from test_torch_port_zoo import jax_tree

SEEDS = (3, 5)
B1 = 0.9
FLAGSHIP = dict(window=10, hidden_dim=16, d_model=32, n_tf_layers=2, n_heads=2, ff_dim=64,
                attn_packing=2)
CONV = dict(window=8, hidden_dim=16, codebook_size=32, num_res_layers=1)
CASES = {"transformer-hybrid": ("transformer", "hybrid", FLAGSHIP),
         "resnet-ema": ("resnet", "ema", CONV)}



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    torch's default of one thread a core oversubscribes it (tens of times
    slower for these small models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n, W, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, W, 29)).astype(np.float32),
            rng.normal(size=(n, W, 126)).astype(np.float32))


def _stacked(exp, seeds=SEEDS):
    return stack_models([init_model(exp.model, s, device="cpu") for s in seeds])


@pytest.mark.parametrize("case", CASES)
def test_stacked_init_is_each_seeds_init(case):
    arch, method, kw = CASES[case]
    exp = make_experiment(arch, method, **kw)
    model = _stacked(exp)
    assert all(m.stacked_seeds == len(SEEDS) for m in model.modules())
    for i, s in enumerate(SEEDS):
        want = init_model(exp.model, s, device="cpu").state_dict()
        got = seed_state_dict(model.state_dict(), i)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", CASES)
def test_stacked_step_matches_jax_vmapped_epoch(case):
    arch, method, kw = CASES[case]
    S, batch = len(SEEDS), 8
    W = kw["window"]
    exp = jax_make_experiment(arch, method, **kw, dropout=0.0, batch_size=batch,
                              accum_chunks=2)
    texp = ExperimentConfig.from_json(exp.to_json())
    jmodel = JaxModel(exp.model)
    trees = [jax.tree_util.tree_map(np.asarray, jax_tree(exp, seed=10 + i)) for i in range(S)]
    states = []
    for tree in trees:
        params, rest = split_variables(tree)
        tx = jax_make_optimizer(exp, params)
        states.append(TrainState(params, rest, tx.init(params)))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    robot, human = _windows(40, W, 1)
    rng = np.random.default_rng(2)
    idx = np.stack([rng.permutation(40)[:batch][None] for _ in range(S)])   # (S, 1, batch)
    epoch = jax.vmap(jax_make_train_epoch(jmodel, tx, exp, None, jit=False),
                     in_axes=(0, None, None, 0, 0))
    stacked, jlogs = epoch(stacked, robot, human, idx,
                           jnp.stack([jax.random.split(jax.random.key(i), 1) for i in range(S)]))

    model = stack_models([init_model(texp.model, 0, device="cpu") for _ in range(S)])
    model.load_state_dict(stacked_state_dict_from_jax(
        jax.tree_util.tree_map(lambda *x: np.stack(x), *trees), texp.model, S), strict=True)
    opt = make_optimizer(model, texp)
    logs = ms.make_stacked_train_epoch(texp)(model, opt, torch.from_numpy(robot),
                                             torch.from_numpy(human), torch.from_numpy(idx),
                                             None)
    assert sorted(logs) == sorted(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], np.asarray(v), rtol=1e-5, err_msg=k)

    after = jax.tree_util.tree_map(np.asarray, stacked.variables())
    mu = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1), stacked.opt_state[0].mu)
    jgrads = state_dicts_from_stacked_jax({**after, "params": mu}, texp.model, S)
    jstates = state_dicts_from_stacked_jax(after, texp.model, S)
    state = model.state_dict()
    for i in range(S):
        grads = {n: p.grad[i].numpy() for n, p in model.named_parameters()}
        largest = max(np.linalg.norm(jgrads[i][n].numpy()) for n in grads)
        for name, g in grads.items():
            w = jgrads[i][name].numpy()
            if name.endswith(("in_proj_bias", "in_proj_weight")):
                d = w.shape[0] // 3
                assert np.linalg.norm(g[d:2 * d] - w[d:2 * d]) <= 1e-5 * largest, name
                g, w = (np.delete(a, np.s_[d:2 * d], axis=0) for a in (g, w))
            if ".net.0.bias" in name or ".net.3.bias" in name:   # feeds a BatchNorm
                assert max(np.linalg.norm(g), np.linalg.norm(w)) <= 1e-5 * largest, name
                continue
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= 1e-4, f"seed {i} {name}: {rel}"
        checked = 0
        for name, w in jstates[i].items():
            if any(t in name for t in ("running_", "ema_", "embedding")):
                np.testing.assert_allclose(state[name][i].numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=f"seed {i} {name}")
                checked += 1
        assert checked > 0


def _exp(tmp_path, name, arch="transformer", method="hybrid", kw=FLAGSHIP, **over):
    exp = make_experiment(arch, method, **{**kw, "batch_size": 16, "accum_chunks": 2,
                                           "epochs": 2, "seeds": SEEDS, **over})
    return dataclasses.replace(exp, log_dir=str(tmp_path / name / "results"),
                               checkpoint_dir=str(tmp_path / name / "checkpoints"))


def _ds(W=10, n=60):
    return PairedDataset.from_numpy(*_windows(n, W, 4), device="cpu")


@pytest.mark.parametrize("case,dropout", [("transformer-hybrid", 0.0),
                                          ("transformer-hybrid", 0.1), ("resnet-ema", 0.0)])
def test_multiseed_trainer_matches_sequential_trainer(tmp_path, case, dropout):
    arch, method, kw = CASES[case]
    over = dict(arch=arch, method=method, kw=kw, dropout=dropout)
    ds = _ds(kw["window"])
    stacked = ms.MultiSeedTrainer(_exp(tmp_path, "m", **over), device="cpu", verbose=False)
    hm = stacked.run(ds)
    seq = Trainer(_exp(tmp_path, "s", **over), device="cpu", verbose=False)
    hs = seq.run(ds)
    rtol = 1e-5 if arch == "transformer" else 1e-4
    steps = 2 * (int(0.9 * 60) // 16)
    for s in SEEDS:
        for k in ("train_loss", "train_recon_loss", "train_vq_loss", "val_loss", "val_recon",
                  "perplexity", "dcr"):
            np.testing.assert_allclose(hm[s][k], hs[s][k], rtol=rtol, atol=1e-7,
                                       err_msg=f"{s} {k}")
        got = checkpoint.load_checkpoint(stacked.ckpt_path(s, "final"))["model_state_dict"]
        want = checkpoint.load_checkpoint(seq.ckpt_path(s, "final"))["model_state_dict"]
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=2 * steps * 2e-4, err_msg=k)


def test_grouped_plain_k1_is_each_group_on_its_own():
    g = torch.Generator().manual_seed(0)
    BH, S, W, Dh, G = 12, 20, 10, 16, 3
    q, k, v, do = (torch.randn(BH, S, Dh, generator=g) for _ in range(4))
    from bridgerl_tpu_torch.models.layers import attention_bias
    bias = attention_bias(2, W)
    seeds = torch.tensor([7, 123456, 99], dtype=torch.int32)
    out = attention.attention_fwd(q, k, v, bias, 0.25, seeds, 0.1, W)
    grads = attention.attention_bwd(q, k, v, bias, do, 0.25, seeds, 0.1, W)
    mask = attention.window_dropout_mask(seeds, BH, S, W, 0.1)
    n = BH // G
    for i in range(G):
        r = slice(i * n, (i + 1) * n)
        one = seeds[i:i + 1]
        assert torch.equal(mask[r], attention.window_dropout_mask(int(seeds[i]), n, S, W, 0.1))
        assert torch.equal(out[r], attention.attention_fwd(q[r], k[r], v[r], bias, 0.25, one,
                                                           0.1, W))
        for a, b in zip(grads, attention.attention_bwd(q[r], k[r], v[r], bias, do[r], 0.25, one,
                                                       0.1, W)):
            assert torch.equal(a[r], b)
    # one value is the single-seed call
    assert torch.equal(attention.window_dropout_mask(torch.tensor([7], dtype=torch.int32),
                                                     BH, S, W), attention.window_dropout_mask(
        7, BH, S, W))
    with pytest.raises(ValueError, match="divide"):
        attention.window_dropout_mask(torch.tensor([1, 2, 3, 4, 5]), BH, S, W)


def test_draw_seed_takes_one_seed_from_each_generator():
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    got = attention.draw_seed(gens, "cpu")
    want = torch.cat([attention.draw_seed(torch.Generator().manual_seed(s), "cpu")
                      for s in (1, 2)])
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_grouped_plain_k2_is_each_group_on_its_own():
    g = torch.Generator().manual_seed(1)
    x, cb = torch.randn(3, 70, 8, generator=g), torch.randn(3, 16, 8, generator=g)
    idx, counts, dw = codebook.nearest_codes(x, cb)
    assert idx.shape == (3, 70) and counts.shape == (3, 16) and dw.shape == (3, 16, 8)
    for i in range(3):
        want = codebook.nearest_codes(x[i], cb[i])
        assert all(torch.equal(a[i], b) for a, b in zip((idx, counts, dw), want))
        c, d = codebook.assignment_stats(x[i], idx[i], 16)
        assert torch.equal(counts[i], c) and torch.equal(dw[i], d)
    assert torch.equal(codebook.quantize_lookup(idx, cb)[2], cb[2][idx[2].long()])


def test_optimizer_state_stacks_and_unstacks(tmp_path):
    exp = _exp(tmp_path, "o")
    model = _stacked(exp)
    opt = make_optimizer(model, exp)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    state = opt.state_dict()
    per_seed = [seed_optimizer_state(state, i) for i in range(len(SEEDS))]
    one = per_seed[1]["state"][0]
    assert one["exp_avg"].shape == next(model.parameters()).shape[1:]
    again = stack_optimizer_states(per_seed)
    for k, st in state["state"].items():
        for n, t in st.items():
            assert torch.equal(t, again["state"][k][n])


def test_files_carry_the_reference_names(tmp_path):
    exp = _exp(tmp_path, "f", epochs=1)
    trainer = ms.MultiSeedTrainer(exp, device="cpu", verbose=False)
    trainer.run(_ds())
    ck_dir, log_dir = exp.checkpoint_dir, exp.log_dir
    assert sorted(os.listdir(ck_dir)) == sorted(
        f"Exp_transformer_W10_hybrid_teacher_seed_{s}_{k}.pth"
        for s in SEEDS for k in ("best", "last", "final"))
    assert sorted(os.listdir(log_dir)) == sorted(
        [f"log_transformer_hybrid_seed_{s}.json" for s in SEEDS]
        + [f"log_Exp_transformer_W10_teacher_seed_{s}.json" for s in SEEDS])
    finals = [checkpoint.load_checkpoint(trainer.ckpt_path(s, "final"))["model_state_dict"]
              for s in SEEDS]
    key = "robot_decoder.output_proj.weight"
    assert not torch.equal(finals[0][key], finals[1][key])
    last = checkpoint.load_checkpoint(trainer.ckpt_path(SEEDS[0], "last"))
    assert last["epoch"] == 0 and last["config"].train.seeds == SEEDS
    assert last["optimizer_state_dict"]["state"]


def test_resume_repeats_the_uninterrupted_run(tmp_path):
    """Two epochs, or one and a resume for the second: equal histories."""
    ds = _ds()
    whole = ms.MultiSeedTrainer(_exp(tmp_path, "w", dropout=0.1), device="cpu",
                                verbose=False).run(ds)
    ms.MultiSeedTrainer(_exp(tmp_path, "r", dropout=0.1, epochs=1), device="cpu",
                        verbose=False).run(ds)
    resumed = ms.MultiSeedTrainer(_exp(tmp_path, "r", dropout=0.1, resume=True),
                                  device="cpu", verbose=False).run(ds)
    for s in SEEDS:
        for k in ("train_loss", "val_loss"):
            assert len(resumed[s][k]) == 2
            np.testing.assert_allclose(resumed[s][k], whole[s][k], rtol=1e-6, err_msg=k)


def test_partial_resume_is_an_error(tmp_path):
    ds = _ds()
    exp = _exp(tmp_path, "p", epochs=1)
    trainer = ms.MultiSeedTrainer(exp, device="cpu", verbose=False)
    trainer.run(ds)
    os.remove(trainer.ckpt_path(SEEDS[1], "last"))
    with pytest.raises(ValueError, match="partial multiseed resume"):
        ms.MultiSeedTrainer(dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, resume=True, epochs=2)), device="cpu", verbose=False).run(ds)


@pytest.mark.parametrize("pattern", [True, False])
def test_student_from_per_seed_or_shared_teachers(tmp_path, pattern):
    ds = _ds()
    teacher_exp = _exp(tmp_path, "t", epochs=1)
    teachers = ms.MultiSeedTrainer(teacher_exp, device="cpu", verbose=False)
    teachers.run(ds)
    path = (os.path.join(teacher_exp.checkpoint_dir,
                         "Exp_transformer_W10_hybrid_teacher_seed_{seed}_best.pth")
            if pattern else teachers.ckpt_path(SEEDS[0], "best"))
    student = ms.MultiSeedTrainer(_exp(tmp_path, "st", epochs=1, mode="student",
                                       teacher_ckpt=path), device="cpu", verbose=False)
    hist = student.run(ds)
    for s in SEEDS:
        assert np.isfinite(hist[s]["val_align"]).all()
        got = checkpoint.load_checkpoint(student.ckpt_path(s, "final"))["model_state_dict"]
        teacher = checkpoint.load_checkpoint(
            teachers.ckpt_path(s if pattern else SEEDS[0], "best"))["model_state_dict"]
        key = "robot_decoder.output_proj.weight"     # frozen: the teacher's
        assert torch.equal(got[key], teacher[key])
        human = "human_encoder.input_proj.weight"    # trained from the seed's own init
        assert not torch.equal(got[human], teacher[human])


def test_stops_when_every_seed_has_stalled(tmp_path, monkeypatch):
    monkeypatch.setattr(ms, "stacked_eval_epoch", lambda *a, **k: {
        "val_recon": np.ones(len(SEEDS)), "dcr": np.zeros(len(SEEDS))})
    trainer = ms.MultiSeedTrainer(_exp(tmp_path, "e", epochs=10, patience=2), device="cpu",
                                  verbose=False)
    hist = trainer.run(_ds())
    for s in SEEDS:
        assert len(hist[s]["train_loss"]) == 3
        ck = checkpoint.load_checkpoint(trainer.ckpt_path(s, "last"))
        assert ck["patience_counter"] == 2 and ck["best_loss"] == 1.0


def test_stacked_checkpoint_resumes_in_the_sequential_trainer(tmp_path):
    """A seed's `_last` from the stacked run is a sequential checkpoint."""
    ds = _ds()
    ms.MultiSeedTrainer(_exp(tmp_path, "x", epochs=1), device="cpu", verbose=False).run(ds)
    seq = Trainer(_exp(tmp_path, "x", epochs=2, resume=True, seeds=(SEEDS[0],)), device="cpu",
                  verbose=False)
    hist = seq.run(ds)[SEEDS[0]]
    assert len(hist["train_loss"]) == 2


def test_convert_stacked_jax_tree():
    exp = jax_make_experiment("transformer", "hybrid", **FLAGSHIP)
    trees = [jax.tree_util.tree_map(np.asarray, jax_tree(exp, seed=i)) for i in range(2)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)
    texp = ExperimentConfig.from_json(exp.to_json())
    per_seed = state_dicts_from_stacked_jax(stacked, texp.model, 2)
    whole = stacked_state_dict_from_jax(stacked, texp.model, 2)
    for i, tree in enumerate(trees):
        want = state_dict_from_jax(tree, texp.model)
        for k, v in want.items():
            assert torch.equal(per_seed[i][k], v) and torch.equal(whole[k][i], v), k
