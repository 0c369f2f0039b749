"""The trainer's recipe options against the JAX package, on the CPU:
codebook seeding (``codebook_data_init``), the transfer init of
``init_from``, cheap dropout, ``reuse_dropout_mask`` and ``info_nce_loss``,
and the training command line with the four recipe flags.

Weights are JAX variable trees filled from a numpy seed
(``test_torch_port_zoo.py``: hidden 16, K 32, one residual block, d_model
32, one transformer layer, window 8), converted with
``convert.state_dict_from_jax``. Seeding: the same rows picked (the JAX
rows with JAX's own jitter taken off equal the port's picked encoder rows
within 1e-5), ``ema_w == embedding`` and cluster sizes 1, the seeded rows
within 6 x 1e-3 x std of JAX's (the jitters come from different generators;
each is 1e-3 x std x a standard normal), every other entry untouched, and
nothing seeded for fsq, lfq, ae and standard. Merging: equal to JAX's
merge, entry for entry. Cheap dropout: the kept share within 4 sigma of
230/256 at rate 0.1 over 2**16 draws, kept values scaled exactly as the JAX
module scales them. ``info_nce_loss`` within 1e-6.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.models.layers import CheapDropout as JaxCheapDropout
from bridgerl_tpu.train.checkpoint import merge_matching_variables as jax_merge
from bridgerl_tpu.train.codebook_seed import seed_codebook_variables
from bridgerl_tpu.train.losses import info_nce_loss as jax_info_nce
from bridgerl_tpu_torch.cli import process_data, train_ablation
from bridgerl_tpu_torch.config import TrainConfig, make_experiment
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.data.dataset import PairedDataset, train_val_split
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models.layers import cheap_dropout
from bridgerl_tpu_torch.train import info_nce_loss
from bridgerl_tpu_torch.train.checkpoint import load_checkpoint, merge_matching_variables
from bridgerl_tpu_torch.train.codebook_seed import JITTER, seed_codebooks
from bridgerl_tpu_torch.train.trainer import accumulate_grads

from test_torch_port_zoo import ZOO, jax_tree, pair, windows, one_torch_thread  # noqa: F401

SEEDED = {("resnet_no_down", "ema"): "quantizer", ("simple", "rvq"): "quantizer.layers.0",
          ("resnet_no_down", "hybrid"): "quantizer.vq.layers.0",
          ("transformer", "hybrid"): "quantizer.vq.layers.0"}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch,method", sorted(SEEDED), ids=lambda v: str(v))
def test_codebook_seeding_matches_jax(arch, method):
    exp, jmodel, variables, texp, model = pair(arch, method)
    x = windows(7, 16, 8, 29)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert seed_codebooks(model, torch.from_numpy(x)) == [SEEDED[arch, method][len("quantizer."):]]
    jax_seeded = state_dict_from_jax(seed_codebook_variables(jmodel, variables, jnp.asarray(x)),
                                     texp.model)
    got = model.state_dict()
    prefix = SEEDED[arch, method]
    emb, ema_w, cs = (got[f"{prefix}.{k}"] for k in ("embedding.weight", "ema_w",
                                                     "ema_cluster_size"))
    assert torch.equal(ema_w, emb) and torch.equal(cs, torch.ones_like(cs))
    assert torch.equal(jax_seeded[f"{prefix}.ema_cluster_size"], cs)
    # the same rows: JAX's rows with its own jitter taken off are the port's picks
    with torch.no_grad():
        flat = model.encode_robot(torch.from_numpy(x)).float().reshape(-1, emb.shape[1])
    jflat = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=jmodel.encode_robot),
                       np.float32).reshape(-1, emb.shape[1])
    K, n = emb.shape[0], flat.shape[0]
    idx = (np.arange(K) * n) // K
    jnoise = np.asarray(jax.random.normal(jax.random.key(0), emb.shape, jnp.float32))
    jrows = jax_seeded[f"{prefix}.embedding.weight"].numpy() - (
        JITTER * jflat.std(axis=0, keepdims=True) * jnoise)
    scale = float(np.abs(jflat).max())
    np.testing.assert_allclose(flat[idx].numpy(), jrows, atol=1e-5 * scale, rtol=0)
    std = flat.std(dim=0, correction=0)
    assert ((emb - jax_seeded[f"{prefix}.embedding.weight"]).abs()
            <= 6 * JITTER * std + 1e-5 * scale).all()
    # nothing else moved: residual stages, other buffers, every parameter
    for k, v in got.items():
        if not k.startswith(prefix + "."):
            assert torch.equal(v, before[k]), k
            np.testing.assert_array_equal(v.numpy(), jax_seeded[k].numpy(), err_msg=k)


@pytest.mark.parametrize("method", ["fsq", "lfq", "ae", "standard"])
def test_codebook_seeding_is_a_no_op_without_ema_state(method):
    exp, jmodel, variables, texp, model = pair("resnet_no_down", method)
    x = windows(8, 4, 8, 29)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert seed_codebooks(model, torch.from_numpy(x)) == []
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert seed_codebook_variables(jmodel, variables, jnp.asarray(x)) is variables


@pytest.mark.parametrize("arch", ["transformer", "resnet"])
def test_merge_matching_variables_matches_jax(arch):
    """ae -> hybrid: the towers come from the ae weights, the quantizer keeps
    the hybrid's init, as the JAX merge gives it."""
    hybrid = make_experiment(arch, "hybrid", **ZOO)
    ae = make_experiment(arch, "ae", **ZOO)
    jh, ja = (jax_tree(jax_make_experiment(arch, m, **ZOO), seed)
              for m, seed in (("hybrid", 0), ("ae", 1)))
    want = state_dict_from_jax(jax_merge(jh, serialization.to_state_dict(ja)), hybrid.model)
    target = state_dict_from_jax(jh, hybrid.model)
    source = state_dict_from_jax(ja, ae.model)
    got = merge_matching_variables(target, source)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], (target if k.startswith("quantizer.") else source)[k]), k
    assert any(k.startswith("quantizer.") for k in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cheap_dropout_rate_scale_and_draws(dtype):
    n = 2 ** 16
    x = torch.ones(n, dtype=dtype)
    out = cheap_dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = out != 0
    p = 230 / 256
    assert abs(kept.float().mean().item() - p) <= 4 * math.sqrt(p * (1 - p) / n)
    jax_dtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout = JaxCheapDropout(0.1, deterministic=False).apply(
        {}, jnp.ones((n,), jax_dtype), rngs={"dropout": jax.random.key(0)})
    jkept = np.asarray(jout.astype(jnp.float32))
    assert out.dtype == dtype
    assert set(out[kept].float().unique().tolist()) == set(np.unique(jkept[jkept != 0]).tolist())
    assert torch.equal(out, cheap_dropout(x, 0.1, torch.Generator().manual_seed(3)))
    assert not torch.equal(out, cheap_dropout(x, 0.1, torch.Generator().manual_seed(4)))
    assert cheap_dropout(x, 0.001, None) is x           # round(0.256) = 0: nothing drops
    high = cheap_dropout(x, 0.999, torch.Generator().manual_seed(5))
    assert abs((high != 0).float().mean().item() - 1 / 256) <= 4 * math.sqrt(1 / 256 / n)


def _step_grads(exp, model, robot, idx, seed):
    model.zero_grad(set_to_none=True)
    accumulate_grads(model, exp, robot, robot, idx, torch.Generator().manual_seed(seed))
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("cheap", [False, True])
def test_reuse_dropout_mask_repeats_the_draw(cheap):
    """Two microbatches of the same windows: with the option both draw the
    one mask, so the averaged gradient equals one microbatch's; without it
    they draw two."""
    kw = dict(ZOO, dropout=0.1, cheap_dropout=cheap)
    robot = torch.from_numpy(windows(11, 4, 8, 29))
    rows = torch.arange(4)
    twice = torch.cat([rows, rows])
    grads = {}
    for reuse in (False, True):
        exp = make_experiment("transformer", "fsq", accum_chunks=2, batch_size=8,
                              reuse_dropout_mask=reuse, **kw)
        one = make_experiment("transformer", "fsq", accum_chunks=1, batch_size=4, **kw)
        model = init_model(exp.model, 0, device="cpu")
        grads[reuse] = (_step_grads(exp, model, robot, twice, 9),
                        _step_grads(one, model, robot, rows, 9))
    same, single = grads[True]
    assert all(torch.equal(same[k], single[k]) for k in single)
    differ, single = grads[False]
    assert any(not torch.equal(differ[k], single[k]) for k in single)


@pytest.mark.parametrize("temperature", [0.07, 0.5])
def test_info_nce_loss_matches_jax(temperature):
    rng = np.random.default_rng(12)
    zh, zr = (rng.normal(size=(16, 2, 8)).astype(np.float32) for _ in range(2))
    got = info_nce_loss(torch.from_numpy(zh), torch.from_numpy(zr), temperature)
    want = float(jax_info_nce(jnp.asarray(zh), jnp.asarray(zr), temperature))
    assert abs(got.item() - want) <= 1e-6 * max(1.0, abs(want))


def test_cli_recipe_on_the_cpu(tmp_path, monkeypatch):
    """process_data, an ae teacher, then the hybrid with --init_from,
    --codebook_data_init, --cheap_dropout and --reuse_dropout_mask (the
    CLI has no width flags, so a narrow resnet_no_down keeps the run short
    on a loaded CPU; the transformer runs it on the card in chip_smoke.py):
    the flags reach the config; at step 0 (epochs 0) the towers equal the ae
    checkpoint's and the first-stage codebook rows are the robot encoder's
    outputs on the first batch_size training windows (plus the jitter);
    then two epochs train with finite losses."""
    monkeypatch.chdir(tmp_path)
    assert process_data.main(["--synthetic", "--window", "8", "--step", "16",
                              "--n_sequences", "1"]) == 0
    common = ["--arch", "resnet_no_down", "--hidden_dim", "16", "--window", "8",
              "--batch_size", "32", "--seed", "3", "--device", "cpu"]
    assert train_ablation.main(common + ["--method", "ae", "--epochs", "1"]) == 0
    ae_ckpt = "checkpoints/Exp_resnet_no_down_W8_ae_teacher_seed_3_best.pth"
    recipe = ["--method", "hybrid", "--init_from", ae_ckpt, "--codebook_data_init",
              "--cheap_dropout", "--reuse_dropout_mask", "--accum_chunks", "4"]
    assert train_ablation.main(common + recipe + ["--epochs", "0"]) == 0
    ae = load_checkpoint(ae_ckpt)
    step0 = load_checkpoint(
        "checkpoints/Exp_resnet_no_down_W8_hybrid_teacher_seed_3_final.pth")
    towers = [k for k in ae["model_state_dict"] if not k.startswith("quantizer.")]
    assert towers
    for k in towers:
        assert torch.equal(step0["model_state_dict"][k], ae["model_state_dict"][k]), k

    robot = np.load("data/processed/g1_train.npy")
    ds = PairedDataset.from_numpy(robot, np.load("data/processed/human_train.npy"), "cpu")
    train_ds, _ = train_val_split(ds, TrainConfig().val_fraction, 3)
    model = init_model(ae["config"].model, 0, device="cpu")
    model.load_state_dict(ae["model_state_dict"])
    with torch.no_grad():
        flat = model.encode_robot(train_ds.robot[:32]).float().reshape(-1, 16)
    emb = step0["model_state_dict"]["quantizer.vq.layers.0.embedding.weight"]
    idx = (torch.arange(emb.shape[0]) * flat.shape[0]) // emb.shape[0]
    jitter = (emb - flat[idx]).abs()
    assert (jitter <= 6 * JITTER * flat.std(dim=0, correction=0)).all()
    assert jitter.max() > 0
    assert torch.equal(step0["model_state_dict"]["quantizer.vq.layers.0.ema_w"], emb)

    assert train_ablation.main(common + recipe + ["--epochs", "2"]) == 0
    cfg = load_checkpoint(
        "checkpoints/Exp_resnet_no_down_W8_hybrid_teacher_seed_3_last.pth")["config"]
    assert cfg.model.cheap_dropout and cfg.train.reuse_dropout_mask
    assert cfg.train.codebook_data_init and cfg.train.init_from == ae_ckpt
    with open("results/log_resnet_no_down_hybrid_W8_seed_3.json") as f:
        hist = json.load(f)
    assert len(hist["train_loss"]) == 2
    assert all(math.isfinite(v) for k in ("train_loss", "val_loss") for v in hist[k])
