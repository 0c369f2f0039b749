"""The port's prior training path (``bridgerl_tpu_torch/train/prior.py``)
against the JAX package's on the CPU, at tiny sizes:

- ``extract_code_grids`` (with phases and the window energy) on the tiny VQ
  of ``tests/test_token_prior.py`` (resnet_no_down + hybrid, hidden 16):
  grids, mask, take ids, energy and config equal, the VQ weights copied by
  ``state_dict_from_jax``; ``energy_tilt_weights`` within 1e-6;
- ``train_prior`` at dropout 0 for 3 epochs from JAX's initial weights:
  the same split (by take too) and batch order, so the history agrees within
  1e-5 relative; parameters within 1e-5 absolute, except where Adam
  amplifies a rounding residue (see the test);
- ``classify_grids`` predictions equal, CE within 1e-5;
- the checkpoint round trip, and refusal of the JAX package's msgpack file.

Tests that train pin torch to one thread (``one_torch_thread``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.models import DualMotionVQVAE as JaxVQ
from bridgerl_tpu.models import token_prior as jtp
from bridgerl_tpu.train import prior as jprior
from bridgerl_tpu_torch.config import ExperimentConfig
from bridgerl_tpu_torch.convert import prior_state_dict_from_jax, state_dict_from_jax
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models import token_prior as ttp
from bridgerl_tpu_torch.train import prior as tprior

from test_torch_port_prior import TINY, jax_prior, port_prior
from test_torch_port_zoo import jax_tree, one_torch_thread  # noqa: F401  (fixture)

EPOCHS = 3


def tiny_vq(seed=0):
    """The tiny VQ of tests/test_token_prior.py in both packages, with the
    same weights: (JAX experiment, JAX model, its variables, port
    experiment, port model on the CPU)."""
    exp = jax_make_experiment("resnet_no_down", "hybrid", window=10, hidden_dim=16,
                              num_res_layers=1)
    variables = jax_tree(exp, seed)
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, seed, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    return exp, JaxVQ(exp.model), variables, texp, model


@pytest.fixture(scope="module")
def vq():
    return tiny_vq()


def _sequences(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(t, 29)).astype(np.float32) for t in lengths]


def test_extract_code_grids_equal_jax(vq):
    exp, jm, jv, texp, tm = vq
    seqs = _sequences(1, (40, 25, 9, 33))
    mean, std = np.zeros(29, np.float32), np.ones(29, np.float32)
    kw = dict(max_len=8, phases=[0, 2], return_energy=True, batch_windows=16)
    want = jprior.extract_code_grids(jm, jv, exp, seqs, mean, std, 5, **kw)
    got = tprior.extract_code_grids(tm, texp, seqs, mean, std, 5, **kw)
    for name, g, w in zip(("grids", "mask", "pcfg", "seq_ids", "energy"), got, want):
        if name == "pcfg":
            assert g.to_json() == w.to_json()
        elif name == "energy":
            np.testing.assert_allclose(g, w, atol=1e-6)
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].shape == (6, 8, 50) and got[2].tokens_per_stream == 10
    with pytest.raises(ValueError, match="phase"):
        tprior.extract_code_grids(tm, texp, seqs, mean, std, 5, phases=[5])


def test_energy_tilt_weights_equal_jax():
    rng = np.random.default_rng(2)
    energy = rng.uniform(0, 1, size=(5, 8)).astype(np.float32)
    mask = (rng.uniform(size=(5, 8)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(tprior.energy_tilt_weights(energy, mask, 0.7),
                               jprior.energy_tilt_weights(energy, mask, 0.7), atol=1e-6)


def _corpus(n=16, seed=0):
    """Grids with a learnable pattern plus noise, ragged masks, 4 takes."""
    rng = np.random.default_rng(seed)
    grids = np.zeros((n, 8, 2), np.int32)
    grids[..., 0] = (np.arange(8)[None] + rng.integers(0, 3, size=(n, 1))) % 7
    grids[..., 1] = rng.integers(0, 5, size=(n, 8))
    mask = np.ones((n, 8), np.float32)
    mask[::3, 6:] = 0.0
    return grids, mask, np.repeat(np.arange(4), n // 4)


def _jax_initial(pcfg, tcfg):
    """The variables JAX's train_prior starts from."""
    model = jtp.MotionTokenPrior(pcfg)
    key = jax.random.key(tcfg.seed)
    cls = jnp.zeros((2,), jnp.int32) if pcfg.class_names else None
    init = jax.jit(lambda g: model.init({"params": key, "dropout": key}, g, train=False,
                                        class_ids=cls))
    return jax.tree_util.tree_map(np.asarray, init(jnp.zeros((2, 8, 2), jnp.int32)))


@pytest.mark.parametrize("by_take", [False, True])
def test_train_prior_matches_jax(by_take, one_torch_thread):  # noqa: F811
    """3 epochs at dropout 0 from JAX's initial weights: per-epoch train
    and validation CE within 1e-5 relative. Parameters within 1e-5
    absolute, except the attention key biases: softmax ignores a shift of a
    row's logits, so their true gradient is 0 and Adam divides the rounding
    residue by its own RMS, a step of order lr with a sign that is noise;
    they are held to 2 * steps * lr."""
    pcfg = dataclasses.replace(TINY, slot_ar=True, depth_layers=1)
    grids, mask, takes = _corpus()
    tcfg = jprior.PriorTrainConfig(epochs=EPOCHS, batch_size=4, lr=3e-4, patience=-1,
                                   val_fraction=0.25, seed=3)
    seq_ids = takes if by_take else None
    initial = _jax_initial(pcfg, tcfg)
    jvars, jhist = jprior.train_prior(grids, mask, pcfg, tcfg, verbose=False, seq_ids=seq_ids)
    tpcfg = ttp.PriorConfig.from_json(pcfg.to_json())
    model, hist = tprior.train_prior(
        grids, mask, tpcfg, tprior.PriorTrainConfig(**dataclasses.asdict(tcfg)), verbose=False,
        seq_ids=seq_ids, device="cpu", initial=prior_state_dict_from_jax(initial, tpcfg))
    assert sorted(hist) == sorted(jhist)
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-5, err_msg=k)
    steps = EPOCHS * len(grids) // 4   # at least the optimizer steps taken
    want = prior_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars), tpcfg)
    got = model.state_dict()
    d = pcfg.d_model
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith("in_proj_bias"):
            np.testing.assert_allclose(g[d:2 * d], w.numpy()[d:2 * d], atol=2 * steps * tcfg.lr,
                                       err_msg=k)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w.numpy(), np.s_[d:2 * d])
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, err_msg=k)


def test_train_prior_options_match_jax(one_torch_thread):  # noqa: F811
    """``pos_weights`` (an energy tilt), ``select="train"`` and patience: the
    same history as JAX's, stopped at the same epoch. Scheduled sampling
    (the port's draws are its own) trains to finite losses and moves them."""
    pcfg = TINY
    grids, mask, takes = _corpus()
    energy = np.random.default_rng(6).uniform(size=mask.shape).astype(np.float32)
    w = tprior.energy_tilt_weights(energy, mask, 0.5)
    tcfg = jprior.PriorTrainConfig(epochs=6, batch_size=4, lr=3e-4, patience=2,
                                   val_fraction=0.25, seed=5, select="train")
    _, jhist = jprior.train_prior(grids, mask, pcfg, tcfg, verbose=False, pos_weights=w)
    tpcfg = ttp.PriorConfig.from_json(pcfg.to_json())
    ttcfg = tprior.PriorTrainConfig(**dataclasses.asdict(tcfg))
    initial = prior_state_dict_from_jax(_jax_initial(pcfg, tcfg), tpcfg)
    _, hist = tprior.train_prior(grids, mask, tpcfg, ttcfg, verbose=False, pos_weights=w,
                                 device="cpu", initial=initial)
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-5, err_msg=k)
    ss = dataclasses.replace(ttcfg, epochs=2, scheduled_sampling=0.9, patience=-1)
    _, plain = tprior.train_prior(grids, mask, tpcfg,
                                  dataclasses.replace(ss, scheduled_sampling=0.0),
                                  verbose=False, device="cpu", initial=initial)
    _, sampled = tprior.train_prior(grids, mask, tpcfg, ss, verbose=False, device="cpu",
                                    initial=initial)
    assert np.isfinite(sampled["train_loss"]).all()
    assert sampled["train_loss"][0] == pytest.approx(plain["train_loss"][0], rel=1e-6)
    assert sampled["train_loss"][1] != pytest.approx(plain["train_loss"][1], rel=1e-4)


def test_train_prior_refuses_what_jax_refuses():
    grids, mask, _ = _corpus(4)
    pcfg = ttp.PriorConfig.from_json(dataclasses.replace(TINY, class_names=("a", "b")).to_json())
    with pytest.raises(ValueError, match="class_ids"):
        tprior.train_prior(grids, mask, pcfg, tprior.PriorTrainConfig(epochs=1), device="cpu")
    with pytest.raises(ValueError, match="val_take_ids"):
        tprior.split_indices(4, tprior.PriorTrainConfig(), val_take_ids=[0])


def test_classify_grids_equal_jax():
    pcfg = dataclasses.replace(TINY, class_names=("walk", "run", "jump"))
    jm, jv = jax_prior(pcfg, seed=4)
    tm = port_prior(pcfg, jv)
    grids, mask, _ = _corpus(10, seed=5)
    want_pred, want_ce = jprior.classify_grids(jm, jv, grids, mask, batch=4)
    got_pred, got_ce = tprior.classify_grids(tm, grids, mask, batch=4)
    np.testing.assert_array_equal(got_pred, want_pred)
    np.testing.assert_allclose(got_ce, want_ce, atol=1e-5)
    with pytest.raises(ValueError, match="class-conditioned"):
        tprior.classify_grids(port_prior(TINY, jax_prior(TINY)[1]), grids, mask)


def test_prior_checkpoint_round_trip(tmp_path):
    pcfg = dataclasses.replace(TINY, slot_ar=True, depth_layers=1, class_names=("a", "b"))
    jm, jv = jax_prior(pcfg)
    tm = port_prior(pcfg, jv)
    path = str(tmp_path / "prior.ckpt")
    tprior.save_prior_checkpoint(path, tm, tm.cfg, history={"val_loss": [1.0]})
    back, pcfg2 = tprior.load_prior_checkpoint(path, device="cpu")
    assert pcfg2 == tm.cfg and back.cfg.slot_ar and back.cfg.class_names == ("a", "b")
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)
    payload = torch.load(path, weights_only=True)
    assert payload["kind"] == "bridgerl-token-prior" and payload["history"] == {"val_loss": [1.0]}
    jax_path = str(tmp_path / "jax_prior.ckpt")
    jprior.save_prior_checkpoint(jax_path, jv, pcfg)
    with pytest.raises(ValueError, match="token-prior"):
        tprior.load_prior_checkpoint(jax_path, device="cpu")
