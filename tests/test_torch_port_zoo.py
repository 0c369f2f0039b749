"""The model zoo (every arch and every quantization method) against the JAX
package, on the CPU.

Weights are the JAX model's variable tree filled from a numpy seed (shapes
from ``jax.eval_shape`` of the JAX init, so that no init runs eagerly):
kernels and biases N(0, 0.3), scales near 1, BatchNorm running variances in
[0.5, 1.5], EMA codebooks N(0, 0.5) with cluster sizes in [0.5, 2]. They
reach the port through ``convert.state_dict_from_jax`` and load with
``strict=True``. Inputs are numpy arrays from a seed; small widths (hidden
16, K 32, one residual block, d_model 32, one transformer layer, window 8,
batch 4). The JAX side runs at matmul precision "highest"
(tests/conftest.py).

Tolerances: outputs, losses and metrics within 1e-5 of their scale (the
largest magnitude of the JAX value; summation order differs), code streams
exact, BatchNorm running statistics and EMA state after a train-mode
forward within 1e-6.
"""

import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.export.torch_import import export_torch_state_dict
from bridgerl_tpu.models import init_model as jax_init_model
from bridgerl_tpu_torch.config import ARCHS, METHODS, ExperimentConfig
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.models import init_model

ZOO = dict(window=8, hidden_dim=16, codebook_size=32, num_res_layers=1, d_model=32,
           n_tf_layers=1, n_heads=2, ff_dim=64, dropout=0.0)
B = 4
RTOL = 1e-5
STATE_ATOL = 1e-6
MUTABLE = ["batch_stats", "qstats", "intermediates"]


def filled(variables_shape, seed):
    """A variable tree of the given shapes, filled from a numpy seed."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "ema_cluster_size":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name in ("embedding", "ema_w"):
            return rng.normal(0.0, 0.5, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.1, shape)).astype(np.float32)
        return rng.normal(0.0, 0.3, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables_shape)


def jax_tree(exp, seed=0):
    shapes = jax.eval_shape(lambda k: jax_init_model(exp.model, k)[1], jax.random.key(0))
    return filled(shapes, seed)


def pair(arch, method, seed=0, **over):
    """(JAX experiment, JAX model, its variables, port experiment, a fresh
    port model on the CPU holding the same weights)."""
    exp, jmodel, variables = _jax_side(arch, method, seed, tuple(sorted(over.items())))
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, seed, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    return exp, jmodel, variables, texp, model


@functools.lru_cache(maxsize=None)
def _jax_side(arch, method, seed, over):
    exp = jax_make_experiment(arch, method, **{**ZOO, **dict(over)})
    from bridgerl_tpu.models import DualMotionVQVAE as JaxModel
    return exp, JaxModel(exp.model), jax_tree(exp, seed)


def windows(seed, b, W, dim):
    return np.random.default_rng(seed).normal(size=(b, W, dim)).astype(np.float32)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test, restored after it. Tier-1 runs
    several pytest workers on a few cores, and the many small operations of
    a small model slow tenfold when their thread pools contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_scaled_close(got, want, err_msg="", rtol=RTOL):
    """|got - want| <= rtol * (the largest |want|, at least 1e-3)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-3)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, f"{err_msg}: {err} > {rtol} x {scale}"


def jax_codes(intermediates, call):
    """Code streams of the ``call``-th quantizer call (0: robot, 1: human
    when both branches run), named by module path."""
    flat = traverse_util.flatten_dict(intermediates)
    return {"/".join(k[:-1]): np.asarray(v[call]) for k, v in flat.items() if k[-1] == "codes"}


def state_close(model, new_variables, cfg, what=("running_", "ema_", "embedding")):
    """The port's buffers (BatchNorm statistics, EMA state) against the JAX
    variables after the same work: 1e-6 absolute, 1e-5 relative."""
    want = state_dict_from_jax(new_variables, cfg)
    got = model.state_dict()
    checked = 0
    for name, w in want.items():
        if any(s in name.split(".")[-1] or s in name for s in what) and "num_batches" not in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=RTOL,
                                       atol=STATE_ATOL, err_msg=name)
            checked += 1
    return checked


CASES = sorted({(arch, "ema") for arch in ARCHS} | {("simple", m) for m in METHODS})


@pytest.mark.parametrize("arch,method", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_forward_matches_jax_in_eval_and_train(arch, method):
    """Eval: outputs, z_e, loss, metrics and codes of both branches. Train
    (both branches, dropout 0): the same, with the BatchNorm statistics and
    the EMA state each branch folded, the robot branch first."""
    exp, jmodel, variables, texp, model = pair(arch, method)
    xr, xh = windows(1, B, 8, 29), windows(2, B, 8, 126)
    for train in (False, True):
        ref, mods = jmodel.apply(variables, x_robot=xr, x_human=xh, train=train,
                                 rngs={"dropout": jax.random.key(0)}, mutable=MUTABLE)
        with torch.no_grad():
            got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh),
                        train=train, generator=torch.Generator().manual_seed(0))
        for call, (branch, key) in enumerate((("robot", "recon"), ("human", "retargeted"))):
            tag = f"train={train} {branch}"
            for k in (key, "z_e", "loss_vq"):
                assert_scaled_close(got[branch][k].numpy(), ref[branch][k], f"{tag}/{k}")
            assert sorted(got[branch]["metrics"]) == sorted(ref[branch]["metrics"])
            for k, v in ref[branch]["metrics"].items():
                assert_scaled_close(got[branch]["metrics"][k].numpy(), v, f"{tag}/{k}")
            want = jax_codes(mods.get("intermediates", {}), call) if method != "ae" else {}
            assert sorted(got[branch]["codes"]) == sorted(want), tag
            for k, v in want.items():
                np.testing.assert_array_equal(got[branch]["codes"][k].numpy(), v,
                                              err_msg=f"{tag}/{k}")
        if train:
            new = {**jax.tree_util.tree_map(np.asarray, variables),
                   **{k: jax.tree_util.tree_map(np.asarray, v) for k, v in mods.items()
                      if k != "intermediates"}}
            checked = state_close(model, new, texp.model)
            assert checked > 0 or (arch == "simple" and method in ("fsq", "lfq", "ae"))


ALL = list(itertools.product(ARCHS, METHODS))


@pytest.mark.parametrize("arch,method,scan", [(a, m, False) for a, m in ALL]
                         + [("transformer", "hybrid", True), ("transformer", "rvq", True)],
                         ids=[f"{a}-{m}" for a, m in ALL] + ["transformer-hybrid-scan",
                                                             "transformer-rvq-scan"])
def test_state_dict_from_jax_has_the_reference_layout(arch, method, scan):
    """Every key the JAX package's own torch export writes, with the same
    values (the FSQ and LFQ projections' k=1 axis squeezed), plus
    ``num_batches_tracked``; loads into the port with ``strict=True``. With
    ``scan_layers`` the stacked layers unstack into the same keys."""
    exp = jax_make_experiment(arch, method, **ZOO, scan_layers=scan)
    variables = jax_tree(exp)
    texp = ExperimentConfig.from_json(exp.to_json())
    ours = state_dict_from_jax(variables, texp.model)
    init_model(texp.model, 0, device="cpu").load_state_dict(ours, strict=True)
    if scan:   # the same weights without scan_layers give the same state_dict
        blocks = {}
        for tower, sub in variables["params"].items():
            if "stack" in sub:
                stacked = sub["stack"]["layers"]["block"]
                blocks[tower] = {k: v for k, v in sub.items() if k != "stack"}
                for i in range(texp.model.n_tf_layers):
                    blocks[tower][f"layer_{i}"] = jax.tree_util.tree_map(lambda a: a[i],
                                                                         stacked)
            else:
                blocks[tower] = sub
        variables = {**variables, "params": blocks}
        unscanned = state_dict_from_jax(variables, ExperimentConfig.from_json(
            jax_make_experiment(arch, method, **ZOO).to_json()).model)
        assert sorted(unscanned) == sorted(ours)
        for k in ours:
            assert torch.equal(ours[k], unscanned[k]), k
    ref = export_torch_state_dict(variables, arch, method, n_tf_layers=exp.model.n_tf_layers,
                                  n_heads=exp.model.n_heads,
                                  num_res_layers=exp.model.num_res_layers,
                                  rvq_layers=exp.model.n_layers)
    tracked = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - tracked == set(ref)
    assert (len(tracked) > 0) == (arch in ("resnet", "resnet_no_down"))
    for k, v in ref.items():
        want = v[..., 0] if v.ndim == 3 and "project_" in k else v
        np.testing.assert_array_equal(ours[k].numpy(), want, err_msg=k)


def test_conv_transpose_doubles_the_length_with_the_flipped_kernel():
    """The simple decoder's transposed convolutions give exactly 2x the
    length at each stage and agree with flax's ConvTranspose through the
    kernel flip, at a window JAX's init never saw (16)."""
    exp, jmodel, variables, _, model = pair("simple", "ae")
    z = np.random.default_rng(3).normal(size=(B, 4, 16)).astype(np.float32)
    ref = jmodel.apply(variables, z, method="decode_latent")
    with torch.no_grad():
        got = model.decode_latent(torch.from_numpy(z))
    assert got.shape == (B, 16, 29)
    assert_scaled_close(got.numpy(), ref, "decode_latent")


def test_batchnorm_keeps_the_biased_running_variance():
    """flax folds the biased batch variance into the running one (torch's
    BatchNorm1d would fold the unbiased one): checked against the numbers."""
    from bridgerl_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(3)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, 5)).astype(np.float32))
    bn(x, train=True)
    biased = x.permute(1, 0, 2).reshape(3, -1).var(dim=1, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 + 0.1 * biased).numpy(),
                               rtol=1e-6)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("arch,method", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_serving_functions_follow_the_method(arch, method):
    """``motion_codes`` exists where the method has codes (not ``ae``, as in
    the JAX package), returns the streams the JAX model sows under their
    names, one code a latent token: the transformer's pooled tokens, W / 4
    for the strided towers, W for resnet_no_down; ``meta["functions"]``
    says the same."""
    from bridgerl_tpu_torch.export.serving import build_serving_module, code_stream_names

    exp, jmodel, variables, texp, model = pair(arch, method)
    module = build_serving_module(model, texp)
    sigs = module.meta["functions"]
    assert sorted(module.fns) == sorted(sigs)
    x = windows(9, 3, 8, 126)
    assert_scaled_close(module.retarget(x).numpy(),
                        jmodel.apply(variables, x_human=x)["human"]["retargeted"], "retarget")
    if method == "ae":
        assert "motion_codes" not in module.fns and code_stream_names(texp.model) == ()
        return
    _, mods = jmodel.apply(variables, x_human=x, mutable=["intermediates"])
    want = jax_codes(mods["intermediates"], 0)
    got = module.motion_codes(x)
    assert sorted(got) == sorted(want) == sorted(code_stream_names(texp.model))
    tokens = {"transformer": 1, "resnet_no_down": 8}.get(arch, 2)
    for k, v in want.items():
        assert sigs["motion_codes"]["output"][k] == ["b", tokens]
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
