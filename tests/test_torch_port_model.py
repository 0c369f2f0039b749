"""The port's whole DualMotionVQVAE against the JAX package, on the CPU.

Weights come from the JAX init (moved by seeded numpy noise, so zero biases
and unit LayerNorm scales are checked as values) through
``convert.state_dict_from_jax`` and load with ``strict=True``. Inputs are
numpy arrays from a seed. The JAX side runs at matmul precision "highest"
(tests/conftest.py). Tolerances: 1e-5 absolute on f32 outputs (different
summation order); code streams exact.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.export.torch_import import export_torch_state_dict
from bridgerl_tpu.models import init_model as jax_init_model
from bridgerl_tpu_torch.config import ExperimentConfig, ModelConfig, make_experiment
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.models import DualMotionVQVAE, init_model

SMALL = dict(window=10, hidden_dim=16, d_model=32, n_tf_layers=2, n_heads=4, ff_dim=64)
ATOL = 1e-5


def perturbed(variables, seed):
    """Every leaf replaced or moved by seeded numpy noise; the EMA codebooks
    get a spread that gives the residual VQ layers varied codes."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = path[-1].key
        if name == "ema_cluster_size":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("embedding", "ema_w"):
            return rng.normal(0.0, 0.5, a.shape).astype(np.float32)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


def jax_and_port(seed=0, **overrides):
    """(JAX experiment, JAX model, its variables, port experiment, port model
    on the CPU holding the same weights). Cached: callers only read them."""
    return _jax_and_port(seed, tuple(sorted(overrides.items())))


@functools.lru_cache(maxsize=None)
def _jax_and_port(seed, overrides):
    exp = jax_make_experiment("transformer", "hybrid", **{**SMALL, **dict(overrides)})
    jmodel, variables = jax_init_model(exp.model, jax.random.key(seed))
    variables = perturbed(variables, seed)
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, seed, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    return exp, jmodel, variables, texp, model


def jax_codes(jmodel, variables, **inputs):
    """The JAX model's sown code streams, named by module path."""
    _, mods = jmodel.apply(variables, train=False, mutable=["intermediates"], **inputs)
    flat = traverse_util.flatten_dict(mods["intermediates"])
    return {"/".join(k[:-1]): np.asarray(v[0]) for k, v in flat.items() if k[-1] == "codes"}


def windows(seed, b, W, dim):
    return np.random.default_rng(seed).normal(size=(b, W, dim)).astype(np.float32)


CASES = [
    dict(attn_packing=1),
    dict(attn_packing=4),
    dict(attn_packing=4, fsq_bounded=False),
    dict(attn_packing=4, vq_norm=True),
    dict(attn_packing=2, tf_tokens=2),
]


@pytest.mark.parametrize("over", CASES, ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_forward_matches_jax(over):
    exp, jmodel, variables, _, model = jax_and_port(**over)
    xr, xh = windows(1, 8, 10, 29), windows(2, 8, 10, 126)
    ref = jmodel.apply(variables, x_robot=xr, x_human=xh, train=False)
    with torch.no_grad():
        got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh))
    for branch, key in (("robot", "recon"), ("human", "retargeted")):
        for k in (key, "z_e", "loss_vq"):
            np.testing.assert_allclose(got[branch][k].numpy(), np.asarray(ref[branch][k]),
                                       atol=ATOL, err_msg=f"{branch}/{k}")
        for k, v in ref[branch]["metrics"].items():
            np.testing.assert_allclose(got[branch]["metrics"][k].numpy(), np.asarray(v),
                                       atol=ATOL, err_msg=f"{branch}/metrics/{k}")


@pytest.mark.parametrize("branch", ["robot", "human"])
@pytest.mark.parametrize("packing", [1, 4])
def test_code_streams_match_jax(branch, packing):
    _, jmodel, variables, _, model = jax_and_port(attn_packing=packing)
    x = windows(3, 12, 10, 29 if branch == "robot" else 126)
    ref = jax_codes(jmodel, variables, **{f"x_{branch}": x})
    with torch.no_grad():
        got = model(**{f"x_{branch}": torch.from_numpy(x)})[branch]["codes"]
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert len({tuple(v.reshape(-1)) for v in ref.values()}) > 1  # not all trivially equal


@pytest.mark.parametrize("method", ["encode_robot", "encode_human", "decode_latent"])
def test_encode_decode_helpers_match_jax(method):
    _, jmodel, variables, _, model = jax_and_port(attn_packing=4)
    dims = {"encode_robot": (8, 10, 29), "encode_human": (8, 10, 126),
            "decode_latent": (8, 1, 16)}
    x = np.random.default_rng(5).normal(size=dims[method]).astype(np.float32)
    ref = jmodel.apply(variables, x, method=method)
    with torch.no_grad():
        got = getattr(model, method)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("bounded", [True, False])
def test_state_dict_matches_reference_export(bounded):
    """Every key both emit agrees; only the FSQ projections' k=1 conv axis is
    squeezed in the port."""
    exp, _, variables, texp, model = jax_and_port(fsq_bounded=bounded)
    ref = export_torch_state_dict(variables, "transformer", "hybrid",
                                  n_tf_layers=exp.model.n_tf_layers,
                                  n_heads=exp.model.n_heads)
    ours = state_dict_from_jax(variables, texp.model)
    assert set(ours) == set(ref) == set(model.state_dict())
    for k, v in ours.items():
        want = ref[k]
        if k.startswith("quantizer.fsq.") and k.endswith(".weight"):
            assert want.shape[-1] == 1
            want = want[..., 0]
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


def test_strict_load_rejects_missing_key():
    _, _, variables, texp, _ = jax_and_port()
    sd = state_dict_from_jax(variables, texp.model)
    sd.pop("quantizer.vq.layers.0.ema_w")
    with pytest.raises(RuntimeError, match="ema_w"):
        init_model(texp.model, 0, device="cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("over", [dict(arch="resnet"), dict(scan_layers=True)])
def test_state_dict_from_jax_rejects_other_trees(over):
    """A tree of another model than the config's (the flagship's unstacked
    transformer tree) raises, naming the path it lacks."""
    _, _, variables, _, _ = jax_and_port()
    over = dict(over)
    cfg = make_experiment(over.pop("arch", "transformer"), "hybrid", **SMALL, **over).model
    with pytest.raises(KeyError, match="stack|Conv_0"):
        state_dict_from_jax(variables, cfg)


def test_init_model_is_seeded_and_torch_style():
    cfg = make_experiment("transformer", "hybrid", **SMALL).model
    a, b, c = (init_model(cfg, s, device="cpu") for s in (7, 7, 8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["human_encoder.input_proj.weight"],
                           sc["human_encoder.input_proj.weight"])
    for k, v in sa.items():
        if k.endswith("bias"):
            assert torch.count_nonzero(v) == 0, k
    w = sa["human_encoder.input_proj.weight"]
    assert w.abs().max() <= 1 / np.sqrt(126) and w.abs().max() > 0.5 / np.sqrt(126)
    qkv = sa["robot_decoder.transformer.layers.1.self_attn.in_proj_weight"]
    assert qkv.abs().max() <= np.sqrt(6 / 64)
    assert torch.equal(sa["human_encoder.transformer.layers.0.norm1.weight"], torch.ones(32))
    emb = sa["quantizer.vq.layers.2.embedding.weight"]
    assert emb.shape == (512, 16) and emb.abs().max() <= 1 / 512
    assert torch.equal(sa["quantizer.vq.layers.2.ema_w"], emb)  # warm start
    assert torch.equal(sa["quantizer.vq.layers.2.ema_cluster_size"], torch.ones(512))
    assert not a.training


def test_init_model_full_width_parameter_count_matches_jax():
    """The flagship's full-width tree holds as many numbers as the JAX one."""
    exp = jax_make_experiment("transformer", "hybrid", window=10, attn_packing=8)
    shapes = jax.eval_shape(lambda k: jax_init_model(exp.model, k)[1], jax.random.key(0))
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes))
    model = DualMotionVQVAE(ExperimentConfig.from_json(exp.to_json()).model)
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_port == n_jax


def test_torch_init_off_raises():
    """torch_init=False no longer raises: kernels are flax's lecun-normal,
    a normal truncated to 2 standard units at variance 1 / fan_in (the
    attention blocks' fan-in d), biases 0."""
    cfg = make_experiment("transformer", "hybrid", **SMALL, torch_init=False).model
    sd = init_model(cfg, 0, device="cpu").state_dict()
    for key, fan_in in (("human_encoder.input_proj.weight", 126),
                        ("robot_decoder.transformer.layers.1.linear2.weight", 64),
                        ("human_encoder.transformer.layers.0.self_attn.in_proj_weight", 32)):
        w = sd[key].numpy()
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= 2 * std + 1e-7, key
        assert abs(w.std() - np.sqrt(1.0 / fan_in)) < 0.1 * np.sqrt(1.0 / fan_in), key
    assert all(torch.count_nonzero(v) == 0 for k, v in sd.items() if k.endswith("bias"))


@pytest.mark.parametrize("over", [dict(cheap_dropout=True), dict(fused_attention=True)])
def test_eval_neutral_options_give_the_same_model(over):
    """Options that change only training or the JAX kernel choice build the
    same eval model."""
    base = init_model(make_experiment("transformer", "hybrid", **SMALL).model, 2,
                      device="cpu")
    other = init_model(make_experiment("transformer", "hybrid", **SMALL, **over).model, 2,
                       device="cpu")
    x = torch.from_numpy(windows(4, 8, 10, 126))
    with torch.no_grad():
        assert torch.equal(base(x_human=x)["human"]["retargeted"],
                           other(x_human=x)["human"]["retargeted"])


@pytest.mark.parametrize("arch,method", [("resnet", "hybrid"), ("transformer", "ema")])
def test_unported_models_raise(arch, method):
    """Every arch and method builds, with int8_ff too: it makes the
    transformer blocks' feed-forward pair Int8Dense and leaves a conv arch
    as it is."""
    from bridgerl_tpu_torch.models.layers import Int8Dense

    small = {k: v for k, v in SMALL.items() if k != "window"}
    plain = DualMotionVQVAE(make_experiment(arch, method, window=16, **small).model)
    int8 = DualMotionVQVAE(make_experiment(arch, method, window=16, int8_ff=True,
                                           **small).model)
    assert not any(isinstance(m, Int8Dense) for m in plain.modules())
    n_int8 = sum(isinstance(m, Int8Dense) for m in int8.modules())
    assert n_int8 == (2 * 3 * SMALL["n_tf_layers"] if arch == "transformer" else 0)
    assert {k: v.shape for k, v in plain.state_dict().items()} == \
        {k: v.shape for k, v in int8.state_dict().items()}


@pytest.mark.parametrize("kw", [
    dict(arch="transformer", method="hybrid", window=10),
    dict(arch="transformer", method="hybrid", window=64, tf_tokens=4),
    dict(arch="resnet", method="fsq", window=64, mode="student", seeds=(1, 2)),
    dict(arch="transformer", method="hybrid", window=10, attn_packing=8, hidden_dim=32),
])
def test_config_matches_jax(kw):
    kw = dict(kw)
    arch, method = kw.pop("arch"), kw.pop("method")
    ref = jax_make_experiment(arch, method, **kw)
    ours = make_experiment(arch, method, **kw)
    assert ours.to_dict() == dataclasses.asdict(ref)
    assert ExperimentConfig.from_json(ref.to_json()) == ours
    assert ours.run_name(3) == ref.run_name(3) and ours.log_name(3) == ref.log_name(3)


def test_config_rejects_bad_values():
    with pytest.raises(ValueError):
        ModelConfig(arch="mlp")
    with pytest.raises(ValueError):
        ModelConfig(window_size=10, tf_tokens=3)
    with pytest.raises(TypeError):
        make_experiment("transformer", "hybrid", not_a_field=1)
