"""bfloat16 compute in the port against the JAX package's, on the CPU.

The JAX package computes in bfloat16 with float32 parameters, casting at
each module's boundary (flax's mixed precision); the port does the same with
explicit casts. K1 follows the TPU kernel (``fused_attention=True``): bf16
in and out, float32 softmax inside. Inputs are numpy arrays from a seed;
weights come from the JAX init through ``convert.state_dict_from_jax``; the
JAX Pallas kernel runs in interpret mode. Small widths: d_model 32, two
layers, two heads (Dh 16).

Tolerances, each with its reason:

- K1 (plain version against the Pallas kernel): one bf16 ulp of the JAX
  value plus 1e-6 absolute. Both round the same float32 quantity once and
  differ only in summation order; the 1e-6 is that order's float32 noise,
  visible only where a sum cancels to near 0 (a dv of ~1e-6 is 2 ulps apart
  otherwise).
- A block and the whole model against JAX's bf16 model: 4 ulps of the
  output's largest magnitude (measured: 2 ulps, 0.031 at a scale of 2.4).
  flax rounds each Dense's product and then its bias sum to bf16, torch
  rounds the biased product once, and LayerNorm computes its statistics in
  another order; those 1-ulp differences pass through the residual stream of
  every block. The same outputs must also lie no farther from JAX's float32
  model than twice JAX's own bf16 answer does.
- JAX's default attention (``fused_attention=False``: flax's bf16 logits and
  softmax) is a known difference: its tower outputs are held to 8 ulps of
  the scale, its model outputs only on the windows whose codes agree.
- The train step: each parameter's gradient no farther from JAX's float32
  gradient, in relative norm, than twice JAX's bf16 gradient is (the bf16
  rounding of the two frameworks differs as above, and its effect on a
  gradient is as large as bf16 itself); the loss 1e-2 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.models import init_model as jax_init_model
from bridgerl_tpu.models import layers as jax_layers
from bridgerl_tpu.ops.pallas.attention import _packed_attention
from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch.config import ExperimentConfig, compute_dtype, make_experiment
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.data.dataset import PairedDataset
from bridgerl_tpu_torch.export.server import ServingApp
from bridgerl_tpu_torch.export.serving import build_serving_module
from bridgerl_tpu_torch.models import init_model, layers
from bridgerl_tpu_torch.ops import attention
from bridgerl_tpu_torch.train.checkpoint import load_checkpoint
from bridgerl_tpu_torch.train.trainer import (
    Trainer,
    accumulate_grads,
    make_optimizer,
    make_train_epoch,
)
from chip_smoke import bf16_ulp, bf16_ulps

from test_torch_port_model import perturbed

BF16 = torch.bfloat16
SMALL = dict(window=10, hidden_dim=16, d_model=32, n_tf_layers=2, n_heads=2, ff_dim=64,
             attn_packing=2, dropout=0.0)
K1_ATOL = 1e-6       # float32 summation-order noise (see the module docstring)
MODEL_ULPS = 4       # of the output's largest magnitude
DEFAULT_ULPS = 8     # the gap to flax's bf16 softmax, on the towers' outputs


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32), np.float32)


@functools.lru_cache(maxsize=None)
def _pair(dtype="bfloat16", fused=True, seed=0):
    exp = jax_make_experiment("transformer", "hybrid", compute_dtype=dtype,
                              fused_attention=fused, **SMALL)
    jmodel, variables = jax_init_model(exp.model, jax.random.key(seed))
    variables = jax.tree_util.tree_map(np.asarray, perturbed(variables, seed))
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, seed, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    return exp, jmodel, variables, texp, model


def _inputs(seed=1, b=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 10, 29)).astype(np.float32),
            rng.normal(size=(b, 10, 126)).astype(np.float32))


# ---------------------------------------------------------------- K1

K1_SHAPES = [(6, 80, 16, 8), (8, 10, 16, 1), (8, 80, 64, 8), (4, 20, 32, 2)]


@pytest.mark.parametrize("BH,S,Dh,P", K1_SHAPES)
def test_k1_plain_matches_the_pallas_kernel_in_bf16(BH, S, Dh, P):
    """Forward and backward (jax.vjp) of the TPU kernel in interpret mode on
    bf16 inputs, dropout 0: one bf16 ulp, plus the float32 noise."""
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.normal(size=(BH, S, Dh)).astype(np.float32) for _ in range(4))
    bias = layers.attention_bias(P, S // P)
    scale = Dh ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    ref, vjp = jax.vjp(lambda a, b, c: _packed_attention(a, b, c, jnp.asarray(bias.numpy()),
                                                         jnp.int32(0), scale, 0.0),
                       jq, jk, jv)
    tq, tk, tv, tdo = (_bf16(a) for a in (q, k, v, do))
    out = attention.packed_attention_reference(tq, tk, tv, bias, scale, 0, 0.0, S // P)
    grads = attention.packed_attention_bwd_reference(tq, tk, tv, bias, tdo, scale, 0, 0.0,
                                                     S // P)
    assert ref.dtype == jnp.bfloat16 and out.dtype == BF16
    assert bf16_ulps(out, torch.from_numpy(_np(ref)), K1_ATOL) <= 1.0
    for name, g, w in zip(("dq", "dk", "dv"), grads, vjp(jdo)):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        assert bf16_ulps(g, torch.from_numpy(_np(w)), K1_ATOL) <= 1.0, name


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_plain_bf16_is_the_float32_function_rounded_once(rate):
    """The bf16 plain versions equal the float32 ones on the widened inputs,
    rounded to bf16 at the end: bit for bit."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(6, 40, 32, generator=g).to(BF16) for _ in range(4))
    bias = layers.attention_bias(4, 10)
    args = (bias, 0.2, 77, rate, 10)
    out = attention.packed_attention_reference(q, k, v, *args)
    want = attention.packed_attention_reference(q.float(), k.float(), v.float(), *args)
    assert out.dtype == BF16 and torch.equal(out, want.to(BF16))
    got = attention.packed_attention_bwd_reference(q, k, v, bias, do, 0.2, 77, rate, 10)
    want = attention.packed_attention_bwd_reference(q.float(), k.float(), v.float(), bias,
                                                    do.float(), 0.2, 77, rate, 10)
    for a, b in zip(got, want):
        assert a.dtype == BF16 and torch.equal(a, b.to(BF16))


def test_k1_autograd_in_bf16_gives_bf16_gradients():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, 20, 16, generator=g).to(BF16).requires_grad_()
               for _ in range(3))
    out = attention.packed_attention(q, k, v, layers.attention_bias(2, 10), 0.25, 0.1,
                                     torch.Generator().manual_seed(2), window=10)
    out.float().sum().backward()
    assert out.dtype == BF16 and all(t.grad.dtype == BF16 for t in (q, k, v))


@pytest.mark.parametrize("bad", ["mixed", "bias_bf16", "float16", "dout_f32"])
def test_k1_wrapper_checks_take_bf16_alike_and_a_float32_bias(bad):
    """The checks the CUDA wrappers make before a launch: q, k, v (and dout)
    all float32 or all bf16, the bias float32."""
    q = torch.zeros(2, 10, 16, dtype=BF16)
    bias = torch.zeros(10, 10)
    plan = attention._check(q, q, q, bias, None, 10, "bwd", extra=(("dout", q),))
    assert plan == attention.k1_plan(2, 10, 10, 16, BF16, "bwd")
    args = dict(q=q, k=q, v=q, bias=bias, dout=q)
    if bad == "mixed":
        args["k"] = q.float()
    elif bad == "bias_bf16":
        args["bias"] = bias.to(BF16)
    elif bad == "float16":
        args.update(q=q.half(), k=q.half(), v=q.half(), dout=q.half())
    elif bad == "dout_f32":
        args["dout"] = q.float()
    with pytest.raises(ValueError):
        attention._check(args["q"], args["k"], args["v"], args["bias"], None, 10, "bwd",
                         extra=(("dout", args["dout"]),))


# ---------------------------------------------------------------- towers and model

def test_compute_dtype_maps_the_config():
    assert compute_dtype(make_experiment("transformer", "hybrid").model) == torch.float32
    cfg = make_experiment("transformer", "hybrid", compute_dtype="bfloat16").model
    assert compute_dtype(cfg) == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        compute_dtype(make_experiment("transformer", "hybrid", compute_dtype="fp8").model)


@pytest.mark.parametrize("d_model,max_len", [(32, 10), (256, 10), (256, 80)])
def test_bf16_positional_table_equals_jax(d_model, max_len):
    """Built step by step in bf16 as the JAX package builds it: bit for bit
    (the float32 table rounded once differs by up to 0.3 at 80 positions)."""
    got = layers.sinusoidal_pe(max_len, d_model, BF16)
    want = jax_layers.sinusoidal_pe(max_len, d_model, jnp.bfloat16)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_bf16_activation_dropout_divides_by_the_bf16_keep():
    """flax divides by keep converted to bf16 (0.9 -> 0.8984375)."""
    x = torch.linspace(-3, 3, 4001).to(BF16)
    y = layers.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    want = jnp.asarray(_np(x)).astype(jnp.bfloat16) / 0.9
    assert y.dtype == BF16
    np.testing.assert_array_equal(_np(y)[kept.numpy()], _np(want)[kept.numpy()])


def test_bf16_block_matches_jax():
    """Block 0 of the robot encoder on bf16 activations against flax's
    TransformerBlock in bf16 with the TPU kernel: 4 ulps of the scale."""
    exp, _, variables, _, model = _pair()
    m = exp.model
    jblock = jax_layers.TransformerBlock(m.d_model, m.n_heads, m.ff_dim, dropout=0.0,
                                         dtype=jnp.bfloat16, torch_init=True,
                                         fused_attention=True)
    h = np.random.default_rng(2).normal(size=(8, 10, m.d_model)).astype(np.float32)
    want = jblock.apply({"params": variables["params"]["robot_encoder"]["layer_0"]},
                        jnp.asarray(h, jnp.bfloat16))
    stack = model.robot_encoder.transformer
    with torch.no_grad():
        got = stack.layers[0](_bf16(h), stack.bias_single, window=10)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    err = np.abs(_np(got) - _np(want)).max()
    print(f"bf16 block vs JAX: max abs {err} at scale {np.abs(_np(want)).max()}")
    assert err <= MODEL_ULPS * bf16_ulp(np.abs(_np(want)).max())


def _model_outputs(jmodel, variables, model, xr, xh):
    ref = jmodel.apply(variables, x_robot=xr, x_human=xh, train=False)
    with torch.no_grad():
        got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh))
    return ref, got


BRANCH_KEYS = (("robot", "recon"), ("robot", "z_e"), ("human", "retargeted"), ("human", "z_e"))


def test_bf16_model_matches_jax_in_eval_mode():
    """The whole model in bf16 against JAX's with the TPU kernel's
    attention: outputs and latents within 4 ulps of their scale and no
    farther from JAX's float32 model than twice JAX's bf16 answer; losses
    1e-2 relative; code streams equal on every window."""
    _, jmodel, variables, _, model = _pair()
    _, j32, v32, _, _ = _pair("float32")
    xr, xh = _inputs()
    ref, got = _model_outputs(jmodel, variables, model, xr, xh)
    ref32 = j32.apply(v32, x_robot=xr, x_human=xh, train=False)
    for branch, key in BRANCH_KEYS:
        g, w, w32 = _np(got[branch][key]), _np(ref[branch][key]), _np(ref32[branch][key])
        assert got[branch][key].dtype == BF16
        scale = np.abs(w).max()
        err, own = np.abs(g - w).max(), np.abs(w - w32).max()
        print(f"{branch}/{key}: port vs JAX bf16 {err}, JAX bf16 vs f32 {own}, "
              f"port vs JAX f32 {np.abs(g - w32).max()}, scale {scale}")
        assert err <= MODEL_ULPS * bf16_ulp(scale), f"{branch}/{key}"
        assert np.abs(g - w32).max() <= 2 * own, f"{branch}/{key}"
        assert got[branch]["loss_vq"].dtype == torch.float32
        np.testing.assert_allclose(got[branch]["loss_vq"].item(),
                                   float(ref[branch]["loss_vq"]), rtol=1e-2)
    _, mods = jmodel.apply(variables, x_human=xh, train=False, mutable=["intermediates"])
    with torch.no_grad():
        codes = model(x_human=torch.from_numpy(xh))["human"]["codes"]
    flat = jax.tree_util.tree_flatten_with_path(mods["intermediates"])[0]
    want = {"/".join(p.key for p in path[:-2]): np.asarray(v) for path, v in flat}
    assert sorted(codes) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(codes[k].numpy(), v, err_msg=k)


def test_bf16_gap_to_jax_default_attention():
    """flax's default attention takes bf16 logits and a bf16 softmax; the
    port follows the TPU kernel's float32 softmax. The gap, printed: the
    towers' latents within 8 ulps of their scale, the outputs on the windows
    whose codes agree within 8 ulps, and most windows' codes agree."""
    _, _, variables, _, model = _pair()
    exp_d, jdefault, _, _, _ = _pair(fused=False)
    xr, xh = _inputs()
    ref, got = _model_outputs(jdefault, variables, model, xr, xh)
    _, mods = jdefault.apply(variables, x_human=xh, train=False, mutable=["intermediates"])
    flat = jax.tree_util.tree_flatten_with_path(mods["intermediates"])[0]
    want = {"/".join(p.key for p in path[:-2]): np.asarray(v)[:, 0] for path, v in flat}
    with torch.no_grad():
        codes = model(x_human=torch.from_numpy(xh))["human"]["codes"]
    same = np.all([codes[k].numpy()[:, 0] == v for k, v in want.items()], axis=0)
    print(f"codes agree on {same.mean()} of windows")
    assert same.mean() >= 0.75
    for branch, key in BRANCH_KEYS:
        g, w = _np(got[branch][key]), _np(ref[branch][key])
        scale = np.abs(w).max()
        rows = same if (branch, key) == ("human", "retargeted") else slice(None)
        print(f"{branch}/{key} vs JAX default: max abs {np.abs(g - w).max()}, on agreeing "
              f"windows {np.abs(g[rows] - w[rows]).max()}, scale {scale}")
        assert np.abs(g[rows] - w[rows]).max() <= DEFAULT_ULPS * bf16_ulp(scale), f"{branch}/{key}"


def test_bf16_parameters_and_gradients_stay_float32():
    """Mixed precision as in tests/test_bf16.py: the parameters, buffers and
    gradients are float32 after a bf16 forward and backward; the losses are
    float32."""
    _, _, _, texp, _ = _pair()
    model = init_model(texp.model, 0, device="cpu")
    xr, xh = _inputs()
    out = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh), train=True,
                generator=torch.Generator().manual_seed(0))
    loss = (out["robot"]["recon"].float() ** 2).mean() + out["robot"]["loss_vq"]
    loss.backward()
    assert loss.dtype == torch.float32 and out["robot"]["recon"].dtype == BF16
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert len(grads) > 20      # the robot branch's: the loss leaves the human encoder out
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
    assert all(g.dtype == torch.float32 for g in grads.values())
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32, name


def test_bf16_tower_activations_stay_bf16():
    """Every module of the towers returns bf16, from the input projection to
    the output projection: a float32 buffer added to a bf16 tensor would
    promote the stack to float32 silently."""
    _, _, _, texp, _ = _pair()
    model = init_model(texp.model, 0, device="cpu")
    seen = []
    for tower in (model.human_encoder, model.robot_encoder, model.robot_decoder):
        for name, mod in tower.named_modules():
            mod.register_forward_hook(
                lambda m, i, o, name=name: seen.append((name, o.dtype)))
    xr, xh = _inputs()
    with torch.no_grad():
        model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh))
    assert len(seen) > 30
    assert all(dt == BF16 for _, dt in seen), [s for s in seen if s[1] != BF16]


# ---------------------------------------------------------------- training

STEP_BATCH = 32
STEP = dict(fused_attention=True, batch_size=STEP_BATCH, accum_chunks=2, **SMALL)


def _keep_grads() -> optax.GradientTransformation:
    """An optimizer that leaves the parameters as they are and keeps the
    batch's gradient as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           grads))


def _jax_step_grads(dtype: str, variables, robot, human, idx):
    """The logs and the gradient of one optimizer batch through the JAX
    package's make_train_epoch (its teacher loss, its microbatch
    accumulation), as port state-dict entries."""
    exp = jax_make_experiment("transformer", "hybrid", compute_dtype=dtype, **STEP)
    jmodel, _ = jax_init_model(exp.model, jax.random.key(0))
    params, rest = split_variables(variables)
    tx = _keep_grads()
    state, logs = jax_make_train_epoch(jmodel, tx, exp, mesh=None)(
        TrainState(params, rest, tx.init(params)), robot, human, idx,
        jax.random.split(jax.random.key(0), 1))
    grads = jax.tree_util.tree_map(np.array, {"params": state.opt_state, **rest})
    return ({k: float(v) for k, v in logs.items()},
            state_dict_from_jax(grads, ExperimentConfig.from_json(exp.to_json()).model))


def test_bf16_teacher_step_matches_jax():
    """The gradient of one teacher optimizer batch (two microbatches, dropout
    0) in bf16 against JAX's through make_train_epoch, with the TPU kernel
    and the same index matrix: every parameter's gradient no farther from
    JAX's float32 gradient, in relative norm, than twice JAX's bf16 gradient
    is (as chip_smoke.py's train_agree_bf16 holds the card); the loss within
    1e-2 of JAX's bf16 loss and no farther from the float32 loss than twice
    JAX's bf16 loss, or one bf16 rounding of it. Parameters outside the
    teacher's loss have no gradient in the port and a zero one in JAX."""
    exp = jax_make_experiment("transformer", "hybrid", compute_dtype="bfloat16", **STEP)
    _, variables = jax_init_model(exp.model, jax.random.key(0))
    variables = jax.tree_util.tree_map(np.asarray, perturbed(variables, 0))
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, 0, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    robot, human = _inputs(4, STEP_BATCH)
    idx = np.random.default_rng(5).permutation(STEP_BATCH).reshape(1, STEP_BATCH)
    logs16, want16 = _jax_step_grads("bfloat16", variables, robot, human, idx)
    logs32, want32 = _jax_step_grads("float32", variables, robot, human, idx)

    make_optimizer(model, texp)
    logs = accumulate_grads(model, texp, torch.from_numpy(robot), torch.from_numpy(human),
                            torch.from_numpy(idx[0]), None)
    assert sorted(logs) == sorted(logs16)
    for k, v in logs16.items():
        got, v32 = float(logs[k]), logs32[k]
        print(f"{k}: port {got} JAX bf16 {v} JAX float32 {v32}")
        np.testing.assert_allclose(got, v, rtol=1e-2, err_msg=k)
        assert abs(got - v32) <= max(2 * abs(v - v32), 2.0 ** -8 * abs(v32)), k

    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    ratios = {}
    for name, p in model.named_parameters():
        w16, w32 = want16[name].numpy(), want32[name].numpy()
        if p.grad is None:
            assert not w32.any() and not w16.any(), name
            continue
        assert p.grad.dtype == torch.float32 and np.linalg.norm(w32) > 0, name
        got, own = rel(p.grad.numpy(), w32), rel(w16, w32)
        ratios[name] = got / own
        assert got <= 2 * own, f"{name}: {got} from JAX float32, JAX bf16 {own}"
    worst = max(ratios, key=ratios.get)
    print(f"{len(ratios)} gradients; worst {worst} at {ratios[worst]} x JAX bf16's distance, "
          f"median {np.median(list(ratios.values()))}")
    assert len(ratios) > 40


def test_bf16_three_steps_lower_the_loss():
    """Three optimizer steps on one batch in bf16: the loss falls and stays
    finite (the counterpart of tests/test_bf16.py's convergence test)."""
    exp = make_experiment("transformer", "hybrid", compute_dtype="bfloat16", batch_size=32,
                          accum_chunks=1, learning_rate=2e-3, **SMALL)
    model = init_model(exp.model, 0, device="cpu")
    opt = make_optimizer(model, exp)
    robot, human = (torch.from_numpy(a) for a in _inputs(6, 32))
    step = make_train_epoch(exp)
    idx = torch.arange(32)[None]
    losses = [step(model, opt, robot, human, idx, None)["train_loss"] for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_bf16_trainer_teacher_then_student_keeps_float32_checkpoints(tmp_path):
    """The Trainer runs the bf16 teacher then student on the CPU; both write
    the reference's float32 .pth layout."""
    kw = dict(compute_dtype="bfloat16", batch_size=32, accum_chunks=2, epochs=1,
              **{**SMALL, "dropout": 0.1})

    def exp(**over):
        e = make_experiment("transformer", "hybrid", **kw, **over)
        return dataclasses.replace(e, log_dir=str(tmp_path / "results"),
                                   checkpoint_dir=str(tmp_path / "checkpoints"))

    rng = np.random.default_rng(3)
    ds = PairedDataset.from_numpy(rng.normal(size=(110, 10, 29)).astype(np.float32),
                                  rng.normal(size=(110, 10, 126)).astype(np.float32),
                                  device="cpu")
    teacher = Trainer(exp(), device="cpu", verbose=False)
    hist = teacher.run(ds)[42]
    assert np.isfinite(hist["train_loss"]).all() and np.isfinite(hist["val_recon"]).all()
    student = Trainer(exp(mode="student", teacher_ckpt=teacher.ckpt_path(42, "best")),
                      device="cpu", verbose=False)
    shist = student.run(ds)[42]
    assert np.isfinite(shist["val_align"]).all()
    for tr in (teacher, student):
        sd = torch.load(tr.ckpt_path(42, "best"), map_location="cpu",
                        weights_only=True)["model_state_dict"]
        assert all(t.dtype == torch.float32 for t in sd.values())
        assert sd["quantizer.fsq.project_in.weight"].ndim == 3   # the reference's conv
        init_model(tr.exp.model, 0, device="cpu").load_state_dict(
            load_checkpoint(tr.ckpt_path(42, "best"))["model_state_dict"])


# ---------------------------------------------------------------- serving

def test_bf16_serving_is_float32_at_the_boundary_and_pads_buckets():
    """The serving functions of a bf16 model take and return float32, the
    answers lie no farther from the float32 model's than 4 ulps of their
    scale, and ServingApp's zero-padded bucket (3 -> 4) gives the rows of
    the unpadded call."""
    _, _, _, texp, model = _pair()
    _, _, _, texp32, model32 = _pair("float32")
    module = build_serving_module(model, texp)
    module32 = build_serving_module(model32, texp32)
    assert module.meta["functions"] == module32.meta["functions"]
    x = _inputs(7, 3)[1]
    got, want = module.fns["retarget"](x), module32.fns["retarget"](x)
    assert got.dtype == torch.float32 and got.shape == (3, 10, 29)
    assert (got - want).abs().max().item() <= MODEL_ULPS * bf16_ulp(want.abs().max())
    padded = ServingApp(module).call("retarget", x)
    exact = ServingApp(module, bucket_batches=False).call("retarget", x)
    assert padded.dtype == np.float32 and padded.shape == exact.shape
    assert np.abs(padded - exact).max() <= MODEL_ULPS * bf16_ulp(np.abs(exact).max())
    codes = ServingApp(module).call("motion_codes", x)
    assert all(v.dtype == np.int32 and v.shape == (3, 1) for v in codes.values())
