"""K2 past 512 columns, on the CPU: the tensor-core kernel's arithmetic and the
flagship at a wide latent against the JAX package.

- ``csrc/k2_wide.cuh`` multiplies in 3xTF32: each float32 operand is split
  as k1_mma.cuh splits it (hi = the mantissa masked to tf32's 10 bits, lo =
  the same mask of x - hi) and a product is lo*hi + hi*lo + hi*hi. Emulated
  here in torch (the tensor cores' products of tf32 operands are exact;
  the sums are taken in float64), at chip_smoke.py's ``K2_WIDE`` shapes
  with fewer rows, and with codes scaled so that rows crowd onto a few of
  them: the emulated argmin is the float32 plain version's outside
  ``K2_TIE``'s near ties, and the distances' largest error against float64
  is at most twice the float32 plain version's (plain TF32's is over ten
  times larger).
- The flagship (transformer + hybrid, W 10) at hidden_dim 640 and 1024,
  narrowed to d_model 32 and one block, against the JAX package's model
  with the same weights (JAX sends the residual VQ's search past 512
  columns to XLA): code streams equal, outputs within 1e-5, and one
  training step (dropout 0, two microbatches) with its loss within 1e-5
  relative and every gradient within 1e-6.

Torch runs on one thread here, as the other training parity tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.models import init_model as jax_init_model
from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch.config import ExperimentConfig
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.ops import codebook
from bridgerl_tpu_torch.train.trainer import accumulate_grads, make_optimizer
from chip_smoke import K2_TIE, K2_WIDE

from test_torch_port_model import jax_codes, perturbed, windows

TF32_MASK = -8192   # 0xffffe000 as an int32: sign, exponent and tf32's 10 mantissa bits
WIDE = dict(window=10, d_model=32, n_tf_layers=1, n_heads=2, ff_dim=64, attn_packing=2,
            dropout=0.0)
ATOL, LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-6
STEP_BATCH = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_tf32(t: torch.Tensor):
    """k1_mma.cuh's split_tf32: t = hi + lo + r, hi and lo tf32 bit patterns."""
    hi = (t.view(torch.int32) & TF32_MASK).view(torch.float32)
    lo = ((t - hi).view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, lo


def products_3xtf32(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    xh, xl = split_tf32(x)
    ch, cl = split_tf32(cb)
    d = lambda a, b: a.double() @ b.double().t()   # noqa: E731
    return (d(xl, ch) + d(xh, cl) + d(xh, ch)).float()


@pytest.mark.parametrize("N,D,K", [(N // 8, D, K) for N, D, K in K2_WIDE])
@pytest.mark.parametrize("scale", [1.0, 0.25, 3.0])
def test_3xtf32_keeps_the_float32_nearest_codes(N, D, K, scale):
    rng = np.random.default_rng(N + D + int(8 * scale))
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    cb = torch.from_numpy((rng.standard_normal((K, D)) * scale).astype(np.float32))
    norm = (cb * cb).sum(1)
    want_idx, _, _ = codebook.nearest_codes_plain(x, cb)
    dist32 = norm[None, :] - 2.0 * (x @ cb.t())
    two = torch.topk(dist32, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) <= K2_TIE * (1.0 + two[:, 0].abs())
    got = torch.argmin(norm[None, :] - 2.0 * products_3xtf32(x, cb), dim=1).to(torch.int32)
    assert not ((got != want_idx) & ~near_tie).any()

    # the distances' largest error against float64: 3xTF32 within float32's own, TF32 not
    exact = norm.double()[None, :] - 2.0 * (x.double() @ cb.double().t())
    err = lambda dot: (norm.double()[None, :] - 2.0 * dot.double() - exact).abs().max().item()
    err32, err3 = err(x @ cb.t()), err(products_3xtf32(x, cb))
    hi_x, hi_c = split_tf32(x)[0], split_tf32(cb)[0]
    err1 = err(hi_x.double() @ hi_c.double().t())
    assert err3 <= 2.0 * err32 and err1 > 10.0 * err32


def _pair(hidden):
    exp = jax_make_experiment("transformer", "hybrid", hidden_dim=hidden, batch_size=STEP_BATCH,
                              accum_chunks=2, **WIDE)
    jmodel, variables = jax_init_model(exp.model, jax.random.key(0))
    variables = jax.tree_util.tree_map(np.asarray, perturbed(variables, 0))
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, 0, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    return exp, jmodel, variables, texp, model


@pytest.mark.parametrize("hidden", [640, 1024])
def test_wide_flagship_matches_jax(hidden):
    exp, jmodel, variables, texp, model = _pair(hidden)
    xr, xh = windows(1, 8, 10, 29), windows(2, 8, 10, 126)
    ref = jmodel.apply(variables, x_robot=xr, x_human=xh, train=False)
    model.eval()
    with torch.no_grad():
        got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh))
    for branch, key in (("robot", "recon"), ("human", "retargeted")):
        for k in (key, "z_e", "loss_vq"):
            np.testing.assert_allclose(got[branch][k].numpy(), np.asarray(ref[branch][k]),
                                       atol=ATOL, err_msg=f"{hidden} {branch}/{k}")
        codes = jax_codes(jmodel, variables, **{f"x_{branch}": xr if branch == "robot" else xh})
        assert sorted(got[branch]["codes"]) == sorted(codes)
        for k, v in codes.items():
            np.testing.assert_array_equal(got[branch]["codes"][k].numpy(), v, err_msg=k)

    # one teacher step: JAX's make_train_epoch with an optimizer that keeps the gradient
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))
    robot, human = windows(3, STEP_BATCH, 10, 29), windows(4, STEP_BATCH, 10, 126)
    idx = np.random.default_rng(5).permutation(STEP_BATCH).reshape(1, STEP_BATCH)
    params, rest = split_variables(variables)
    state, jlogs = jax_make_train_epoch(jmodel, keep, exp, mesh=None)(
        TrainState(params, rest, keep.init(params)), robot, human, idx,
        jax.random.split(jax.random.key(0), 1))
    want = state_dict_from_jax(
        jax.tree_util.tree_map(np.array, {"params": state.opt_state, **rest}), texp.model)

    model.train()
    make_optimizer(model, texp)
    logs = accumulate_grads(model, texp, torch.from_numpy(robot), torch.from_numpy(human),
                            torch.from_numpy(idx[0]), None)
    assert sorted(logs) == sorted(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    compared = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=GRAD_ATOL, err_msg=name)
        compared += 1
    assert compared > 20
