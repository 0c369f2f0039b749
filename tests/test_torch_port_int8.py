"""The port's int8 feed-forward against the JAX package's ``ops/int8.py``.

- ``int8_matmul`` forward, float32 and bfloat16, on normal rows and rows
  with outliers (one entry 100x its row), all-zero rows (the 1e-8 scale
  floor) and ties at x.5 (round half to even): bit for bit in both dtypes
  (the same integer product, scales and roundings);
- its straight-through gradients against JAX's ``custom_vjp`` within 1e-6
  relative (float32) and 1 bf16 ulp of the largest (bfloat16);
- the quantizer itself: scales and int8 values equal JAX's;
- ``Int8Dense`` state_dicts interchangeable with ``Dense``'s, and its bias
  added after the product's rounding (in bf16 that is not ``Dense``'s
  single rounding);
- the transformer + hybrid with ``int8_ff``: eval and train forwards within
  1e-5 of JAX's ``int8_ff`` model in float32, and one accumulated teacher
  step's logs within 1e-5 relative, gradients within 1e-4 in relative norm
  (the key rows of in_proj, whose true gradient is 0, at 1e-5 of the
  largest gradient norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.ops import int8 as jax_int8
from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import make_optimizer as jax_make_optimizer
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.models.layers import Dense, Int8Dense
from bridgerl_tpu_torch.ops import int8
from bridgerl_tpu_torch.train.trainer import make_optimizer, make_train_epoch

from chip_smoke import bf16_ulp
from test_torch_port_train_ops import fresh_pair

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
B1 = 0.9



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    torch's default of one thread a core oversubscribes it (tens of times
    slower for these small models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind, seed=0, shape=(3, 7, 32), n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(scale=0.2, size=(shape[-1], n)).astype(np.float32)   # JAX's (K, N)
    if kind == "outliers":
        x[0, 0, 3] *= 100.0
        x[1, 2, 0] = -250.0
        w[5, 2] = 40.0
    elif kind == "zeros":
        x[0, :2] = 0.0
        w[:, 1] = 0.0
    elif kind == "ties":       # values on x.5 steps of their row's scale
        x[..., :] = np.round(rng.uniform(-127, 127, size=shape)) / 2.0
        x[..., 0] = 63.5
    return x, w


def _torch(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["normal", "outliers", "zeros", "ties"])
def test_int8_matmul_forward_matches_jax(kind, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w = _inputs(kind)
    got = int8.int8_matmul(_torch(x, tdt), _torch(w.T, tdt))
    want = np.asarray(jax_int8.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
                      .astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (3, 7, 16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, _ = _inputs("outliers", 1)
    q, s = int8.quantize(_torch(x, tdt), -1)
    jq, js = jax_int8._quantize(jnp.asarray(x, jdt), -1)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_matmul_gradients_match_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, w = _inputs("outliers", 2)
    g = np.random.default_rng(3).normal(size=(3, 7, 16)).astype(np.float32)
    _, vjp = jax.vjp(jax_int8.int8_matmul, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jgx, jgw = (np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g, jdt)))
    xt, wt = _torch(x, tdt).requires_grad_(), _torch(w.T, tdt).requires_grad_()
    int8.int8_matmul(xt, wt).backward(_torch(g, tdt))
    assert xt.grad.dtype == wt.grad.dtype == tdt
    for got, want in ((xt.grad.float().numpy(), jgx), (wt.grad.float().numpy().T, jgw)):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=bf16_ulp(np.abs(want).max()))


def test_straight_through_is_the_plain_product_gradient():
    x, w = (torch.randn(5, 16, generator=torch.Generator().manual_seed(i)).requires_grad_()
            for i in range(2))
    int8.int8_matmul(x, w).sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (x @ w.t()).sum().backward()
    assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)


def test_stacked_int8_matmul_is_per_seed():
    """A seed-stacked weight quantizes and multiplies each seed on its own."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 6, 16, generator=g), torch.randn(3, 8, 16, generator=g)
    got = int8.int8_matmul(x, w, 3)
    for s in range(3):
        assert torch.equal(got[s], int8.int8_matmul(x[s], w[s]))


def test_int_product_is_exact():
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-127, 128, (9, 512), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (24, 512), generator=g, dtype=torch.int8)
    want = a.long() @ b.long().t()
    assert torch.equal(int8.int_product(a, b).long(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_dense_state_dict_is_dense(dtype):
    tdt, _ = DTYPES[dtype]
    dense, q = Dense(32, 16, tdt), Int8Dense(32, 16, tdt)
    assert {k: v.shape for k, v in dense.state_dict().items()} == \
        {k: v.shape for k, v in q.state_dict().items()}
    q.load_state_dict(dense.state_dict(), strict=True)
    dense.load_state_dict(q.state_dict(), strict=True)
    x = torch.randn(4, 32)
    y = q(x)
    assert y.dtype == tdt
    with torch.no_grad():
        q.bias.fill_(0.3)
    want = (int8.int8_matmul(x.to(tdt), q.weight.to(tdt)) + q.bias.to(tdt))
    assert torch.equal(q(x), want)


def test_int8_model_matches_jax_forward():
    """Eval and train (dropout 0) forwards of both branches within 1e-5."""
    exp, jmodel, variables, texp, model = fresh_pair(int8_ff=True, dropout=0.0)
    rng = np.random.default_rng(8)
    xr = rng.normal(size=(8, 10, 29)).astype(np.float32)
    xh = rng.normal(size=(8, 10, 126)).astype(np.float32)
    for train in (False, True):
        ref = jmodel.apply(variables, x_robot=xr, x_human=xh, train=train,
                           mutable=["qstats", "intermediates"] if train else False)
        ref = ref[0] if train else ref
        with torch.no_grad():
            got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh),
                        train=train)
        for branch, key in (("robot", "recon"), ("human", "retargeted"), ("robot", "z_e")):
            np.testing.assert_allclose(got[branch][key].numpy(), np.asarray(ref[branch][key]),
                                       atol=1e-5, err_msg=f"{train} {branch} {key}")


def test_int8_teacher_step_matches_jax():
    batch = 16
    exp, jmodel, variables, texp, model = fresh_pair(int8_ff=True, dropout=0.0,
                                                     batch_size=batch, accum_chunks=2)
    rng = np.random.default_rng(9)
    robot = rng.normal(size=(batch, 10, 29)).astype(np.float32)
    human = rng.normal(size=(batch, 10, 126)).astype(np.float32)
    idx = np.arange(batch)[None]
    params, rest = split_variables(variables)
    tx = jax_make_optimizer(exp, params)
    state = TrainState(params, rest, tx.init(params))
    state, jlogs = jax_make_train_epoch(jmodel, tx, exp, mesh=None)(
        state, robot, human, idx, jax.random.split(jax.random.key(0), 1))
    logs = make_train_epoch(texp)(model, make_optimizer(model, texp), torch.from_numpy(robot),
                                  torch.from_numpy(human), torch.from_numpy(idx), None)
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], float(v), rtol=1e-5, err_msg=k)
    after = jax.tree_util.tree_map(np.asarray, state.variables())
    mu = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1), state.opt_state[0].mu)
    jgrad = state_dict_from_jax({**after, "params": mu}, texp.model)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    largest = max(np.linalg.norm(jgrad[n].numpy()) for n in grads)
    for name, g in grads.items():
        w = jgrad[name].numpy()
        if name.endswith(("in_proj_bias", "in_proj_weight")):
            d = w.shape[0] // 3
            assert np.linalg.norm(g[d:2 * d] - w[d:2 * d]) <= 1e-5 * largest, name
            g, w = (np.delete(a, np.s_[d:2 * d], axis=0) for a in (g, w))
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, f"{name}: {rel}"
