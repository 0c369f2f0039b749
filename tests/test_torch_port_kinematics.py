"""The port's G1 kinematics and FK loss against the JAX package's.

- the chain's arrays equal ``load_g1_chain()``'s, and its levels are
  [1, 3, 3, 3, 4, 4, 4, 2, 2, 2, 2] links;
- ``make_batched_fk`` on random (N, W, 29) radians within 1e-5 of JAX's
  (float32 products in another order) and of ``fk_numpy`` (float64), its
  rotations orthonormal within 1e-5, and ``make_fk``'s base frame honoured;
- ``fk_loss`` and its gradient within 1e-5 relative of JAX's ``jax.grad``;
- a teacher step with ``lambda_fk`` 1.0 against JAX's ``make_train_epoch``
  (the train-loop test's tolerances);
- ``fk_fn`` off unless ``lambda_fk`` > 0 and the robot has 29 joints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.sim import fk_numpy as jax_fk_numpy
from bridgerl_tpu.sim import load_g1_chain as jax_load_g1_chain
from bridgerl_tpu.sim import make_batched_fk as jax_make_batched_fk
from bridgerl_tpu.sim.urdf import rpy_to_matrix as jax_rpy_to_matrix
from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import losses as jax_losses
from bridgerl_tpu.train import make_optimizer as jax_make_optimizer
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.sim import (
    DEFAULT_ROOT_HEIGHT,
    G1_JOINT_NAMES,
    fk_numpy,
    load_g1_chain,
    make_batched_fk,
    make_fk,
    rpy_to_matrix,
)
from bridgerl_tpu_torch.train import losses
from bridgerl_tpu_torch.train.trainer import fk_fn, make_optimizer, make_train_epoch

from test_torch_port_train_ops import fresh_pair

ATOL = 1e-5
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


def _q(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, size=shape).astype(np.float32)


@pytest.mark.parametrize("field", ["parent_index", "origin_pos", "origin_rot", "axis",
                                   "actuated_index", "lower", "upper"])
def test_chain_equals_jax(field):
    got, want = getattr(load_g1_chain(), field), getattr(jax_load_g1_chain(), field)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_chain_names_and_levels():
    chain, jchain = load_g1_chain(), jax_load_g1_chain()
    assert chain.link_names == jchain.link_names and chain.joint_names == jchain.joint_names
    assert chain.actuated_names == jchain.actuated_names == G1_JOINT_NAMES
    assert (chain.num_links, chain.num_actuated) == (30, 29)
    assert np.bincount(chain.depth()).tolist() == [1, 3, 3, 3, 4, 4, 4, 2, 2, 2, 2]


@pytest.mark.parametrize("rpy", [(0.0, 0.0, 0.0), (0.3, -1.2, 2.5), (1.5707963, 0.2, -0.7)])
def test_rpy_to_matrix_matches_jax(rpy):
    np.testing.assert_array_equal(rpy_to_matrix(rpy), jax_rpy_to_matrix(rpy))


@pytest.mark.parametrize("shape", [(3, 10, 29), (1, 64, 29), (7, 1, 29)])
def test_batched_fk_matches_jax(shape):
    q = _q(shape)
    got = make_batched_fk(load_g1_chain())(torch.from_numpy(q)).numpy()
    want = np.asarray(jax_make_batched_fk(jax_load_g1_chain())(jnp.asarray(q)))
    assert got.shape == (*shape[:2], 30, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_fk_matches_numpy_reference(seed):
    chain = load_g1_chain()
    q = _q((4, 29), seed)
    pos, rot = make_fk(chain)(torch.from_numpy(q))
    for i in range(4):
        p, r = fk_numpy(chain, q[i].astype(np.float64))
        jp, jr = jax_fk_numpy(jax_load_g1_chain(), q[i].astype(np.float64))
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_allclose(pos[i].numpy(), p, atol=ATOL, rtol=0)
        np.testing.assert_allclose(rot[i].numpy(), r, atol=ATOL, rtol=0)


def test_rotations_are_orthonormal_and_root_is_the_base():
    pos, rot = make_fk(load_g1_chain())(torch.from_numpy(_q((5, 6, 29), 2)))
    eye = torch.eye(3).expand_as(rot)
    assert (rot @ rot.transpose(-1, -2) - eye).abs().max() < ATOL
    assert (torch.linalg.det(rot) - 1.0).abs().max() < ATOL
    np.testing.assert_array_equal(pos[..., 0, :].numpy(),
                                  np.broadcast_to([0.0, 0.0, DEFAULT_ROOT_HEIGHT], (5, 6, 3))
                                  .astype(np.float32))


def test_fk_base_frame():
    """A moved and turned base moves every link rigidly."""
    chain = load_g1_chain()
    q = torch.from_numpy(_q((2, 29), 3))
    R = torch.from_numpy(rpy_to_matrix((0.1, -0.4, 0.9)))
    t = torch.tensor([1.0, -2.0, 0.5])
    pos, rot = make_fk(chain)(q, base_pos=t, base_rot=R)
    p0, r0 = make_fk(chain)(q, base_pos=torch.zeros(3))
    np.testing.assert_allclose(pos.numpy(), (p0 @ R.t() + t).numpy(), atol=ATOL)
    np.testing.assert_allclose(rot.numpy(), (R @ r0).numpy(), atol=ATOL)


def test_fk_rejects_a_wrong_joint_count():
    with pytest.raises(ValueError, match="29"):
        make_batched_fk(load_g1_chain())(torch.zeros(1, 2, 28))


def test_fk_loss_and_gradient_match_jax():
    """1e-5 relative: the loss and its gradient in the reconstruction."""
    recon, real = _q((4, 10, 29), 4), _q((4, 10, 29), 5)
    jchain = jax_load_g1_chain()
    from bridgerl_tpu.sim import make_fk as jax_make_fk
    single = jax_make_fk(jchain)
    jfn = jax.vmap(jax.vmap(lambda q: single(q)[0]))
    jloss, jgrad = jax.value_and_grad(lambda r: jax_losses.fk_loss(r, real, jfn))(
        jnp.asarray(recon))
    r = torch.from_numpy(recon).requires_grad_()
    loss = losses.fk_loss(r, torch.from_numpy(real), make_batched_fk(load_g1_chain()))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())


def test_fk_loss_is_float32_in_bf16():
    recon = torch.from_numpy(_q((2, 10, 29), 6)).to(torch.bfloat16)
    loss = losses.fk_loss(recon, recon.float() + 0.01, make_batched_fk(load_g1_chain()))
    assert loss.dtype == torch.float32 and loss.item() > 0


@pytest.mark.parametrize("over,on", [(dict(lambda_fk=1.0), True), (dict(lambda_fk=0.0), False),
                                     (dict(lambda_fk=1.0, robot_input_dim=30), False)])
def test_fk_term_only_for_the_g1(over, on):
    exp = make_experiment("transformer", "hybrid", window=10, **over)
    assert (fk_fn(exp) is not None) == on


def test_teacher_step_with_lambda_fk_matches_jax():
    """One accumulated teacher step (2 microbatches, dropout 0) with
    lambda_fk 1: the logs within 1e-5 relative, every gradient within 1e-4
    in relative norm of JAX's (read from Adam's first moment), except the
    key rows of in_proj (a true gradient of 0: rounding residue, held at
    1e-5 of the largest gradient norm)."""
    batch = 16
    exp, jmodel, variables, texp, model = fresh_pair(dropout=0.0, batch_size=batch,
                                                     accum_chunks=2, lambda_fk=1.0)
    assert fk_fn(texp) is not None
    rng = np.random.default_rng(7)
    robot = rng.normal(scale=0.5, size=(batch, 10, 29)).astype(np.float32)
    human = rng.normal(size=(batch, 10, 126)).astype(np.float32)
    idx = np.arange(batch)[None]
    params, rest = split_variables(variables)
    tx = jax_make_optimizer(exp, params)
    state = TrainState(params, rest, tx.init(params))
    state, jlogs = jax_make_train_epoch(jmodel, tx, exp, mesh=None)(
        state, robot, human, idx, jax.random.split(jax.random.key(0), 1))
    opt = make_optimizer(model, texp)
    logs = make_train_epoch(texp)(model, opt, torch.from_numpy(robot), torch.from_numpy(human),
                                  torch.from_numpy(idx), None)
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], float(v), rtol=1e-5, err_msg=k)
    from bridgerl_tpu_torch.convert import state_dict_from_jax
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
