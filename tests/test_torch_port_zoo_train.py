"""Training steps of the model zoo against the JAX package's
``make_train_epoch``, on the CPU, and bf16 forwards of the conv towers
against JAX's bf16 model.

One optimizer batch of 4 windows in 2 microbatches at dropout 0, the same
index matrix on both sides, weights as in ``test_torch_port_zoo.py``. The JAX
gradient is read from AdamW's first moment after its first step (``mu = (1 -
b1) g``). Tolerances: every log 1e-5 relative; each parameter's gradient
1e-4 in relative norm; BatchNorm statistics and EMA state after the step 1e-6
(and 1e-5 relative). A convolution bias that feeds a BatchNorm has a true
gradient of exactly 0 (the batch mean cancels a constant shift), so both
sides hold only rounding residue there: those are held at 1e-5 of the
largest gradient norm instead.
"""

import jax
import numpy as np
import pytest
import torch

from bridgerl_tpu.train import TrainState, split_variables
from bridgerl_tpu.train import make_optimizer as jax_make_optimizer
from bridgerl_tpu.train import make_train_epoch as jax_make_train_epoch
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.train.trainer import make_optimizer, make_train_epoch

from chip_smoke import bf16_ulp
from test_torch_port_zoo import B, pair, state_close, windows

B1 = 0.9
GRAD_RTOL = 1e-4
RESIDUE = 1e-5


def _feeds_batchnorm(name: str) -> bool:
    return ".net.0.bias" in name or ".net.3.bias" in name


def _step(arch, method, mode="teacher"):
    """One optimizer step on both sides: (JAX logs, JAX state after, its
    gradient as a port state_dict, port logs, port model after, its
    experiment, the port model's state before)."""
    exp, jmodel, variables, texp, model = pair(arch, method, batch_size=B, accum_chunks=2,
                                               mode=mode)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    robot, human = windows(5, B, 8, 29), windows(6, B, 8, 126)
    idx = np.arange(B)[None]
    params, rest = split_variables(variables)
    tx = jax_make_optimizer(exp, params)
    state = TrainState(params, rest, tx.init(params))
    state, jlogs = jax_make_train_epoch(jmodel, tx, exp)(
        state, robot, human, idx, jax.random.split(jax.random.key(0), 1))
    adam = (state.opt_state[0] if mode == "teacher"
            else state.opt_state.inner_states["train"].inner_state[0])
    after = jax.tree_util.tree_map(np.asarray, state.variables())
    if mode == "teacher":
        grad_params = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1), adam.mu)
    else:   # the student's moments cover the human encoder only
        grad_params = {**after["params"], "human_encoder": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / (1 - B1), adam.mu["human_encoder"])}
    jgrad = state_dict_from_jax({**after, "params": grad_params}, texp.model)
    opt = make_optimizer(model, texp)
    logs = make_train_epoch(texp)(model, opt, torch.from_numpy(robot), torch.from_numpy(human),
                                  torch.from_numpy(idx), None)
    return jlogs, after, jgrad, logs, model, texp, before


def _check_grads(model, jgrad, only=None):
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()
             if p.grad is not None and (only is None or n.startswith(only))}
    assert grads
    largest = max(np.linalg.norm(jgrad[n].numpy()) for n in grads)
    for name, g in grads.items():
        w = jgrad[name].numpy()
        if _feeds_batchnorm(name):
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= RESIDUE * largest, name
            continue
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= GRAD_RTOL, f"{name}: gradient off by {rel} in relative norm"


@pytest.mark.parametrize("arch,method", [("resnet", "standard"), ("simple", "lfq"),
                                         ("resnet_no_down", "rvq")])
def test_accumulated_teacher_step_matches_jax(arch, method):
    jlogs, after, jgrad, logs, model, texp, _ = _step(arch, method)
    assert sorted(logs) == sorted(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], float(v), rtol=1e-5, err_msg=k)
    _check_grads(model, jgrad)
    if method == "standard":   # the codebook is a parameter that the loss reaches
        assert np.linalg.norm(model.quantizer.embedding.weight.grad.numpy()) > 0
    checked = state_close(model, after, texp.model)
    assert checked > 0 or arch == "simple"


def test_student_step_matches_jax_and_moves_the_frozen_statistics():
    """Only the human encoder trains, but both branches run in train mode:
    the frozen robot towers' BatchNorm statistics move (the decoder's twice a
    microbatch), as JAX's, and their parameters do not."""
    jlogs, after, jgrad, logs, model, texp, before = _step("resnet", "ema", mode="student")
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], float(v), rtol=1e-5, err_msg=k)
    _check_grads(model, jgrad, only="human_encoder.")
    assert state_close(model, after, texp.model) > 0
    now = model.state_dict()
    for name, p in model.named_parameters():
        if not name.startswith("human_encoder."):
            assert torch.equal(p.detach(), before[name]), name
    for tower in ("robot_encoder", "robot_decoder"):
        moved = [k for k in now if k.startswith(tower) and k.endswith("running_mean")]
        assert moved and all(not torch.equal(now[k], before[k]) for k in moved), tower
    tracked = now["robot_decoder.model.0.net.1.num_batches_tracked"]
    assert int(tracked) == 2 * 2   # two microbatches, both branches


@pytest.mark.parametrize("arch", ["simple", "resnet"])
def test_bf16_forward_matches_jax_bf16(arch):
    """compute_dtype="bfloat16" against JAX's bf16 model: on the windows
    whose codes agree, the outputs lie within 4 bf16 ulps of the output's
    scale (the two frameworks round the convolutions' bias sums and
    products at different places, a few ulps through the towers)."""
    exp, jmodel, variables, _, model = pair(arch, "hybrid", compute_dtype="bfloat16")
    xr, xh = windows(7, 32, 8, 29), windows(8, 32, 8, 126)
    ref, mods = jmodel.apply(variables, x_robot=xr, x_human=xh, mutable=["intermediates"])
    with torch.no_grad():
        got = model(x_robot=torch.from_numpy(xr), x_human=torch.from_numpy(xh))
    from test_torch_port_zoo import jax_codes
    compared = 0
    for call, (branch, key) in enumerate((("robot", "recon"), ("human", "retargeted"))):
        assert got[branch][key].dtype == torch.bfloat16
        want_codes = jax_codes(mods["intermediates"], call)
        rows = np.all([(got[branch]["codes"][k].numpy() == v).reshape(len(v), -1).all(1)
                       for k, v in want_codes.items()], axis=0)
        g = got[branch][key].float().numpy()[rows]
        w = np.asarray(ref[branch][key], np.float32)[rows]
        if rows.any():
            scale = float(np.abs(w).max())
            assert np.abs(g - w).max() <= 4 * bf16_ulp(scale), (branch, scale)
        compared += int(rows.sum())
    assert compared >= 32   # most windows keep their codes
