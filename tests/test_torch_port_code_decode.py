"""Code decode (``ops/code_decode.py``) against the JAX package's, on the CPU.

Weights are the JAX model's variable tree filled from a numpy seed
(``test_torch_port_zoo.py::pair``: hidden 16, K 32, one residual block,
window 8), converted with ``convert.state_dict_from_jax``. The same integer
code streams (the JAX forward's, on seeded numpy windows) decode through
both packages: float32 latents within 1e-6. The eval-mode round trip is
exact: with the straight-through estimator's ``z + (z_q - z)`` taken as
``z_q``, decoding a forward's codes gives back that forward's ``z_q`` bit
for bit (in float32 and in bfloat16); as the forward computes it, within
1e-6. The live ``decode_codes`` serving function agrees with the JAX
``make_serving_fns``'s within 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.export.serialize import make_serving_fns as jax_make_serving_fns
from bridgerl_tpu.ops import code_decode as jax_cd
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.export.serving import build_serving_module, identity_stats
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.ops import code_decode, quantizers

from test_torch_port_model import jax_and_port, jax_codes, windows
from test_torch_port_zoo import B, ZOO, pair, one_torch_thread  # noqa: F401

QUANTIZED = ("standard", "ema", "rvq", "fsq", "lfq", "hybrid")
ATOL = 1e-6

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _x(seed, cfg, dim=29):
    return windows(seed, B, cfg.window_size, dim)


@torch.no_grad()
def _decode(cfg, model, codes):
    return code_decode.decode_codes(cfg, model,
                                    {k: torch.as_tensor(v) for k, v in codes.items()})


@pytest.mark.parametrize("method", QUANTIZED)
def test_decode_matches_jax(method):
    """The JAX forward's codes decode to the same latent in both packages."""
    exp, jmodel, variables, texp, model = pair("resnet_no_down", method)
    codes = jax_codes(jmodel, variables, x_robot=jnp.asarray(_x(1, texp.model)))
    assert sorted(codes) == sorted(jax_cd.code_vocab_sizes(exp.model))
    want = np.asarray(jax_cd.decode_codes(exp.model, variables,
                                          {k: jnp.asarray(v) for k, v in codes.items()}))
    got = _decode(texp.model, model, codes)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _forward_z_q(model, x):
    """The eval-mode quantizer output and codes of the robot branch."""
    with torch.no_grad():
        _, z_q, _, codes = model.quantizer(model.encode_robot(torch.from_numpy(x)))
    return z_q, quantizers.prefix_codes("quantizer", codes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", QUANTIZED)
def test_eval_round_trip_is_exact(method, dtype, monkeypatch):
    """Decoding a forward's codes gives that forward's z_q: bit for bit with
    the straight-through value taken as z_q, within 1e-6 as computed."""
    cfg = make_experiment("resnet_no_down", method, compute_dtype=dtype, **ZOO).model
    model = init_model(cfg, 3, device="cpu")
    x = 2.0 * _x(2, cfg)
    z_q, codes = _forward_z_q(model, x)
    decoded = _decode(cfg, model, codes)
    assert decoded.dtype == z_q.dtype
    np.testing.assert_allclose(decoded.float().numpy(), z_q.float().numpy(),
                               atol=ATOL if dtype == "float32" else 1e-2, rtol=0)
    monkeypatch.setattr(quantizers, "ste", lambda z, z_q: z_q)
    z_q_exact, codes_exact = _forward_z_q(model, x)
    assert all(torch.equal(codes[k], codes_exact[k]) for k in codes)
    assert torch.equal(_decode(cfg, model, codes_exact), z_q_exact)


@pytest.mark.parametrize("method", ["fsq", "hybrid"])
def test_unbounded_fsq_decode_raises(method):
    exp, jmodel, variables, texp, model = pair("resnet_no_down", method, fsq_bounded=False)
    codes = jax_codes(jmodel, variables, x_robot=jnp.asarray(_x(1, texp.model)))
    with pytest.raises(ValueError, match="fsq_bounded"):
        _decode(texp.model, model, codes)


def test_ae_has_no_codes():
    cfg = make_experiment("resnet_no_down", "ae", window=10).model
    with pytest.raises(ValueError, match="ae"):
        code_decode.code_vocab_sizes(cfg)
    with pytest.raises(ValueError, match="ae"):
        _decode(cfg, init_model(cfg, 0, device="cpu"), {})


@pytest.mark.parametrize("method", QUANTIZED)
def test_vocab_and_normalize_match_jax(method):
    exp, jmodel, variables, texp, model = pair("resnet_no_down", method)
    assert code_decode.code_vocab_sizes(texp.model) == jax_cd.code_vocab_sizes(exp.model)
    codes = jax_codes(jmodel, variables, x_robot=jnp.asarray(3.0 * _x(4, texp.model)))
    want = {k: np.asarray(v) for k, v in jax_cd.normalize_codes(exp.model, codes).items()}
    got = code_decode.normalize_codes(texp.model, {k: torch.from_numpy(v)
                                                   for k, v in codes.items()})
    sizes = code_decode.code_vocab_sizes(texp.model)
    for k in codes:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].min() >= 0 and got[k].max() < sizes[k], k
    back = code_decode.denormalize_codes(texp.model, got)
    for k in codes:
        np.testing.assert_array_equal(back[k].numpy(), codes[k], err_msg=k)


@pytest.mark.parametrize("levels", [(8, 5, 5, 5), (7, 5, 5, 5, 5), (8, 8, 8)])
def test_fsq_digits_and_lfq_signs_match_jax(levels):
    rng = np.random.default_rng(len(levels))
    lo, n = code_decode.fsq_index_range(levels)
    assert (lo, n) == jax_cd.fsq_index_range(levels)
    idx = rng.integers(lo, lo + n, size=257).astype(np.int32)
    np.testing.assert_array_equal(
        code_decode.fsq_codes_to_values(torch.from_numpy(idx), levels).numpy(),
        np.asarray(jax_cd.fsq_codes_to_values(jnp.asarray(idx), levels)))
    bits = rng.integers(0, 2 ** 10, size=257).astype(np.int32)
    np.testing.assert_array_equal(
        code_decode.lfq_codes_to_signs(torch.from_numpy(bits), 10).numpy(),
        np.asarray(jax_cd.lfq_codes_to_signs(jnp.asarray(bits), 10)))
    assert math.prod(levels) == n


@pytest.mark.parametrize("packing", [1, 4])
def test_serving_decode_codes_matches_jax(packing):
    """The live fourth serving function against JAX's: motion_codes of the
    same windows, then decode_codes, within 1e-5; and decoding a window's
    codes gives its retarget within 1e-5."""
    _, jmodel, variables, texp, model = jax_and_port(attn_packing=packing)
    jfns = jax_make_serving_fns(jmodel, variables, identity_stats(29), identity_stats(126))
    module = build_serving_module(model, texp)
    x = windows(9, 6, 10, 126)
    codes = {k: v.numpy() for k, v in module.motion_codes(x).items()}
    want = np.asarray(jfns["decode_codes"]({k: jnp.asarray(v) for k, v in codes.items()}))
    got = module.decode_codes(codes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), module.retarget(x).numpy(), atol=1e-5, rtol=0)
