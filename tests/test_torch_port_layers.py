"""The port's attention (K1's plain version) and transformer towers against
the JAX package, on the CPU.

Attention is held at 2e-6 absolute against two references: flax
``nn.dot_product_attention`` and the JAX package's fused Pallas kernel
``fused_attention_fn`` run in interpret mode (as the JAX package's own CPU
tests run it), each with the block-diagonal window mask and without a mask.
Towers are held at 1e-5 (f32, different summation order).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.models import layers as jax_layers
from bridgerl_tpu.ops.pallas.attention import fused_attention_fn
from bridgerl_tpu_torch.models import layers
from bridgerl_tpu_torch.ops import attention

from test_torch_port_model import jax_and_port

ATTN_ATOL = 2e-6
TOWER_ATOL = 1e-5


def _qkv(B, S, H, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, H, Dh)).astype(np.float32) for _ in range(3))


def _port_attention(q, k, v, packing, window):
    """Port path: fold (B, S, H, Dh) to (B*H, S, Dh), plain K1, unfold."""
    B, S, H, Dh = q.shape
    fold = lambda a: torch.from_numpy(a).permute(0, 2, 1, 3).reshape(B * H, S, Dh)
    bias = layers.attention_bias(packing, window, "cpu")
    out = attention.packed_attention(fold(q), fold(k), fold(v), bias, 1.0 / np.sqrt(Dh))
    return out.reshape(B, H, S, Dh).permute(0, 2, 1, 3).numpy()


REFERENCES = {
    "flax": lambda q, k, v, mask: fnn.dot_product_attention(
        q, k, v, mask=mask, deterministic=True),
    "pallas_interpret": lambda q, k, v, mask: fused_attention_fn(
        q, k, v, mask=mask, deterministic=True),
}


@pytest.mark.parametrize("reference", sorted(REFERENCES))
@pytest.mark.parametrize("packing,window", [(8, 10), (2, 10), (1, 10)],
                         ids=["mask-P8", "mask-P2", "nomask"])
def test_plain_attention_matches_jax(reference, packing, window):
    q, k, v = _qkv(B=3, S=packing * window, H=2, Dh=16)
    mask = jax_layers.block_diagonal_mask(packing, window) if packing > 1 else None
    ref = REFERENCES[reference](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    got = _port_attention(q, k, v, packing, window)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATTN_ATOL)


def test_packed_rows_equal_separate_windows():
    """P windows under the block mask give the P separate attentions."""
    q, k, v = _qkv(B=2, S=40, H=2, Dh=8, seed=3)
    packed = _port_attention(q, k, v, 4, 10)
    for w in range(4):
        sl = slice(10 * w, 10 * (w + 1))
        alone = _port_attention(q[:, sl], k[:, sl], v[:, sl], 1, 10)
        np.testing.assert_allclose(packed[:, sl], alone, atol=ATTN_ATOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    t = torch.randn(4, 10, 16, generator=torch.Generator().manual_seed(0))
    counter = attention.COUNTER["fwd", torch.float32]
    counter.reset()
    out = attention.packed_attention(t, t, t, torch.zeros(10, 10), 0.25)
    ref = attention.packed_attention_reference(t, t, t, torch.zeros(10, 10), 0.25)
    assert torch.equal(out, ref)
    assert counter.count == 0


@pytest.mark.parametrize("max_len,d_model", [(10, 32), (80, 256), (64, 8)])
def test_sinusoidal_pe_matches_jax(max_len, d_model):
    # the f32 angle position * div_term reaches 79, whose ulp is 7.6e-6: the
    # two frameworks' exp() may round it one ulp apart
    np.testing.assert_allclose(layers.sinusoidal_pe(max_len, d_model).numpy(),
                               np.asarray(jax_layers.sinusoidal_pe(max_len, d_model)),
                               atol=1e-5)


@pytest.mark.parametrize("packing,window", [(1, 10), (4, 10), (8, 10), (3, 7)])
def test_mask_and_bias_match_jax(packing, window):
    want = np.asarray(jax_layers.block_diagonal_mask(packing, window))[0, 0]
    mask = layers.block_diagonal_mask(packing, window).numpy()
    np.testing.assert_array_equal(mask, want)
    bias = layers.attention_bias(packing, window, "cpu").numpy()
    assert bias.dtype == np.float32
    np.testing.assert_array_equal(bias, np.where(want, 0.0, -1e9).astype(np.float32))


TOWER_CASES = [dict(attn_packing=1), dict(attn_packing=4), dict(attn_packing=8),
               dict(attn_packing=2, tf_tokens=2)]


@pytest.mark.parametrize("tower,dim", [("human_encoder", 126), ("robot_encoder", 29)])
@pytest.mark.parametrize("over", TOWER_CASES,
                         ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_encoder_matches_jax(tower, dim, over):
    _, jmodel, variables, _, model = jax_and_port(**over)
    x = np.random.default_rng(11).normal(size=(8, 10, dim)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x),
                       method=lambda m, x: getattr(m, tower)(x, train=False))
    with torch.no_grad():
        got = getattr(model, tower)(torch.from_numpy(x))
    assert got.shape == (8, over.get("tf_tokens", 1), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOWER_ATOL)


@pytest.mark.parametrize("over", TOWER_CASES,
                         ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
@pytest.mark.parametrize("batch", [8, 5])
def test_decoder_matches_jax(over, batch):
    """batch 5 is not a multiple of the packing, so it runs unpacked."""
    _, jmodel, variables, _, model = jax_and_port(**over)
    tokens = over.get("tf_tokens", 1)
    z = np.random.default_rng(12).normal(size=(batch, tokens, 16)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(z),
                       method=lambda m, z: m.robot_decoder(z, train=False))
    with torch.no_grad():
        got = model.robot_decoder(torch.from_numpy(z))
    assert got.shape == (batch, 10, 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOWER_ATOL)


def test_towers_take_only_their_window_length():
    _, _, _, _, model = jax_and_port()
    with pytest.raises(ValueError, match="10"):
        model.human_encoder(torch.zeros(2, 12, 126))


def test_constant_buffers_follow_the_model_and_stay_out_of_the_state_dict():
    _, _, _, _, model = jax_and_port(attn_packing=4)
    stack = model.robot_decoder.transformer
    assert stack.pe.shape == (10, 32)
    assert stack.bias_single.shape == (10, 10) and not stack.bias_single.any()
    np.testing.assert_array_equal(stack.bias_packed.numpy(),
                                  layers.attention_bias(4, 10).numpy())
    assert not any(k.endswith(("pe", "bias_single", "bias_packed"))
                   for k in model.state_dict())


def test_layer_norm_eps_is_flax_default():
    _, _, _, _, model = jax_and_port()
    block = model.human_encoder.transformer.layers[0]
    assert block.norm1.eps == block.norm2.eps == 1e-6
