"""K1's ``window`` argument on the CPU: the windowed plain versions against
the JAX package's fused attention, against the full-row plain versions, and
the towers' use of it.

With ``window`` W the function attends only within the diagonal (W, W)
blocks of each packed row. The JAX reference is ``fused_attention_fn``
(the Pallas kernel in interpret mode) under the block-diagonal mask, and its
``jax.vjp``, at dropout 0: 2e-6 on the forward, 1e-5 on the gradients
(N(0, 1) inputs, f32 sums in another order). Against the full-row plain
version with the block-diagonal bias: 1e-6, since the bias's -1e9 makes
every across-window probability exactly 0 and only the summation order
differs; at dropout 0.1 the masks are the same Philox words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.models import layers as jax_layers
from bridgerl_tpu.ops.pallas.attention import fused_attention_fn
from bridgerl_tpu_torch.models import layers
from bridgerl_tpu_torch.ops import attention

WINDOWS = [(8, 10), (2, 10), (1, 10), (4, 7)]


def _fold(a):
    B, S, H, Dh = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 2, 1, 3).reshape(B * H, S, Dh)


def _unfold(t, B, H):
    BH, S, Dh = t.shape
    return t.reshape(B, H, S, Dh).permute(0, 2, 1, 3).numpy()


def _inputs(BH, S, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(BH, S, Dh)).astype(np.float32))
                 for _ in range(4))


@pytest.mark.parametrize("packing,window", WINDOWS)
def test_windowed_plain_matches_jax_fused_attention_and_vjp(packing, window):
    B, H, Dh, S = 2, 2, 16, packing * window
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.normal(size=(B, S, H, Dh)).astype(np.float32) for _ in range(4))
    tq, tk, tv = (_fold(a).requires_grad_() for a in (q, k, v))
    bias = layers.attention_bias(packing, window)
    out = attention.attention_fwd(tq, tk, tv, bias, Dh ** -0.5, None, 0.0, window)
    got = torch.autograd.grad(out, (tq, tk, tv), _fold(do))
    mask = jax_layers.block_diagonal_mask(packing, window) if packing > 1 else None
    ref, vjp = jax.vjp(lambda a, b, c: fused_attention_fn(a, b, c, mask=mask,
                                                          deterministic=True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_unfold(out.detach(), B, H), np.asarray(ref), atol=2e-6)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_unfold(g, B, H), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("packing,window", WINDOWS)
def test_windowed_plain_equals_full_row_with_block_bias(packing, window, rate):
    S, Dh = packing * window, 16
    q, k, v, do = _inputs(6, S, Dh)
    bias = layers.attention_bias(packing, window)
    seed = torch.tensor([77], dtype=torch.int32)
    full = attention.packed_attention_reference(q, k, v, bias, 0.25, seed, rate)
    win = attention.packed_attention_reference(q, k, v, bias, 0.25, seed, rate, window)
    np.testing.assert_allclose(win.numpy(), full.numpy(), atol=1e-6)
    full_g = attention.packed_attention_bwd_reference(q, k, v, bias, do, 0.25, seed, rate)
    win_g = attention.packed_attention_bwd_reference(q, k, v, bias, do, 0.25, seed, rate,
                                                     window)
    for a, b in zip(win_g, full_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_window_mask_is_the_diagonal_of_the_full_mask():
    BH, P, W = 5, 4, 7
    S = P * W
    full = attention.attention_dropout_mask(11, BH, S, 0.2)
    blocks = full.reshape(BH, P, W, P, W).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
    assert torch.equal(attention.window_dropout_mask(11, BH, S, W, 0.2), blocks)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bias_outside_the_windows_is_not_read(rate):
    """Across-window entries of bias change nothing when W < S; inside the
    windows a general bias is taken as it is."""
    S, W, Dh = 24, 6, 8
    q, k, v, do = _inputs(4, S, Dh, seed=2)
    rng = np.random.default_rng(3)
    bias = torch.from_numpy(rng.normal(size=(S, S)).astype(np.float32))
    inside = layers.block_diagonal_mask(S // W, W)
    other = torch.where(inside, bias, torch.from_numpy(
        rng.normal(size=(S, S)).astype(np.float32)) * 100.0)
    seed = torch.tensor([5], dtype=torch.int32)
    out = attention.attention_fwd(q, k, v, bias, 0.3, seed, rate, W)
    assert torch.equal(out, attention.attention_fwd(q, k, v, other, 0.3, seed, rate, W))
    grads = attention.attention_bwd(q, k, v, bias, do, 0.3, seed, rate, W)
    for a, b in zip(grads, attention.attention_bwd(q, k, v, other, do, 0.3, seed, rate, W)):
        assert torch.equal(a, b)
    # the first window alone, as its own row, gives the first window's rows
    first = attention.attention_fwd(q[:, :W].contiguous(), k[:, :W].contiguous(),
                                    v[:, :W].contiguous(), bias[:W, :W].contiguous(), 0.3,
                                    seed, 0.0)
    np.testing.assert_allclose(attention.attention_fwd(q, k, v, bias, 0.3, seed, 0.0, W)
                               [:, :W].numpy(), first.numpy(), atol=1e-6)


@pytest.mark.parametrize("window", [7, 0, -10, 25])
def test_a_window_that_does_not_divide_the_row_raises(window):
    q = torch.zeros(2, 20, 8)
    bias = torch.zeros(20, 20)
    with pytest.raises(ValueError, match="window"):
        attention.attention_fwd(q, q, q, bias, 0.1, None, 0.0, window)
    with pytest.raises(ValueError, match="window"):
        attention.attention_bwd(q, q, q, bias, q, 0.1, None, 0.0, window)
    with pytest.raises(ValueError, match="window"):
        attention.packed_attention(q, q, q, bias, 0.1, window=window)


def test_window_none_is_the_whole_row():
    q, k, v, do = _inputs(3, 12, 8)
    bias = torch.randn(12, 12, generator=torch.Generator().manual_seed(0))
    for W in (None, 12):
        np.testing.assert_array_equal(
            attention.packed_attention_reference(q, k, v, bias, 0.2, window=W).numpy(),
            attention.packed_attention_reference(q, k, v, bias, 0.2).numpy())


@pytest.mark.parametrize("packing,batch", [(4, 8), (4, 6), (1, 4)],
                         ids=["packed", "batch-not-divisible", "unpacked"])
def test_transformer_stack_passes_its_window(monkeypatch, packing, batch):
    """Every attention call of the towers takes window = seq_len, whether
    the batch is packed into rows of P windows or not, and causal False."""
    calls = []
    real = layers.packed_attention_qkv

    def spy(qkv, heads, bias, scale, dropout_rate=0.0, generator=None, window=None,
            causal=False):
        calls.append((qkv.shape[1], window, causal))
        return real(qkv, heads, bias, scale, dropout_rate, generator, window=window,
                    causal=causal)

    monkeypatch.setattr(layers, "packed_attention_qkv", spy)
    stack = layers.TransformerStack(2, 16, 2, 32, seq_len=5, packing=packing, dropout=0.0)
    stack(torch.randn(batch, 5, 16, generator=torch.Generator().manual_seed(0)))
    rows = 5 * packing if batch % packing == 0 else 5
    assert calls == [(rows, 5, False)] * 2


# ---------------------------------------------------------------- causal

def _garbage_above(S: int, seed: int = 5) -> torch.Tensor:
    """The causal bias with large random values, and NaNs, above the diagonal."""
    rng = np.random.default_rng(seed)
    bias = torch.from_numpy(rng.normal(scale=1e4, size=(S, S)).astype(np.float32))
    bias[0, S - 1] = float("nan")
    return torch.where(torch.ones(S, S, dtype=torch.bool).tril(), 0.0, bias)


@pytest.mark.parametrize("S", [5, 12, 40, 256])   # 256: the prior's JAX default max_len
def test_causal_plain_matches_jax_fused_attention_and_vjp(S):
    """``causal=True`` with garbage above the diagonal: the plain forward and,
    through the op's autograd, the plain backward equal JAX's
    fused_attention_fn under the causal mask and its vjp, at the windowed
    tests' tolerances."""
    B, H, Dh = 2, 2, 16
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.normal(size=(B, S, H, Dh)).astype(np.float32) for _ in range(4))
    tq, tk, tv = (_fold(a).requires_grad_() for a in (q, k, v))
    out = attention.attention_fwd(tq, tk, tv, _garbage_above(S), Dh ** -0.5, None, 0.0,
                                  causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), _fold(do))
    mask = jnp.tril(jnp.ones((S, S), bool))
    ref, vjp = jax.vjp(lambda a, b, c: fused_attention_fn(a, b, c, mask=mask,
                                                          deterministic=True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_unfold(out.detach(), B, H), np.asarray(ref), atol=2e-6)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_unfold(g, B, H), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_causal_plain_does_not_read_above_the_diagonal(rate, window):
    """Garbage above the diagonal changes neither the plain forward nor the
    plain backward under ``causal=True`` (bit for bit), and both equal the
    functions with the causal bias read (causal=False), since expf of -1e9
    is exactly 0."""
    BH, S, Dh = 6, 24, 16
    q, k, v, do = _inputs(BH, S, Dh, seed=4)
    bias = layers.causal_bias(S)
    garbage = _garbage_above(S)
    seed = torch.tensor([9], dtype=torch.int32)
    fwd = lambda b, c: attention.packed_attention_reference(q, k, v, b, 0.25, seed, rate,
                                                            window, causal=c)
    bwd = lambda b, c: attention.packed_attention_bwd_reference(q, k, v, b, do, 0.25, seed,
                                                                rate, window, causal=c)
    assert torch.equal(fwd(garbage, True), fwd(bias, True))
    torch.testing.assert_close(fwd(garbage, True), fwd(bias, False), rtol=0, atol=1e-6)
    for a, b, c in zip(bwd(garbage, True), bwd(bias, True), bwd(bias, False)):
        assert torch.equal(a, b) and torch.isfinite(a).all()
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
