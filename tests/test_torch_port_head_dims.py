"""Every shape the JAX package computes, on the CPU: K1 at any head dim,
K2 past D 512, the int8 product at any width.

- K1's head-dim rule (``attention.head_width``): the instantiated dims run
  as they are, any other Dh up to 128 at the next instantiated one, past 128
  at the next multiple of 8 on the wide kernels (Dh 160, 256, 512 as they
  are), in column groups of at most 256; the pad / slice wrappers
  (``padded_fwd``, ``padded_bwd``) around the plain versions equal the
  unpadded plain versions within 1e-6 (f32; zero columns add nothing to a
  dot product, only the summation's length changes), forward and the
  gradients of q, k and v, at dropout 0 and 0.1 with the same keep masks;
- K1 at Dh 24, 96 and 160 (the plain version, through the op) against the
  JAX package's fused attention (the Pallas kernel in interpret mode, whole
  Dh) and its vjp: 2e-6 forward, 1e-5 gradients, as
  ``test_torch_port_window_attention.py`` holds Dh 16;
- the token prior at Dh 96 (d_model 96, one head, one layer, slot-AR with
  one depth layer), Dh 160 (d_model 160, one head) and Dh 256 (d_model 256,
  one head, one layer, slot-AR with one depth layer: the Dh of the
  capacity sweep's d512 2-head arm) against the JAX prior within 1e-5, as
  ``test_torch_port_prior.py`` holds its tiny priors;
- the plain ``nearest_codes`` at D 1024 against the JAX package's
  ``nearest_codes_auto`` (which sends D past 512 to XLA): indices and
  counts equal, dw within 1e-5;
- ``Int8Dense`` at K = 100, N = 196 against the JAX package's, bit for bit
  in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.models import token_prior as jtp
from bridgerl_tpu.ops import int8 as jax_int8
from bridgerl_tpu.ops.pallas import vq_kernel as jax_vq_kernel
from bridgerl_tpu.ops.pallas.attention import fused_attention_fn
from bridgerl_tpu_torch.models.layers import Int8Dense
from bridgerl_tpu_torch.ops import attention, codebook

from test_torch_port_prior import TINY, jax_prior, port_prior

PAD_ATOL = 1e-6
PRIOR_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other CPU parity tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkvd(BH, S, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(BH, S, Dh)).astype(np.float32))
                 for _ in range(4))


@pytest.mark.parametrize("Dh,width,groups", [(1, 16, 1), (8, 16, 1), (16, 16, 1), (17, 32, 1),
                                             (24, 32, 1), (48, 64, 1), (65, 96, 1),
                                             (96, 96, 1), (97, 128, 1), (128, 128, 1),
                                             (129, 136, 1), (160, 160, 1), (256, 256, 1),
                                             (300, 304, 2), (512, 512, 2), (1000, 1000, 4)])
def test_head_width_rule(Dh, width, groups):
    """The width a head dim runs at, and past 128 the wide kernels' column
    groups on a full grid (512 windows); a grid of 2 blocks splits its
    columns further, to groups of at most 64 columns."""
    assert attention.head_width(Dh) == width
    assert attention.k1_plan(512, 64, 64, Dh, torch.float32, "bwd").groups == groups
    small = attention.k1_plan(2, 64, 64, Dh, torch.float32, "bwd")
    if Dh > 128:
        assert small.path == "wide" and small.groups >= groups
        assert attention._group_cols(-(-width // 16) * 16, small.groups) <= 64
    else:
        assert small.groups == 1
    assert 96 in attention.SUPPORTED_HEAD_DIMS and attention.WIDE_ALIGN == 8


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", [8, 24, 48, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_padding_equals_the_unpadded_plain_version(Dh, rate, causal):
    """The pad / slice wrappers around the plain versions against the plain
    versions at the true Dh: forward, the backward's dq, dk and dv, and
    autograd through the op, with windows of 10 (causal: whole rows)."""
    BH, S = 6, 20
    W = S if causal else 10
    q, k, v, do = _qkvd(BH, S, Dh, seed=Dh)
    bias = torch.zeros(S, S) if not causal else torch.triu(torch.full((S, S), -1e9), 1)
    scale, seed = Dh ** -0.5, torch.tensor([1234], dtype=torch.int32)
    args = (bias, scale, seed, rate, W, causal)
    want = attention.packed_attention_reference(q, k, v, *args)
    got = attention.padded_fwd(attention.packed_attention_reference, q, k, v, *args)
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=PAD_ATOL, rtol=0)
    bargs = (scale, seed, rate, W, causal)
    want_b = attention.packed_attention_bwd_reference(q, k, v, bias, do, *bargs)
    got_b = attention.padded_bwd(attention.packed_attention_bwd_reference, q, k, v, bias, do,
                                 *bargs)
    for a, b in zip(got_b, want_b):
        assert a.shape == (BH, S, Dh)
        torch.testing.assert_close(a, b, atol=PAD_ATOL, rtol=0)
    # the keep mask of the padded call is the unpadded one: with v = I the
    # forward returns p_drop, whose zeros are the dropped elements
    if rate:
        eye = torch.eye(S, Dh).expand(BH, S, Dh).contiguous() if Dh >= S else None
        if eye is not None:
            a = attention.padded_fwd(attention.packed_attention_reference, q, k, eye, *args)
            b = attention.packed_attention_reference(q, k, eye, *args)
            assert torch.equal(a[:, :, :S] > 0, b[:, :, :S] > 0)
    # autograd through the op (the plain version on the CPU) at the true Dh
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.attention_fwd(tq, tk, tv, bias, scale, seed, rate, W, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), do)
    for a, b in zip(grads, want_b):
        torch.testing.assert_close(a, b, atol=PAD_ATOL, rtol=0)


def test_padding_refuses_mismatched_shapes():
    q, k, v, do = _qkvd(2, 10, 24)
    with pytest.raises(ValueError, match="shape"):
        attention.padded_fwd(attention.packed_attention_reference, q, k[..., :20], v,
                             torch.zeros(10, 10), 0.2)
    with pytest.raises(ValueError, match="shape"):
        attention.padded_bwd(attention.packed_attention_bwd_reference, q, k, v,
                             torch.zeros(10, 10), do[:1], 0.2)


def _fold(a):
    B, S, H, Dh = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 2, 1, 3).reshape(B * H, S, Dh)


def _unfold(t, B, H):
    BH, S, Dh = t.shape
    return t.reshape(B, H, S, Dh).permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("Dh", [24, 96, 160])
def test_k1_at_odd_head_dims_matches_jax_fused_attention(Dh):
    B, H, S = 2, 1, 10
    rng = np.random.default_rng(Dh)
    q, k, v, do = (rng.normal(size=(B, S, H, Dh)).astype(np.float32) for _ in range(4))
    tq, tk, tv = (_fold(a).requires_grad_() for a in (q, k, v))
    out = attention.attention_fwd(tq, tk, tv, torch.zeros(S, S), Dh ** -0.5, None, 0.0)
    got = torch.autograd.grad(out, (tq, tk, tv), _fold(do))
    ref, vjp = jax.vjp(lambda a, b, c: fused_attention_fn(a, b, c, deterministic=True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_unfold(out.detach(), B, H), np.asarray(ref), atol=2e-6)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_unfold(g, B, H), np.asarray(w), atol=1e-5)


# the d384L6 prior's head dim (96), two past 128 (160; 256, the d512 2-head arm's), at one
# head and a small depth
WIDE_PRIORS = {"dh96": dict(d_model=96, n_heads=1, n_layers=1, ff_dim=64, slot_ar=True,
                            depth_layers=1),
               "dh160": dict(d_model=160, n_heads=1, n_layers=1, ff_dim=64),
               "dh256": dict(d_model=256, n_heads=1, n_layers=1, ff_dim=64, slot_ar=True,
                             depth_layers=1)}
# dh256's one head of 256 columns: its prior's logits reach 16, where float32's spacing is
# 1.9e-6, and the two frameworks' summation orders part by up to ~60 of those (1.1e-4; at the
# same width 4 heads of 64 part by 2.9e-5, 8 of 32 by 1.7e-5, and 1e-5 holds at d_model 160
# and 192): it is held to PRIOR_ATOL times the scale of what it is compared with
SCALED_PRIORS = ("dh256",)


def _prior_atol(name, want) -> float:
    return PRIOR_ATOL * (max(1.0, float(np.abs(want).max())) if name in SCALED_PRIORS else 1.0)


@pytest.mark.parametrize("name", list(WIDE_PRIORS))
def test_prior_at_wide_head_dims_matches_jax(name):
    pcfg = dataclasses.replace(TINY, **WIDE_PRIORS[name])
    jm, jv = jax_prior(pcfg)
    tm = port_prior(pcfg, jv)
    rng = np.random.default_rng(3)
    g = np.stack([rng.integers(0, n, size=(3, pcfg.max_len)) for n in pcfg.vocab_sizes],
                 axis=-1).astype(np.int32)
    with torch.no_grad():
        got = tm(torch.from_numpy(g))
        ctx = tm(torch.from_numpy(g), mode="context")
    apply = jax.jit(jm.apply, static_argnames="mode")
    want = apply(jv, jnp.asarray(g))
    want_ctx = np.asarray(apply(jv, jnp.asarray(g), mode="context"))
    np.testing.assert_allclose(ctx.numpy(), want_ctx, atol=_prior_atol(name, want_ctx))
    for s in range(len(pcfg.vocab_sizes)):
        w = np.asarray(want[s])
        np.testing.assert_allclose(got[s].numpy(), w, atol=_prior_atol(name, w))


def test_nearest_codes_past_512_columns_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 1024)).astype(np.float32)
    cb = rng.normal(size=(256, 1024)).astype(np.float32)
    idx, counts, dw = codebook.nearest_codes_plain(torch.from_numpy(x), torch.from_numpy(cb))
    i0, c0, d0 = (np.asarray(t) for t in jax_vq_kernel.nearest_codes_auto(jnp.asarray(x),
                                                                          jnp.asarray(cb)))
    np.testing.assert_array_equal(idx.numpy(), i0)
    np.testing.assert_array_equal(counts.numpy(), c0)
    np.testing.assert_allclose(dw.numpy(), d0, atol=1e-5, rtol=0)


def test_int8_dense_at_widths_off_eight_matches_jax():
    K, N = 100, 196
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 3, K)).astype(np.float32)
    w = rng.normal(scale=0.1, size=(K, N)).astype(np.float32)   # JAX's (K, N)
    b = rng.normal(scale=0.1, size=(N,)).astype(np.float32)
    want = jax_int8.Int8Dense(N).apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
    layer = Int8Dense(K, N)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        layer.bias.copy_(torch.from_numpy(b))
        got = layer(torch.from_numpy(x))
    assert got.shape == (5, 3, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
