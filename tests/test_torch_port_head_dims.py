"""Every shape the JAX package computes, on the CPU: K1 at any head dim,
K2 past D 512, the int8 product at any width.

- K1's head-dim rule (``attention.head_width``): every Dh runs as it is,
  staged up to 128 at the next instantiated width, past 128 at Dh itself on
  the wide kernels, in column groups of at most 256; autograd through the op
  at Dh 8, 24, 48 and 96 against the plain backward at the same Dh, at
  dropout 0 and 0.1; ``_check`` refusing tensors of other shapes;
- a mirror of the kernels' staging and stores (csrc/k1_tiles.cuh's
  ``stage_chunks``, k1_mma.cuh's ``stage_mma`` and ``store_rows``, which the
  bf16 multi-window kernels use too, k1_wide.cuh's ``stage_cols`` and
  ``store_cols``), for every
  Dh from 1 to 512 on each path, in both dtypes: the copies cover the
  columns below Dh once, zero-fill the rest of the staged width reading
  nothing, are aligned for their size, and the stores write the columns
  below Dh alone, once; the plan's copy size is the C launchers' rule;
- K1 at Dh 8, 24, 48, 80, 96 and 160 (the plain version, through the op)
  against the JAX package's fused attention (the Pallas kernel in interpret
  mode, whole Dh) and its vjp: 2e-6 forward, 1e-5 gradients, as
  ``test_torch_port_window_attention.py`` holds Dh 16;
- the token prior at Dh 48 (d_model 48, one head, one layer, slot-AR with
  one depth layer: the Dh of the capacity sweep's d192 arm), Dh 96 (d_model
  96, one head, one layer, slot-AR with one depth layer), Dh 160 (d_model
  160, one head) and Dh 256 (d_model 256, one head, one layer, slot-AR with
  one depth layer: the Dh of the capacity sweep's d512 2-head arm) against
  the JAX prior within 1e-5, as ``test_torch_port_prior.py`` holds its tiny
  priors;
- the plain ``nearest_codes`` at D 1024 against the JAX package's
  ``nearest_codes_auto`` (which sends D past 512 to XLA): indices and
  counts equal, dw within 1e-5;
- ``Int8Dense`` at K = 100, N = 196 against the JAX package's, bit for bit
  in float32.
"""

import dataclasses
import re

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
from bridgerl_tpu_torch.ops import attention, codebook, kernels

from test_torch_port_prior import TINY, jax_prior, port_prior

GRAD_ATOL = 1e-6
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
                                             (129, 129, 1), (160, 160, 1), (256, 256, 1),
                                             (300, 300, 2), (512, 512, 2), (1000, 1000, 4)])
def test_head_width_rule(Dh, width, groups):
    """The width a head dim is staged and planned at, and past 128 the wide
    kernels' column groups on a full grid (512 windows); a grid of 2 blocks
    splits its columns further, to groups of at most 64 columns."""
    assert attention.head_width(Dh) == width
    plan = attention.k1_plan(512, 64, 64, Dh, torch.float32, "bwd")
    assert plan.groups == groups and (plan.Dh, plan.width) == (Dh, width)
    small = attention.k1_plan(2, 64, 64, Dh, torch.float32, "bwd")
    if Dh > 128:
        assert small.path == "wide" and small.groups >= groups
        assert attention._group_cols(-(-width // 16) * 16, small.groups) <= 64
    else:
        assert small.groups == 1
    assert 96 in attention.SUPPORTED_HEAD_DIMS and not hasattr(attention, "padded_fwd")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", [8, 24, 48, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_through_the_op_at_any_head_dim(Dh, rate, causal):
    """Autograd through the op (the plain version on the CPU) at the true Dh
    against the plain backward, with windows of 10 (causal: whole rows)."""
    BH, S = 6, 20
    W = S if causal else 10
    q, k, v, do = _qkvd(BH, S, Dh, seed=Dh)
    bias = torch.zeros(S, S) if not causal else torch.triu(torch.full((S, S), -1e9), 1)
    scale, seed = Dh ** -0.5, torch.tensor([1234], dtype=torch.int32)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate, W,
                                                    causal)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.attention_fwd(tq, tk, tv, bias, scale, seed, rate, W, causal)
    torch.testing.assert_close(out.detach(), attention.packed_attention_reference(
        q, k, v, bias, scale, seed, rate, W, causal), atol=0, rtol=0)
    grads = torch.autograd.grad(out, (tq, tk, tv), do)
    for a, b in zip(grads, want):
        assert a.shape == (BH, S, Dh)
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


def test_check_refuses_mismatched_shapes():
    q, k, v, do = _qkvd(2, 10, 24)
    bias = torch.zeros(10, 10)
    with pytest.raises(ValueError, match="shape"):
        attention._check(q, k[..., :20], v, bias, None, 10, "fwd")
    with pytest.raises(ValueError, match="shape"):
        attention._check(q, k, v, bias, None, 10, "bwd", extra=(("dout", do[:1]),))


# ---- a mirror of the kernels' staging and stores at any head dim

# a plan's path, by the shape that takes it (B*H, S = P W, W, direction), up to Dh 128; the
# wide kernels past it
STAGING_PATHS = {"tiles": (8, 20, 10, "bwd"), "tensor cores": (8, 64, 64, "fwd"),
                 "window-resident": (8, 64, 64, "bwd"), "row-buffered": (8, 160, 160, "bwd"),
                 "two-sweep": (128, 256, 256, "bwd"), "wide": (8, 64, 64, "bwd")}
ROWS = (0, 1, 7)   # rows of the tensor the mirror stages and stores (an odd row: any misalignment)


def _c_copy_rule():
    """csrc/k1_tiles.cuh's copy_bytes as Python: the launchers' rule."""
    src = (kernels.CSRC / "k1_tiles.cuh").read_text()
    body = re.search(r"constexpr int copy_bytes\(int Dh, int E\) \{\s*return (.*?);", src, re.S)
    *pairs, last = re.split(r"\s+\?\s+|\s+:\s+", body.group(1))   # cond, value, ..., value
    expr = " else ".join(f"{v} if {c}" for c, v in zip(pairs[::2], pairs[1::2])) + f" else {last}"
    return lambda Dh, E: eval(expr, {"Dh": Dh, "E": E})   # noqa: S307


def _check_staging(chunks, Dh, cols, E, copy, dst_unit):
    """Each row's copies (arrays of src column or -1, dst column; V elements
    each): the columns below Dh read once, each into its own column; [Dh,
    cols) zero-filled, nothing read; every copy aligned for its bytes at a
    16-byte base, in device memory (row r at byte r * Dh * E) and in the
    tile (rows of a multiple of 16 bytes, ``dst_unit`` bytes an element)."""
    V = copy // E
    for r, (src, dst) in chunks.items():
        filled = np.zeros(cols, np.int64)
        np.add.at(filled, (dst[:, None] + np.arange(V)).ravel(), 1)
        assert not ((dst * dst_unit) % (copy * dst_unit // E)).any()
        reads = src >= 0
        assert (dst[~reads] >= Dh).all() and (src[reads] == dst[reads]).all()
        assert (src[reads] + V <= Dh).all() and not (((r * Dh + src[reads]) * E) % copy).any()
        read = np.zeros(Dh, np.int64)
        np.add.at(read, (src[reads][:, None] + np.arange(V)).ravel(), 1)
        assert (read == 1).all() and (filled == 1).all()


def _check_stores(stores, Dh, E):
    """Each row's stores (column, elements): the columns below Dh once,
    nothing at or past Dh (the next row's), each store aligned for its
    bytes at a 16-byte base."""
    for r, row in stores.items():
        seen = np.zeros(Dh + 16, np.int64)
        for col, n in row:
            seen[col:col + n] += 1
            assert ((r * Dh + col) * E) % (n * E) == 0
        assert (seen[:Dh] == 1).all() and not seen[Dh:].any()


def _chunks(Dh, spans, E, copy):
    """stage_chunks' copies of one row over the column spans (c0, cols):
    (src column or -1 where zero-filled, dst column) arrays."""
    dst = np.concatenate([np.arange(c0, c0 + w, copy // E) for c0, w in spans])
    return np.where(dst < Dh, dst, -1), dst


def _pairs(Dh, cols, ragged):
    """store_rows / store_cols: column pairs 8n + 2t below ``cols``; ragged,
    those below Dh, whole where Dh is even, else one element at a time."""
    out = []
    for c in range(0, cols, 2):
        if not ragged:
            out.append((c, 2))
        elif c < Dh:
            out += [(c, 2)] if Dh % 2 == 0 else [(c, 1)] + ([(c + 1, 1)] if c + 1 < Dh else [])
    return out


def _quads(Dh, cols, ragged):
    """The window tiles' put4: columns 4c .. 4c + 3; ragged, those below
    Dh, whole where Dh is a multiple of 4, else one at a time."""
    out = []
    for c in range(0, cols, 4):
        if not ragged:
            out.append((c, 4))
        elif c < Dh:
            out += [(c, 4)] if Dh % 4 == 0 else [(c + e, 1) for e in range(4) if c + e < Dh]
    return out


@pytest.mark.parametrize("dtype", attention.DTYPES)
@pytest.mark.parametrize("path", list(STAGING_PATHS))
def test_kernels_stage_and_store_the_true_head_dim(path, dtype):
    """For every Dh its path takes (1 to 128; the wide kernels 129 to 512):
    the plan's path and copy size (the C launchers' rule), and a mirror of
    the kernels' staging and stores at that size (module docstring)."""
    BH, S, W, direction = STAGING_PATHS[path]
    E, rule = dtype.itemsize, _c_copy_rule()
    for Dh in range(129, 513) if path == "wide" else range(1, 129):
        plan = attention.k1_plan(BH, S, W, Dh, dtype, direction)
        width = plan.width
        assert plan.copy_bytes == rule(Dh, E) == attention.copy_bytes(Dh, dtype)
        assert ((Dh * E) % plan.copy_bytes == 0
                and all((Dh * E) % b for b in attention.COPY_SIZES if b > plan.copy_bytes))
        one = plan.path == "mma" and not plan.blocks_kv
        # below W 32 float32 takes the window tiles, bf16 the multi-window kernels
        tiles = plan.path == ("tiles" if dtype == torch.float32 else "multi")
        kind = {"tiles": tiles, "tensor cores": one,
                "window-resident": one and plan.rows == plan.cols,
                "row-buffered": plan.path == "mma" and plan.rows == 32 and plan.blocks_kv,
                "two-sweep": plan.path == "mma" and plan.rows == 64 and plan.blocks_kv > 0,
                "wide": plan.path == "wide"}[path]
        assert kind, (path, Dh, plan)
        copy = plan.copy_bytes
        if path == "wide":
            # k1_wide.cuh: contraction slabs, group columns and whole rows of Dp columns,
            # 16-byte copies but where Dh's rows are not 16-byte aligned
            L = (attention.wide_window_layout(Dh, dtype, plan.groups) if plan.blocks_kv == 0
                 else attention.wide_layout(Dh, dtype, "dq", plan.groups))
            assert plan.ragged == (copy < 16) and L.Dp == -(-Dh // 16) * 16
            slabs = [(c0, min(L.slab, L.Dp - c0)) for c0 in range(0, L.Dp, L.slab)]
            # each group's columns once (the last group's past Dp staged for no product)
            groups = [(cg * L.group_cols, min(L.group_cols, L.Dp - cg * L.group_cols))
                      for cg in range(plan.groups) if cg * L.group_cols < L.Dp]
            for spans in (slabs, groups, [(0, L.Dp)]):
                chunks = {r: _chunks(Dh, spans, E, copy) for r in ROWS}
                _check_staging(chunks, Dh, L.Dp, E, copy, E)
            # store_cols: warp half ch of group cg owns nact tiles of 8 from oc0
            HW, stores = L.group_cols // 2, {}
            for r in ROWS:
                row = []
                for cg in range(plan.groups):
                    for ch in range(2):
                        oc0 = cg * L.group_cols + ch * HW
                        nact = max(0, min(HW, L.Dp - oc0)) // 8
                        row += [(oc0 + c, n) for c, n in _pairs(Dh, 8 * nact, plan.ragged)
                                if oc0 + c < Dh]
                stores[r] = row
            _check_stores(stores, Dh, E)
            continue
        assert plan.ragged == (Dh != width) and width in attention.SUPPORTED_HEAD_DIMS
        if not plan.ragged:   # the native loops: whole rows in 16-byte copies
            assert copy == 16
        if plan.path == "tiles":   # float32 tiles; bf16's multi-window kernels as stage_mma
            chunks = {r: _chunks(Dh, [(0, width)], E, copy) for r in ROWS}
            _check_staging(chunks, Dh, width, E, copy, 4)
            _check_stores({r: _quads(Dh, width, plan.ragged) for r in ROWS}, Dh, E)
            continue
        chunks = {r: _chunks(Dh, [(0, width)], E, copy) for r in ROWS}
        _check_staging(chunks, Dh, width, E, copy, E)
        # store_rows: the row-buffered dq kernel's two parts each store NOW tiles from c8
        parts = 2 if path == "row-buffered" else 1
        now = width // 8 // parts
        stores = {r: [(part * now * 8 + c, n) for part in range(parts)
                      for c, n in _pairs(Dh - part * now * 8, 8 * now, plan.ragged)]
                  for r in ROWS}
        _check_stores(stores, Dh, E)


def _fold(a):
    B, S, H, Dh = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 2, 1, 3).reshape(B * H, S, Dh)


def _unfold(t, B, H):
    BH, S, Dh = t.shape
    return t.reshape(B, H, S, Dh).permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("Dh", [8, 24, 48, 80, 96, 160])
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


# the d192 arm's head dim (48: 4 heads), the d384L6 prior's (96), two past 128 (160; 256,
# the d512 2-head arm's), at one head and a small depth
WIDE_PRIORS = {"dh48": dict(d_model=48, n_heads=1, n_layers=1, ff_dim=64, slot_ar=True,
                            depth_layers=1),
               "dh96": dict(d_model=96, n_heads=1, n_layers=1, ff_dim=64, slot_ar=True,
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
