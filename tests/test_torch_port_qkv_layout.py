"""K1's fused layout on the CPU: the projection's (B, S, 3d) output in, out as
(B, S, d), d(qkv) as one (B, S, 3d) tensor (``ops/attention.py::attention_qkv``).

- The fused plain forward and backward are bit for bit the 3-D plain version on
  the folded copies, in both dtypes, on every path's shape (packed windows, W 64,
  causal, a ragged head dim, a wide one, seed groups).
- ``SelfAttention`` (projection, fused op, ``out_proj``) matches flax's
  ``MultiHeadDotProductAttention`` (default attention, and the JAX package's
  Pallas kernel in interpret mode) in its output and in every parameter's
  gradient, and hands the op the projection's output as it is.
- The rows' layout and the copy width the kernels are launched with: a mirror of
  csrc/k1_tiles.cuh's addresses, division and copy rule.

Small shapes, single-threaded: the tier-1 suite's time is shared.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bridgerl_tpu.models import layers as jax_layers
from bridgerl_tpu.ops.pallas.attention import fused_attention_fn
from bridgerl_tpu_torch import convert
from bridgerl_tpu_torch.models import layers
from bridgerl_tpu_torch.ops import attention, kernels

BF16 = torch.bfloat16
MHA_ATOL = 2e-6      # out against flax, float32 (test_torch_port_layers.py's ATTN_ATOL)
GRAD_ATOL = 1e-5     # parameter gradients against JAX's, float32 (summation order)

# (B, H, S, Dh, window, causal, dropout, seed groups): a shape of each K1 path
CASES = {
    "packed-W10": (4, 4, 80, 16, 10, False, 0.1, 1),
    "W64": (2, 2, 64, 16, 64, False, 0.1, 1),
    "causal-S32": (2, 2, 32, 16, None, True, 0.1, 1),
    "ragged-Dh50-H3": (2, 3, 20, 50, 10, False, 0.1, 1),
    "wide-Dh160": (1, 2, 20, 160, 10, False, 0.1, 1),
    "two-seed-groups": (4, 2, 20, 16, 10, False, 0.1, 2),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bias(S, window, causal):
    if causal:
        return layers.causal_bias(S)
    return layers.attention_bias(S // window, window, "cpu")


def _inputs(case, dtype, seed=0):
    B, H, S, Dh, window, causal, rate, G = CASES[case]
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * Dh, generator=g).to(dtype)
    dout = torch.randn(B, S, H * Dh, generator=g).to(dtype)
    seed_t = torch.randint(0, attention.SEED_HIGH, (G,), generator=g, dtype=torch.int32)
    return qkv, dout, _bias(S, window, causal), seed_t


@pytest.mark.parametrize("dtype", attention.DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_plain_is_the_3d_plain_on_folded_copies(case, dtype):
    """Forward, the fused backward and autograd's d(qkv): bit for bit the 3-D
    plain version's on the folded copies, unfolded (d(qkv) its three
    gradients side by side)."""
    B, H, S, Dh, window, causal, rate, G = CASES[case]
    qkv, dout, bias, seed = _inputs(case, dtype)
    scale = Dh ** -0.5
    q, k, v = attention.split_qkv(qkv, H)
    want = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, window, causal)
    got = attention.attention_qkv(qkv, H, bias, scale, seed, rate, window, causal)
    assert got.shape == (B, S, H * Dh) and got.dtype == dtype
    assert torch.equal(got, attention.unfold_heads(want, H))
    grads = attention.packed_attention_bwd_reference(
        q, k, v, bias, attention.fold_heads(dout, H), scale, seed, rate, window, causal)
    want_grad = torch.cat([attention.unfold_heads(t, H) for t in grads], dim=-1)
    got_grad = attention.attention_qkv_bwd(qkv, H, bias, dout, scale, seed, rate, window,
                                           causal)
    assert got_grad.shape == qkv.shape and torch.equal(got_grad, want_grad)
    x = qkv.clone().requires_grad_()
    (auto,) = torch.autograd.grad(
        attention.attention_qkv(x, H, bias, scale, seed, rate, window, causal), x, dout)
    assert torch.equal(auto, want_grad)


def test_fold_and_unfold_are_inverse_and_head_major():
    """Row b * H + h of the folded rows is head h (columns h Dh ..) of batch
    row b; unfold undoes fold."""
    x = torch.arange(2 * 3 * 12, dtype=torch.float32).reshape(2, 3, 12)
    rows = attention.fold_heads(x, 4)
    assert rows.shape == (8, 3, 3)
    assert torch.equal(rows[4 + 2, 1], x[1, 1, 6:9])
    assert torch.equal(attention.unfold_heads(rows, 4), x)


# ---------------------------------------------------------------- SelfAttention and flax

D_MODEL, HEADS = 32, 4


def _flax_and_port(packing, window, attention_fn, seed=0):
    """flax's MultiHeadDotProductAttention (d_model 32, 4 heads) and the port's
    SelfAttention holding its weights (convert.py's mapping)."""
    kw = {"attention_fn": attention_fn} if attention_fn is not None else {}
    mha = fnn.MultiHeadDotProductAttention(num_heads=HEADS, qkv_features=D_MODEL,
                                           deterministic=True, **kw)
    x = np.random.default_rng(seed).normal(size=(3, packing * window, D_MODEL))
    x = x.astype(np.float32)
    params = mha.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(   # nonzero biases, so that their gradients show
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(seed + 1), p.shape), params)
    port = layers.SelfAttention(D_MODEL, HEADS)
    sd = {}
    convert._attention(sd, "m", {"attn": params}, "attn")
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    return mha, params, port, x


@pytest.mark.parametrize("reference", ["flax", "pallas_interpret"])
@pytest.mark.parametrize("packing,window", [(2, 5), (1, 8)], ids=["packed", "unpacked"])
def test_self_attention_matches_flax_mha(reference, packing, window):
    """Output and the gradients of both projections (q, k, v in one
    in_proj_weight; out_proj) against flax at dropout 0, under the
    block-diagonal mask of ``packing`` windows."""
    fn = fused_attention_fn if reference == "pallas_interpret" else None
    mha, params, port, x = _flax_and_port(packing, window, fn)
    mask = jax_layers.block_diagonal_mask(packing, window) if packing > 1 else None
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(mha.apply({"params": p}, jnp.asarray(x), jnp.asarray(x), mask=mask) * r)

    want = mha.apply({"params": params}, jnp.asarray(x), jnp.asarray(x), mask=mask)
    jgrads = jax.grad(loss)(params)
    bias = layers.attention_bias(packing, window, "cpu")
    out = port(torch.from_numpy(x), bias, window=window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=MHA_ATOL)
    (out * torch.from_numpy(r)).sum().backward()
    sd = {}
    convert._attention(sd, "m", {"attn": jax.tree_util.tree_map(np.asarray, jgrads)}, "attn")
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), sd["m." + name], atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", attention.DTYPES, ids=["f32", "bf16"])
def test_self_attention_hands_the_projection_output_to_the_op(monkeypatch, dtype):
    """The op gets the projection's output itself (no reshape, transpose,
    copy or chunk), and out_proj gets the op's output itself."""
    seen = {}
    real_linear, real_op = layers.linear, layers.packed_attention_qkv

    def linear_spy(*args, **kw):
        y = real_linear(*args, **kw)
        seen.setdefault("projection", y)
        return y

    def op_spy(qkv, heads, *args, **kw):
        seen["op_in"], seen["heads"] = qkv, heads
        seen["op_out"] = real_op(qkv, heads, *args, **kw)
        return seen["op_out"]

    monkeypatch.setattr(layers, "linear", linear_spy)
    monkeypatch.setattr(layers, "packed_attention_qkv", op_spy)
    attn = layers.SelfAttention(D_MODEL, HEADS, dtype)
    torch.nn.init.normal_(attn.in_proj_weight, generator=torch.Generator().manual_seed(0))
    attn.out_proj.register_forward_pre_hook(lambda m, args: seen.setdefault("out_proj_in",
                                                                            args[0]))
    x = torch.randn(2, 10, D_MODEL, generator=torch.Generator().manual_seed(1)).to(dtype)
    attn(x, layers.attention_bias(2, 5, "cpu"), window=5)
    assert seen["op_in"] is seen["projection"] and seen["heads"] == HEADS
    assert seen["op_in"].shape == (2, 10, 3 * D_MODEL) and seen["op_in"].is_contiguous()
    assert seen["out_proj_in"] is seen["op_out"]
    assert seen["op_out"].shape == (2, 10, D_MODEL) and seen["op_out"].dtype == dtype


def test_exported_self_attention_calls_the_fused_op_between_the_projections():
    """torch.export of SelfAttention: one fused K1 call, no 3-D call, and no
    transpose, permute, clone, contiguous copy or cat in the graph."""
    attn = layers.SelfAttention(D_MODEL, HEADS).eval()
    torch.nn.init.normal_(attn.in_proj_weight, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 10, D_MODEL, generator=torch.Generator().manual_seed(1))
    bias = layers.attention_bias(2, 5, "cpu")

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = attn

        def forward(self, x, bias):
            return self.attn(x, bias, window=5)

    ep = torch.export.export(Wrap(), (x, bias))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum("packed_attention_qkv_fwd" in t for t in targets) == 1
    assert not any("packed_attention_fwd" in t for t in targets)
    for bad in ("transpose", "permute", "clone", "contiguous", "cat", "split", "chunk"):
        assert not any(bad in t for t in targets), (bad, targets)
    torch.testing.assert_close(ep.module()(x, bias), attn(x, bias, window=5), rtol=0, atol=0)


# ---------------------------------------------------------------- refusals and counters

@pytest.mark.parametrize("bad", ["d-not-3-heads", "dout-shape", "dout-dtype", "seed-groups",
                                 "bias-shape"])
def test_fused_op_refuses_what_it_cannot_take(bad):
    qkv = torch.randn(2, 10, 3 * 16)
    dout = torch.randn(2, 10, 16)
    bias, seed, heads = torch.zeros(10, 10), torch.zeros(1, dtype=torch.int32), 4
    if bad == "d-not-3-heads":
        qkv = torch.randn(2, 10, 50)
    elif bad == "dout-shape":
        dout = torch.randn(2, 10, 12)
    elif bad == "dout-dtype":
        dout = dout.to(BF16)
    elif bad == "seed-groups":
        seed = torch.zeros(3, dtype=torch.int32)
    else:
        bias = torch.zeros(10, 12)
    with pytest.raises(ValueError):
        attention._check_qkv(qkv, heads, bias, seed, None, "bwd", False, dout)


def test_fused_op_on_cpu_counts_no_launch():
    kernels.reset_counters()
    qkv = torch.randn(2, 10, 48, requires_grad=True)
    attention.attention_qkv(qkv, 4, torch.zeros(10, 10), 0.5, None).sum().backward()
    assert all(c.count == 0 for c in kernels.COUNTERS.values())
    assert set(attention.QKV_COUNTER.values()) <= set(kernels.COUNTERS.values())


# ---------------------------------------------------------------- the kernels' addressing

def _strided_qkv(B, S, d3, pad_pos, pad_batch, offset, dtype=torch.float32):
    """(B, S, d3) as a view of a larger buffer: rows pad_pos elements apart
    beyond d3, batch rows pad_batch beyond, starting ``offset`` elements in."""
    pos = d3 + pad_pos
    batch = S * pos + pad_batch
    buf = torch.arange(offset + B * batch, dtype=torch.float64).to(dtype)
    return buf.as_strided((B, S, d3), (batch, pos, 1), offset)


@pytest.mark.parametrize("B,H,S,Dh,pad_pos,pad_batch,offset", [
    (2, 4, 5, 8, 0, 0, 0), (3, 3, 4, 50, 0, 0, 0), (2, 2, 6, 16, 7, 3, 1), (1, 5, 3, 3, 1, 9, 5)])
def test_row_layout_addresses_the_folded_rows(B, H, S, Dh, pad_pos, pad_batch, offset):
    """csrc/k1_tiles.cuh's Span at the fused launch's layout (qkv_layout):
    position s of row n of q, k and v, and of out and d(qkv), is the folded
    copies' element (n, s), for strided and offset buffers too."""
    qkv = _strided_qkv(B, S, 3 * H * Dh, pad_pos, pad_batch, offset)
    out = torch.empty(B, S, H * Dh)
    grad = torch.empty(B, S, 3 * H * Dh)
    layout = attention.qkv_layout(qkv, H, out, grad)
    flat = qkv.as_strided((qkv.storage_offset() + qkv.stride(0) * B,), (1,), 0)
    base, d = qkv.storage_offset(), H * Dh
    folded = attention.split_qkv(qkv, H)
    for n in range(B * H):
        for s in range(S):
            at = base + attention.row_offset(layout, Dh, n, s)
            for t, x in enumerate(folded):
                assert torch.equal(flat[at + t * d:at + t * d + Dh], x[n, s])
            b, h = divmod(n, H)
            assert (attention.row_offset(layout, Dh, n, s, "out")
                    == out[b, s, h * Dh:].storage_offset())
            assert (attention.row_offset(layout, Dh, n, s, "grad")
                    == grad[b, s, h * Dh:].storage_offset())


@settings(max_examples=200, deadline=None)
@given(H=st.integers(1, 6), S=st.integers(1, 90), Dh=st.integers(1, 40),
       pad_pos=st.integers(0, 5), pad_batch=st.integers(0, 9), P0=st.integers(0, 10 ** 4),
       rows=st.integers(1, 80), contiguous=st.booleans())
def test_span_runs_equal_the_divided_rows(H, S, Dh, pad_pos, pad_batch, P0, rows, contiguous):
    """csrc/k1_tiles.cuh's Span: where a block's rows are one run (all in one
    row n, or the 3-D op's contiguous rows) it steps a position from its first
    row; that is the divided address of every row of the block."""
    if contiguous:
        H, layout = 1, attention.RowLayout.contiguous(S, Dh)
    else:
        pos = 3 * H * Dh + pad_pos
        layout = attention.RowLayout(H, pos, S * pos + pad_batch, H * Dh, S * H * Dh)
    n, s = divmod(P0, S)
    flat = layout.H == 1 and layout.in_batch == S * layout.in_pos
    if not (flat or s + rows <= S):
        return
    base = P0 * layout.in_pos if flat else attention.row_offset(layout, Dh, n, s)
    for r in range(rows):
        nr, sr = divmod(P0 + r, S)
        assert base + r * layout.in_pos == attention.row_offset(layout, Dh, nr, sr)


def test_contiguous_layout_is_the_3d_rows():
    """The 3-D op's layout (H 1, a position Dh apart) addresses row n's
    position s at (n S + s) Dh: today's contiguous rows."""
    layout = attention.RowLayout.contiguous(7, 12)
    assert all(attention.row_offset(layout, 12, n, s, w) == (n * 7 + s) * 12
               for n in range(5) for s in range(7) for w in ("in", "out", "grad"))
    assert layout.args("fwd") == (1, 12, 84, 12, 84) and len(layout.args("bwd")) == 7


@settings(max_examples=300, deadline=None)
@given(Dh=st.integers(1, 600), bf16=st.booleans(),
       strides=st.lists(st.integers(0, 10 ** 6), max_size=6),
       addresses=st.lists(st.integers(0, 2 ** 40), min_size=1, max_size=7))
def test_copy_width_divides_every_stride_and_offset(Dh, bf16, strides, addresses):
    """The plan's copy width divides Dh E, every stride times E and every
    address, and no wider one of COPY_SIZES does; bf16 addresses are even,
    float32 ones multiples of 4, so 2-byte copies are bf16's alone."""
    dtype = BF16 if bf16 else torch.float32
    E = dtype.itemsize
    addresses = [a * E for a in addresses]
    copy = attention.copy_bytes(Dh, dtype, strides, addresses)
    values = [Dh * E, *(x * E for x in strides), *addresses]
    assert all(v % copy == 0 for v in values)
    assert all(any(v % b for v in values) for b in attention.COPY_SIZES if b > copy)
    assert copy >= E


@pytest.mark.parametrize("dtype", attention.DTYPES, ids=["f32", "bf16"])
def test_copy_width_of_contiguous_rows_is_the_head_dims(dtype):
    """On 16-byte addresses with the 3-D op's strides the layout adds nothing:
    the width is the head dim's alone (the contiguous plans are as before)."""
    for Dh in range(1, 300):
        S = 7
        layout = attention.RowLayout.contiguous(S, Dh)
        assert (attention.copy_bytes(Dh, dtype, layout.strides("bwd"), (0, 16, 4096))
                == attention.copy_bytes(Dh, dtype))


def test_misaligned_fused_layout_takes_narrower_copies_and_the_ragged_form():
    """A fused buffer whose start or strides are off 16 bytes stages in
    narrower copies; the plan is then the kernels' ragged form even at a
    native head dim."""
    qkv = _strided_qkv(2, 10, 3 * 64, 2, 0, 2, BF16)   # 4-byte offset, rows 4 bytes off
    out = torch.empty(2, 10, 64, dtype=BF16)
    layout = attention.qkv_layout(qkv, 4, out)
    E = 2
    addr = [qkv.data_ptr() + t * 64 * E for t in range(3)] + [out.data_ptr()]
    copy = attention.copy_bytes(16, BF16, layout.strides("fwd"), addr)
    assert copy == 4
    plan = attention.k1_plan(8, 10, 10, 16, BF16)._replace(copy_bytes=copy)
    assert plan.width == 16 and plan.ragged


def _div(d: int):
    """csrc/k1_tiles.cuh's Div, in Python: (multiplier, shift) for d."""
    ceil_log2 = (d - 1).bit_length()
    return (((1 << ceil_log2) - d) << 32) // d + 1, ceil_log2


@settings(max_examples=400, deadline=None)
@given(d=st.integers(1, 2 ** 31 - 1), x=st.integers(0, 2 ** 31 - 1))
def test_fast_division_is_exact_below_2_31(d, x):
    """Div's multiply-high, add and shift give x // d for every x below 2^31
    (the kernels divide positions and rows, fewer than MAX_POSITIONS), its
    multiplier a 32-bit word, d = 1 included, with no branch."""
    mul, shr = _div(d)
    assert 0 < mul < 2 ** 32
    assert (((x * mul) >> 32) + x) >> shr == x // d


def test_fast_division_mirror_follows_the_source():
    """The mirror above is the source's rule (multiplier and shift)."""
    src = (kernels.CSRC / "k1_tiles.cuh").read_text()
    assert "return Div{d, (unsigned)((((1ull << l) - d) << 32) / d + 1), l};" in src
    assert "(__umulhi(x, mul) + x) >> shr" in src
    assert attention.MAX_POSITIONS == 2 ** 31


def test_rows_of_no_positions_give_empty_results_and_no_division():
    """(B, 0, 3d): the fused op gives empty out and d(qkv) of the plain shapes
    (the CUDA launchers return before any launch, as for no rows), and the
    C side refuses S < 1 before it makes Div's constants (no divisor 0)."""
    qkv, dout = torch.empty(2, 0, 48), torch.empty(2, 0, 16)
    seed = torch.tensor([5], dtype=torch.int32)
    bias = torch.zeros(0, 0)
    assert attention.attention_qkv(qkv, 4, bias, 0.5, seed, 0.1, 5).shape == (2, 0, 16)
    assert attention.attention_qkv_bwd(qkv, 4, bias, dout, 0.5, seed, 0.1, 5).shape == (2, 0, 48)
    src = (kernels.CSRC / "k1_tiles.cuh").read_text()
    head = src[src.index("inline bool launch_head("):src.index("hd = make_head(")]
    assert "if (S < 1 ||" in head
    py = (kernels.CSRC.parent / "ops" / "attention.py").read_text()
    assert py.count("if BH == 0 or S == 0:\n        return") == 2


def test_timing_tool_folds_as_a_model_did():
    """tools/kernel_times.py's fold and unfold (the parent's SelfAttention
    copies, timed as ``folded_*_ms``) are ops/attention.py's."""
    from bridgerl_tpu_torch.tools import kernel_times

    x = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(0))
    assert torch.equal(kernel_times._fold(x, 3), attention.fold_heads(x, 3))
    assert torch.equal(kernel_times._unfold(kernel_times._fold(x, 3), 3), x)


def test_timing_tool_reads_a_ptxas_report():
    """``kernel_times --regs``: each kernel of a ptxas -v report with its
    registers, stack frame and spills."""
    from bridgerl_tpu_torch.tools import kernel_times

    text = """ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""
    assert list(kernel_times.ptxas_rows(text)) == [
        {"function": "_Z3fooPf", "stack": 8, "spill_stores": 4, "spill_loads": 12,
         "registers": 255},
        {"function": "_Z3barv", "stack": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 40}]
