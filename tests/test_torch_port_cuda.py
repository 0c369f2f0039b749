"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test here skips with a reason. On a
machine with one (which needs no JAX), run

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

``--noconftest`` skips tests/conftest.py, which configures JAX for the rest
of the suite. Shapes go beyond chip_smoke.py's: every head dim K1 takes, odd
sequence lengths and general biases, forward and backward, with dropout 0
and 0.1, at every head dim (8, 24, 48, 1, 12, 50, 100 staged in the
kernels' ragged form, 96 native, 130, 136, 160, 256, 300, 301, 512 on the
wide kernels); K2 at odd N, D and K, D up to 4096 (the tensor-core kernel past 512),
K over several slices of a cluster rank and ragged last slices, N off the
row tile, exact ties (also across the slices of one cluster), repeat calls,
and the shapes and launch plans it refuses; the model zoo's shapes (K2 at K
1024 and N 4,096 and 16,384, also from the crowding untrained codebook; K1
at S = W = 64 in both dtypes); the int8 product at widths off 8 (K 100, N
196); one small-model train step against the CPU; two data-parallel ranks
sharing the card over gloo against one process. K1's bfloat16
instantiations run at every head dim, on windows, whole rows and the
tensor-core path's long windows, with the dropout mask, what they refuse,
and a small bf16 train step. K1's tensor-core path (windows of 32 and more)
runs at ragged windows (W 40, 96), S = W = 160 at Dh 128, under the causal
bias with its tiles skipped (causal=True) and read (causal=False), and
repeats dq, dk and dv bit for bit over two launches; the backward past its
window-resident kernel (``LONG_BWD``: the row-buffered dq kernel in blocks
of 32 and 64 rows, the two-sweep one, the prior at 256 positions) and the
window-resident kernel at Dh 16, 32 and 128.

K1 runs with ``window`` (the diagonal blocks of each packed row only) and
without it (W = S, any bias). Tolerances: K1 1e-4 absolute (f32, other summation order and expf), with
the dropout mask equal bit for bit (the same Philox words); in bf16 one
bf16 ulp of the plain value (both round the same float32 quantity). K2
indices equal except rows whose two best plain distances lie within
1e-5 * (1 + |d|); counts and dw equal bit for bit to ``assignment_stats`` on
the CPU for the kernel's own indices (both add each code's rows in
increasing row order), and equal on every run.
"""

import pytest
import torch

from bridgerl_tpu_torch import parallel
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.export.serving import build_serving_module
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models.layers import attention_bias, causal_bias
from bridgerl_tpu_torch.ops import attention, codebook, kernels, vq_kernel
from bridgerl_tpu_torch.train.trainer import accumulate_grads, make_optimizer
from chip_smoke import bf16_ulps

pytestmark = pytest.mark.cuda
FWD_F32, BWD_F32 = attention.COUNTER["fwd", torch.float32], attention.COUNTER["bwd", torch.float32]


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _k1_case(gen, BH, S, Dh, bias):
    q, k, v = (torch.randn(BH, S, Dh, device="cuda", generator=gen) for _ in range(3))
    scale = Dh ** -0.5
    before = FWD_F32.count
    out = attention.packed_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert FWD_F32.count == before + 1
    ref = attention.packed_attention_reference(q, k, v, bias, scale)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("Dh", attention.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("BH,S", [(1, 1), (7, 10), (300, 33), (64, 80), (3, 128)])
def test_k1_matches_plain_with_general_bias(gen, Dh, BH, S):
    bias = torch.randn(S, S, device="cuda", generator=gen) * 3.0
    _k1_case(gen, BH, S, Dh, bias)


@pytest.mark.parametrize("packing,window", [(8, 10), (2, 10), (16, 10), (4, 7)])
def test_k1_matches_plain_with_window_mask(gen, packing, window):
    _k1_case(gen, 96, packing * window, 64, attention_bias(packing, window, "cuda"))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", attention.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("packing,window", [(8, 10), (16, 10), (4, 7), (1, 10)])
def test_k1_windowed_fwd_and_bwd_match_plain(gen, packing, window, Dh, rate):
    """window=W computes the diagonal blocks only: forward and backward
    against the windowed plain versions, 1e-4."""
    BH, S = 40, packing * window
    q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=gen) for _ in range(4))
    bias = attention_bias(packing, window, "cuda")
    seed, scale = _seed(gen), Dh ** -0.5
    kernels.reset_counters()
    out = attention.attention_fwd(q, k, v, bias, scale, seed, rate, window)
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, window)
    torch.cuda.synchronize()
    assert FWD_F32.count == 1 and BWD_F32.count == 1
    ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, window)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate,
                                                    window)
    assert (out - ref).abs().max().item() <= 1e-4
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4


def test_k1_windows_with_a_general_bias_and_the_philox_mask(gen):
    """A random bias inside the windows, and v = I / dout = I to read both
    kernels' keep bits: equal to the plain mask's diagonal blocks."""
    BH, S, W = 24, 40, 10
    q, k = (torch.randn(BH, S, 64, device="cuda", generator=gen) for _ in range(2))
    bias = torch.randn(S, S, device="cuda", generator=gen) * 3.0
    eye = torch.eye(W, 64, device="cuda").repeat(S // W, 1).expand(BH, S, 64).contiguous()
    seed = _seed(gen)
    fwd = attention.attention_fwd(q, k, eye, bias, 0.2, seed, 0.3, W)
    dv = attention.attention_bwd(q, k, eye, bias, eye, 0.2, seed, 0.3, W)[2]
    ref = attention.packed_attention_reference(q, k, eye, bias, 0.2, seed, 0.3, W)
    assert (fwd - ref).abs().max().item() <= 1e-4
    want = attention.window_dropout_mask(seed, BH, S, W, 0.3, "cuda")
    got_fwd = fwd[:, :, :W].reshape(BH, S // W, W, W) > 0
    got_bwd = dv[:, :, :W].reshape(BH, S // W, W, W).transpose(2, 3) > 0
    assert torch.equal(got_fwd, want) and torch.equal(got_bwd, want)


def test_k1_refuses_a_window_that_does_not_divide_the_row(gen):
    q = torch.randn(4, 20, 64, device="cuda", generator=gen)
    bias = torch.zeros(20, 20, device="cuda")
    with pytest.raises(ValueError, match="window"):
        attention.attention_fwd(q, q, q, bias, 0.125, None, 0.0, 7)
    with pytest.raises(ValueError, match="window"):
        attention.attention_bwd(q, q, q, bias, q, 0.125, None, 0.0, 7)
    with pytest.raises(ValueError, match="window"):
        attention.packed_attention(q, q, q, bias, 0.125, window=0)


def test_k1_empty_batch_launches_nothing(gen):
    q = torch.empty(0, 10, 64, device="cuda")
    before = FWD_F32.count
    out = attention.packed_attention(q, q, q, torch.zeros(10, 10, device="cuda"), 0.125)
    assert out.shape == (0, 10, 64) and FWD_F32.count == before


@pytest.mark.parametrize("bad", ["bias_device", "dtype", "bias_shape", "too_long"])
def test_k1_refuses_what_it_does_not_take(gen, bad):
    S, Dh = 10, 64
    q = torch.randn(4, S, Dh, device="cuda", generator=gen)
    bias = torch.zeros(S, S, device="cuda")
    args = {"q": q, "k": q, "v": q, "bias": bias}
    if bad == "bias_device":   # any head dim is taken (staged as it is): not this
        args["bias"] = bias.cpu()
    elif bad == "dtype":
        args["k"] = q.double()
    elif bad == "bias_shape":
        args["bias"] = torch.zeros(S, S + 1, device="cuda")
    elif bad == "too_long":   # the Philox counter i * S + j has 32 bits
        S = attention.MAX_ROW + 1
        args = {n: torch.randn(1, S, 16, device="cuda") for n in "qkv"}
        args["bias"] = torch.zeros(1, 1, device="cuda").expand(S, S)
    with pytest.raises(ValueError):
        attention.packed_attention(args["q"], args["k"], args["v"], args["bias"], 0.1)


def _seed(gen):
    return attention.draw_seed(gen, "cuda")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [10, 80, 120])
@pytest.mark.parametrize("Dh", attention.SUPPORTED_HEAD_DIMS)
def test_k1_bwd_matches_plain(gen, Dh, S, rate):
    BH = 48
    q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=gen) for _ in range(4))
    bias = attention_bias(S // 10, 10, "cuda")
    seed, scale = _seed(gen), Dh ** -0.5
    before = BWD_F32.count
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate)
    torch.cuda.synchronize()
    assert BWD_F32.count == before + 1
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.parametrize("S,Dh", [(80, 64), (10, 16), (120, 128)])
def test_k1_fwd_with_dropout_matches_plain(gen, S, Dh):
    q, k, v = (torch.randn(32, S, Dh, device="cuda", generator=gen) for _ in range(3))
    bias = attention_bias(S // 10, 10, "cuda")
    seed = _seed(gen)
    out = attention.attention_fwd(q, k, v, bias, Dh ** -0.5, seed, 0.1)
    ref = attention.packed_attention_reference(q, k, v, bias, Dh ** -0.5, seed, 0.1)
    assert (out - ref).abs().max().item() <= 1e-4


def test_k1_masks_equal_plain_philox(gen):
    """v = I makes the forward return p_drop and dout = I makes dv p_drop^T:
    the kernels' keep bits equal attention_dropout_mask exactly."""
    BH, S = 40, 20
    q, k = (torch.randn(BH, S, 32, device="cuda", generator=gen) for _ in range(2))
    eye = torch.eye(S, 32, device="cuda").expand(BH, S, 32).contiguous()
    bias = torch.zeros(S, S, device="cuda")
    seed = _seed(gen)
    fwd = attention.attention_fwd(q, k, eye, bias, 0.2, seed, 0.3)[:, :, :S] > 0
    dv = attention.attention_bwd(q, k, eye, bias, eye, 0.2, seed, 0.3)[2]
    want = attention.attention_dropout_mask(seed, BH, S, 0.3, "cuda")
    assert torch.equal(fwd, want) and torch.equal(dv[:, :S, :S].transpose(1, 2) > 0, want)


def test_k1_autograd_goes_through_both_kernels(gen):
    q, k, v = (torch.randn(16, 80, 64, device="cuda", generator=gen, requires_grad=True)
               for _ in range(3))
    bias = attention_bias(8, 10, "cuda")
    kernels.reset_counters()
    out = attention.packed_attention(q, k, v, bias, 0.125, 0.1,
                                     torch.Generator(device="cuda").manual_seed(3))
    out.sum().backward()
    assert FWD_F32.count == 1 and BWD_F32.count == 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_k1_bwd_empty_batch_launches_nothing(gen):
    q = torch.empty(0, 10, 64, device="cuda")
    before = BWD_F32.count
    dq, dk, dv = attention.attention_bwd(q, q, q, torch.zeros(10, 10, device="cuda"), q,
                                         0.125, None, 0.0)
    assert dq.shape == (0, 10, 64) and BWD_F32.count == before


@pytest.mark.parametrize("bad", ["bias_device", "dtype", "dout_shape", "seed", "no_seed",
                                 "too_long"])
def test_k1_bwd_refuses_what_it_does_not_take(gen, bad):
    S, Dh = 10, 64
    t = lambda *shape: torch.randn(*shape, device="cuda")
    args = {"q": t(4, S, Dh), "k": t(4, S, Dh), "v": t(4, S, Dh), "do": t(4, S, Dh),
            "bias": torch.zeros(S, S, device="cuda"), "seed": _seed(gen), "rate": 0.1}
    if bad == "bias_device":
        args["bias"] = args["bias"].cpu()
    elif bad == "dtype":
        args["k"] = args["k"].double()
    elif bad == "dout_shape":
        args["do"] = t(4, S + 1, Dh)
    elif bad == "seed":
        args["seed"] = args["seed"].long()
    elif bad == "no_seed":
        args["seed"] = None
    elif bad == "too_long":   # the Philox counter i * S + j has 32 bits
        S = attention.MAX_ROW + 1
        args.update({n: t(1, S, 16) for n in ("q", "k", "v", "do")})
        args["bias"] = torch.zeros(1, 1, device="cuda").expand(S, S)
    with pytest.raises(ValueError):
        attention.attention_bwd(args["q"], args["k"], args["v"], args["bias"], args["do"],
                                0.1, args["seed"], args["rate"])


@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_small_model_train_step_on_the_card_matches_the_cpu(gen, mode):
    """One accumulated step at dropout 0: loss 1e-5 relative, every
    gradient 1e-4 in relative norm, and the exact launches per microbatch."""
    exp = make_experiment("transformer", "hybrid", window=10, hidden_dim=16, d_model=64,
                          n_tf_layers=2, ff_dim=64, attn_packing=4, dropout=0.0,
                          batch_size=64, accum_chunks=2, mode=mode)
    x = torch.randn(64, 10, 29, generator=torch.Generator().manual_seed(1))
    h = torch.randn(64, 10, 126, generator=torch.Generator().manual_seed(2))
    res = {}
    for dev in ("cuda", "cpu"):
        model = init_model(exp.model, 3, device=dev)
        make_optimizer(model, exp)
        kernels.reset_counters()
        logs = accumulate_grads(model, exp, x.to(dev), h.to(dev),
                                torch.arange(64, device=dev), None)
        res[dev] = (float(logs["train_loss"]), {n: p.grad.cpu() for n, p in
                                                model.named_parameters()
                                                if p.grad is not None})
        if dev == "cuda":
            per_mb = {"teacher": (4, 4, 4), "student": (8, 2, 8)}[mode]
            got = tuple(kernels.COUNTERS[n].count for n in
                        ("packed_attention_fwd", "packed_attention_bwd", "vq_assign"))
            assert got == tuple(2 * c for c in per_mb)
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert sorted(gg) == sorted(gc)
    for n in gc:
        assert (gg[n] - gc[n]).norm() <= 1e-4 * gc[n].norm(), n


def _k2_case(x, cb):
    before = vq_kernel.launch_counter.count
    idx, counts, dw = codebook.nearest_codes(x, cb)
    torch.cuda.synchronize()
    assert vq_kernel.launch_counter.count == before + 1
    assert idx.dtype == torch.int32 and counts.shape == (cb.shape[0],)
    dist = torch.sum(cb * cb, dim=1)[None, :] - 2.0 * (x @ cb.t())
    idx0 = torch.argmin(dist, dim=1).to(torch.int32)
    if cb.shape[0] > 1:
        two = torch.topk(dist, 2, dim=1, largest=False).values
        near_tie = (two[:, 1] - two[:, 0]) <= 1e-5 * (1.0 + two[:, 0].abs())
        assert not ((idx != idx0) & ~near_tie).any()
    else:
        assert torch.equal(idx, idx0)
    own_counts, own_dw = codebook.assignment_stats(x.cpu(), idx.cpu(), cb.shape[0])
    assert torch.equal(counts.cpu(), own_counts) and counts.sum().item() == x.shape[0]
    assert torch.equal(dw.cpu(), own_dw)
    return idx, counts, dw


@pytest.mark.parametrize("N,D,K", [(1, 64, 512), (33, 7, 5), (4096, 64, 512),
                                   (1000, 512, 100), (5000, 128, 1024), (31, 64, 1),
                                   (257, 33, 65), (20000, 33, 64), (40000, 7, 5),
                                   (20000, 128, 256)])
def test_k2_matches_plain(gen, N, D, K):
    """Up to (257, 33, 65) one row tile per cluster; the last three take
    several tiles per cluster (plain loads at D = 33 and 7, the runtime-D
    path at 128)."""
    x = torch.randn(N, D, device="cuda", generator=gen)
    cb = torch.randn(K, D, device="cuda", generator=gen)
    _k2_case(x, cb)


def test_k2_skewed_assignments(gen):
    """Most rows on one code: its long chain of row-order adds stays exact."""
    x = torch.randn(4096, 64, device="cuda", generator=gen) * 0.01
    cb = torch.randn(512, 64, device="cuda", generator=gen)
    cb[17] = 0.0
    _k2_case(x, cb)


def test_k2_repeats_bit_for_bit(gen):
    x = torch.randn(512, 64, device="cuda", generator=gen)
    cb = torch.randn(512, 64, device="cuda", generator=gen)
    first = _k2_case(x, cb)
    for _ in range(3):
        again = codebook.nearest_codes(x, cb)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("N,D,K", [(1000, 64, 65), (1000, 64, 513), (1000, 64, 1024),
                                   (1000, 64, 4096), (300, 512, 4096)])
def test_k2_cluster_loop_and_ragged_slices(gen, N, D, K):
    """K beyond one slice per cluster rank (up to 8 per rank at K = 4096),
    and last slices holding 1 code (K = 65, 513)."""
    x = torch.randn(N, D, device="cuda", generator=gen)
    cb = torch.randn(K, D, device="cuda", generator=gen)
    _k2_case(x, cb)


@pytest.mark.parametrize("N", [4097, 1000, 6554, 511, 40001])
def test_k2_rows_off_the_tile(gen, N):
    """N not a multiple of the row tile (64 rows at 4097, 6554 and 40001,
    32 at 1000 and 511); at 40001 the statistics take two passes of idx."""
    x = torch.randn(N, 64, device="cuda", generator=gen)
    cb = torch.randn(512, 64, device="cuda", generator=gen)
    _k2_case(x, cb)


@pytest.mark.parametrize("K,low,high", [(512, 3, 200), (4096, 3, 515), (4096, 70, 4000),
                                        (513, 100, 512)])
def test_k2_ties_across_slices_go_to_the_lowest_index(gen, K, low, high):
    """Two equal codes in different slices: other cluster ranks (3 and 200,
    70 and 4000), or slices 0 and 8 of one rank (3 and 515). Every row
    near them takes the lower one."""
    cb = torch.randn(K, 64, device="cuda", generator=gen) * 3.0
    cb[high] = cb[low]
    x = cb[low].repeat(200, 1) + 1e-3 * torch.randn(200, 64, device="cuda", generator=gen)
    idx, counts, dw = _k2_case(x, cb)
    assert (idx == low).all() and counts[high].item() == 0 and counts[low].item() == 200


def test_k2_refuses_a_plan_that_does_not_cover_the_codes(gen):
    x = torch.randn(64, 64, device="cuda", generator=gen)
    cb = torch.randn(512, 64, device="cuda", generator=gen)
    out = [torch.empty(64, dtype=torch.int32, device="cuda"),
           torch.empty(512, device="cuda"), torch.empty(512, 64, device="cuda")]
    p = vq_kernel.k2_plan(64, 64, 512)
    fn = kernels.entry("vq_assign")
    ptrs = [t.data_ptr() for t in (x, cb, *out)]
    stream = kernels.stream_ptr(x)
    good = (p.tile_rows, p.cluster, p.slices_per_block, p.tiles_per_cluster, p.smem_bytes,
            p.pass_rows, int(p.wide))
    assert fn(*ptrs, 1, 64, 64, 512, *good, stream) == 0   # one group
    for bad in [(p.tile_rows, 4, 1, 1, p.smem_bytes, p.pass_rows, 0),      # 4 of 8 slices
                (p.tile_rows, 9, 1, 1, p.smem_bytes, p.pass_rows, 0),      # cluster > 8
                (48, p.cluster, 1, 1, p.smem_bytes, p.pass_rows, 0),       # no such tile
                (p.tile_rows, p.cluster, 1, 0, p.smem_bytes, p.pass_rows, 0),  # no tiles
                (p.tile_rows, p.cluster, 1, 2, p.smem_bytes, p.pass_rows, 0),  # too little
                (p.tile_rows, p.cluster, 1, 1, p.smem_bytes - 4, p.pass_rows, 0),
                (p.tile_rows, p.cluster, 1, 1, p.smem_bytes, 0, 0),
                (p.tile_rows, p.cluster, 1, 1, p.smem_bytes, p.pass_rows, 1)]:  # the wide path's
        assert fn(*ptrs, 1, 64, 64, 512, *bad, stream) != 0
    assert fn(*ptrs, 0, 64, 64, 512, *good, stream) != 0       # no group
    torch.cuda.synchronize()


def test_k2_ties_go_to_the_lowest_index(gen):
    cb = torch.randn(100, 16, device="cuda", generator=gen)
    cb[40:] = cb[3]  # codes 3 and 40..99 are one point
    x = cb[3].repeat(70, 1) + 1e-3 * torch.randn(70, 16, device="cuda", generator=gen)
    idx, counts, _ = codebook.nearest_codes(x, cb)
    assert set(idx.tolist()) <= {3} | set(range(40)) and 40 not in idx.tolist()
    assert counts[40:].sum().item() == 0


@pytest.mark.parametrize("bad", ["D", "dtype", "device", "K"])
def test_k2_refuses_what_it_does_not_take(gen, bad):
    x = torch.randn(8, 16, device="cuda")
    cb = torch.randn(32, 16, device="cuda")
    if bad == "D":   # every D of at least 1 is taken (the tensor-core kernel past 512)
        x, cb = torch.randn(8, 0, device="cuda"), torch.randn(32, 0, device="cuda")
    elif bad == "dtype":
        x = x.double()
    elif bad == "device":
        cb = cb.cpu()
    elif bad == "K":
        cb = cb[:0]
    with pytest.raises(ValueError):
        vq_kernel.nearest_codes_cuda(x, cb)


@pytest.mark.parametrize("packing", [1, 4])
def test_small_model_on_the_card_matches_the_cpu(gen, packing):
    exp = make_experiment("transformer", "hybrid", window=10, hidden_dim=16, d_model=64,
                          n_tf_layers=2, ff_dim=64, attn_packing=packing)
    gpu = build_serving_module(init_model(exp.model, 3, device="cuda"), exp)
    cpu = build_serving_module(init_model(exp.model, 3, device="cpu"), exp)
    x = torch.randn(16, 10, 126, generator=torch.Generator().manual_seed(1)).numpy()
    kernels.reset_counters()
    got = gpu.retarget(x).cpu()
    assert kernels.COUNTERS["packed_attention_fwd"].count == 4
    assert kernels.COUNTERS["vq_assign"].count == 4
    assert (got - cpu.retarget(x)).abs().max().item() <= 1e-4
    codes_gpu, codes_cpu = gpu.motion_codes(x), cpu.motion_codes(x)
    assert all(torch.equal(codes_gpu[k].cpu(), codes_cpu[k]) for k in codes_cpu)


# ---------------------------------------------------------------- K1 in bfloat16

BF16 = torch.bfloat16
BF16_ATOL = 1e-6   # float32 summation noise, seen only where a sum cancels to near 0


def _bf16(gen, *shape):
    return torch.randn(*shape, device="cuda", generator=gen).to(BF16)


def _bf16_pair(gen, BH, S, Dh, bias, window, rate, causal=False):
    """Both bf16 kernels against the bf16 plain versions on the same inputs:
    at most one bf16 ulp apart (both round the same float32 quantity), each
    launched once on its own bf16 counter (and on its tensor-core counter
    for windows of MIN_MMA_WINDOW and more) and the float32 ones untouched."""
    q, k, v, do = (_bf16(gen, BH, S, Dh) for _ in range(4))
    seed, scale = _seed(gen), Dh ** -0.5
    kernels.reset_counters()
    out = attention.attention_fwd(q, k, v, bias, scale, seed, rate, window, causal)
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, window, causal)
    torch.cuda.synchronize()
    names = ["packed_attention_fwd_bf16", "packed_attention_bwd_bf16"]
    if (window or S) >= attention.MIN_MMA_WINDOW:
        names += [n + "_mma" for n in names]
    elif Dh <= 128:   # the multi-window kernels
        names += [n + "_multi" for n in names]
    if attention.k1_plan(BH, S, window or S, Dh, BF16, "bwd", causal).blocks_kv:
        names.append("packed_attention_bwd_bf16_long")
    assert {n: c.count for n, c in kernels.COUNTERS.items() if c.count} == dict.fromkeys(
        names, 1)
    ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, window,
                                               causal)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate,
                                                    window, causal)
    assert out.dtype == BF16 and bf16_ulps(out, ref, BF16_ATOL) <= 1.0
    for a, b in zip(got, want):
        assert a.dtype == BF16 and bf16_ulps(a, b, BF16_ATOL) <= 1.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", attention.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("packing,window", [(8, 10), (1, 10), (4, 7)])
def test_k1_bf16_windowed_fwd_and_bwd_match_plain(gen, packing, window, Dh, rate):
    _bf16_pair(gen, 40, packing * window, Dh, attention_bias(packing, window, "cuda"),
               window, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh,S", [(16, 33), (64, 80), (128, 120), (128, 200)])
def test_k1_bf16_whole_rows_and_the_row_kernels(gen, Dh, S, rate):
    """window=None with a general bias; at Dh 128 and S 120 or 200 the
    windows are too large to tile (the row kernels took them once) and both
    kernels take the tensor-core path, as S 33 and 80 do."""
    bias = torch.randn(S, S, device="cuda", generator=gen) * 3.0
    _bf16_pair(gen, 12, S, Dh, bias, None, rate)


def test_k1_bf16_row_paths_are_exercised():
    """The shapes above that the row kernels took (a window's tile does not
    fit one block's shared memory) take the tensor-core path (k1_plan, the
    launchers' rule), within the budget."""
    assert attention.tile_bytes_per_window(200, 128, "fwd") > attention.SMEM_LIMIT
    assert attention.tile_bytes_per_window(120, 128, "bwd") > attention.SMEM_LIMIT
    for S, direction in ((200, "fwd"), (120, "bwd"), (200, "bwd")):
        plan = attention.k1_plan(12, S, S, 128, BF16, direction)
        assert plan.path == "mma" and max(plan.smem_bytes, plan.smem_kv) <= 232448


def test_k1_bf16_masks_equal_plain_philox(gen):
    """v = I and dout = I (exact in bf16) read both bf16 kernels' keep bits:
    equal to the plain Philox mask bit for bit."""
    BH, S = 40, 20
    q, k = (_bf16(gen, BH, S, 32) for _ in range(2))
    eye = torch.eye(S, 32, device="cuda", dtype=BF16).expand(BH, S, 32).contiguous()
    bias = torch.zeros(S, S, device="cuda")
    seed = _seed(gen)
    fwd = attention.attention_fwd(q, k, eye, bias, 0.2, seed, 0.3)[:, :, :S] > 0
    dv = attention.attention_bwd(q, k, eye, bias, eye, 0.2, seed, 0.3)[2]
    want = attention.attention_dropout_mask(seed, BH, S, 0.3, "cuda")
    assert torch.equal(fwd, want) and torch.equal(dv[:, :S, :S].transpose(1, 2) > 0, want)


@pytest.mark.parametrize("bad", ["mixed", "bias_bf16", "misaligned", "dout_f32"])
def test_k1_bf16_refuses_what_it_does_not_take(gen, bad):
    S, Dh = 10, 64
    args = {n: _bf16(gen, 4, S, Dh) for n in ("q", "k", "v", "do")}
    args["bias"] = torch.zeros(S, S, device="cuda")
    if bad == "mixed":
        args["k"] = args["k"].float()
    elif bad == "bias_bf16":
        args["bias"] = args["bias"].to(BF16)
    elif bad == "misaligned":
        args["q"] = _bf16(gen, 4 * S * Dh + 1)[1:].view(4, S, Dh)   # 2 bytes off
    elif bad == "dout_f32":
        args["do"] = args["do"].float()
    with pytest.raises(ValueError):
        if bad == "dout_f32":
            attention.attention_bwd(args["q"], args["k"], args["v"], args["bias"], args["do"],
                                    0.1, None, 0.0)
        else:
            attention.attention_fwd(args["q"], args["k"], args["v"], args["bias"], 0.1, None,
                                    0.0)


def test_small_bf16_train_step_on_the_card_matches_the_cpu(gen):
    """One accumulated teacher step in bf16 at dropout 0, on the card and on
    the CPU, against the CPU's float32 step: the card's loss and each
    gradient no farther from float32 than twice the CPU's bf16 ones (the
    loss with a floor of 1e-3 relative: a mean of many bf16-rounded terms can
    land near the float32 value by chance); launches on the bf16 counters."""
    kw = dict(window=10, hidden_dim=16, d_model=64, n_tf_layers=2, ff_dim=64,
              attn_packing=4, dropout=0.0, batch_size=64, accum_chunks=2)
    x = torch.randn(64, 10, 29, generator=torch.Generator().manual_seed(1))
    h = torch.randn(64, 10, 126, generator=torch.Generator().manual_seed(2))
    res = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "bfloat16"), ("cpu", "float32")):
        exp = make_experiment("transformer", "hybrid", compute_dtype=dtype, **kw)
        model = init_model(exp.model, 3, device=dev)
        make_optimizer(model, exp)
        kernels.reset_counters()
        logs = accumulate_grads(model, exp, x.to(dev), h.to(dev),
                                torch.arange(64, device=dev), None)
        res[dev, dtype] = (float(logs["train_loss"]),
                           {n: p.grad.cpu() for n, p in model.named_parameters()
                            if p.grad is not None})
        if dev == "cuda":
            assert {n: c.count for n, c in kernels.COUNTERS.items() if c.count} == {
                "packed_attention_fwd_bf16": 8, "packed_attention_bwd_bf16": 8,
                "packed_attention_fwd_bf16_multi": 8, "packed_attention_bwd_bf16_multi": 8,
                "packed_attention_fwd_bf16_qkv": 8, "packed_attention_bwd_bf16_qkv": 8,
                "vq_assign": 8}
            assert all(g.dtype == torch.float32 for g in res[dev, dtype][1].values())
    (lg, gg), (lc, gc), (l32, g32) = (res["cuda", "bfloat16"], res["cpu", "bfloat16"],
                                      res["cpu", "float32"])
    assert abs(lg - l32) <= max(2 * abs(lc - l32), 1e-3 * abs(l32))
    assert sorted(gg) == sorted(gc) == sorted(g32)
    for n in g32:
        own = (gc[n] - g32[n]).norm()
        assert (gg[n] - g32[n]).norm() <= 2 * own + 1e-6 * g32[n].norm(), n


# ---------------------------------------------------------------- the zoo's shapes

@pytest.mark.parametrize("N", [4096, 16384])
@pytest.mark.parametrize("init", ["normal", "untrained"])
def test_k2_at_the_zoo_shapes(gen, N, init):
    """K = 1024 (the standard, ema and rvq default) at the rows of a batch of
    256 windows of 64 frames: 16 tokens each (simple, resnet) and 64
    (resnet_no_down). "untrained" is the U(-1/K, 1/K) codebook a model
    starts from, which crowds rows onto few codes and into long row-order
    chains in the statistics kernel."""
    x = torch.randn(N, 64, device="cuda", generator=gen)
    cb = torch.randn(1024, 64, device="cuda", generator=gen)
    if init == "untrained":
        cb = (torch.rand(1024, 64, device="cuda", generator=gen) * 2 - 1) / 1024
    _k2_case(x, cb)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_at_window_64(gen, rate):
    """The CLI's default transformer: windows of 64 frames, unpacked, at
    (B*H 1024, S 64, Dh 64); one window a block in both dtypes."""
    bias = attention_bias(1, 64, "cuda")
    q, k, v, do = (torch.randn(1024, 64, 64, device="cuda", generator=gen) for _ in range(4))
    seed, scale = _seed(gen), 64 ** -0.5
    out = attention.attention_fwd(q, k, v, bias, scale, seed, rate, 64)
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, 64)
    torch.cuda.synchronize()
    ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, 64)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate, 64)
    assert (out - ref).abs().max().item() <= 1e-4
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4
    _bf16_pair(gen, 1024, 64, 64, bias, 64, rate)


# ---------------------------------------------------------------- custom ops and the artifact

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_k1_takes_views_as_an_exported_graph_gives_them(gen, dtype):
    """An exported graph's reshape after the head transpose is a view at
    b = 1: both K1 ops take strided q, k, v and dout (copying them) and
    agree with the plain version on the same values."""
    S, Dh, W = 80, 64, 10
    bias = attention_bias(8, W, "cuda")
    q, k, v, do = (torch.randn(4, Dh, S, device="cuda", generator=gen).to(dtype).transpose(1, 2)
                   for _ in range(4))
    seed, scale = _seed(gen), Dh ** -0.5
    kernels.reset_counters()
    out = attention.attention_fwd(q, k, v, bias, scale, seed, 0.1, W)
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, 0.1, W)
    torch.cuda.synchronize()
    multi = ({f"{attention.ENTRY[d, dtype]}_multi": 1 for d in ("fwd", "bwd")}
             if dtype == BF16 else {})
    assert {n: c.count for n, c in kernels.COUNTERS.items() if c.count} == {
        attention.ENTRY["fwd", dtype]: 1, attention.ENTRY["bwd", dtype]: 1, **multi}
    ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, 0.1, W)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, 0.1, W)
    for a, b in zip([out, *got], [ref, *want]):
        if dtype == BF16:
            assert bf16_ulps(a, b, BF16_ATOL) <= 1.0
        else:
            assert (a - b).abs().max().item() <= 1e-4


def test_custom_ops_launch_the_kernels_on_cuda_tensors(gen):
    """torch.ops.bridgerl.* on CUDA tensors launch the kernels (one count
    each) and agree with the plain versions; the autograd formula of the
    forward op launches the backward kernel."""
    q, k, v = (torch.randn(8, 10, 64, device="cuda", generator=gen, requires_grad=True)
               for _ in range(3))
    bias = torch.zeros(10, 10, device="cuda")
    kernels.reset_counters()
    out = torch.ops.bridgerl.packed_attention_fwd(q, k, v, bias, None, 0.125, 0.0, 10)
    out.sum().backward()
    x = torch.randn(300, 64, device="cuda", generator=gen)
    cb = torch.randn(512, 64, device="cuda", generator=gen)
    idx, counts, dw = torch.ops.bridgerl.nearest_codes(x, cb)
    torch.cuda.synchronize()
    assert {n: c.count for n, c in kernels.COUNTERS.items() if c.count} == {
        "packed_attention_fwd": 1, "packed_attention_bwd": 1, "vq_assign": 1}
    ref = attention.packed_attention_reference(q.detach(), k.detach(), v.detach(), bias, 0.125)
    assert (out.detach() - ref).abs().max().item() <= 1e-4
    want_idx, want_counts, _ = codebook.nearest_codes_plain(x, cb)
    assert torch.equal(idx, want_idx) and torch.equal(counts, want_counts)
    # the CPU adds each code's rows in row order, as the kernel does; the
    # card's index_add_ adds them in no fixed order
    assert torch.equal(dw.cpu(), codebook.assignment_stats(x.cpu(), idx.cpu(), 512)[1])


def test_eager_path_equals_the_custom_ops(gen):
    """Outside a trace CUDA tensors skip the ops' dispatch; through the ops
    (tools/dispatch_cost.py's through_ops, as a trace goes) one small
    transformer + hybrid training microbatch gives the same loss and
    gradients, bit for bit, with the same launches."""
    from bridgerl_tpu_torch.tools.dispatch_cost import through_ops

    exp = make_experiment("transformer", "hybrid", window=10, hidden_dim=16, d_model=64,
                          n_tf_layers=1, ff_dim=64, attn_packing=4, batch_size=16,
                          accum_chunks=2)
    x = torch.randn(16, 10, exp.model.robot_input_dim, device="cuda", generator=gen)
    runs = []
    for ops in (False, True):
        model = init_model(exp.model, 0, device="cuda")
        make_optimizer(model, exp)
        kernels.reset_counters()
        g = torch.Generator(device="cuda").manual_seed(1)
        with through_ops() if ops else torch.enable_grad():
            logs = accumulate_grads(model, exp, x, x, torch.arange(16, device="cuda"), g)
        torch.cuda.synchronize()
        runs.append((logs["train_loss"].item(),
                     {n: c.count for n, c in kernels.COUNTERS.items()},
                     [p.grad.clone() for p in model.parameters() if p.grad is not None]))
    (loss0, counts0, grads0), (loss1, counts1, grads1) = runs
    assert loss0 == loss1 and counts0 == counts1 and counts0["packed_attention_bwd"] > 0
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))


def test_artifact_on_the_card_matches_the_live_module(gen, tmp_path):
    """A small transformer + hybrid frozen with cuda programs: at b = 1, 3
    and 16 every function agrees with the live module (packing 4) within
    1e-5, codes equal, with one model call's launches (unpacked: the same
    counts); decode_codes runs the decoder's K1 only."""
    from bridgerl_tpu_torch.export.serialize import build_serving_artifact, load_serving_artifact

    exp = make_experiment("transformer", "hybrid", window=10, hidden_dim=16, d_model=64,
                          n_tf_layers=2, ff_dim=64, attn_packing=4)
    model = init_model(exp.model, 3, device="cuda")
    path = str(tmp_path / "a.zip")
    build_serving_artifact(model, exp, path, data_dir=None, platforms=("cuda",))
    art, live = load_serving_artifact(path), build_serving_module(model, exp)
    rng = torch.Generator().manual_seed(2)
    for b in (1, 3, 16):
        x = torch.randn(b, 10, 126, generator=rng).numpy()
        kernels.reset_counters()
        got = art.retarget(x)
        codes = art.motion_codes(x)
        torch.cuda.synchronize()
        assert kernels.COUNTERS["packed_attention_fwd"].count == 8
        assert kernels.COUNTERS["vq_assign"].count == 8
        assert (got - live.retarget(x)).abs().max().item() <= 1e-5
        want = live.motion_codes(x)
        assert all(torch.equal(codes[k], want[k]) for k in want)
        kernels.reset_counters()
        decoded = art.decode_codes(codes)
        torch.cuda.synchronize()
        assert kernels.COUNTERS["packed_attention_fwd"].count == 2
        assert kernels.COUNTERS["vq_assign"].count == 0
        assert (decoded - live.decode_codes(want)).abs().max().item() <= 1e-5
        assert (decoded - got).abs().max().item() <= 1e-5


# ---------------------------------------------------------------- seed groups, FK, int8

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_seed_groups_equal_separate_launches(gen, dtype, rate):
    """K1 with G = 4 seed groups, forward and backward, on the window tiles
    (S 80, W 10) and the tensor-core path (S = W = 160 at Dh 128, no bias):
    bit for bit the G launches of one group each, and the plain version's
    grouped call at today's tolerance."""
    G, BH = 4, 4 * 12
    for S, W, Dh, bias in ((80, 10, 64, attention_bias(8, 10, "cuda")),
                           (160, 160, 128, torch.zeros(160, 160, device="cuda"))):
        q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        seeds = torch.randint(0, attention.SEED_HIGH, (G,), device="cuda", generator=gen,
                              dtype=torch.int32)
        fwd_before = attention.COUNTER["fwd", dtype].count
        out = attention.attention_fwd(q, k, v, bias, 0.125, seeds, rate, W)
        grads = attention.attention_bwd(q, k, v, bias, do, 0.125, seeds, rate, W)
        torch.cuda.synchronize()
        assert attention.COUNTER["fwd", dtype].count == fwd_before + 1
        n = BH // G
        for i in range(G):
            r = slice(i * n, (i + 1) * n)
            one = seeds[i:i + 1]
            assert torch.equal(out[r], attention.attention_fwd(q[r], k[r], v[r], bias, 0.125,
                                                               one, rate, W))
            for a, b in zip(grads, attention.attention_bwd(q[r], k[r], v[r], bias, do[r],
                                                           0.125, one, rate, W)):
                assert torch.equal(a[r], b)
        want = attention.packed_attention_reference(q, k, v, bias, 0.125, seeds, rate, W)
        if dtype == torch.float32:
            assert (out - want).abs().max().item() <= 1e-4
        else:
            assert bf16_ulps(out, want, 1e-6) <= 1.0


def test_k1_one_seed_group_is_todays_launch(gen):
    """A seed tensor of one value gives the single-seed call's mask."""
    BH, S, W = 64, 80, 10
    q, k = (torch.randn(BH, S, 128, device="cuda", generator=gen) for _ in range(2))
    eye = torch.eye(W, 128, device="cuda").repeat(S // W, 1).expand(BH, S, 128).contiguous()
    seed = attention.draw_seed(gen, "cuda")
    bias = attention_bias(8, W, "cuda")
    kept = attention.attention_fwd(q, k, eye, bias, 0.1, seed, 0.1, W) > 0
    want = attention.window_dropout_mask(int(seed.item()), BH, S, W, 0.1, "cuda")
    got = torch.stack([kept[:, w * W:(w + 1) * W, :W] for w in range(S // W)], dim=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("G,N,D,K", [(4, 2048, 64, 512), (3, 1001, 64, 300), (2, 77, 20, 70),
                                     (2, 512, 640, 512), (3, 100, 513, 70)])
def test_k2_groups_equal_separate_launches(gen, G, N, D, K):
    """K2 over a group axis (one launch, N off a multiple of 4 included):
    bit for bit the G calls of one group, dw bit-equal to the CPU's
    assignment_stats of each group. (2, 512, 640, 512) is a stacked
    two-seed step at a wide latent (TMA: each group its own box of the
    tensor maps); D 513 takes the cp.async staging."""
    x = torch.randn(G, N, D, device="cuda", generator=gen)
    cb = torch.randn(G, K, D, device="cuda", generator=gen)
    before = vq_kernel.launch_counter.count
    idx, counts, dw = vq_kernel.nearest_codes_cuda(x, cb)
    torch.cuda.synchronize()
    assert vq_kernel.launch_counter.count == before + 1
    assert idx.shape == (G, N) and counts.shape == (G, K) and dw.shape == (G, K, D)
    for g in range(G):
        one = vq_kernel.nearest_codes_cuda(x[g].contiguous(), cb[g].contiguous())
        assert all(torch.equal(a[g], b) for a, b in zip((idx, counts, dw), one))
        c, d = codebook.assignment_stats(x[g].cpu(), idx[g].cpu(), K)
        assert torch.equal(counts[g].cpu(), c) and torch.equal(dw[g].cpu(), d)


def test_fk_on_the_card_matches_numpy(gen):
    import numpy as np

    from bridgerl_tpu_torch.sim import fk_numpy, load_g1_chain, make_batched_fk

    chain = load_g1_chain()
    q = (torch.rand(8, 10, 29, device="cuda", generator=gen) * 3.0 - 1.5)
    pos = make_batched_fk(chain)(q).cpu().numpy()
    qn = q.cpu().numpy().astype(np.float64)
    for i, t in ((0, 0), (3, 7), (7, 9)):
        assert np.abs(pos[i, t] - fk_numpy(chain, qn[i, t])[0]).max() <= 1e-5


@pytest.mark.parametrize("M,K,N", [(1, 256, 512), (10, 256, 512), (17, 256, 512),
                                   (4096, 256, 512), (7, 100, 196), (300, 100, 196)])
def test_int8_matmul_on_the_card_equals_the_cpu(gen, M, K, N):
    """torch._int_mm with padded rows (and K, N padded to multiples of 8:
    100 x 196) gives the CPU's exact product, so the float32 forward is bit
    for bit the CPU's; the bf16 forward too."""
    from bridgerl_tpu_torch.ops import int8

    x = torch.randn(M, K, device="cuda", generator=gen)
    x[0, 0] = 50.0
    w = torch.randn(N, K, device="cuda", generator=gen) * 0.1
    for dt in (torch.float32, torch.bfloat16):
        got = int8.int8_matmul(x.to(dt), w.to(dt))
        want = int8.int8_matmul(x.to(dt).cpu(), w.to(dt).cpu())
        assert torch.equal(got.cpu(), want)


def test_stacked_step_on_the_card_matches_the_cpu(gen):
    """Two seeds of a small flagship stacked: one optimizer batch at dropout
    0 on the card and on the CPU, each seed's loss within 1e-4 relative and
    each gradient within 1e-3 in relative norm (train_agree's rule); one K1
    forward a block and one K2 a VQ layer for both seeds."""
    from bridgerl_tpu_torch.models.stacked import stack_models
    from bridgerl_tpu_torch.train.multiseed import stacked_accumulate_grads

    exp = make_experiment("transformer", "hybrid", window=10, hidden_dim=16, d_model=64,
                          n_tf_layers=2, ff_dim=64, attn_packing=4, dropout=0.0,
                          batch_size=32, seeds=(1, 2))
    robot = torch.randn(64, 10, 29, generator=torch.Generator().manual_seed(0))
    human = torch.randn(64, 10, 126, generator=torch.Generator().manual_seed(1))
    idx = torch.stack([torch.arange(32), torch.arange(32, 64)])
    out = {}
    for dev in ("cpu", "cuda"):
        model = stack_models([init_model(exp.model, s, device=dev) for s in (1, 2)])
        make_optimizer(model, exp).zero_grad(set_to_none=True)
        kernels.reset_counters()
        logs = stacked_accumulate_grads(model, exp, robot.to(dev), human.to(dev),
                                        idx.to(dev), None)
        out[dev] = (logs["train_loss"].cpu(), {n: p.grad.cpu() for n, p in
                                               model.named_parameters()
                                               if p.grad is not None})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert kernels.COUNTERS["packed_attention_fwd"].count == 4
            assert kernels.COUNTERS["vq_assign"].count == 4
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert g_cpu and sorted(g_cpu) == sorted(g_gpu)
    assert ((l_gpu - l_cpu).abs() / l_cpu.abs()).max().item() <= 1e-4
    for name, gc in g_cpu.items():
        for s in range(2):
            rel = (g_gpu[name][s] - gc[s]).norm() / gc[s].norm().clamp_min(1e-30)
            assert rel.item() <= 1e-3, (name, s)


# ---------------------------------------------------------------- the token prior

CAUSAL_SHAPES = [(128, 128, 64), (16384, 5, 64), (24, 32, 64), (6, 77, 16), (8, 128, 128)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("BH,S,Dh", CAUSAL_SHAPES)
def test_k1_under_the_causal_bias_matches_plain(gen, BH, S, Dh, dtype, rate):
    """K1 forward and backward under the prior's causal bias (window = S:
    the tensor-core path at S 32, 77 and 128, the window tiles at S 5), with
    causal=True (the tiles above the diagonal skipped): within 1e-4 in
    float32, one bf16 ulp in bf16, one launch each."""
    from bridgerl_tpu_torch.models.layers import causal_bias

    bias = causal_bias(S, "cuda")
    if dtype == BF16:
        return _bf16_pair(gen, BH, S, Dh, bias, None, rate, causal=True)
    q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=gen) for _ in range(4))
    seed, scale = _seed(gen), Dh ** -0.5
    kernels.reset_counters()
    out = attention.attention_fwd(q, k, v, bias, scale, seed, rate, causal=True)
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, causal=True)
    torch.cuda.synchronize()
    assert FWD_F32.count == 1 and BWD_F32.count == 1
    ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, causal=True)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate,
                                                    causal=True)
    assert (out - ref).abs().max().item() <= 1e-4
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_k1_causal_keep_mask_equals_plain_philox(gen, dtype):
    """v = I and dout = I at S = 128 (the tensor-core path, causal=True):
    on and below the diagonal both kernels keep exactly the plain Philox
    bits; above it p is exactly 0."""
    from bridgerl_tpu_torch.models.layers import causal_bias

    BH, S, Dh = 16, 128, 128
    q, k = (torch.randn(BH, S, Dh, device="cuda", generator=gen).to(dtype) for _ in range(2))
    eye = torch.eye(S, Dh, device="cuda", dtype=dtype).expand(BH, S, Dh).contiguous()
    bias, seed = causal_bias(S, "cuda"), _seed(gen)
    fwd = attention.attention_fwd(q, k, eye, bias, Dh ** -0.5, seed, 0.1,
                                  causal=True)[:, :, :S] > 0
    dv = attention.attention_bwd(q, k, eye, bias, eye, Dh ** -0.5, seed, 0.1, causal=True)[2]
    lower = torch.ones(S, S, device="cuda").tril().bool()
    want = attention.attention_dropout_mask(seed, BH, S, 0.1, "cuda") & lower
    assert torch.equal(fwd, want) and torch.equal(dv[:, :S, :S].transpose(1, 2) > 0, want)


@pytest.mark.parametrize("slot_ar", [False, True])
def test_small_prior_train_step_and_sampling_on_the_card_match_the_cpu(gen, slot_ar):
    """A small prior: one training step at dropout 0 (loss within 1e-4
    relative, gradients 1e-3 in relative norm) and greedy-free sampling
    whose every token is the CPU's draw from the card's prefix (the same
    Philox-Gumbel noise) but where the CPU's two best perturbed scores lie
    within 1e-4."""
    from bridgerl_tpu_torch.models.token_prior import (
        PriorConfig,
        filter_logits,
        init_prior,
        position_noise,
        prior_loss,
        sample_grids,
    )

    pcfg = PriorConfig(streams=("a", "b"), vocab_sizes=(40, 24), tokens_per_stream=1,
                       window=10, stride=5, d_model=64, n_heads=4, n_layers=2, ff_dim=128,
                       dropout=0.0, max_len=32, slot_ar=slot_ar, depth_layers=1)
    g = torch.Generator().manual_seed(3)
    grid = torch.stack([torch.randint(0, v, (8, 32), generator=g) for v in (40, 24)], -1)
    mask = torch.ones(8, 32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_prior(pcfg, 0, device=dev)
        kernels.reset_counters()
        loss = prior_loss(model(grid.to(dev), train=True), grid.to(dev), mask.to(dev))
        loss.backward()
        out[dev] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert FWD_F32.count == pcfg.n_layers + pcfg.depth_layers * slot_ar
            assert BWD_F32.count == FWD_F32.count
            with torch.no_grad():
                card = sample_grids(model, 9, 4, 12, temperature=0.9, top_k=10)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for n, gc in g_cpu.items():
        assert ((g_gpu[n] - gc).norm() / gc.norm().clamp_min(1e-30)).item() <= 1e-3, n
    cpu = init_prior(pcfg, 0, device="cpu")
    card = card.cpu().long()
    noise = position_noise(cpu, torch.tensor(9), 12, 4)
    with torch.no_grad():
        logits = cpu(card)   # teacher-forced on the card's grid: every position's draw
    for s, lg in enumerate(logits):
        scores = filter_logits(lg, temperature=0.9, top_k=10) + noise[:, s].transpose(0, 1)[
            ..., :lg.shape[-1]]
        top2 = scores.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 1e-4
        assert torch.equal(scores.argmax(-1)[clear], card[..., s][clear])


# ---- the sim layer and the latent encoders (slice 10), card against the CPU ----

def _rot_inputs(seed):
    import numpy as np

    g = np.random.default_rng(seed)
    q0 = g.normal(size=(64, 4)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    return {"rotvec": g.uniform(-3, 3, (64, 3)).astype(np.float32), "q0": q0,
            "q1": np.concatenate([-q0[:16], g.normal(size=(48, 4)).astype(np.float32)]),
            "t": g.uniform(0, 1, (64, 1)).astype(np.float32),
            "d6": g.normal(size=(64, 6)).astype(np.float32)}


@pytest.mark.parametrize("fn", ["axis_angle_to_matrix", "quat_to_matrix", "quat_to_matrix_wxyz",
                                "rotation_6d_to_matrix", "quat_slerp"])
def test_rotations_on_the_card_match_the_cpu(gen, fn):
    from bridgerl_tpu_torch.data import rotations as rot

    x = _rot_inputs(0)
    calls = {"axis_angle_to_matrix": lambda t: rot.axis_angle_to_matrix(t["rotvec"]),
             "quat_to_matrix": lambda t: rot.quat_to_matrix(t["q1"]),
             "quat_to_matrix_wxyz": lambda t: rot.quat_to_matrix(t["q1"], scalar_first=True),
             "rotation_6d_to_matrix": lambda t: rot.rotation_6d_to_matrix(t["d6"]),
             "quat_slerp": lambda t: rot.quat_slerp(t["q0"], t["q1"], t["t"])}[fn]
    card = calls({k: torch.as_tensor(v, device="cuda") for k, v in x.items()})
    cpu = calls({k: torch.as_tensor(v) for k, v in x.items()})
    assert card.device.type == "cuda" and (card.cpu() - cpu).abs().max().item() <= 1e-6


@pytest.mark.parametrize("root", [False, True])
def test_load_motion_on_the_card_matches_the_cpu(gen, root):
    import numpy as np

    from bridgerl_tpu_torch.sim import load_motion

    g = np.random.default_rng(1)
    dof = g.uniform(-0.3, 0.3, (120, 29)).astype(np.float32)
    kw = {}
    if root:
        ang = np.linspace(0, 3, 120)
        kw = {"base_pos": np.cumsum(g.normal(scale=0.01, size=(120, 3)), 0).astype(np.float32),
              "base_rot": np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)],
                                   -1).astype(np.float32)}
    card = load_motion(dof, 20, 50, device="cuda", **kw)
    cpu = load_motion(dof, 20, 50, device="cpu", **kw)
    for name in ("dof_pos", "dof_vel", "base_pos", "base_rot", "base_lin_vel", "base_ang_vel"):
        a, b = getattr(card, name), getattr(cpu, name)
        assert a.device.type == "cuda" and (a.cpu() - b).abs().max().item() <= 1e-6, name


def test_replay_scene_on_the_card(gen):
    import numpy as np

    from bridgerl_tpu_torch.sim import G1ReplayScene, fk_numpy

    scene = G1ReplayScene(device="cuda")
    m = scene.load(np.random.default_rng(2).uniform(-1, 1, (40, 29)).astype(np.float32))
    pos, rot = (a.cpu().numpy() for a in scene.rollout_full())
    q = m.dof_pos.cpu().numpy().astype(np.float64)
    for t in (0, 17, m.num_frames - 1):
        want = fk_numpy(scene.chain, q[t])
        assert np.abs(pos[t] - want[0]).max() <= 1e-5 and np.abs(rot[t] - want[1]).max() <= 1e-5
    flags = [scene.get_next_state()[1] for _ in range(m.num_frames)]
    assert flags[-1] and not any(flags[:-1])
    step_pos, _ = scene.step()
    assert np.abs(step_pos.cpu().numpy() - fk_numpy(scene.chain, q[0], m.base_pos[0].cpu()
                                                    .numpy())[0]).max() <= 1e-5
    windows = scene.fk_windows(m.dof_pos[:36].reshape(4, 9, 29))
    assert windows.device.type == "cuda" and windows.shape == (4, 9, 30, 3)
    assert scene.benchmark_steps_per_sec(frames=2000) > 0


def test_csv_to_npz_on_the_card_matches_the_cpu(gen, tmp_path):
    import numpy as np

    from bridgerl_tpu_torch.cli import csv_to_npz

    g = np.random.default_rng(3)
    T = 60
    ang = np.linspace(0, 1.2, T)
    rows = np.concatenate([np.cumsum(g.normal(scale=0.01, size=(T, 3)), 0),
                           np.stack([0 * ang, 0 * ang, np.sin(ang / 2), np.cos(ang / 2)], -1),
                           g.uniform(-0.4, 0.4, (T, 29))], 1)
    np.savetxt(tmp_path / "m.csv", rows, delimiter=",")
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = str(tmp_path / f"{dev}.npz")
        assert csv_to_npz.main(["--input_file", str(tmp_path / "m.csv"), "--output_file",
                                out[dev], "--device", dev]) == 0
    card, cpu = np.load(out["cuda"]), np.load(out["cpu"])
    for k in cpu.files:
        scale = max(float(np.abs(cpu[k]).max()), 1e-3)
        assert np.abs(card[k] - cpu[k]).max() <= 1e-5 * scale, k


def test_latent_vectors_on_the_card_match_the_cpu(gen):
    import copy

    import numpy as np

    from bridgerl_tpu_torch.eval.latent import get_latent_vectors

    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8, d_model=64,
                          ff_dim=128, n_tf_layers=2)
    model = init_model(exp.model, 0, device="cuda").eval()
    cpu = copy.deepcopy(model).cpu()
    x = np.random.default_rng(4).normal(size=(300, 10, 126)).astype(np.float32)
    before = FWD_F32.count
    card = get_latent_vectors(model, x, "human", batch=256)    # 256 packed, then 44 unpacked
    assert FWD_F32.count - before == 2 * exp.model.n_tf_layers
    want = get_latent_vectors(cpu, x, "human", batch=256)
    assert card.shape == (300, 64) and np.abs(card - want).max() <= 1e-3


def test_reference_import_on_the_card_matches_the_cpu_import(gen):
    """A reference-layout wrapper of a small transformer + hybrid (DataParallel
    keys, a plain config dict) imported on the card and on the CPU: the
    float32 serving rule (1e-3, codes equal on >= 99.9% of rows), K1 and K2
    launched on the card."""
    import numpy as np

    from bridgerl_tpu_torch.export.torch_import import import_torch_checkpoint
    from bridgerl_tpu_torch.train.checkpoint import to_reference_state_dict

    src = make_experiment("transformer", "hybrid", window=10, d_model=64, ff_dim=128,
                          n_tf_layers=2, fsq_bounded=False)
    sd = to_reference_state_dict(init_model(src.model, 3, device="cpu").state_dict())
    payload = {"model_state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 2,
               "config": {"arch": "transformer", "method": "hybrid", "window": 10}}
    exp, card, _ = import_torch_checkpoint(payload, device="cuda")
    _, cpu, _ = import_torch_checkpoint(payload, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(256, 10, 126)).astype(np.float32))
    before = (FWD_F32.count, kernels.COUNTERS["vq_assign"].count)
    with torch.inference_mode():
        got = card(x_human=x.cuda())["human"]
        want = cpu(x_human=x)["human"]
    assert (FWD_F32.count - before[0], kernels.COUNTERS["vq_assign"].count - before[1]) == (4, 4)
    assert (got["retargeted"].cpu() - want["retargeted"]).abs().max().item() <= 1e-3
    for name, codes in want["codes"].items():
        assert (got["codes"][name].cpu() == codes).float().mean().item() >= 0.999, name


def test_trace_on_the_card_records_k1_and_k2(gen, tmp_path):
    import json

    from bridgerl_tpu_torch.utils.profiling import TRACE_NAME, trace

    exp = make_experiment("transformer", "hybrid", window=10, attn_packing=8, d_model=64,
                          ff_dim=128, n_tf_layers=1)
    model = init_model(exp.model, 0, device="cuda")
    x = torch.randn(64, 10, 126, device="cuda", generator=gen)
    with torch.inference_mode():
        model(x_human=x)
        with trace(str(tmp_path)):
            model(x_human=x)
            torch.cuda.synchronize()
    names = {e.get("name", "") for e in
             json.loads((tmp_path / TRACE_NAME).read_text())["traceEvents"]}
    assert any("k1_fwd_" in n for n in names) and any("vq_assign_nearest" in n for n in names)


def test_two_gloo_ranks_on_the_card_match_one_process(gen):
    """A small transformer + hybrid teacher, two steps at batch 32 in 2
    microbatches, on two ranks sharing the card over gloo (CUDA tensors in
    the collectives) against one process on the card: losses within 2e-4
    relative, the first step's gradients within 1e-5 * (1 + max|g|), EMA
    state within 2e-3 (tests/test_sharding.py's bands); the parameters
    bit-equal on both ranks."""
    import numpy as np

    import torch_parallel_cases as cases

    rng = np.random.default_rng(0)
    spec = dict(arch="transformer", method="hybrid", device="cuda",
                over=dict(window=10, hidden_dim=16, d_model=64, n_tf_layers=1, n_heads=2,
                          ff_dim=64, attn_packing=2, dropout=0.0, batch_size=32,
                          accum_chunks=2),
                robot=rng.normal(size=(64, 10, 29)).astype(np.float32),
                human=rng.normal(size=(64, 10, 126)).astype(np.float32),
                idx=rng.permutation(64).reshape(2, 32))
    ranks = [r[0] for r in parallel.launch(cases.run, 2, "gloo", args=([("steps", spec)],),
                                           device="cuda", timeout=300)]
    one = cases.run([("steps", spec)])[0]
    for run in ranks:
        for got, want in zip(run["logs"], one["logs"]):
            for k in want:
                assert abs(got[k] - want[k]) <= 2e-4 * abs(want[k]), k
        for k, w in one["grads"].items():
            assert np.abs(run["grads"][k] - w).max() <= 1e-5 * (1.0 + np.abs(w).max()), k
        for k in one["state"]:
            if k.endswith(("ema_w", "ema_cluster_size")):
                assert np.abs(run["state"][k] - one["state"][k]).max() <= 2e-3, k
    for k in ranks[0]["state"]:
        assert np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k]), k


# ---------------------------------------------------------------- K1's tensor-core path

def _k1_pair(gen, dtype, BH, S, Dh, bias, window, rate, causal=False):
    """Both kernels against the plain versions (1e-4 in float32, one bf16
    ulp in bf16); a second launch of each repeats the first bit for bit."""
    q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    seed, scale = _seed(gen), Dh ** -0.5
    kernels.reset_counters()
    run = lambda: [attention.attention_fwd(q, k, v, bias, scale, seed, rate, window, causal),
                   *attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, window,
                                            causal)]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert attention.MMA_COUNTER["fwd", dtype].count == 2
    assert attention.MMA_COUNTER["bwd", dtype].count == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = [attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, window,
                                                 causal),
            *attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate,
                                                      window, causal)]
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        if dtype == BF16:
            assert bf16_ulps(a, b, BF16_ATOL) <= 1.0
        else:
            assert (a - b).abs().max().item() <= 1e-4
    return got


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("packing,window,Dh", [(4, 40, 64), (2, 40, 16), (1, 96, 32),
                                               (2, 96, 128), (1, 160, 128), (3, 32, 64),
                                               (1, 200, 64)])
def test_k1_long_windows_match_plain_and_repeat(gen, packing, window, Dh, dtype, rate):
    """Ragged windows (W 40 and 96 are not multiples of the 64-row block or
    the 32-row tile), S = W = 160 at Dh 128 (the row kernels' shape), W 32
    and 200: the window mask's bias, forward and backward."""
    _k1_pair(gen, dtype, 24, packing * window, Dh, attention_bias(packing, window, "cuda"),
             window, rate)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("BH,S,Dh,rate", [(128, 128, 64, 0.1), (40, 96, 64, 0.0),
                                          (12, 160, 128, 0.1), (16, 33, 16, 0.1)])
def test_k1_causal_with_and_without_the_skip(gen, BH, S, Dh, dtype, rate):
    """causal=True skips the tiles above the diagonal and reads no bias
    there (here garbage); causal=False reads the causal bias in every tile.
    Both within the plain version's tolerance, and equal to each other."""
    from bridgerl_tpu_torch.models.layers import causal_bias

    bias = causal_bias(S, "cuda")
    garbage = torch.where(bias == 0, 0.0, torch.randn(S, S, device="cuda", generator=gen) * 1e4)
    state = gen.get_state()
    skip = _k1_pair(gen, dtype, BH, S, Dh, garbage, None, rate, causal=True)
    gen.set_state(state)
    full = _k1_pair(gen, dtype, BH, S, Dh, bias, None, rate, causal=False)
    for a, b in zip(skip, full):
        if dtype == BF16:
            assert bf16_ulps(a, b, BF16_ATOL) <= 1.0
        else:
            assert (a - b).abs().max().item() <= 1e-5


# past the window-resident backward (W > 128, or W > 64 at Dh 128): chip_smoke.py's
# two-kernel cases (the row-buffered dq kernel in 32-row blocks), the prior at 256
# positions and the same at Dh 128 (full cards: the two-sweep dq kernel), a window whose
# row buffers fill most of the shared memory (W 600), one too long for them (two-sweep),
# and the window-resident kernel at Dh 32 and 16 (W 128) and at Dh 128 (W 64)
LONG_BWD = [(24, 160, 128, False), (48, 200, 64, False), (32, 160, 64, True),
            (128, 256, 64, True), (512, 128, 128, True), (2, 600, 64, False),
            (2, 1024, 16, True), (128, 128, 32, True), (3, 128, 16, False), (4, 64, 128, True)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("BH,S,Dh,causal", LONG_BWD)
def test_k1_backward_past_the_window_resident_kernel(gen, BH, S, Dh, causal, dtype, rate):
    """Forward and backward against the plain versions, each launched twice
    and bit-equal; the backward's launches counted on the two-kernel counter
    exactly where its plan has a dk / dv kernel."""
    from bridgerl_tpu_torch.models.layers import causal_bias

    bias = causal_bias(S, "cuda") if causal else attention_bias(1, S, "cuda")
    _k1_pair(gen, dtype, BH, S, Dh, bias, None, rate, causal)
    plan = attention.k1_plan(BH, S, S, Dh, dtype, "bwd", causal)
    assert attention.LONG_COUNTER["bwd", dtype].count == (2 if plan.blocks_kv else 0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_k1_long_window_keep_mask_equals_plain_philox(gen, dtype):
    """v = I and dout = I at W 64 over packed rows of 2 windows (the K4
    teacher's layout): both tensor-core kernels keep exactly the plain
    Philox bits inside the windows."""
    BH, S, W, Dh = 24, 128, 64, 128
    q, k = (torch.randn(BH, S, Dh, device="cuda", generator=gen).to(dtype) for _ in range(2))
    eye = torch.eye(W, Dh, device="cuda", dtype=dtype).repeat(2, 1).expand(BH, S, Dh)
    eye = eye.contiguous()
    bias, seed = attention_bias(2, W, "cuda"), _seed(gen)
    fwd = attention.attention_fwd(q, k, eye, bias, 0.125, seed, 0.1, W)[:, :, :W]
    dv = attention.attention_bwd(q, k, eye, bias, eye, 0.125, seed, 0.1, W)[2][:, :, :W]
    want = attention.window_dropout_mask(seed, BH, S, W, 0.1, "cuda")
    got_fwd = fwd.reshape(BH, 2, W, W) > 0
    got_bwd = dv.reshape(BH, 2, W, W).transpose(2, 3) > 0
    assert torch.equal(got_fwd, want) and torch.equal(got_bwd, want)


def test_k1_refuses_a_plan_that_is_not_the_launchers(gen):
    """The C entry points recompute the plan and refuse any other."""
    q = torch.randn(8, 64, 64, device="cuda", generator=gen)
    out = torch.empty_like(q)
    bias = torch.zeros(64, 64, device="cuda")
    plan = attention.k1_plan(8, 64, 64, 64, torch.float32, "fwd")
    fn = kernels.entry("packed_attention_fwd")
    call = lambda path, blocks, smem, copy=16: fn(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), bias.data_ptr(), out.data_ptr(), 8, 64, 64,
        64, *attention.RowLayout.contiguous(64, 64).args("fwd"), 0.125, 0, 8, 0, 1.0, 0, 0,
        path, blocks, smem, copy, kernels.stream_ptr(q))
    assert call(1, plan.blocks, plan.smem_bytes) == 0
    for bad in [(0, plan.blocks, plan.smem_bytes), (1, plan.blocks - 1, plan.smem_bytes),
                (1, plan.blocks, plan.smem_bytes - 16), (1, plan.blocks, plan.smem_bytes, 8)]:
        assert call(*bad) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("S", [64, 160])
def test_k1_backward_entry_points_refuse_each_others_plans(gen, S):
    """The one-kernel entry point (window tiles, window-resident) and the
    two-kernel one (``LONG_ENTRY``) are libraries of their own: each takes
    only its own plans."""
    BH, Dh = 4, 64
    q = torch.randn(BH, S, Dh, device="cuda", generator=gen)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bias = torch.zeros(S, S, device="cuda")
    plan = attention.k1_plan(BH, S, S, Dh, torch.float32, "bwd")
    stats = torch.empty(max(attention.backward_scratch(plan), 1), device="cuda")
    assert bool(plan.blocks_kv) == (S == 160)
    status = {}
    for name in ("packed_attention_bwd", attention.LONG_ENTRY[torch.float32]):
        status[name] = kernels.entry(name)(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), bias.data_ptr(), q.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), BH, S, S, Dh,
            *attention.RowLayout.contiguous(S, Dh).args("bwd"), Dh ** -0.5, 0, BH, 0, 1.0,
            0, 0, 1, plan.blocks, plan.smem_bytes, plan.blocks_kv, plan.smem_kv,
            plan.copy_bytes, kernels.stream_ptr(q))
    torch.cuda.synchronize()
    own = attention.LONG_ENTRY[torch.float32] if plan.blocks_kv else "packed_attention_bwd"
    assert {n: s == 0 for n, s in status.items()} == {n: n == own for n in status}


@pytest.mark.parametrize("N,D,K,scale", [
    (512, 640, 512, 1.0), (4096, 640, 512, 1.0), (512, 1024, 512, 1.0), (4096, 1024, 512, 1.0),
    (100, 513, 70, 1.0), (300, 2048, 600, 1.0), (50, 1001, 65, 1.0),
    (64, 513, 512, 1.0), (64, 520, 512, 1.0), (64, 4096, 512, 1.0),   # ragged, a step of 8, wide
    (1, 1024, 512, 1.0), (100, 1024, 1, 1.0), (100, 640, 70, 1.0),    # N 1, K 1, K 70
    (4096, 1024, 512, 0.25), (512, 640, 512, 3.0)])   # codes scaled: rows crowd onto few codes
def test_k2_past_512_columns_matches_plain(gen, N, D, K, scale):
    """D past 512: the tensor-core kernel of csrc/k2_wide.cuh (TMA where D is
    a multiple of 4, cp.async staging at 513, 1001), under the rule of every
    K2 case; two calls equal bit for bit; counted on vq_assign_wide too."""
    x = torch.randn(N, D, device="cuda", generator=gen)
    cb = torch.randn(K, D, device="cuda", generator=gen) * scale
    wide = vq_kernel.wide_counter.count
    first = _k2_case(x, cb)
    assert vq_kernel.wide_counter.count == wide + 1
    assert all(torch.equal(a, b) for a, b in zip(first, codebook.nearest_codes(x, cb)))


@pytest.mark.parametrize("N,D", [(300, 640), (1000, 1024), (100, 513)])
def test_k2_wide_kernel_takes_several_tiles_a_cluster(gen, N, D):
    """The wide kernel's clusters can take 2 or 3 row tiles each (its plan
    takes one): bit for bit the outputs of the plan's launch."""
    x = torch.randn(N, D, device="cuda", generator=gen)
    cb = torch.randn(512, D, device="cuda", generator=gen)
    want = vq_kernel.nearest_codes_cuda(x, cb)
    fn = kernels.entry("vq_assign")
    p = vq_kernel.k2_plan(N, D, 512)
    assert p.wide and p.tiles_per_cluster == 1
    for tiles in (2, 3):
        out = [torch.empty_like(t) for t in want]
        status = fn(x.data_ptr(), cb.data_ptr(), *[t.data_ptr() for t in out], 1, N, D, 512,
                    p.tile_rows, p.cluster, p.slices_per_block, tiles,
                    vq_kernel.wide_smem(p.tile_rows, tiles), p.pass_rows, 1,
                    kernels.stream_ptr(x))
        torch.cuda.synchronize()
        assert status == 0 and all(torch.equal(a, b) for a, b in zip(out, want)), tiles


def test_k2_refuses_a_plan_for_the_other_kernel(gen):
    """A plan made for D up to 512 is refused past it, and a wide plan at D
    512 or below; the right plans launch. Only the wrapper's launches count
    on vq_assign_wide."""
    fn = kernels.entry("vq_assign")
    for D, other in ((640, 512), (512, 640)):
        x = torch.randn(64, D, device="cuda", generator=gen)
        cb = torch.randn(512, D, device="cuda", generator=gen)
        out = [torch.empty(64, dtype=torch.int32, device="cuda"),
               torch.empty(512, device="cuda"), torch.empty(512, D, device="cuda")]
        args = [t.data_ptr() for t in (x, cb, *out)] + [1, 64, D, 512]
        stream = kernels.stream_ptr(x)
        for plan, ok in ((vq_kernel.k2_plan(64, D, 512), True),
                         (vq_kernel.k2_plan(64, other, 512), False)):
            fields = (plan.tile_rows, plan.cluster, plan.slices_per_block,
                      plan.tiles_per_cluster, plan.smem_bytes, plan.pass_rows, int(plan.wide))
            assert (fn(*args, *fields, stream) == 0) == ok, (D, plan)
        before = vq_kernel.wide_counter.count
        codebook.nearest_codes(x, cb)
        assert vq_kernel.wide_counter.count == before + (D > 512)
    torch.cuda.synchronize()


# Head dims off the instantiated widths, staged in the kernels' ragged form on every path:
# the window tiles (W 10), the tensor-core forward and window-resident backward (W 64, and
# W 96 at 128 rows), the row-buffered backward (24 windows of 160), the two-sweep backward
# (the full grid of 128 windows of 256, causal). Copies (f32 · bf16): Dh 1 of 4 bytes ·
# plain 2-byte loads, 12 of 16 · 8, 50 of 8 · 4, 100 of 16 · 8; 8, 24, 48 of 16 bytes.
RAGGED_SHAPES = [(40, 20, 10, Dh, False) for Dh in (1, 12, 50, 100)] + \
    [(8, 64, 64, Dh, False) for Dh in (1, 12, 50, 100)] + \
    [(24, 160, 160, Dh, False) for Dh in (1, 12, 50, 100)] + \
    [(128, 256, 256, Dh, True) for Dh in (1, 12, 50, 100)] + [(32, 96, 96, 12, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("BH,S,W,Dh,causal", [(40, 20, 10, 8, False), (40, 20, 10, 24, False),
                                              (40, 20, 10, 96, False), (8, 64, 64, 48, False),
                                              (128, 96, 96, 96, True), (8, 64, 64, 160, False),
                                              (40, 20, 10, 256, False), (6, 96, 96, 256, True),
                                              (2, 32, 32, 512, False),
                                              # wide: windows a block at W 5 and 10 (the last
                                              # block partial), Dh 160 unpadded at W 10, a
                                              # column group past 256 and Dh 512 on a grid of
                                              # 512 blocks, Dh 136 staged at 144, causal W 5
                                              (7, 30, 5, 256, True), (13, 40, 10, 160, False),
                                              (3, 160, 160, 384, True), (128, 64, 64, 512, False),
                                              (5, 72, 72, 136, False), (12, 20, 5, 200, False),
                                              # full grids past W 64: whole rows, one column
                                              # group (merged in bf16 at 256, in both dtypes
                                              # at 160), the tiles with most work first
                                              (72, 96, 96, 256, True), (72, 96, 96, 160, True),
                                              # wide in narrower copies (f32 · bf16): Dh 130 of
                                              # 8 · 4 bytes, 300 of 16 · 8, 301 of 4 · plain
                                              # loads (odd: stores one element at a time), at W
                                              # 10 (windows a block), 64 (one kernel) and past
                                              (40, 20, 10, 130, False), (8, 64, 64, 130, False),
                                              (12, 160, 160, 130, True), (40, 20, 5, 300, False),
                                              (8, 64, 64, 300, False), (3, 160, 160, 300, True),
                                              (8, 64, 64, 301, False), (40, 20, 10, 301, False),
                                              *RAGGED_SHAPES])
def test_k1_at_any_head_dim_matches_plain(gen, BH, S, W, Dh, causal, rate, dtype):
    """Every head dim as it is: off the instantiated widths (8, 24, 48; 1,
    12, 50, 100 on every path) in the kernels' ragged form, staged at the next
    width, Dh 96 (the d384L6 prior's) natively, and past 128 on the wide
    kernels (130, 136, 160, 200, 256, 300, 301, 384, 512; several windows a
    block at W <= 32): forward and backward against the plain version at the
    true Dh (f32 1e-4, bf16 one ulp), every element of every row (a store
    past Dh would land in the next row), two backward launches bit for bit,
    and the counters of the path."""
    q, k, v, do = (torch.randn(BH, S, Dh, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    bias = (torch.triu(torch.full((S, S), -1e9, device="cuda"), 1) if causal
            else attention_bias(S // W, W, "cuda"))
    seed, scale = _seed(gen), Dh ** -0.5
    kernels.reset_counters()
    out = attention.attention_fwd(q, k, v, bias, scale, seed, rate, W, causal)
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, W, causal)
    again = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, W, causal)
    torch.cuda.synchronize()
    assert attention.COUNTER["fwd", dtype].count == 1 and attention.COUNTER["bwd", dtype].count == 2
    if Dh > 128:   # the wide kernels: their own counters, no other path's
        assert attention.WIDE_COUNTER["fwd", dtype].count == 1
        assert attention.WIDE_COUNTER["bwd", dtype].count == 2
        assert attention.MMA_COUNTER["bwd", dtype].count == 0
    else:
        plan = attention.k1_plan(BH, S, W, Dh, dtype, "bwd", causal)
        assert attention.MMA_COUNTER["bwd", dtype].count == (2 if plan.path == "mma" else 0)
        assert attention.LONG_COUNTER["bwd", dtype].count == (2 if plan.blocks_kv else 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, W, causal)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate, W,
                                                    causal)
    for a, b in zip([out, *got], [ref, *want]):
        assert a.shape == (BH, S, Dh) and a.dtype == dtype
        if dtype == torch.float32:
            assert (a - b).abs().max().item() <= 1e-4
        else:
            assert bf16_ulps(a, b, 1e-6) <= 1.0


def test_k1_wide_entry_points_refuse_other_plans(gen):
    """The wide kernels' entry points take only head dims past 128, at their
    own plan, copy size and path."""
    BH, S, Dh = 4, 64, 256
    q = torch.randn(BH, S, Dh, device="cuda", generator=gen)
    out = torch.empty_like(q)
    bias = torch.zeros(S, S, device="cuda")
    plan = attention.k1_plan(BH, S, S, Dh, torch.float32, "fwd")
    fn = kernels.entry(attention.WIDE_ENTRY["fwd", torch.float32])
    call = lambda dh, blocks, smem, path=attention.PATH_CODE["wide"], copy=16: fn(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), bias.data_ptr(), out.data_ptr(), BH, S, S,
        dh, *attention.RowLayout.contiguous(S, dh).args("fwd"), 0.1, 0, BH, 0, 1.0, 0, 0, path,
        blocks, smem, copy, kernels.stream_ptr(q))
    assert call(Dh, plan.blocks, plan.smem_bytes) == 0
    for bad in [(128, plan.blocks, plan.smem_bytes), (196, plan.blocks, plan.smem_bytes),
                (Dh, plan.blocks - 1, plan.smem_bytes), (Dh, plan.blocks, plan.smem_bytes - 16),
                (Dh, plan.blocks, plan.smem_bytes, attention.PATH_CODE["mma"]),
                (Dh, plan.blocks, plan.smem_bytes, attention.PATH_CODE["wide"], 8)]:
        assert call(*bad) != 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------- bf16 multi-window kernels
#
# bf16 at W < 32 (csrc/k1_multi.cuh): several whole windows a block, a warp a strip of
# 16 query rows on the tensor cores. W 1 (64 windows a block), 5 (the slot-AR depth
# stacks), 10 (the flagship), 16 (strips on window boundaries), 24 and 31 (two windows a
# block, a strip across both); Dh native (16, 64, 96, 128) and ragged (8, 24, 48; 50 in
# copies of 4 bytes, 21 in plain 2-byte loads).

MULTI_W = (1, 5, 10, 16, 24, 31)
MULTI_DH = (8, 16, 21, 24, 48, 50, 64, 96, 128)


def _multi_run(gen, BH, S, W, Dh, rate, causal=False, seed=None, bias=None):
    """Forward and two backward launches of the bf16 multi-window kernels:
    one bf16 ulp from the plain version, the backward bit-equal over two
    launches, every launch counted on the entry's and the multi counter."""
    from bridgerl_tpu_torch.models.layers import causal_bias

    q, k, v, do = (_bf16(gen, BH, S, Dh) for _ in range(4))
    if bias is None:
        bias = causal_bias(S, "cuda") if causal else attention_bias(S // W, W, "cuda")
    seed, scale = _seed(gen) if seed is None else seed, Dh ** -0.5
    assert attention.k1_plan(BH, S, W, Dh, BF16, "bwd", causal).path == "multi"
    kernels.reset_counters()
    out = attention.attention_fwd(q, k, v, bias, scale, seed, rate, W, causal)
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, W, causal)
    again = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate, W, causal)
    torch.cuda.synchronize()
    assert {n: c.count for n, c in kernels.COUNTERS.items() if c.count} == {
        "packed_attention_fwd_bf16": 1, "packed_attention_fwd_bf16_multi": 1,
        "packed_attention_bwd_bf16": 2, "packed_attention_bwd_bf16_multi": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = attention.packed_attention_reference(q, k, v, bias, scale, seed, rate, W, causal)
    want = attention.packed_attention_bwd_reference(q, k, v, bias, do, scale, seed, rate, W,
                                                    causal)
    for a, b in zip([out, *got], [ref, *want]):
        assert a.shape == (BH, S, Dh) and a.dtype == BF16
        assert bf16_ulps(a, b, BF16_ATOL) <= 1.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Dh", MULTI_DH)
@pytest.mark.parametrize("W", MULTI_W)
def test_k1_multi_window_kernels_match_plain(gen, W, Dh, rate):
    """Every window length and head dim the kernels take, over a grid whose
    last block holds fewer windows than the others."""
    _multi_run(gen, 13, 5 * W, W, Dh, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("W,P", [(5, 1), (5, 3), (10, 2), (31, 2)])
def test_k1_multi_window_kernels_under_the_causal_bias(gen, W, P, rate):
    """causal: the slot-AR depth stacks' S = W = 5, and several causal windows
    a row (the diagonal blocks of the causal bias)."""
    _multi_run(gen, 24, P * W, W, 64, rate, causal=True)


@pytest.mark.parametrize("Dh", [16, 64])
def test_k1_multi_window_kernels_at_the_longest_rows(gen, Dh):
    """S = 65,535 (the largest Philox counter i * S + j): W 5, 15 and 17
    divide it; windows of rows far into the packed row."""
    S = attention.MAX_ROW
    bias = torch.zeros(S, S, device="cuda")
    for W in (5, 15, 17):
        _multi_run(gen, 2, S, W, Dh, 0.1, bias=bias)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_multi_window_kernels_with_seed_groups(gen, rate):
    """4 seed groups in one launch (the stacked multi-seed step): bit for bit
    the launches of one group each, and one ulp from the plain version."""
    G, BH, S, W, Dh = 4, 4 * 24, 80, 10, 64
    q, k, v, do = (_bf16(gen, BH, S, Dh) for _ in range(4))
    bias = attention_bias(S // W, W, "cuda")
    seeds = torch.randint(0, attention.SEED_HIGH, (G,), device="cuda", generator=gen,
                          dtype=torch.int32)
    _multi_run(gen, BH, S, W, Dh, rate, seed=seeds)
    out = attention.attention_fwd(q, k, v, bias, 0.125, seeds, rate, W)
    grads = attention.attention_bwd(q, k, v, bias, do, 0.125, seeds, rate, W)
    n = BH // G
    for i in range(G):
        r, one = slice(i * n, (i + 1) * n), seeds[i:i + 1]
        assert torch.equal(out[r], attention.attention_fwd(q[r], k[r], v[r], bias, 0.125, one,
                                                           rate, W))
        for a, b in zip(grads, attention.attention_bwd(q[r], k[r], v[r], bias, do[r], 0.125,
                                                       one, rate, W)):
            assert torch.equal(a[r], b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("W", [1, 5, 10, 16, 31])
def test_k1_multi_window_keep_masks_equal_plain_philox(gen, W, causal):
    """v = I and dout = I (Dh >= S) read both kernels' keep bits: inside the
    windows (on and below each diagonal under causal) exactly the plain
    Philox mask, the masks the float32 window tiles draw."""
    from bridgerl_tpu_torch.models.layers import causal_bias

    BH, S, Dh = 40, 2 * W, 64
    q, k = (_bf16(gen, BH, S, Dh) for _ in range(2))
    eye = torch.eye(W, Dh, device="cuda", dtype=BF16).repeat(S // W, 1).expand(
        BH, S, Dh).contiguous()
    bias = causal_bias(S, "cuda") if causal else attention_bias(S // W, W, "cuda")
    seed = _seed(gen)
    fwd = attention.attention_fwd(q, k, eye, bias, 0.125, seed, 0.3, W, causal)
    dv = attention.attention_bwd(q, k, eye, bias, eye, 0.125, seed, 0.3, W, causal)[2]
    want = attention.window_dropout_mask(seed, BH, S, W, 0.3, "cuda")
    if causal:
        want &= torch.ones(W, W, device="cuda").tril().bool()
    got_fwd = fwd[:, :, :W].reshape(BH, S // W, W, W) > 0
    got_bwd = dv[:, :, :W].reshape(BH, S // W, W, W).transpose(2, 3) > 0
    assert torch.equal(got_fwd, want) and torch.equal(got_bwd, want)
    f32 = attention.attention_fwd(q.float(), k.float(), eye.float(), bias, 0.125, seed, 0.3, W,
                                  causal)
    assert torch.equal(f32[:, :, :W].reshape(BH, S // W, W, W) > 0, want)


def test_k1_multi_window_entry_points_refuse_other_plans(gen):
    """The bf16 entry points take only the multi-window plan at W < 32: not
    the float32 tiles' (path 0), nor other blocks or shared memory."""
    BH, S, W, Dh = 8, 80, 10, 64
    q = _bf16(gen, BH, S, Dh)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bias = torch.zeros(S, S, device="cuda")
    fwd, bwd = (attention.multi_plan(BH, S, W, Dh, d) for d in ("fwd", "bwd"))
    tiles = attention.k1_plan(BH, S, W, Dh, torch.float32, "fwd")
    f = kernels.entry("packed_attention_fwd_bf16")
    b = kernels.entry("packed_attention_bwd_bf16")
    layout = attention.RowLayout.contiguous(S, Dh)
    call_f = lambda path, blocks, smem: f(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), bias.data_ptr(), dq.data_ptr(), BH, S, W, Dh,
        *layout.args("fwd"), 0.125, 0, BH, 0, 1.0, 0, 0, path, blocks, smem, 16,
        kernels.stream_ptr(q))
    call_b = lambda path, blocks, smem, blocks_kv=0: b(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), bias.data_ptr(), q.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), 0, BH, S, W, Dh, *layout.args("bwd"), 0.125, 0, BH, 0,
        1.0, 0, 0, path, blocks, smem, blocks_kv, 0, 16, kernels.stream_ptr(q))
    code = attention.PATH_CODE["multi"]
    assert call_f(code, fwd.blocks, fwd.smem_bytes) == 0
    assert call_b(code, bwd.blocks, bwd.smem_bytes) == 0
    for bad in [(0, tiles.blocks, tiles.smem_bytes), (code, fwd.blocks + 1, fwd.smem_bytes),
                (code, fwd.blocks, fwd.smem_bytes + 16), (attention.PATH_CODE["mma"],
                                                          fwd.blocks, fwd.smem_bytes)]:
        assert call_f(*bad) != 0
    for bad in [(0, bwd.blocks, bwd.smem_bytes), (code, bwd.blocks, fwd.smem_bytes),
                (code, bwd.blocks, bwd.smem_bytes, bwd.blocks)]:
        assert call_b(*bad) != 0
    torch.cuda.synchronize()



# ---------------------------------------------------------------- the fused layout
#
# attention_qkv: K1 reading q, k and v in the projection's (B, S, 3d) output and writing
# out as (B, S, d), d(qkv) as one (B, S, 3d) tensor. Every path, both dtypes, dropout 0
# and 0.1 (with two seed groups), causal: bit for bit the 3-D launch on the folded copies.

QKV_CASES = {   # (B, H, S, Dh, window, causal)
    "tiles-multi-W10": (16, 4, 80, 64, 10, False),
    "tiles-multi-W5-Dh48": (4, 4, 20, 48, 5, False),
    "mma-window-W64": (4, 4, 64, 64, 64, False),
    "window-128-Dh32": (2, 2, 128, 32, 128, False),
    "row-buffered-W160": (2, 2, 160, 64, 160, False),
    "two-sweep-W256": (32, 4, 256, 64, 256, False),
    "causal-S160": (4, 2, 160, 64, None, True),
    "causal-S16": (8, 2, 16, 32, None, True),
    "ragged-Dh50-H3": (4, 3, 20, 50, 10, False),
    "wide-Dh160-W10": (2, 2, 40, 160, 10, False),
    "wide-ragged-Dh130": (2, 2, 40, 130, 10, False),
    "wide-pair-Dh256-W128": (2, 2, 128, 256, 128, False),
}


def _qkv_case(gen, case, dtype, rate, qkv=None):
    B, H, S, Dh, window, causal = QKV_CASES[case]
    W = window or S
    if qkv is None:
        qkv = torch.randn(B, S, 3 * H * Dh, device="cuda", generator=gen).to(dtype)
    dout = torch.randn(B, S, H * Dh, device="cuda", generator=gen).to(dtype)
    bias = causal_bias(S, "cuda") if causal else attention_bias(S // W, W, "cuda")
    seed = torch.randint(0, attention.SEED_HIGH, (2 if rate else 1,), device="cuda",
                         generator=gen, dtype=torch.int32)
    return qkv, dout, bias, seed, (Dh ** -0.5, seed, rate, W, causal), H


def _qkv_equal_3d(qkv, dout, bias, args, H):
    """The fused launch against the 3-D launch on the folded copies."""
    q, k, v = attention.split_qkv(qkv, H)
    out3 = attention.attention_fwd(q, k, v, bias, *args)
    grads3 = attention.attention_bwd(q, k, v, bias, attention.fold_heads(dout, H), *args)
    kernels.reset_counters()
    out = attention.attention_qkv(qkv, H, bias, *args)
    grad = attention.attention_qkv_bwd(qkv, H, bias, dout, *args)
    again = attention.attention_qkv_bwd(qkv, H, bias, dout, *args)
    torch.cuda.synchronize()
    assert out.shape == (qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3)
    assert torch.equal(out, attention.unfold_heads(out3, H))
    assert torch.equal(grad, torch.cat([attention.unfold_heads(g, H) for g in grads3], -1))
    assert torch.equal(again, grad)
    dt = qkv.dtype
    assert attention.QKV_COUNTER["fwd", dt].count == 1
    assert attention.QKV_COUNTER["bwd", dt].count == 2


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", attention.DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(QKV_CASES))
def test_k1_fused_layout_equals_the_3d_launch(gen, case, dtype, rate):
    qkv, dout, bias, _, args, H = _qkv_case(gen, case, dtype, rate)
    _qkv_equal_3d(qkv, dout, bias, args, H)


@pytest.mark.parametrize("dtype", attention.DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["tiles-multi-W10", "mma-window-W64", "row-buffered-W160",
                                  "wide-Dh160-W10", "wide-pair-Dh256-W128"])
def test_k1_fused_layout_off_16_bytes_takes_narrower_copies(gen, case, dtype):
    """q, k and v in a buffer that starts one element in, rows a padded
    element apart: the launch stages in copies under 16 bytes (the kernels'
    ragged form, at a native head dim too), bit-equal to the 3-D launch."""
    B, H, S, Dh, _, _ = QKV_CASES[case]
    d3 = 3 * H * Dh
    buf = torch.randn(1 + B * S * (d3 + 1), device="cuda", generator=gen).to(dtype)
    qkv = buf.as_strided((B, S, d3), (S * (d3 + 1), d3 + 1, 1), 1)
    qkv, dout, bias, _, args, H = _qkv_case(gen, case, dtype, 0.1, qkv)
    out = torch.empty(B, S, H * Dh, device="cuda", dtype=dtype)
    layout = attention.qkv_layout(qkv, H, out)
    E = dtype.itemsize
    copy = attention.copy_bytes(Dh, dtype, layout.strides("fwd"),
                                [qkv.data_ptr() + t * H * Dh * E for t in range(3)])
    assert copy == E if dtype == torch.bfloat16 else copy == 4
    _qkv_equal_3d(qkv, dout, bias, args, H)


def test_k1_fused_op_copies_only_an_input_it_cannot_address(gen):
    """A qkv whose last dimension is not contiguous is copied first (an input
    conversion) and gives the same bits; the launch counts as fused."""
    B, H, S, Dh = 2, 2, 20, 16
    strided = torch.randn(B, S, 2, 3 * H * Dh, device="cuda", generator=gen)[:, :, 0, :]
    odd = torch.randn(B, 3 * H * Dh, S, device="cuda", generator=gen).transpose(1, 2)
    assert strided.stride(-1) == 1 and odd.stride(-1) == S   # addressed as it is; copied
    bias = attention_bias(2, 10, "cuda")
    for qkv in (strided, odd):
        want = attention.attention_qkv(qkv.contiguous(), H, bias, 0.25, None, 0.0, 10)
        got = attention.attention_qkv(qkv, H, bias, 0.25, None, 0.0, 10)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", attention.DTYPES, ids=["f32", "bf16"])
def test_k1_empty_rows_launch_nothing(gen, dtype):
    """Rows of no positions, fused (B, 0, 3d) and 3-D (BH, 0, Dh), forward and
    backward: empty outputs of the plain version's shapes, and no launch."""
    B, H, Dh = 2, 4, 16
    qkv = torch.empty(B, 0, 3 * H * Dh, device="cuda", dtype=dtype)
    dout = torch.empty(B, 0, H * Dh, device="cuda", dtype=dtype)
    q = torch.empty(B * H, 0, Dh, device="cuda", dtype=dtype)
    bias = torch.zeros(0, 0, device="cuda")
    seed = attention.draw_seed(gen, "cuda")
    args = (0.25, seed, 0.1, 5)
    kernels.reset_counters()
    out = attention.attention_qkv(qkv, H, bias, *args)
    grad = attention.attention_qkv_bwd(qkv, H, bias, dout, *args)
    out3 = attention.attention_fwd(q, q, q, bias, *args)
    grads3 = attention.attention_bwd(q, q, q, bias, q, *args)
    torch.cuda.synchronize()
    assert out.shape == (B, 0, H * Dh) and grad.shape == (B, 0, 3 * H * Dh)
    assert out3.shape == q.shape and all(g.shape == q.shape for g in grads3)
    assert all(c.count == 0 for c in kernels.COUNTERS.values())
