"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test here skips with a reason. On a
machine with one (which needs no JAX), run

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

``--noconftest`` skips tests/conftest.py, which configures JAX for the rest
of the suite. Shapes go beyond chip_smoke.py's: every head dim K1 takes, odd
sequence lengths and general biases, forward and backward, with dropout 0
and 0.1; K2 at odd N, D and K, D up to 512, K over several slices of a
cluster rank and ragged last slices, N off the row tile, exact ties (also
across the slices of one cluster), repeat calls, and the shapes and launch
plans it refuses; one small-model train step against the CPU.

K1 runs with ``window`` (the diagonal blocks of each packed row only) and
without it (W = S, any bias). Tolerances: K1 1e-4 absolute (f32, other summation order and expf), with
the dropout mask equal bit for bit (the same Philox words). K2
indices equal except rows whose two best plain distances lie within
1e-5 * (1 + |d|); counts and dw equal bit for bit to ``assignment_stats`` on
the CPU for the kernel's own indices (both add each code's rows in
increasing row order), and equal on every run.
"""

import pytest
import torch

from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.export.serving import build_serving_module
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models.layers import attention_bias
from bridgerl_tpu_torch.ops import attention, codebook, kernels, vq_kernel
from bridgerl_tpu_torch.train.trainer import accumulate_grads, make_optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _k1_case(gen, BH, S, Dh, bias):
    q, k, v = (torch.randn(BH, S, Dh, device="cuda", generator=gen) for _ in range(3))
    scale = Dh ** -0.5
    before = attention.launch_counter.count
    out = attention.packed_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert attention.launch_counter.count == before + 1
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
    assert attention.launch_counter.count == 1 and attention.bwd_launch_counter.count == 1
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
    before = attention.launch_counter.count
    out = attention.packed_attention(q, q, q, torch.zeros(10, 10, device="cuda"), 0.125)
    assert out.shape == (0, 10, 64) and attention.launch_counter.count == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "strided", "bias_shape", "too_long"])
def test_k1_refuses_what_it_does_not_take(gen, bad):
    S, Dh = 10, 64
    q = torch.randn(4, S, Dh, device="cuda", generator=gen)
    bias = torch.zeros(S, S, device="cuda")
    args = {"q": q, "k": q, "v": q, "bias": bias}
    if bad == "head_dim":
        args = {n: torch.randn(4, S, 48, device="cuda") for n in "qkv"} | {"bias": bias}
    elif bad == "dtype":
        args["k"] = q.double()
    elif bad == "strided":
        args["v"] = torch.randn(4, Dh, S, device="cuda").transpose(1, 2)
    elif bad == "bias_shape":
        args["bias"] = torch.zeros(S, S + 1, device="cuda")
    elif bad == "too_long":
        S = 1024
        args = {n: torch.randn(1, S, 128, device="cuda") for n in "qkv"}
        args["bias"] = torch.zeros(S, S, device="cuda")
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
    before = attention.bwd_launch_counter.count
    got = attention.attention_bwd(q, k, v, bias, do, scale, seed, rate)
    torch.cuda.synchronize()
    assert attention.bwd_launch_counter.count == before + 1
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
    assert attention.launch_counter.count == 1 and attention.bwd_launch_counter.count == 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_k1_bwd_empty_batch_launches_nothing(gen):
    q = torch.empty(0, 10, 64, device="cuda")
    before = attention.bwd_launch_counter.count
    dq, dk, dv = attention.attention_bwd(q, q, q, torch.zeros(10, 10, device="cuda"), q,
                                         0.125, None, 0.0)
    assert dq.shape == (0, 10, 64) and attention.bwd_launch_counter.count == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "strided", "dout_shape", "seed",
                                 "no_seed", "too_long"])
def test_k1_bwd_refuses_what_it_does_not_take(gen, bad):
    S, Dh = 10, 64
    t = lambda *shape: torch.randn(*shape, device="cuda")
    args = {"q": t(4, S, Dh), "k": t(4, S, Dh), "v": t(4, S, Dh), "do": t(4, S, Dh),
            "bias": torch.zeros(S, S, device="cuda"), "seed": _seed(gen), "rate": 0.1}
    if bad == "head_dim":
        args.update({n: t(4, S, 48) for n in ("q", "k", "v", "do")})
    elif bad == "dtype":
        args["k"] = args["k"].double()
    elif bad == "strided":
        args["do"] = t(4, Dh, S).transpose(1, 2)
    elif bad == "dout_shape":
        args["do"] = t(4, S + 1, Dh)
    elif bad == "seed":
        args["seed"] = args["seed"].long()
    elif bad == "no_seed":
        args["seed"] = None
    elif bad == "too_long":
        args.update({n: t(1, 240, 128) for n in ("q", "k", "v", "do")})
        args["bias"] = torch.zeros(240, 240, device="cuda")
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
            p.pass_rows)
    assert fn(*ptrs, 64, 64, 512, *good, stream) == 0
    for bad in [(p.tile_rows, 4, 1, 1, p.smem_bytes, p.pass_rows),      # 4 of 8 slices
                (p.tile_rows, 9, 1, 1, p.smem_bytes, p.pass_rows),      # cluster > 8
                (48, p.cluster, 1, 1, p.smem_bytes, p.pass_rows),       # no such tile
                (p.tile_rows, p.cluster, 1, 0, p.smem_bytes, p.pass_rows),  # no tiles
                (p.tile_rows, p.cluster, 1, 2, p.smem_bytes, p.pass_rows),  # too little memory
                (p.tile_rows, p.cluster, 1, 1, p.smem_bytes - 4, p.pass_rows),
                (p.tile_rows, p.cluster, 1, 1, p.smem_bytes, 0)]:
        assert fn(*ptrs, 64, 64, 512, *bad, stream) != 0
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
    if bad == "D":
        x, cb = torch.randn(8, 513, device="cuda"), torch.randn(32, 513, device="cuda")
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
