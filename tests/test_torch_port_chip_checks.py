"""Rules of ``chip_smoke.py`` that decide a check on the card, run here on
synthetic inputs: the float32 serving rule on weights trained on the card
(``trained_f32_rule``: values on the windows whose codes agree, every other
window an RVQ near tie or one of the few FSQ flips allowed), the K2
profile's status (``k2_profile_status``: whole, short, or failed at once),
K2's bound (``k2_bound``: past 512 columns three tf32 products a product on
the tensor cores), the split of K2's launches between its two rows
(``row_launches``), and K1's bf16 multi-window rows: the counts a path must
show on them (``multi_want``), the row a case belongs to (``k1_case_kernel``)
and the rows a bf16 entry point splits into (``split_k1_rows``); the fused
layout's counts (``qkv_want``), its rows (``check_k1_qkv``'s names) and the
buffer each K1 case is also launched in (``_fused_qkv``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bridgerl_tpu_torch.ops.quantizers import HybridVQ

B, T, D, K, STAGES = 6, 2, 4, 8, 2


def _quantizer(seed=0):
    g = torch.Generator().manual_seed(seed)
    return HybridVQ(D, fsq_levels=(3, 3), vq_codebook_size=K, num_quantizers=STAGES, generator=g)


def _codes(q, z):
    """The quantizer's code streams on the CPU for latents z (B, T, D)."""
    with torch.no_grad():
        codes = q(z)[3]
    return {k: v.numpy().astype(np.int32) for k, v in codes.items()}


def _tie_case(q, z, b, t):
    """Make window b's token t an exact first-stage RVQ tie: another code is
    moved to the mirror image of its nearest code through its residual, so
    the two lie at one distance and the card may pick either. Returns the
    CPU's codes and the other code."""
    with torch.no_grad():
        _, z_fsq, _, _ = q.fsq(z)
        residual = (z - z_fsq)[b, t]
        cb = q.vq.layers[0].embedding.weight
        first = int(torch.argmin(((residual - cb) ** 2).sum(-1)))
        other = (first + 1) % K
        cb[other] = 2 * residual - cb[first]
    want = _codes(q, z)
    pick = int(want["rvq/vq_0"][b, t])
    assert pick in (first, other)
    return want, first if pick == other else other


def test_a_near_tie_flip_passes_and_the_shared_windows_are_compared():
    q = _quantizer()
    z = torch.randn(B, T, D, generator=torch.Generator().manual_seed(1))
    want, other = _tie_case(q, z, 2, 1)
    got = {k: v.copy() for k, v in want.items()}
    got["rvq/vq_0"][2, 1] = other     # the card's pick of the tie
    got["rvq/vq_1"][2, 1] = (got["rvq/vq_1"][2, 1] + 1) % K   # later stages follow it
    values = np.random.default_rng(0).normal(size=(B, 10, 29)).astype(np.float32)
    card = values.copy()
    card[2] += 0.5                    # the flipped window's values: not compared
    card[0] += 0.5 * chip_smoke.SERVE_ATOL
    out = chip_smoke.trained_f32_rule("tie", q, z, got, want, card, values)
    assert out["code_flips"]["rvq_near_ties"] == 1 and out["code_flips"]["rvq_not_ties"] == 0
    assert out["rows_compared"] == B - 1 and out["max_abs_err_vs_cpu"] <= chip_smoke.SERVE_ATOL
    assert out["max_abs_err_all_rows"] >= 0.5


def test_a_flip_outside_a_near_tie_fails():
    q = _quantizer()
    z = torch.randn(B, T, D, generator=torch.Generator().manual_seed(2))
    want = _codes(q, z)
    with torch.no_grad():
        _, z_fsq, _, _ = q.fsq(z)
        d = (((z - z_fsq)[3, 0] - q.vq.layers[0].embedding.weight) ** 2).sum(-1)
    far = int(torch.argmax(d))        # the farthest code: no tie
    got = {k: v.copy() for k, v in want.items()}
    got["rvq/vq_0"][3, 0] = far
    with pytest.raises(AssertionError, match="outside near ties"):
        chip_smoke.trained_f32_rule("far", q, z, got, want)


def test_a_value_error_on_a_shared_window_fails():
    q = _quantizer()
    z = torch.randn(B, T, D, generator=torch.Generator().manual_seed(3))
    want = _codes(q, z)
    values = np.zeros((B, 10, 29), np.float32)
    card = values.copy()
    card[4, 3, 7] = 2 * chip_smoke.SERVE_ATOL
    with pytest.raises(AssertionError, match="windows whose codes agree"):
        chip_smoke.trained_f32_rule("value", q, z, want, want, card, values)


def test_fsq_flips_count_against_codes_agree():
    """FSQ flips are rounding boundaries, not K2: one is allowed at this
    size (0.1% of 12 tokens, and one), two are not."""
    q = _quantizer()
    z = torch.randn(B, T, D, generator=torch.Generator().manual_seed(4))
    want = _codes(q, z)
    got = {k: v.copy() for k, v in want.items()}
    got["fsq"][0, 0] += 1
    assert chip_smoke.trained_f32_rule("fsq", q, z, got, want)["code_flips"]["fsq_flips"] == 1
    got["fsq"][1, 1] += 1
    with pytest.raises(AssertionError, match="FSQ codes differ"):
        chip_smoke.trained_f32_rule("fsq", q, z, got, want)


@pytest.mark.parametrize("names,calls,status", [
    (["vq_assign_nearest_kernel", "vq_assign_stats_kernel"] * 3, 3, "whole"),
    (["vq_assign_nearest_kernel"] * 3 + ["vq_assign_stats_kernel"] * 2, 3, "short"),
    ([], 3, "short"),
])
def test_k2_profile_status(names, calls, status):
    assert chip_smoke.k2_profile_status(names, calls) == status


@pytest.mark.parametrize("names", [
    ["vq_assign_nearest_kernel", "vq_assign_stats_kernel", "Memset (Device)"],
    ["vq_assign_nearest_kernel"] * 4 + ["vq_assign_stats_kernel"] * 3,
])
def test_k2_profile_fails_at_once_on_another_record_or_too_many(names):
    with pytest.raises(AssertionError):
        chip_smoke.k2_profile_status(names, 3)


@pytest.mark.parametrize("N,D,K,G", [(512, 64, 512, 1), (4096, 64, 1024, 1), (2048, 64, 512, 4),
                                     (512, 1024, 512, 1), (4096, 640, 512, 1),
                                     (512, 640, 512, 2)])
def test_k2_bound(N, D, K, G):
    """Bytes: x and the codebook read once, idx, counts and dw written once.
    Operations up to 512 columns at the float32 cores' 67 TFLOP/s; past it
    the products as three tf32 products at 495 TFLOP/s, the norms and dw's
    adds at 67."""
    ms, by = chip_smoke.k2_bound(N, D, K, G)
    t_bytes = 4 * G * (N * D + 2 * K * D + N + K) / 3.35e12
    if D <= 512:
        t_ops = G * (2 * N * K * D + 2 * K * D + N * D) / 67e12
    else:
        t_ops = G * (6 * N * K * D / 495e12 + (2 * K * D + N * D) / 67e12)
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations") == "operations"


def test_k2_rows_split_the_launches():
    """K2's row counts the launches up to 512 columns (its counter less the
    wide one); vq_assign_wide's row those past it."""
    launched = {"vq_assign": 10, "vq_assign_wide": 4}
    assert chip_smoke.row_launches({"name": "vq_assign"}, launched) == 6
    assert chip_smoke.row_launches({"name": "vq_assign_wide"}, launched) == 4


def test_multi_window_counts_follow_the_bf16_entry_points():
    """multi_want: a bf16 entry point's launches on neither its tensor-core
    nor its wide counter are multi-window launches; float32 has none."""
    want = {"packed_attention_fwd_bf16": 10, "packed_attention_fwd_bf16_mma": 3,
            "packed_attention_fwd_bf16_wide": 2, "packed_attention_bwd_bf16": 4,
            "packed_attention_fwd": 7}
    chip_smoke.multi_want(want)
    assert want["packed_attention_fwd_bf16_multi"] == 5
    assert want["packed_attention_bwd_bf16_multi"] == 4
    assert "packed_attention_fwd_multi" not in want
    W10 = chip_smoke.k1_want({"packed_attention_fwd_bf16": 8}, 10)
    W64 = chip_smoke.k1_want({"packed_attention_fwd_bf16": 8}, 64)
    assert W10["packed_attention_fwd_bf16_multi"] == 8
    assert W64["packed_attention_fwd_bf16_multi"] == 0


@pytest.mark.parametrize("name", ["packed_attention_fwd_bf16", "packed_attention_bwd_bf16"])
def test_bf16_short_window_cases_go_to_the_multi_window_rows(name):
    """A bf16 case below W 32 (Dh <= 128) belongs to ``<entry>_multi``, with the
    multi-window source; the float32 one to the entry's window-tile row; the
    bf16 entry keeps no window-tile row, and its launches all land on the
    other rows."""
    case = {"shape": [256, 80, 64], "window": 10, "ms": 0.01}
    assert chip_smoke.k1_case_kernel(name, case) == name + "_multi"
    f32 = name.replace("_bf16", "")
    assert chip_smoke.k1_case_kernel(f32, case) == f32
    long = {"shape": [64, 64, 64], "window": 64, "ms": 0.01}
    assert chip_smoke.k1_case_kernel(name, long) == name + "_mma"
    wide = {"shape": [64, 80, 256], "window": 10, "ms": 0.01}
    assert chip_smoke.k1_case_kernel(name, wide) == name + "_wide"
    cases = [case, long, wide]
    if "bwd" in name:   # a two-kernel backward
        cases.append({"shape": [24, 160, 128], "window": 160, "ms": 0.01})
    row = chip_smoke._kernel_row(name, "bridgerl_tpu_torch/csrc/k1_fwd.cuh", "here", cases)
    rows = {r["name"]: r for r in chip_smoke.split_k1_rows([row])}
    assert name not in rows and rows[name + "_multi"]["source"] == chip_smoke.MULTI_SOURCE
    launched = {name: 9, name + "_mma": 2, name + "_wide": 0, name + "_multi": 7}
    assert chip_smoke.row_launches({"name": name}, launched) == 0
    assert chip_smoke.row_launches(rows[name + "_multi"], launched) == 7


@pytest.mark.parametrize("f32,bf16", [(7, 0), (0, 5), (3, 4)])
def test_qkv_want_follows_the_entry_points(f32, bf16):
    """Every model launch of K1 is a fused one: each entry point's fused
    counter wants its launches; multi_want fills them too."""
    want = chip_smoke.multi_want({"packed_attention_fwd": f32, "packed_attention_bwd": f32,
                                  "packed_attention_fwd_bf16": bf16,
                                  "packed_attention_bwd_bf16": 0})
    assert want["packed_attention_fwd_qkv"] == want["packed_attention_bwd_qkv"] == f32
    assert want["packed_attention_fwd_bf16_qkv"] == bf16
    assert want["packed_attention_bwd_bf16_qkv"] == 0
    assert chip_smoke.qkv_want({})["packed_attention_fwd_qkv"] == 0


def test_fused_rows_count_their_own_launches():
    """A fused row (check_k1_qkv's, named by QKV_COUNTER) counts the launches
    on its own counter, and the split keeps it whole."""
    from bridgerl_tpu_torch.ops import attention

    names = [c.name for c in attention.QKV_COUNTER.values()]
    assert names == [attention.ENTRY[k] + "_qkv" for k in attention.QKV_COUNTER]
    launched = {"packed_attention_fwd_qkv": 9, "packed_attention_fwd": 11}
    assert chip_smoke.row_launches({"name": "packed_attention_fwd_qkv"}, launched) == 9
    row = {"name": "packed_attention_fwd_qkv", "cases": [], "ms": 1.0}
    assert chip_smoke.split_k1_rows([row]) == [row]


def test_fused_buffer_holds_the_folded_rows():
    """_fused_qkv lays q, k and v side by side as the projection does: its
    split gives them back."""
    from bridgerl_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(8, 10, 16, generator=g) for _ in range(3))
    qkv = chip_smoke._fused_qkv(q, k, v)
    assert qkv.shape == (2, 10, 3 * 64)
    assert all(torch.equal(a, b) for a, b in zip(attention.split_qkv(qkv, 4), (q, k, v)))


def test_fused_rows_time_the_blocks_that_cross_rows():
    """check_k1_qkv's main case is the training microbatch, whose blocks lie in
    one row; its other cases (the artifact's S = W = 10, the slot-AR depth
    stack) have blocks that cross from one row to the next in both dtypes
    and directions (csrc/k1_tiles.cuh's spans_rows: H > 1 and a block's
    positions not dividing S), so the kernels' SPAN form is timed too."""
    from bridgerl_tpu_torch.ops import attention

    (B, H, S, Dh, P, rate, causal), *rest = chip_smoke.K1_QKV_SHAPES
    assert (B * H, S, Dh, P, rate, causal) == (256, 80, 64, 8, chip_smoke.DROPOUT, False)
    for dtype in attention.DTYPES:
        for direction in ("fwd", "bwd"):
            for B, H, S, Dh, P, rate, causal in rest:
                plan = attention.k1_plan(B * H, S, S // P, Dh, dtype, direction, causal)
                assert H > 1 and S % (plan.W * plan.windows_per_block) != 0
