"""K1's launch plan (``ops/attention.py::k1_plan``), on the CPU.

The kernels of ``csrc/packed_attention*.cu`` run only on the card, but the
plan that picks their path and sizes their launches is Python, and the C
launchers refuse any plan but their own, so what it promises is checked
here: windows shorter than ``MIN_MMA_WINDOW`` take the window tiles, longer
ones the tensor-core path; every (query, key) pair inside a window, or on
and below the diagonal under ``causal``, is computed exactly once by the
forward, by the dq kernel and by the dk / dv kernel, down to the warps of
the two-kernel backward's blocks; a tile that is skipped lies wholly above
the diagonal; no block asks for more than 232,448 bytes of shared memory;
and every shape the launchers took before the tensor-core path (the window
tiles, or the row kernels it replaced) is still taken. Every head dim from 1
to 512 is planned at the width ``head_width`` gives, past 128 on the wide
kernels, whose blocks (several whole windows at W <= 32) own every output
column once and compute every pair once. The block-to-work mapping below is
the kernels' own index arithmetic.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bridgerl_tpu_torch.ops import attention, kernels
from bridgerl_tpu_torch.ops.attention import (MIN_MMA_WINDOW, MMA_COLS, MMA_ROWS, SMEM_LIMIT,
                                              k1_plan)

BF16 = torch.bfloat16
ROW_WARPS = 8   # the row kernels' warps a block, for the rule they took shapes by


def taken_before(W, Dh, direction):
    """Whether the launchers took (W, Dh) before the tensor-core path: the
    window tiles or, failing them, the row kernels fit one block's shared
    memory."""
    if direction == "fwd":
        tile = 3 * W * (Dh + 4) + 2 * W * (W + 1) + W
        rows = W * (2 * Dh + 1) + ROW_WARPS * W
    else:
        tile = 4 * W * (Dh + 4) + 3 * W * (W + 1)
        rows = 2 * W * (Dh + 1) + 2 * ROW_WARPS * W + 3 * W
    return 4 * min(tile, rows) <= SMEM_LIMIT


# (B*H, S, W, Dh) of chip_smoke.py (K1_SHAPES, K1_BWD_SHAPES, K1_GROUPED, K1_CAUSAL,
# the causal mask at S 128 and Dh 128) and of the card tests beyond them: ragged windows
# (W 40, 96), S = W = 160 and 200 at Dh 128 (the row kernels' shapes), general biases
CARD_SHAPES = [(2048, 80, 10, 64), (256, 10, 10, 64), (256, 80, 10, 64), (1024, 64, 64, 64),
               (16384, 10, 10, 64), (256, 64, 64, 64), (196, 64, 64, 64), (128, 80, 10, 64),
               (176, 10, 10, 64), (8192, 128, 64, 64), (1024, 128, 64, 64),
               (4096, 80, 10, 64), (128, 128, 128, 64), (16384, 5, 5, 64), (16, 32, 32, 64),
               (128, 96, 96, 64), (128, 128, 128, 128), (48, 160, 160, 128),
               (12, 200, 200, 128), (12, 120, 120, 128), (40, 160, 40, 64), (40, 96, 96, 32),
               (3, 128, 128, 16), (300, 33, 33, 16), (1024, 1024, 1024, 16),
               (1, 240, 240, 128), (7, 10, 10, 128), (24, 160, 160, 128), (48, 200, 200, 64),
               (32, 160, 160, 64),
               # the prior at 256 positions and at d_model 128 (Dh 32); K1_CAUSAL's new cases
               (128, 256, 256, 64), (128, 128, 128, 32)]
# the two-kernel backward's shapes in chip_smoke.py (B*H, S = W, Dh, causal)
LONG_SHAPES = [(24, 160, 128, False), (48, 200, 64, False), (32, 160, 64, True),
               (128, 256, 64, True)]
WARPS = 4   # a tensor-core block's warps (csrc/k1_mma.cuh kMmaWarps)


def _check_mma_coverage(plan, causal):
    """Each kernel's pairs, from its blocks and the tiles they read."""
    W, R, C = plan.W, plan.rows, plan.cols
    lower = np.tril(np.ones((W, W), bool)) if causal else np.ones((W, W), bool)
    assert plan.windows_per_block == 1 and plan.blocks == plan.windows * plan.row_tiles
    # forward and dq kernel: block (window, query tile qt) x key tiles
    seen = np.zeros((W, W), np.int64)
    for qt in range(plan.row_tiles):
        rows = slice(qt * R, min((qt + 1) * R, W))
        tiles = plan.key_tiles(qt)
        for kt in range(-(-W // C)):
            if kt in tiles:
                seen[rows, kt * C:min((kt + 1) * C, W)] += 1
            else:   # skipped: its first key lies past the block's last query
                assert causal and kt * C > min((qt + 1) * R, W) - 1
    assert (seen[lower] == 1).all() and seen.max() <= 1
    if plan.direction == "fwd" or plan.blocks_kv == 0:   # the window-resident backward
        return
    _check_warps(plan, causal, lower)
    # dk / dv kernel: block (window, key tile kt) x query tiles
    assert plan.blocks_kv == plan.windows * plan.row_tiles
    seen[:] = 0
    for kt in range(plan.row_tiles):
        keys = slice(kt * R, min((kt + 1) * R, W))
        tiles = plan.query_tiles(kt)
        for qi in range(-(-W // C)):
            if qi in tiles:
                seen[qi * C:min((qi + 1) * C, W), keys] += 1
            else:   # skipped: its last query lies before the block's first key
                assert causal and min((qi + 1) * C, W) - 1 < kt * R
    assert (seen[lower] == 1).all() and seen.max() <= 1


def _check_warps(plan, causal, lower):
    """The two-kernel backward's warps (csrc/k1_bwd.cuh): a block of R rows
    has R / 16 groups of 16 rows, and each 32-wide streamed tile is split in
    KP = 4 / (R / 16) parts, one a warp. In the dq kernel a warp computes its
    rows against its part of each key tile, and skips under causal the 8-key
    column tiles past its last row; then it adds ds k for its rows and a
    1 / KP share of dq's columns. In the dk / dv kernel a warp takes its 16
    keys against its part of each query tile, and the parts' sums are added
    in part order. Every pair on and below the diagonal is computed once."""
    W, R, C = plan.W, plan.rows, plan.cols
    RG, KP = R // 16, WARPS // (R // 16)
    NTW = C // 8 // KP
    assert RG * KP == WARPS and NTW in (2, 4) and R in (32, 64)
    dq, dkv = np.zeros((W, W), np.int64), np.zeros((W, W), np.int64)
    for t in range(plan.row_tiles):
        for w in range(WARPS):
            rg, part = w % RG, w // RG
            first = t * R + rg * 16
            rows = slice(first, min(first + 16, W))
            for kt in plan.key_tiles(t):
                for c in range(NTW):
                    j = kt * C + part * NTW * 8 + c * 8
                    if causal and j > first + 15:   # c_end: wholly above the warp's rows
                        continue
                    dq[rows, j:min(j + 8, W)] += 1
            keys = slice(first, min(first + 16, W))
            for qi in plan.query_tiles(t):
                i = qi * C + part * NTW * 8
                dkv[i:min(i + 8 * NTW, W), keys] += 1
    for seen in (dq, dkv):
        assert (seen[lower] == 1).all() and seen.max() <= 1
    # dq's output column tiles, a 1 / KP share a warp of a row group
    for Dh in attention.SUPPORTED_HEAD_DIMS:
        NO = Dh // 8
        assert NO % KP == 0
        assert sorted(n for part in range(KP) for n in range(part * NO // KP,
                                                              (part + 1) * NO // KP)) == list(range(NO))


def _check_multi(plan, Dh):
    """The bf16 multi-window plan (csrc/k1_multi.cuh): blocks of G whole
    windows (``multi_windows``; the last the windows left), each window in
    one block; 4 strips a block, each of whole windows (up to W 16) or of
    one 16-row part of a window, against ``cols`` keys in 16-key chunks, a
    window's keys from the start of its own chunk; each (query, key) pair
    of a window (on and below the diagonal under causal) computed once by
    the query strips and once by the key strips over the same chunks, every
    row read within the staged rows, and key j of a window at the same place
    in its chunks wherever the window lies in its block; the shared memory
    within the budget."""
    W, R = plan.W, attention.MULTI_ROWS
    G = min(attention.multi_windows(W), max(plan.windows, 1))
    assert plan.path == "multi" and plan.windows_per_block == G and plan.rows == G * W <= R
    assert plan.blocks == -(-plan.windows // G) and plan.blocks_kv == plan.smem_kv == 0
    assert attention.backward_scratch(plan) == 0
    row = attention.mma_row_bytes(attention.head_width(Dh), BF16)
    staged = attention.MULTI_STAGED
    tile = (8 if W <= 8 else 16 * -(-W // 16)) + 4   # a window's chunks and 4
    smem = 3 * staged * row if plan.direction == "fwd" else 4 * staged * row + R * tile * 4
    assert plan.smem_bytes == smem + R * W * 4 <= SMEM_LIMIT   # and the (R, W) bias tile
    KT = plan.cols // 8
    C = attention.multi_chunk(W)
    assert KT in (2, 3, 4) and KT == attention.multi_key_tiles(W) and plan.cols % C == 0
    lower = np.tril(np.ones((W, W), bool)) if plan.causal else np.ones((W, W), bool)
    covered = np.zeros(plan.windows, np.int64)
    for b in range(plan.blocks):
        covered[b * G:(b + 1) * G] += 1
    assert (covered == 1).all()
    # a full block and the last one (the others are the first's)
    for g in {G, plan.windows - (plan.blocks - 1) * G}:
        rows = g * W
        pairs = np.zeros((rows, rows), np.int64)
        for lw in range(g):
            win = slice(lw * W, (lw + 1) * W)
            pairs[win, win] = lower
        by_rows, by_keys = np.zeros_like(pairs), np.zeros_like(pairs)
        seen = np.zeros(rows, np.int64)
        for strip in range(4):
            own = plan.strip_rows(strip, g)
            chunks = plan.strip_chunks(strip)
            assert len(chunks) == plan.cols // C and len(own) <= 16 and (
                not own or own.stop <= rows)
            seen[own.start:own.stop] += 1
            # the rows a block stages, as if it were full: every chunk's and strip's rows
            # within them (a strip past the last block's windows computes, never stores)
            need = (attention.multi_windows(W) - 1) * W + 16 * -(-W // 16)
            assert need <= staged and all(0 <= c and c + C <= need for c in chunks)
            if not own:
                continue
            assert own.start % W == 0 or W > 16   # strips start on windows
            assert own.start + 16 <= need
            # the strip's key at place p is row chunks[p // C] + p % C; a window's keys
            # start its chunk: place p holds key j = p % C of the window at chunks[p // C]
            # up to W 16, key j = p of the window at chunks[0] past it
            for p in range(plan.cols):
                start, j = (chunks[p // C], p % C) if W <= 16 else (chunks[0], p)
                assert chunks[p // C] + p % C == start + j and start % W == 0
                if j >= W or start >= rows:
                    continue
                k = start + j   # key k at its own place: the strip's rows of its window
                for r in own:
                    if r // W == start // W:
                        by_rows[r, k] += pairs[r, k]
                        by_keys[k, r] += pairs[k, r]   # the key strip: the same places
        assert (seen == 1).all() and (by_rows == pairs).all() and (by_keys == pairs).all()


def _check_plan(BH, S, W, Dh, dtype, direction, causal):
    plan = k1_plan(BH, S, W, Dh, dtype, direction, causal)
    assert plan.W == W and plan.direction == direction and plan.windows == BH * (S // W)
    assert 0 < plan.smem_bytes <= SMEM_LIMIT and plan.smem_kv <= SMEM_LIMIT
    if W < MIN_MMA_WINDOW and dtype == BF16:
        _check_multi(plan, Dh)
        return plan
    if W < MIN_MMA_WINDOW:
        G = plan.windows_per_block
        assert plan.path == "tiles" and plan.rows == G * W and plan.blocks_kv == 0
        assert G == min(max(1, attention.TILE_ROWS // W), max(plan.windows, 1))
        assert plan.smem_bytes == G * attention.tile_bytes_per_window(W, Dh, direction)
        covered = np.zeros(plan.windows, np.int64)   # block b takes windows b G .. b G + G - 1
        for b in range(plan.blocks):
            covered[b * G:(b + 1) * G] += 1
        assert (covered == 1).all()
        return plan
    row = Dh * (4 if dtype == torch.float32 else 2) + 16
    # the window-resident block's rows: up to W 64 at every Dh, up to 128 at Dh <= 64
    R = MMA_ROWS if W <= MMA_ROWS else 2 * MMA_ROWS if Dh <= 64 and W <= 2 * MMA_ROWS else 0
    if direction == "bwd" and R:
        # one block a window, everything staged: q, k, v, dout, one float32 (R, R + 4) tile
        assert plan.path == "mma" and (plan.rows, plan.cols) == (R, R)
        assert plan.blocks == plan.windows and plan.blocks_kv == plan.smem_kv == 0
        assert plan.smem_bytes == 4 * R * row + R * (R + 4) * 4
    elif direction == "fwd":   # the block's q rows, two stages of (k, v) tiles
        assert plan.path == "mma" and (plan.rows, plan.cols) == (MMA_ROWS, MMA_COLS)
        assert plan.smem_bytes == (MMA_ROWS + 2 * 2 * MMA_COLS) * row
    else:
        # two kernels, blocks of RB rows (keys in dk / dv): q and dout rows (k and v), two
        # stages of two 32-row tiles; the dq kernel two float32 (RB, keys + 4) buffers,
        # the dk / dv kernel two stages of the rows' 3 statistics
        RB = plan.rows
        stride = -(-W // MMA_COLS) * MMA_COLS + 4
        # two float32 buffers and the keep flags, a 32-bit word a row and key tile
        buffered = lambda rb: ((2 * rb + 2 * 2 * MMA_COLS) * row + 8 * rb * stride  # noqa: E731
                               + 4 * rb * -(-W // MMA_COLS))
        assert plan.path == "mma" and plan.cols == MMA_COLS and RB in (32, 64)
        assert plan.blocks_kv == plan.blocks == plan.windows * plan.row_tiles
        full = plan.windows * -(-W // MMA_ROWS) >= attention.FULL_GRID
        if full or buffered(32) > SMEM_LIMIT:
            # a full card, or no row buffer fits: the two-sweep dq kernel and the dk / dv
            # kernel, 64-row blocks, through the rows' 3 statistics
            assert RB == MMA_ROWS and plan.smem_bytes == (2 * RB + 2 * 2 * MMA_COLS) * row
            assert plan.smem_kv == (2 * RB + 2 * 2 * MMA_COLS) * row + 2 * 3 * MMA_COLS * 4
            assert attention.backward_scratch(plan) == 3 * plan.windows * W + 4
        else:
            # the row-buffered dq kernel and the keys kernel in 32-row blocks, through
            # the p_drop and ds planes (two stages of (q, dout) and of the planes' tiles)
            assert RB == 32 and plan.smem_bytes == buffered(RB)
            assert plan.smem_kv == 2 * 2 * MMA_COLS * row + 2 * 2 * MMA_COLS * (RB + 4) * 4
            assert attention.backward_scratch(plan) == (2 * plan.windows * W
                                                        * -(-W // MMA_COLS) * MMA_COLS)
    _check_mma_coverage(plan, causal)
    return plan


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("BH,S,W,Dh", CARD_SHAPES)
def test_plan_covers_every_pair_once_at_the_card_shapes(BH, S, W, Dh, direction, causal):
    for dtype in attention.DTYPES:
        _check_plan(BH, S, W, Dh, dtype, direction, causal)


@settings(max_examples=150, deadline=None)
@given(W=st.integers(1, 300), P=st.integers(1, 4), Dh=st.sampled_from(attention.SUPPORTED_HEAD_DIMS),
       bf16=st.booleans(), bwd=st.booleans(), causal=st.booleans())
def test_plan_sweep(W, P, Dh, bf16, bwd, causal):
    _check_plan(3, P * W, W, Dh, BF16 if bf16 else torch.float32, "bwd" if bwd else "fwd",
                causal)


@settings(max_examples=150, deadline=None)
@given(W=st.integers(33, 256), BH=st.integers(1, 600), Dh=st.sampled_from(attention.SUPPORTED_HEAD_DIMS),
       bf16=st.booleans(), causal=st.booleans())
def test_backward_sweep_past_the_window_tiles(W, BH, Dh, bf16, causal):
    """The backward from W 33 to 256 at every head dim, over grids small and
    large enough for both block heights: window-resident or two kernels,
    every pair once, down to the warps, within the shared memory."""
    plan = _check_plan(BH, W, W, Dh, BF16 if bf16 else torch.float32, "bwd", causal)
    assert max(plan.smem_bytes, plan.smem_kv) <= SMEM_LIMIT


@pytest.mark.parametrize("BH,S,Dh,causal", LONG_SHAPES)
def test_chip_shapes_past_the_window_resident_kernel_take_the_row_kernels(BH, S, Dh, causal):
    """chip_smoke.py's two-kernel cases take the row-buffered dq kernel in
    32-row blocks in both dtypes, but the prior at 256 positions, whose 512
    blocks of 64 rows fill the card: the two-sweep dq kernel; the prior at
    d_model 128 (Dh 32, 128 positions) one window-resident kernel."""
    for dtype in attention.DTYPES:
        plan = _check_plan(BH, S, S, Dh, dtype, "bwd", causal)
        sweeps = (2 * 64 + 4 * MMA_COLS) * attention.mma_row_bytes(Dh, dtype)
        assert plan.blocks_kv and plan.rows == (64 if BH == 128 else 32)
        assert (plan.smem_bytes == sweeps) == (BH == 128)
        resident = _check_plan(128, 128, 128, 32, dtype, "bwd", True)
        assert (resident.rows, resident.blocks, resident.blocks_kv) == (128, 128, 0)


@settings(max_examples=150, deadline=None)
@given(W=st.integers(1, 2000), Dh=st.sampled_from(attention.SUPPORTED_HEAD_DIMS), bwd=st.booleans())
def test_every_shape_taken_before_is_still_taken(W, Dh, bwd):
    """The row kernels took windows up to the shared memory of one block
    (W 219 at Dh 128 forward, 1417 at Dh 16); the tensor-core path takes
    them all, within the budget."""
    direction = "bwd" if bwd else "fwd"
    plan = k1_plan(2, W, W, Dh, torch.float32, direction)
    assert max(plan.smem_bytes, plan.smem_kv) <= SMEM_LIMIT
    if taken_before(W, Dh, direction):
        assert plan.path == ("tiles" if W < MIN_MMA_WINDOW else "mma")


def test_the_row_kernels_shapes_take_the_tensor_core_path():
    """S = W = 160 and 200 at Dh 128 went to the row kernels; they, and the
    prior's causal rows, take the tensor-core path now."""
    for S in (120, 160, 200):
        assert taken_before(S, 128, "fwd") and not (
            4 * (4 * S * 132 + 3 * S * (S + 1)) <= SMEM_LIMIT)   # no window tile fit
        for direction in ("fwd", "bwd"):
            assert k1_plan(12, S, S, 128, BF16, direction).path == "mma"
    assert k1_plan(128, 128, 128, 64, torch.float32, "bwd", causal=True).path == "mma"
    assert k1_plan(16384, 5, 5, 64, torch.float32, "bwd", causal=True).path == "tiles"


def test_causal_skips_the_tiles_above_the_diagonal():
    """At S = W = 128 on the two-kernel backward (float32, Dh 128, 128
    windows: 32-row blocks): query tile t reads key tiles 0 .. t of 4; key
    tile 1 of the dk / dv kernel reads query tiles 1 to 3. At 512 windows
    (64-row blocks) query tile 0 reads key tiles 0 and 1, tile 1 all four,
    and key tile 1 query tiles 2 and 3. Up to W 128 at Dh <= 64 (the prior's
    rows) the backward's one block holds the whole window."""
    plan = k1_plan(128, 128, 128, 128, torch.float32, "bwd", causal=True)
    assert plan.rows == 32
    assert [list(plan.key_tiles(qt)) for qt in range(4)] == [[0], [0, 1], [0, 1, 2],
                                                             [0, 1, 2, 3]]
    assert [list(plan.query_tiles(kt)) for kt in range(2)] == [[0, 1, 2, 3], [1, 2, 3]]
    full = plan._replace(causal=False)
    assert list(full.key_tiles(0)) == [0, 1, 2, 3] and list(full.query_tiles(1)) == [0, 1, 2, 3]
    wide = k1_plan(512, 128, 128, 128, torch.float32, "bwd", causal=True)
    assert wide.rows == 64
    assert [list(wide.key_tiles(qt)) for qt in range(2)] == [[0, 1], [0, 1, 2, 3]]
    assert [list(wide.query_tiles(kt)) for kt in range(2)] == [[0, 1, 2, 3], [2, 3]]
    small = k1_plan(16, 32, 32, 64, torch.float32, "bwd", causal=True)
    assert small.blocks == 16 and small.blocks_kv == 0 and list(small.key_tiles(0)) == [0]
    resident = k1_plan(128, 128, 128, 64, torch.float32, "bwd", causal=True)
    assert (resident.rows, resident.blocks, resident.blocks_kv) == (128, 128, 0)


@pytest.mark.parametrize("bad", [dict(Dh=0), dict(W=7), dict(S=65536, W=65536),
                                 dict(dtype=torch.float16), dict(direction="up")])
def test_plan_refuses_what_the_kernels_do_not_take(bad):
    args = dict(BH=4, S=64, W=64, Dh=64, dtype=torch.float32, direction="fwd") | bad
    with pytest.raises(ValueError):
        k1_plan(**args)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_mma_plan_is_the_plan_from_the_crossover_on(direction):
    """k1_plan hands every window of MIN_MMA_WINDOW and more to mma_plan;
    below it mma_plan still plans the tensor-core path (the crossover tool's
    build), which k1_plan does not take."""
    for W in (10, 16, 31, 32, 40, 64, 96, 160):
        for Dh in (16, 64, 128):
            mma = attention.mma_plan(4, 2 * W, W, Dh, BF16, direction, True)
            assert mma.path == "mma"
            plan = k1_plan(4, 2 * W, W, Dh, BF16, direction, True)
            assert (plan == mma) == (W >= MIN_MMA_WINDOW)
    with pytest.raises(ValueError):
        attention.mma_plan(4, 64, 64, 0)


def test_phase_tool_finds_what_it_rewrites_in_the_sources():
    """tools/k1_phases.py instruments copies of the window-tile kernels and,
    for its crossover, rewrites kMinWindow: each must still be where it
    looks, with W* equal to MIN_MMA_WINDOW."""
    from bridgerl_tpu_torch.ops import kernels
    from bridgerl_tpu_torch.tools import k1_phases

    for src, kernel, _ in k1_phases.KERNELS:
        text = k1_phases.instrument((kernels.CSRC / src).read_text(), kernel)
        assert all(f"K1_MARK({p});" in text for p in range(5))
        assert 'extern "C" int k1_phases(' in text
    mma = (kernels.CSRC / "k1_mma.cuh").read_text()
    assert mma.count(k1_phases.MIN_WINDOW.format(MIN_MMA_WINDOW)) == 1


HEAD_DIM_WINDOWS = (5, 10, 32, 64, 96, 128, 160, 256)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("W", HEAD_DIM_WINDOWS)
def test_every_head_dim_is_planned_within_the_budget(W, direction):
    """k1_plan and mma_plan take every Dh from 1 to 512, in both dtypes,
    causal or not, as it is: up to 128 the plan of the instantiated width the
    rule gives (the next of SUPPORTED_HEAD_DIMS), its rows staged in copies
    of the plan's size, past it the wide kernels' plan at Dh itself; every
    launch within the shared memory of one block."""
    BH, S = 3, 2 * W
    for Dh in range(1, 513):
        width = attention.head_width(Dh)
        assert width >= Dh and (width in attention.SUPPORTED_HEAD_DIMS if Dh <= 128
                                else width == Dh)
        if Dh <= 128:
            assert width == min(d for d in attention.SUPPORTED_HEAD_DIMS if d >= Dh)
        for dtype in attention.DTYPES:
            for causal in (False, True):
                plan = k1_plan(BH, S, W, Dh, dtype, direction, causal)
                mma = attention.mma_plan(BH, S, W, Dh, dtype, direction, causal)
                assert max(plan.smem_bytes, plan.smem_kv, mma.smem_bytes, mma.smem_kv) \
                    <= SMEM_LIMIT
                assert (plan.Dh, plan.width) == (Dh, width)
                assert plan.copy_bytes == attention.copy_bytes(Dh, dtype)
                if Dh <= 128:
                    assert plan.groups == mma.groups == 1
                    native = k1_plan(BH, S, W, width, dtype, direction, causal)
                    assert plan._replace(Dh=width, copy_bytes=16) == native
                    assert plan.ragged == (Dh != width) and not native.ragged
                else:
                    assert plan == mma and plan.path == "wide"
                    assert plan.groups == attention.wide_groups(width, plan.blocks // plan.groups)
                    assert plan.ragged == (plan.copy_bytes < 16)


WIDE_WARPS = 8    # csrc/k1_wide.cuh kWarps: four row groups of 16 by two column halves


def _reach(r0, n, Wb, W, causal, keys):
    """k1_wide.cuh's reach: the partners (a query's keys; a key's queries)
    that rows r0 .. r0 + n - 1 of a super-window of Wb rows reach."""
    if r0 >= Wb:
        return 0, 0
    rl = min(r0 + n - 1, Wb - 1)
    lo = r0 if keys and causal else r0 // W * W
    hi = rl + 1 if not keys and causal else min((rl // W + 1) * W, Wb)
    return lo, hi


def _tiles_in(lo, hi, p0, n):
    """k1_wide.cuh's tiles_in: the 8-wide tiles of the n from p0 that [lo, hi) reaches."""
    if hi <= p0 or lo >= p0 + 8 * n:
        return 0, 0
    return max(0, lo - p0) // 8, min(n, (hi - p0 + 7) // 8)


def _check_wide(plan, Dh):
    """The wide kernels' blocks: block b is ((super-window, row tile), column
    group) = ((b // groups // tiles, b // groups % tiles), b % groups) (under
    causal with several tiles a window, on grids past one block an SM,
    tile-major, the tiles with the most work first: the last row tiles, the
    dk / dv kernel's first), a
    super-window G = 64 // W whole windows at W <= 32 (else one window, in
    row tiles of 64); warp (rg, ch) owns rows 16 rg .. 16 rg + 15 of the tile
    and the half ch of the group's columns. Each (window, row, output column)
    is owned once, by the dq kernel and by the dk / dv kernel (keys) as by the
    forward, and by the one-kernel backward at W <= 64 (as queries and as
    keys); each group's warps compute every (query, key) pair of the window
    (on and below the diagonal under causal) once: warp (rg, ch) takes the
    8-wide tiles its rows reach of the half ch of each streamed tile, and its
    products read the tiles that hold every partner its rows have (the
    one-kernel backward's dk and dv every query its keys have)."""
    W, G, groups, R, C = plan.W, plan.windows_per_block, plan.groups, MMA_ROWS, MMA_COLS
    Dp = -(-Dh // 16) * 16
    CW = attention._group_cols(Dp, groups)
    HW = CW // 2
    one = plan.direction == "bwd" and W <= attention.WIDE_WINDOW   # the one-kernel backward
    assert plan.path == "wide" and (plan.rows, plan.cols) == (R, R if one else C)
    assert G == (R // W if W <= attention.MULTI_WINDOW else 1)
    tiles = 1 if G > 1 else -(-W // R)
    assert plan.blocks == -(-plan.windows // G) * tiles * groups
    assert groups * CW >= Dh and CW % 16 == 0 and (CW <= attention.GROUP_COLS)
    lower = np.tril(np.ones((W, W), bool)) if plan.causal else np.ones((W, W), bool)
    owned = np.zeros((plan.windows, W, Dh), np.int64)
    pairs = np.zeros((groups, plan.windows, W, W), np.int64)   # (query, key) a group
    kernels = ["fwd"] if plan.direction == "fwd" else ["win"] if one else ["dq", "dkv"]
    assert plan.blocks_kv == (0 if plan.direction == "fwd" or one else plan.blocks)
    assert tiles == 1 or not one
    for kernel in kernels:
        keys = kernel == "dkv"
        owned[:] = 0
        pairs[:] = 0
        for b in range(plan.blocks):
            cg, rest = b % groups, b // groups
            if plan.causal and tiles > 1 and plan.blocks > attention.SPLIT_BELOW:
                # tile-major, the tiles with the most work first
                nsw = -(-plan.windows // G)
                tq = rest // nsw
                n0, i0 = rest % nsw * G, (tq if keys else tiles - 1 - tq) * R
            else:
                n0, i0 = rest // tiles * G, rest % tiles * R
            Wb = min(G, plan.windows - n0) * W
            blo, bhi = _reach(i0, R, Wb, W, plan.causal, keys)
            streamed = range(blo // C if keys else 0, -(-bhi // C))
            for w in range(WIDE_WARPS):
                rg, ch = w % 4, w // 4
                r = np.arange(i0 + 16 * rg, i0 + 16 * rg + 16)
                r = r[r < Wb]
                oc0 = cg * CW + ch * HW
                cols = slice(oc0, min(oc0 + 8 * (max(0, min(HW, Dp - oc0)) // 8), Dh))
                owned[n0 + r // W, r % W, cols] += 1
                wlo, whi = _reach(i0 + 16 * rg, 16, Wb, W, plan.causal, keys)
                if kernel == "win":   # dk, dv: the queries its keys have, in two halves
                    klo, khi = _reach(16 * rg, 16, Wb, W, plan.causal, True)
                    need = np.zeros(R, bool)
                    for hb in range(2):
                        pb, pe = _tiles_in(klo, khi, hb * C, 4)
                        need[hb * C + 8 * pb:hb * C + 8 * pe] = True
                    for key in r:
                        i = np.arange(Wb)
                        ok = (i // W == key // W) & (i >= key if plan.causal else True)
                        assert need[i[ok]].all()
                for t in streamed:
                    xb, xe = _tiles_in(wlo, whi, t * C + 16 * ch, 2)
                    pb, pe = _tiles_in(wlo, whi, t * C, 4)
                    p = np.arange(t * C + 16 * ch + 8 * xb, t * C + 16 * ch + 8 * xe)
                    rr, pp = np.meshgrid(r, p, indexing="ij")
                    q_, k_ = (pp, rr) if keys else (rr, pp)
                    ok = (pp < Wb) & (rr // W == pp // W)
                    if plan.causal:
                        ok &= k_ <= q_
                    assert ((pp[ok] >= t * C + 8 * pb) & (pp[ok] < t * C + 8 * pe)).all()
                    np.add.at(pairs, (cg, n0 + rr[ok] // W, q_[ok] % W, k_[ok] % W), 1)
        assert (owned == 1).all(), kernel
        assert (pairs[:, :, lower] == 1).all() and pairs.max() <= 1, kernel


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("BH,S,W,Dh", [(4, 10, 10, 160), (4, 20, 10, 256), (8, 64, 64, 160),
                                       (3, 96, 96, 512), (2, 256, 256, 256),
                                       (24, 160, 160, 200), (1, 40, 40, 1000),
                                       (40, 256, 256, 160)])
def test_wide_plans_own_every_output_column_once(BH, S, W, Dh, causal):
    """Each (window, row, output column) owned once and each pair computed
    once a column group (:func:`_check_wide`), both directions; each
    kernel's shared memory its layout's, within the budget, in both dtypes;
    the backward one kernel up to W 64, else two with the rows' statistics
    between them."""
    for direction in ("fwd", "bwd"):
        plans = [k1_plan(BH, S, W, Dh, dtype, direction, causal) for dtype in attention.DTYPES]
        for dtype, plan in zip(attention.DTYPES, plans):
            assert plan._replace(smem_bytes=0, smem_kv=0) == plans[0]._replace(smem_bytes=0,
                                                                               smem_kv=0)
            if direction == "bwd" and W <= attention.WIDE_WINDOW:
                assert plan.smem_bytes == attention.wide_window_layout(
                    Dh, dtype, plan.groups).smem <= SMEM_LIMIT
                assert plan.smem_kv == plan.blocks_kv == attention.backward_scratch(plan) == 0
                continue
            first = attention.wide_layout(Dh, dtype, "fwd" if direction == "fwd" else "dq",
                                          plan.groups)
            assert plan.smem_bytes == first.smem <= SMEM_LIMIT
            if direction == "bwd":
                assert plan.smem_kv == attention.wide_layout(Dh, dtype, "dkv",
                                                             plan.groups).smem <= SMEM_LIMIT
                assert attention.backward_scratch(plan) == 3 * plan.windows * W + 4
        _check_wide(plans[0], Dh)


@pytest.mark.parametrize("W", [1, 5, 10, 16, 21, 32])
def test_wide_blocks_hold_whole_windows_at_short_w(W):
    """At W <= 32 a wide block holds 64 // W whole windows (6 at W 10, 12 at
    W 5), the last block the windows left; every pair and column once."""
    for BH, causal in ((7, False), (5, True)):
        plan = k1_plan(BH, 4 * W, W, 256, BF16, "bwd", causal)
        assert plan.windows_per_block == MMA_ROWS // W and plan.row_tiles == 1
        _check_wide(plan, 256)


def test_wide_layouts_fit_from_dh_160_to_1024():
    """Every kernel's layout (the one-kernel backward's too) within the 227
    KB of one block, from Dh 160 to 1024 in steps of 8 and at each column
    group count a grid may take, in both dtypes: whole rows merged where they fit (Dh 160 and 256 but the
    float32 backward at 256, whose own rows stay resident with 128-column
    slabs), streamed slabs where even the own rows do not (float32 Dh 512
    in the backward)."""
    for Dh in range(160, 1025, 8):
        Dp = -(-Dh // 16) * 16
        least = -(-Dp // attention.GROUP_COLS)
        for dtype in attention.DTYPES:
            for groups in sorted({least, attention.wide_groups(Dh, 1)}):
                for kernel in ("fwd", "dq", "dkv"):
                    L = attention.wide_layout(Dh, dtype, kernel, groups)
                    assert L.smem <= SMEM_LIMIT and L.Dp == Dp and L.groups == groups
                    assert L.slabs == -(-Dp // L.slab) and L.merged == (L.slabs == 1
                                                                         and groups == 1)
                L = attention.wide_window_layout(Dh, dtype, groups)
                assert L.smem <= SMEM_LIMIT and L.slabs == -(-Dp // L.slab)
    f32 = lambda Dh, k: attention.wide_layout(Dh, torch.float32, k)   # noqa: E731
    assert f32(160, "dkv").merged and f32(256, "fwd").merged
    assert not f32(256, "dq").merged and f32(256, "dq").resident and f32(256, "dq").slab == 128
    assert not f32(512, "dq").resident
    assert attention.wide_layout(256, BF16, "dkv").merged


@settings(max_examples=200, deadline=None)
@given(W=st.integers(1, MIN_MMA_WINDOW - 1), Dh=st.integers(1, 128), BH=st.integers(1, 400),
       P=st.integers(1, 4000), causal=st.booleans(), bwd=st.booleans())
def test_multi_window_plan_sweep(W, Dh, BH, P, causal, bwd):
    """bf16 below W 32 at every head dim up to 128, rows up to S = 65,535:
    the multi-window kernels, every window and pair once, within the budget;
    float32 at the same shape keeps the window tiles."""
    S = min(P, attention.MAX_ROW // W) * W
    direction = "bwd" if bwd else "fwd"
    plan = _check_plan(BH, S, W, Dh, BF16, direction, causal)
    assert plan.path == "multi" and plan.copy_bytes == attention.copy_bytes(Dh, BF16)
    assert plan.ragged == (Dh != attention.head_width(Dh) or plan.copy_bytes < 16)
    assert k1_plan(BH, S, W, Dh, torch.float32, direction, causal).path == "tiles"


@pytest.mark.parametrize("W", range(1, MIN_MMA_WINDOW))
def test_multi_window_strips_hold_whole_windows(W):
    """Up to W 16 a strip holds min(4, 16 // W) whole windows (one at W 9-16,
    its 16 rows used 10 of at W 10), each in a chunk of its own (8 keys up to
    W 8, 16 past it); past 16 a window takes two strips and two 16-key
    chunks; a block 4 strips."""
    m = attention.multi_per_strip(W)
    assert W > 16 and m == 1 or m * W <= 16 and m == min(4, 16 // W)
    assert attention.multi_chunk(W) == (8 if W <= 8 else 16)
    assert attention.multi_key_tiles(W) == (4 if W > 16 else m if W <= 8 else 2)
    assert attention.multi_windows(W) == (2 if W > 16 else 4 * m)
    assert attention.multi_windows(W) * W <= attention.MULTI_ROWS


def test_bf16_short_windows_plan_the_multi_window_kernels():
    """bf16 below W 32 and up to Dh 128 takes the multi-window kernels; float32
    keeps the window tiles as they were planned; from W 32, and past Dh 128,
    bf16's plans are the tensor-core and wide ones, as before."""
    for W, Dh in ((10, 64), (5, 96), (1, 16), (31, 128), (10, 48), (5, 21)):
        plan = k1_plan(256, 8 * W, W, Dh, BF16, "bwd", causal=W == 5)
        G = {10: 4, 5: 12, 1: 16, 31: 2}[W]
        assert plan.path == "multi" and plan.blocks == -(-plan.windows // G)
        f32 = k1_plan(256, 8 * W, W, Dh, torch.float32, "bwd")
        G = min(max(1, attention.TILE_ROWS // W), plan.windows)
        width = attention.head_width(Dh)
        assert f32.path == "tiles" and f32.windows_per_block == G
        assert f32.smem_bytes == G * attention.tile_bytes_per_window(W, width, "bwd")
    assert k1_plan(64, 64, 32, 64, BF16).path == k1_plan(64, 64, 64, 64, BF16).path == "mma"
    assert k1_plan(64, 80, 10, 256, BF16).path == "wide"
    # the flagship: 4 windows (40 rows) a block, a window and 16 keys a strip, 512 blocks
    # at training's (256, 80, 64)
    flag = k1_plan(256, 80, 10, 64, BF16, "fwd")
    assert (flag.windows_per_block, flag.rows, flag.cols, flag.blocks) == (4, 40, 16, 512)
    assert [list(flag.strip_rows(s, 4)) for s in (0, 3)] == [list(range(10)),
                                                              list(range(30, 40))]
    assert [flag.strip_chunks(s) for s in range(4)] == [[0], [10], [20], [30]]
    # the slot-AR depth stack: 3 windows of 5 a strip, each in an 8-key chunk of its own
    depth = k1_plan(16384, 5, 5, 64, BF16, "bwd", causal=True)
    assert (depth.windows_per_block, depth.cols, depth.strip_chunks(1)) == (12, 24,
                                                                            [15, 20, 25])
    # W 24: a window's two halves in two strips, both against its 32 keys
    half = k1_plan(8, 48, 24, 64, BF16, "fwd")
    assert [half.strip_rows(s, 2) for s in range(4)] == [range(0, 16), range(16, 24),
                                                         range(24, 40), range(40, 48)]
    assert [half.strip_chunks(s) for s in range(4)] == [[0, 16], [0, 16], [24, 40], [24, 40]]


def test_multi_window_constants_are_the_kernels():
    """MULTI_ROWS, MULTI_STAGED and PATH_CODE["multi"] as csrc/k1_multi.cuh
    has them."""
    src = (kernels.CSRC / "k1_multi.cuh").read_text()
    warps = int(re.search(r"constexpr int kMultiWarps = (\d+);", src).group(1))
    assert attention.MULTI_ROWS == 16 * warps
    assert "constexpr int kMultiStaged = kMultiRows + 16;" in src
    assert attention.MULTI_STAGED == attention.MULTI_ROWS + 16
    assert re.search(r"return path == (\d+) &&", src).group(1) == str(
        attention.PATH_CODE["multi"])

