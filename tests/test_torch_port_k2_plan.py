"""K2's launch plan (``ops/vq_kernel.py::k2_plan``), on the CPU.

The kernels of ``csrc/vq_assign.cu`` and ``csrc/k2_wide.cuh`` run only on
the card, but the plan that sizes their launches is Python, so what it
promises is checked here: the nearest-code grid scores every (row, code)
pair exactly once, the statistics grid owns every (code, column) exactly
once, a cluster has at most 8 blocks, a block asks for at most 232,448 bytes
of shared memory; past 512 columns (the tensor-core kernel) every block of a
cluster walks the same (tile, slice, column step) sequence, which covers each
once, and the cluster's ranks issue each 8-row piece of the x tile once; up
to 512 the plans are the ones the kernel had before the wide kernel came.
The block-to-work mapping below is the kernels' own index arithmetic.

The kernel's dw equals ``assignment_stats`` on the CPU bit for bit because
both add each code's rows in increasing row order from 0; the last test
pins that order on the plain side against a sequential float32 sum.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bridgerl_tpu_torch.ops import codebook, vq_kernel
from bridgerl_tpu_torch.ops.vq_kernel import (CODES_PER_SLICE, SMEM_LIMIT, STAT_CODES,
                                              STAT_COLS, k2_plan)

# (N, D, K) of the card tests (tests/test_torch_port_cuda.py) and chip_smoke.py
CARD_SHAPES = [(1, 64, 512), (33, 7, 5), (4096, 64, 512), (1000, 512, 100),
               (5000, 128, 1024), (31, 64, 1), (257, 33, 65), (512, 64, 512),
               (6554, 64, 512), (1000, 64, 65), (1000, 64, 513), (1000, 64, 1024),
               (1000, 64, 4096), (300, 512, 4096), (4097, 64, 512), (70, 16, 100),
               (40001, 64, 512), (20000, 33, 64), (40000, 7, 5), (20000, 128, 256),
               (64, 64, 512), (49, 64, 512),
               # past 512 columns: the tensor-core kernel (the card tests and chip_smoke.py)
               (512, 640, 512), (4096, 640, 512), (512, 1024, 512), (4096, 1024, 512),
               (100, 513, 70), (50, 2048, 600), (4096, 2048, 512), (64, 513, 512),
               (64, 520, 512), (64, 4096, 512), (1, 1024, 512), (100, 1024, 1),
               (100, 640, 70), (300, 2048, 600), (50, 1001, 65)]

# (tile_rows, cluster, slices_per_block, tiles_per_cluster, clusters, smem_bytes, pass_rows,
# stat_grid) of the plans up to 512 columns before the wide kernel came: unchanged
NARROW_PLANS = {
    (1, 64, 512): (32, 8, 1, 1, 1, 28416, 32, (64, 1)),
    (33, 7, 5): (32, 1, 1, 1, 2, 9728, 64, (1, 1)),
    (4096, 64, 512): (64, 8, 1, 2, 32, 60672, 4096, (64, 1)),
    (1000, 512, 100): (32, 2, 1, 1, 32, 200448, 1024, (13, 8)),
    (5000, 128, 1024): (64, 8, 2, 1, 79, 71936, 5024, (128, 2)),
    (31, 64, 1): (32, 1, 1, 1, 1, 28416, 32, (1, 1)),
    (257, 33, 65): (32, 2, 1, 1, 9, 19200, 288, (9, 1)),
    (512, 64, 512): (32, 8, 1, 1, 16, 28416, 512, (64, 1)),
    (6554, 64, 512): (64, 8, 1, 4, 26, 68864, 6560, (64, 1)),
    (1000, 64, 65): (32, 2, 1, 1, 32, 28416, 1024, (9, 1)),
    (1000, 64, 513): (32, 8, 2, 1, 32, 28416, 1024, (65, 1)),
    (1000, 64, 1024): (32, 8, 2, 1, 32, 28416, 1024, (128, 1)),
    (1000, 64, 4096): (32, 8, 8, 1, 32, 28416, 1024, (512, 1)),
    (300, 512, 4096): (32, 8, 8, 1, 10, 200448, 320, (512, 8)),
    (4097, 64, 512): (64, 8, 1, 2, 33, 60672, 4128, (64, 1)),
    (70, 16, 100): (32, 2, 1, 1, 3, 11776, 96, (13, 1)),
    (40001, 64, 512): (64, 8, 1, 16, 40, 118016, 32768, (64, 1)),
    (20000, 33, 64): (64, 1, 1, 2, 157, 42240, 20000, (8, 1)),
    (40000, 7, 5): (64, 1, 1, 3, 209, 33024, 32768, (1, 1)),
    (20000, 128, 256): (64, 4, 1, 5, 63, 122112, 20000, (32, 2)),
    (64, 64, 512): (32, 8, 1, 1, 2, 28416, 64, (64, 1)),
    (49, 64, 512): (32, 8, 1, 1, 2, 28416, 64, (64, 1)),
    (16384, 64, 1024): (64, 8, 2, 1, 256, 39168, 16384, (128, 1)),
    (16384, 64, 512): (64, 8, 1, 8, 32, 85248, 16384, (64, 1)),
    (2048, 64, 512): (64, 8, 1, 1, 32, 39168, 2048, (64, 1)),
}


def _check_plan(N, D, K):
    p = k2_plan(N, D, K)
    assert 1 <= p.cluster <= 8 and p.cluster <= p.slices
    assert 1 <= p.tiles_per_cluster <= vq_kernel.MAX_TILES
    assert p.tiles_per_cluster == 1 or p.slices_per_block == 1  # several tiles keep one slice
    assert p.wide == (D > vq_kernel.MAX_NARROW)
    need = (vq_kernel.wide_smem(p.tile_rows, p.tiles_per_cluster) if p.wide
            else vq_kernel.nearest_smem(p.tile_rows, D, p.tiles_per_cluster))
    assert need <= p.smem_bytes <= 232_448 == SMEM_LIMIT
    assert p.pass_rows % 32 == 0 and 32 <= p.pass_rows <= vq_kernel.MAX_PASS_ROWS
    assert vq_kernel.stats_smem(p.pass_rows) <= SMEM_LIMIT
    assert p.pass_rows >= min(N, vq_kernel.MAX_PASS_ROWS)  # no pass is wasted

    # nearest codes: block b = q * cluster + rank scores the rows of the
    # tiles q * tiles_per_cluster + t below row_tiles against slices rank,
    # rank + cluster, ... below p.slices
    rows = np.zeros(N, np.int64)
    for q in range(p.clusters):
        for t in range(p.tiles_per_cluster):
            tile = q * p.tiles_per_cluster + t
            if tile < p.row_tiles:
                rows[tile * p.tile_rows:(tile + 1) * p.tile_rows] += 1
    assert (rows == 1).all() and (p.row_tiles - 1) * p.tile_rows < N
    assert (p.clusters - 1) * p.tiles_per_cluster < p.row_tiles  # no cluster without rows
    codes = np.zeros(K, np.int64)
    for rank in range(p.cluster):
        mine = [rank + j * p.cluster for j in range(p.slices_per_block)]
        assert mine[0] < p.slices  # every rank has codes to offer the cluster
        for s in mine:
            if s < p.slices:
                codes[s * CODES_PER_SLICE:(s + 1) * CODES_PER_SLICE] += 1
    assert (codes == 1).all() and p.slices == -(-K // CODES_PER_SLICE)

    # statistics: block (i, j), warp w, lane l owns code i * 8 + w // 2 and
    # column j * 64 + 32 (w % 2) + l, those below K and D
    owned = np.zeros((K, D), np.int64)
    gi, gj = p.stat_grid
    for i in range(gi):
        for j in range(gj):
            owned[i * STAT_CODES:(i + 1) * STAT_CODES, j * STAT_COLS:(j + 1) * STAT_COLS] += 1
    assert (owned == 1).all() and (gi - 1) * STAT_CODES < K and (gj - 1) * STAT_COLS < D
    if p.wide:
        _check_wide_walk(p, N, D)
    return p


def _check_wide_walk(p, N, D):
    """k2_wide.cuh's index arithmetic: iteration it of a cluster's producer and
    consumers is (tile it // (spb * steps), slice it // steps % spb, column step
    it % steps); over the cluster's total (ntiles * spb * steps, the same in
    every block) that covers each triple once. Column steps of 32 cover D,
    the last one holding the ragged end. Rank r issues the tile's 8-row pieces
    r, r + C, ...: each piece once, by one rank."""
    steps = -(-D // vq_kernel.WIDE_COLS)
    assert (steps - 1) * vq_kernel.WIDE_COLS < D <= steps * vq_kernel.WIDE_COLS
    for q in {0, p.clusters - 1}:
        ntiles = min(p.tiles_per_cluster, p.row_tiles - q * p.tiles_per_cluster)
        it = np.arange(ntiles * p.slices_per_block * steps)
        st, rest = it % steps, it // steps
        j, t = rest % p.slices_per_block, rest // p.slices_per_block
        triples = t * p.slices_per_block * steps + j * steps + st
        assert np.array_equal(np.sort(triples), it) and t.max() == ntiles - 1
    pieces = np.zeros(p.tile_rows // 8, np.int64)
    for rank in range(p.cluster):
        pieces[rank::p.cluster] += 1
    assert (pieces == 1).all()


@pytest.mark.parametrize("N,D,K", CARD_SHAPES)
def test_plan_covers_every_pair_once_at_the_card_shapes(N, D, K):
    _check_plan(N, D, K)


@settings(max_examples=300, deadline=None)
@given(N=st.integers(1, 50_000), D=st.integers(1, 2048), K=st.integers(1, 8192))
def test_plan_covers_every_pair_once(N, D, K):
    _check_plan(N, D, K)


@settings(max_examples=200, deadline=None)
@given(N=st.integers(1, 20_000), D=st.integers(513, 4096), K=st.integers(1, 2048))
def test_wide_plan_covers_every_pair_and_column_step_once(N, D, K):
    """Past 512 columns: every (row, code) pair and every column step once,
    within one block's shared memory."""
    _check_plan(N, D, K)


@pytest.mark.parametrize("N,D,K", sorted(NARROW_PLANS))
def test_narrow_plans_are_unchanged(N, D, K):
    p = k2_plan(N, D, K)
    assert not p.wide
    assert (p.tile_rows, p.cluster, p.slices_per_block, p.tiles_per_cluster, p.clusters,
            p.smem_bytes, p.pass_rows, p.stat_grid) == NARROW_PLANS[N, D, K]


@pytest.mark.parametrize("N,D,K,tile_rows,cluster,blocks,per_block,tiles", [
    (512, 64, 512, 32, 8, 128, 1, 1),      # training: 16 tiles x 8 ranks
    (4096, 64, 512, 64, 8, 256, 1, 2),     # serving b = 4096: 32 clusters of 2 tiles
    (6554, 64, 512, 64, 8, 208, 1, 4),     # validation: 103 tiles, 26 clusters
    (1000, 64, 4096, 32, 8, 256, 8, 1),    # 64 slices: 8 per rank
    (1000, 64, 513, 32, 8, 256, 2, 1),     # 9 slices, the last one ragged
    (5000, 512, 1024, 32, 8, 1256, 2, 1),  # 64-row tiles do not fit at D = 512
    (33, 7, 5, 32, 1, 2, 1, 1),
    (50_000, 64, 512, 64, 8, 392, 1, 16),  # 782 tiles: at most 16 a cluster
])
def test_plan_at_known_shapes(N, D, K, tile_rows, cluster, blocks, per_block, tiles):
    p = k2_plan(N, D, K)
    assert (p.tile_rows, p.cluster, p.clusters * p.cluster, p.slices_per_block,
            p.tiles_per_cluster) == (tile_rows, cluster, blocks, per_block, tiles)


def test_plan_shared_memory_at_the_flagship_shape():
    """(32 + 64) rows of 68 floats, 64 norms and a (best, idx) for each of
    32 rows from each of 8 ranks; statistics: 512 bits and 2048 rows a warp."""
    p = k2_plan(512, 64, 512)
    assert p.smem_bytes == 4 * (96 * 68 + 64 + 2 * 8 * 32) == 28_416
    assert p.pass_rows == 512
    assert vq_kernel.stats_smem(512) == 4 * 8 * (16 + 2048)


@pytest.mark.parametrize("N,D,K", [(0, 64, 512), (10, 0, 5), (10, -1, 5), (10, 64, 0)])
def test_plan_refuses_shapes_the_kernels_do_not_take(N, D, K):
    with pytest.raises(ValueError):
        k2_plan(N, D, K)


@pytest.mark.parametrize("N,K", [(6554, 512), (512, 512), (4096, 7)])
def test_assignment_stats_adds_each_codes_rows_in_row_order(N, K):
    rng = np.random.default_rng(N + K)
    x = rng.normal(size=(N, 64)).astype(np.float32)
    idx = rng.integers(0, K, size=N).astype(np.int32)
    counts, dw = codebook.assignment_stats(torch.from_numpy(x), torch.from_numpy(idx), K)
    want = np.zeros((K, 64), np.float32)
    for k in range(K):
        rows = x[idx == k]
        if len(rows):
            want[k] = np.cumsum(rows, axis=0, dtype=np.float32)[-1]
    assert np.array_equal(dw.numpy(), want)
    assert np.array_equal(counts.numpy(), np.bincount(idx, minlength=K).astype(np.float32))


@pytest.mark.parametrize("N,K", [(512, 512), (4096, 512), (33, 5), (1000, 4096)])
def test_every_width_up_to_2048_is_planned(N, K):
    """k2_plan takes every D from 1 to 2048 within the shared memory of one
    block: past 512 the tensor-core kernel, whose shared memory does not
    grow with D (it streams the columns)."""
    for D in range(1, 2049):
        p = k2_plan(N, D, K)
        assert p.smem_bytes <= SMEM_LIMIT and vq_kernel.stats_smem(p.pass_rows) <= SMEM_LIMIT
        assert p.wide == (D > 512)
        assert not p.wide or p.smem_bytes == vq_kernel.wide_smem(p.tile_rows,
                                                                  p.tiles_per_cluster)
        assert p.stat_grid[1] == -(-D // STAT_COLS)
