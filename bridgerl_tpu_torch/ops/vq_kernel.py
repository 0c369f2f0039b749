"""K2: nearest-code search with assignment statistics, as a CUDA kernel.

The counterpart of ``bridgerl_tpu/ops/pallas/vq_kernel.py``
(``nearest_codes_pallas``), with the interface of the plain version
``ops/codebook.py::nearest_codes_plain``: (flat (N, D), codebook (K, D)) ->
(idx (N,) int32, counts (K,) f32, dw (K, D) f32). The kernels are in
``csrc/vq_assign.cu``: one finds each row's nearest code, the grid split
into row tiles and code slices with the slices of a tile in one
thread-block cluster; the other adds each code's rows in increasing row
order and writes every output once, so the outputs need no zeroing and dw
is the same on every run. Past MAX_NARROW columns the nearest codes come
from ``csrc/k2_wide.cuh`` (the codes' norms, then a kernel that streams D
through the tf32 tensor cores, 3xTF32), counted on ``vq_assign_wide`` as
well. :func:`k2_plan` sizes the launches from (N, D, K): any N, K and D of
at least 1. Shapes the kernels do not take raise: there is no silent
fallback to the plain version.

Groups: x (G, N, D) and codebook (G, K, D) give idx (G, N), counts (G, K)
and dw (G, K, D) from one launch of each kernel, group g equal bit for bit
to a call on (x[g], codebook[g]); the plan is one group's, repeated over a
grid dimension. A stacked multi-seed step puts its seeds there.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import kernels

MAX_NARROW = 512         # widest D of csrc/vq_assign.cu's nearest-code kernel
SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448      # bytes of shared memory one block may use
CODES_PER_SLICE = 64
MAX_CLUSTER = 8           # the portable thread-block cluster size
TILE_ROWS = (64, 32)      # rows a block scores, in order of preference
MAX_TILES = 16            # row tiles one cluster takes
BLOCKS_PER_SM = 2         # the nearest-code blocks a cluster's tiles aim for
MAX_PASS_ROWS = 32_768   # rows of idx the statistics kernel takes in one pass
STAT_CODES, STAT_COLS = 8, 64   # codes (one warp each) and columns of a statistics block
LIST_ROWS = 2048         # rows a statistics warp lists before adding them
WIDE_STAGES, WIDE_COLS = 4, 32   # k2_wide.cuh's ring: stages of 32 columns (128 bytes a row)

launch_counter = kernels.LaunchCounter("vq_assign")
wide_counter = kernels.LaunchCounter("vq_assign_wide")   # the launches past MAX_NARROW


class K2Plan(NamedTuple):
    """The launch of both K2 kernels for one (N, D, K).

    Nearest codes: ``clusters * cluster`` blocks of 128 threads; cluster
    q takes row tiles q * tiles_per_cluster, ... (those below
    ``row_tiles``) of ``tile_rows`` rows each, and its rank r scores them
    against slices r, r + cluster, ... (``slices_per_block`` of them, those
    below ``slices``) of ``CODES_PER_SLICE`` codes each, with
    ``smem_bytes`` of shared memory. Statistics: ``stat_grid`` blocks of 8
    warps; block (i, j), warp w, owns code i * STAT_CODES + w and columns
    j * STAT_COLS + lane and j * STAT_COLS + 32 + lane, and reads idx in
    passes of ``pass_rows`` rows (a bitmap of that many bits per code in
    shared memory). ``wide`` (D past MAX_NARROW): the nearest codes are
    ``csrc/k2_wide.cuh``'s, blocks of 160 threads streaming D through a
    ring of WIDE_STAGES stages (``wide_smem``)."""
    tile_rows: int
    row_tiles: int
    slices: int
    cluster: int
    slices_per_block: int
    tiles_per_cluster: int
    clusters: int
    smem_bytes: int
    pass_rows: int
    stat_grid: Tuple[int, int]
    wide: bool


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def nearest_smem(tile_rows: int, D: int, tiles: int = 1) -> int:
    """Shared memory of the nearest-code kernel: an x-tile buffer (two when
    a cluster takes more than one tile; each also holds the threads'
    candidates, 2 (16 + 1) floats a row) and the code slice, in rows of D
    rounded up to 8 plus 4 floats, the slice's norms, and a (best, idx) per
    row of the cluster's tiles from each of up to 8 ranks."""
    stride = _cdiv(D, 8) * 8 + 4
    xbuf = max(tile_rows * stride, 2 * 17 * tile_rows)
    return 4 * ((2 if tiles > 1 else 1) * xbuf + CODES_PER_SLICE * stride + CODES_PER_SLICE
                + 2 * MAX_CLUSTER * tiles * tile_rows)


def stats_smem(pass_rows: int) -> int:
    """Shared memory of the statistics kernel: per warp, a bitmap of
    ``pass_rows`` bits and a list of LIST_ROWS rows."""
    return 4 * STAT_CODES * (pass_rows // 32 + LIST_ROWS)


def wide_smem(tile_rows: int, tiles: int = 1) -> int:
    """Shared memory of k2_wide.cuh's nearest-code kernel: 1024 bytes of
    alignment slack, WIDE_STAGES stages of (tile_rows + 64) rows of 128
    bytes, a full and an empty barrier a stage, the two code halves'
    winners per row, and a (best, idx) per row of the cluster's tiles from
    each of up to 8 ranks."""
    return (1024 + WIDE_STAGES * (tile_rows + CODES_PER_SLICE) * 4 * WIDE_COLS
            + 16 * WIDE_STAGES + 16 * tile_rows + 8 * MAX_CLUSTER * tiles * tile_rows)


def k2_plan(N: int, D: int, K: int) -> K2Plan:
    """64-row tiles when they still give a block per SM and fit in shared
    memory, else 32; one cluster of up to 8 blocks splits a tile's codes.
    Up to MAX_NARROW columns, with one slice per block, a cluster takes
    several tiles (at most 16), so that about BLOCKS_PER_SM blocks run on
    each SM and each loads its codes once. Past it a cluster takes one tile:
    the codes stream through the ring for every tile anyway, and two tiles
    a cluster ran slower on the card (PERF.md §6)."""
    if N < 1 or K < 1 or D < 1:
        raise ValueError(f"K2 takes N >= 1, K >= 1 and D >= 1, got N={N}, D={D}, K={K}")
    wide = D > MAX_NARROW

    def smem(t: int, tiles: int = 1) -> int:
        return wide_smem(t, tiles) if wide else nearest_smem(t, D, tiles)

    slices = _cdiv(K, CODES_PER_SLICE)
    cluster = min(MAX_CLUSTER, slices)
    tile_rows = next(t for t in TILE_ROWS
                     if t == TILE_ROWS[-1] or (_cdiv(N, t) * cluster >= SMS
                                               and smem(t) <= SMEM_LIMIT))
    row_tiles = _cdiv(N, tile_rows)
    slices_per_block = _cdiv(slices, cluster)
    tiles = 1
    if slices_per_block == 1 and not wide:
        tiles = min(MAX_TILES, _cdiv(row_tiles, max(1, BLOCKS_PER_SM * SMS // cluster)))
        while tiles > 1 and smem(tile_rows, tiles) > SMEM_LIMIT:
            tiles -= 1
    return K2Plan(tile_rows=tile_rows, row_tiles=row_tiles, slices=slices, cluster=cluster,
                  slices_per_block=slices_per_block, tiles_per_cluster=tiles,
                  clusters=_cdiv(row_tiles, tiles), smem_bytes=smem(tile_rows, tiles),
                  pass_rows=min(_cdiv(N, 32) * 32, MAX_PASS_ROWS),
                  stat_grid=(_cdiv(K, STAT_CODES), _cdiv(D, STAT_COLS)), wide=wide)


def nearest_codes_cuda(flat: torch.Tensor, codebook: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, D) and (K, D), or (G, N, D) and (G, K, D) for G groups."""
    if not (flat.is_cuda and codebook.device == flat.device):
        raise ValueError("nearest_codes_cuda takes CUDA tensors on one device")
    grouped = flat.ndim == 3
    if (flat.ndim not in (2, 3) or codebook.ndim != flat.ndim
            or flat.shape[-1] != codebook.shape[-1]
            or (grouped and flat.shape[0] != codebook.shape[0])):
        raise ValueError(f"shapes {tuple(flat.shape)} and {tuple(codebook.shape)} "
                         "are not (N, D) and (K, D), or (G, N, D) and (G, K, D)")
    G = flat.shape[0] if grouped else 1
    lead = (G,) if grouped else ()
    N, D = flat.shape[-2:]
    K = codebook.shape[-2]
    if D < 1 or K < 1:
        raise ValueError(f"the kernel takes D >= 1 and K >= 1, got D={D}, K={K}")
    for name, t in (("flat", flat), ("codebook", codebook)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if N == 0 or G == 0:
        return (torch.empty(*lead, N, dtype=torch.int32, device=flat.device),
                torch.zeros(*lead, K, dtype=torch.float32, device=flat.device),
                torch.zeros(*lead, K, D, dtype=torch.float32, device=flat.device))
    plan = k2_plan(N, D, K)
    idx = torch.empty(*lead, N, dtype=torch.int32, device=flat.device)
    counts = torch.empty(*lead, K, dtype=torch.float32, device=flat.device)
    dw = torch.empty(*lead, K, D, dtype=torch.float32, device=flat.device)
    fn = kernels.entry("vq_assign")
    status = fn(flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(),
                counts.data_ptr(), dw.data_ptr(), G, N, D, K, plan.tile_rows, plan.cluster,
                plan.slices_per_block, plan.tiles_per_cluster, plan.smem_bytes, plan.pass_rows,
                int(plan.wide), kernels.stream_ptr(flat))
    kernels.check("vq_assign", status)
    launch_counter.add()
    if plan.wide:
        wide_counter.add()
    return idx, counts, dw
