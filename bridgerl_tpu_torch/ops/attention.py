"""K1: packed-window attention over (B*H, S, Dh) rows, forward and backward.

The counterpart of ``bridgerl_tpu/ops/pallas/attention.py``
(``_packed_attention_fwd`` and ``_packed_attention_bwd``):
``out = dropout(softmax(q k^T * scale + bias)) v`` with an f32 softmax, where
``bias`` is one (S, S) additive term shared by every row. Three biases are in
use: the block-diagonal window mask as 0 / -1e9 (the towers), zeros, and the
causal mask, 0 on and below the diagonal and -1e9 above it (the token prior,
``models/token_prior.py``: its backbone at S = the positions, its slot-AR
depth stack at S = the slots of a position). Any other (S, S) float32 bias
computes the same function. flax masks with ``where(mask, logits,
finfo.min)`` instead; in f32 both make ``expf`` of a masked logit exactly 0,
so the two agree up to summation order.

``causal`` states that the bias is ``models/layers.py::causal_bias`` (0 on and
below the diagonal, -1e9 above it): the token prior's two stacks pass it. The
plain versions and the long-window kernels then read no entry of the bias
above the diagonal (p is 0 there, as ``expf(-1e9 - m)`` is), and the kernels
skip the tiles that lie wholly above it; the result is the same as with the
bias read. The window tiles read their (W, W) block, the causal bias by the
contract.

``window`` W (default S; it must divide S) restricts the function to the
diagonal (W, W) blocks of each row: query i attends only to the keys j with
i // W == j // W, with ``bias[i, j]`` added, and no gradient crosses a
window. Entries of ``bias`` outside those blocks are never read. With the
block-diagonal bias of P windows of W frames and ``window=W`` this equals the
full-row function up to summation order, because ``expf(-1e9 + ...)`` is
exactly 0 in f32; the model's towers always pass their window.

Both directions are ``torch.library`` custom ops (``bridgerl::packed_attention_fwd``
and ``bridgerl::packed_attention_bwd``), so that ``torch.export`` can trace
through them. On a CUDA tensor each runs its hand-written kernel,
``csrc/k1_fwd.cuh`` (forward) or ``csrc/k1_bwd.cuh`` (backward), through
the entry point of its dtype (``csrc/packed_attention*.cu``); on a CPU
tensor its plain version, :func:`packed_attention_reference` or
:func:`packed_attention_bwd_reference`.

q, k, v and dout are float32 or bfloat16, all four alike; the bias is always
float32. As in the TPU kernel, bfloat16 inputs are widened to float32 as they
are read, everything inside (logits, softmax, dropout, both products) is
float32, and out, dq, dk and dv are rounded to q's dtype once, at the end
(round to nearest even). Each kernel has a float32 and a bfloat16 entry
point, and each counts its launches on its own counter.

Each launch follows :func:`k1_plan`, which mirrors the C launchers: windows
shorter than ``MIN_MMA_WINDOW`` take the window tiles in float32 (several
whole windows a block, float32 cores) and, in bfloat16, the multi-window
tensor-core kernels (:func:`multi_plan`: several whole windows a block, a
warp a strip of 16 query rows), longer ones the tensor-core path (tiles of
64 rows a block against streamed tiles of 32, online softmax; the backward
one window-resident kernel up to W 64, and 128 at Dh <= 64, else two kernels
with a scratch array between them); head dims past 128 take the wide
kernels at every W (:func:`wide_plan`). The C entry points
recompute the plan and refuse any other. Each entry point counts its
launches, the tensor-core path's on a second counter (``MMA_COUNTER``), the
bfloat16 multi-window kernels' on ``MULTI_COUNTER``. The
backward's two-kernel path has a C entry point of its own
(``LONG_ENTRY``, ``csrc/packed_attention_bwd[_bf16]_long.cu``), whose
launches count on the backward's counters and on ``LONG_COUNTER``; the wide
kernels' (``WIDE_ENTRY``, ``csrc/packed_attention_wide[_bf16].cu``) on the
entry's counter and on ``WIDE_COUNTER``. Each entry point's ragged form
(below) is a library of its own, ``<entry>_ragged`` (``csrc/*_ragged.cu``),
so that nvcc builds the two forms in parallel; its launches count as the
entry point's.

Head dims: every Dh runs as it is, with no copy of q, k, v, dout or the
outputs. The kernels up to 128 are instantiated at the widths
``SUPPORTED_HEAD_DIMS`` (16, 32, 64, 96, 128); a launch stages its rows at
the least of them at or above Dh (:func:`head_width`), and at any other Dh
the kernels' ragged form reads and writes rows of Dh elements, zero-fills
the staged columns from Dh on as it copies (reading nothing for them) and
stores the columns below Dh alone. Past 128 the wide kernels of
``csrc/k1_wide.cuh`` take any Dh the same way (staged at Dh rounded up to
16). Each staging copy is :func:`copy_bytes` wide: 16 bytes where every row
starts on 16 bytes, else 8 or 4, else (bfloat16 at an odd Dh) plain 2-byte
loads; the plan carries it and the C entry points refuse any other. Zero
columns add nothing to q k^T or to dout v^T, the scale is the caller's (1 /
sqrt of Dh), and the keep bits are keyed on (seed, row, i * S + j) alone.

The forward op's registered autograd formula calls the backward op, which
recomputes the probabilities and the dropout mask, as the TPU kernel's
custom VJP does.

The fused layout: :func:`attention_qkv` takes the projection's output, a (B, S, 3d)
tensor holding q, k and v in that order (d = H Dh, heads major within each), as it is,
and returns out as (B, S, d), the layout ``out_proj`` reads; its backward returns
d(qkv) as one (B, S, 3d) tensor, dq, dk and dv each written by the kernels into its own
column block. Row n = b * H + h of the (B*H, S, Dh) problem is head h of batch row b
(the layout :func:`fold_heads` copies out), so the keep bits and the seed groups are
those of the 3-D op on the folded copies, and every output is bit for bit the same. The
kernels address each row through a layout (csrc/k1_tiles.cuh's Head: a position's and a
batch row's strides, :class:`RowLayout`); the 3-D op's contiguous rows are its case H =
1. Its ops are ``bridgerl::packed_attention_qkv_fwd`` / ``_bwd``; launches count on the
entry point's counters and on ``QKV_COUNTER``.

Dropout is counter-based, so the backward regenerates the forward's mask
from the seed alone. The generator is Philox4x32-10 (Salmon et al., SC'11),
written once in CUDA and once here: key (seed, 0), counter
(i*S + j, row, 0, 0) with i and j positions in the packed row, first output
word. An element is kept when its word is below ``uint32(keep * 2**32)`` and
is then scaled by ``1 / keep``. Each (batch*head) row draws its own mask; the
TPU kernel does the same (one PRNG stream per grid program), while flax's
default attention shares one mask across the batch.

Seed groups: ``seed`` may hold G values, G dividing B*H (a stacked
multi-seed step folds its S seeds into the rows, seed-major). Row r then
draws with ``seed[r // (BH / G)]`` as Philox row ``r % (BH / G)``, so group
g's mask is bit for bit that of a call of its own over BH / G rows with
``seed[g]``: what ``jax.vmap`` of the TPU kernel gives each seed. One value
is the single-seed call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import kernels

# the widths the kernels up to 128 are instantiated at (head_width)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 96, 128)
WIDE_STAGE_ALIGN = 16         # past 128 the wide kernels stage a multiple of 16 columns
COPY_SIZES = (16, 8, 4, 2)    # bytes of a staging copy (copy_bytes), widest first
GROUP_COLS = 256              # csrc/k1_wide.cuh kGroupCols: the most columns a block owns
MULTI_WINDOW = 32             # kMultiWindow: at W <= 32 a wide block holds 64 // W windows
EXCHANGE_STRIDE = 40          # kXS: a row of the wide kernels' float32 exchange tiles
SLAB_WIDTHS = (256, 128, 64)  # the wide kernels' contraction slabs, where whole rows do not fit
SPLIT_BELOW = 132             # kSplitBelow (the H100's SMs): small wide grids split columns
KEEP_TILES = 32               # kKeepTiles: the wide dq kernel keeps sweep 1's keep bits
                              # for this many key tiles, a byte a thread each
WIDE_THREADS = 256            # kThreads: a wide block's 8 warps
WIDE_WINDOW = 64              # kWinMax: at W <= 64 the wide backward is one kernel
WINDOW_STRIDE = 68            # kWS: a row of that kernel's float32 (64, 64) tiles
WINDOW_SMEM = 115712          # kWinSmem: its shared memory for two blocks an SM
SMEM_LIMIT = 232448           # bytes of shared memory one H100 block may use
TILE_ROWS = 20                # csrc/k1_tiles.cuh kTileRows: G = 20 // W windows a block
MIN_MMA_WINDOW = 32           # csrc/k1_mma.cuh kMinWindow: W* of the tensor-core path
MULTI_ROWS = 64               # csrc/k1_multi.cuh kMultiRows: a bf16 multi-window block's
                              # rows at most, 4 strips of 16
MULTI_STAGED = MULTI_ROWS + 16   # kMultiStaged: rows it stages (a chunk reads 15 past)
MMA_ROWS, MMA_COLS = 64, 32   # kRows (a block's rows, 16 a warp) and kCols (a streamed tile)
MAX_ROW = 65535               # kMaxRow: the Philox counter i * S + j has 32 bits
FULL_GRID = 264               # kFullGrid: two-kernel backward blocks of MMA_ROWS rows
                              # below which the row-buffered dq kernel runs (two an SM)
SEED_HIGH = 2 ** 31 - 1       # seeds are drawn from [0, SEED_HIGH), as in JAX
DTYPES = (torch.float32, torch.bfloat16)

# the C entry point of each kernel and input dtype; a wrapper counts each
# entry point's launches on the counter of the same name
ENTRY = {("fwd", torch.float32): "packed_attention_fwd",
         ("fwd", torch.bfloat16): "packed_attention_fwd_bf16",
         ("bwd", torch.float32): "packed_attention_bwd",
         ("bwd", torch.bfloat16): "packed_attention_bwd_bf16"}
COUNTER = {key: kernels.LaunchCounter(name) for key, name in ENTRY.items()}
# the launches among those that took the tensor-core path (W >= MIN_MMA_WINDOW)
MMA_COUNTER = {key: kernels.LaunchCounter(name + "_mma") for key, name in ENTRY.items()}
# the backward's tensor-core launches that took two kernels (past the window-resident one),
# each dtype's through a C entry point (and library) of the same name
LONG_ENTRY = {dtype: ENTRY["bwd", dtype] + "_long" for dtype in DTYPES}
LONG_COUNTER = {("bwd", dtype): kernels.LaunchCounter(name) for dtype, name in LONG_ENTRY.items()}
# head dims past 128: the wide kernels (csrc/k1_wide.cuh), a C entry point (and a library a
# dtype) of their own; their launches count on the entry's counter and on WIDE_COUNTER
WIDE_ENTRY = {key: name + "_wide" for key, name in ENTRY.items()}
WIDE_COUNTER = {key: kernels.LaunchCounter(name) for key, name in WIDE_ENTRY.items()}
# the launches among the bfloat16 ones that took the multi-window kernels (W < MIN_MMA_WINDOW)
MULTI_COUNTER = {key: kernels.LaunchCounter(name + "_multi") for key, name in ENTRY.items()
                 if key[1] == torch.bfloat16}
# the launches among those that took the fused layout (attention_qkv)
QKV_COUNTER = {key: kernels.LaunchCounter(name + "_qkv") for key, name in ENTRY.items()}
# the plan's path as the C entry points take it
PATH_CODE = {"tiles": 0, "mma": 1, "wide": 2, "multi": 3}
MAX_POSITIONS = 2 ** 31       # B*H*S, and a position's stride: the kernels' row addresses

Seed = Union[int, torch.Tensor]
# one generator, or one per seed of a stacked multi-seed step
Generators = Union[torch.Generator, Sequence[torch.Generator]]

# ---------------------------------------------------------------- Philox

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a constant a < 2**32 and uint32
    values b held in int64. b is split into 16-bit halves so that no
    intermediate product reaches 2**63."""
    p_lo = a * (b & 0xFFFF)                    # < 2**48
    p_hi = a * (b >> 16)                       # < 2**48
    t = ((p_hi & 0xFFFF) << 16) + p_lo         # < 2**49
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 values. ``counter`` is
    four tensors (or ints), ``key`` two; returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(dropout_rate: float) -> int:
    """uint32(keep * 2**32): the words below it are kept."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} is not in [0, 1)")
    return int((1.0 - dropout_rate) * 4294967296.0)


def resolve_window(S: int, window: Optional[int]) -> int:
    """The window length: S when ``window`` is None; it must divide S, and
    S is at most MAX_ROW (the dropout counter i * S + j has 32 bits)."""
    if S > MAX_ROW:
        raise ValueError(f"rows of {S} positions: K1 takes at most {MAX_ROW}")
    if window is None:
        return S
    W = int(window)
    if W < 1 or S % W:
        raise ValueError(f"window {window} does not divide the row length {S}")
    return W


def seed_groups(seed: Seed, BH: int) -> torch.Tensor:
    """The seed values as int64 (G,), G dividing BH."""
    seeds = torch.as_tensor(seed).reshape(-1).to(torch.int64)
    G = seeds.numel()
    if G < 1 or BH % G:
        raise ValueError(f"{G} seed values do not divide {BH} rows into equal groups")
    return seeds


def window_dropout_mask(seed: Seed, BH: int, S: int, W: int, dropout_rate: float = 0.1,
                        device=None) -> torch.Tensor:
    """The diagonal (W, W) blocks of the kernels' keep mask:
    bool (BH, S // W, W, W). Element (i, j) of window w is position
    (w*W + i, w*W + j) of the packed row. With G seed values, row r draws
    with seed ``r // (BH / G)`` as row ``r % (BH / G)``."""
    seeds = seed_groups(seed, BH).to(device)
    rows_per_group = BH // seeds.numel()
    start = torch.arange(0, S, W, dtype=torch.int64, device=device)[:, None, None]
    a = torch.arange(W, dtype=torch.int64, device=device)
    ij = (start + a[:, None]) * S + (start + a[None, :])           # (S // W, W, W)
    r = torch.arange(BH, dtype=torch.int64, device=device)[:, None]
    key = seeds[r // rows_per_group] & _U32
    bits = philox4x32((ij.reshape(1, -1), r % rows_per_group, 0, 0), (key, 0))[0]
    return (bits < keep_threshold(dropout_rate)).reshape(BH, S // W, W, W)


def attention_dropout_mask(seed: Seed, BH: int, S: int, dropout_rate: float = 0.1,
                           device=None) -> torch.Tensor:
    """Plain version of the kernels' keep mask over whole rows: bool (BH, S, S)."""
    return window_dropout_mask(seed, BH, S, S, dropout_rate, device).reshape(BH, S, S)


def _inv_keep(dropout_rate: float) -> float:
    return 1.0 / (1.0 - dropout_rate)


# ---------------------------------------------------------------- plain versions

def _windows(t: torch.Tensor, W: int) -> torch.Tensor:
    BH, S, Dh = t.shape
    return t.reshape(BH, S // W, W, Dh)


def _window_bias(bias: torch.Tensor, W: int) -> torch.Tensor:
    """The diagonal (W, W) blocks of the (S, S) bias: (S // W, W, W)."""
    n = bias.shape[0] // W
    return bias.reshape(n, W, n, W).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def _causal_blocks(bias: torch.Tensor, causal: bool) -> torch.Tensor:
    """The window blocks of the bias, with -inf above each block's diagonal
    under ``causal`` (what is there is never read)."""
    if not causal:
        return bias
    W = bias.shape[-1]
    lower = torch.ones(W, W, dtype=torch.bool, device=bias.device).tril()
    return torch.where(lower, bias, float("-inf"))


def _probs(q, k, bias, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
    return torch.softmax(s, dim=-1)


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, scale: float, seed: Seed = 0,
                               dropout_rate: float = 0.0,
                               window: Optional[int] = None,
                               causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1's forward, window by window, in float32;
    the result is rounded to q's dtype. Under ``causal`` no entry of the bias
    above the diagonal is read."""
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    bias_w = _causal_blocks(_window_bias(bias, W), causal)
    p = _probs(_windows(q32, W), _windows(k32, W), bias_w, scale)
    if dropout_rate > 0.0:
        keep = window_dropout_mask(seed, BH, S, W, dropout_rate, q.device)
        p = torch.where(keep, p * _inv_keep(dropout_rate), 0.0)
    return torch.matmul(p, _windows(v32, W)).reshape(BH, S, Dh).to(q.dtype)


def packed_attention_bwd_reference(q, k, v, bias, dout, scale: float, seed: Seed = 0,
                                   dropout_rate: float = 0.0,
                                   window: Optional[int] = None, causal: bool = False):
    """Plain PyTorch version of K1's backward, window by window, written out
    as the TPU kernel's ``_attn_bwd_kernel`` is: recompute p and the mask,
    then dv = p_drop^T do, dp = keep * (do v^T) / keep_prob,
    ds = p * (dp - sum(dp * p)) * scale, dq = ds k, dk = ds^T q. It computes
    in float32 and rounds dq, dk and dv to q's dtype. Under ``causal`` no
    entry of the bias above the diagonal is read."""
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    dtype = q.dtype
    q, k, v, dout = (_windows(t.float(), W) for t in (q, k, v, dout))
    p = _probs(q, k, _causal_blocks(_window_bias(bias, W), causal), scale)
    if dropout_rate > 0.0:
        keep = window_dropout_mask(seed, BH, S, W, dropout_rate, q.device)
        inv = _inv_keep(dropout_rate)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, torch.matmul(dout, v.transpose(-1, -2)) * inv, 0.0)
    else:
        p_drop = p
        dp = torch.matmul(dout, v.transpose(-1, -2))
    dv = torch.matmul(p_drop.transpose(-1, -2), dout)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * scale
    dq, dk = torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q)
    return tuple(t.reshape(BH, S, Dh).to(dtype) for t in (dq, dk, dv))


# ---------------------------------------------------------------- the launch plan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class K1Plan(NamedTuple):
    """One K1 launch (``direction`` fwd or bwd) at window W, as the C
    launchers make it.

    ``tiles``: blocks of 128 threads take ``windows_per_block`` (G) whole
    windows each (``rows`` = G * W query rows), ``blocks`` of them with
    ``smem_bytes`` of shared memory; the backward is one kernel.
    ``mma``: block (window, tile) owns ``rows`` rows (queries; keys in the
    backward's dk / dv kernel) and streams the window's other side in tiles
    of ``cols`` = 32; ``blocks`` = windows x ``row_tiles`` for the forward
    and the dq kernel, ``blocks_kv`` for the dk / dv kernel, with
    ``smem_bytes`` and ``smem_kv``. The forward's blocks take 64 rows. The
    backward of a window of at most 64 positions, or 128 at Dh <= 64
    (:func:`window_rows`), is one window-resident kernel: a block a window,
    ``rows`` = ``cols`` = 64 or 128, everything staged at once, ``blocks_kv``
    0. Longer windows take two kernels (:func:`backward_rows`): the
    row-buffered dq kernel and the keys kernel in blocks of 32 rows (keys)
    where 64-row blocks would not fill the card, through p_drop and ds planes
    in device memory; else (or where no row buffer fits) the two-sweep dq
    kernel and the dk / dv kernel in blocks of 64, through the rows'
    statistics (:func:`backward_scratch`). Under
    ``causal`` the tiles that :meth:`key_tiles` and :meth:`query_tiles` leave
    out, all wholly above the diagonal, do not run.

    ``multi``: bfloat16 below MIN_MMA_WINDOW (:func:`multi_plan`): blocks
    of 128 threads take ``windows_per_block`` (G) whole windows each
    (``rows`` = G * W), a warp the rows of one strip (:meth:`strip_rows`)
    against ``cols`` = 8 * :func:`multi_key_tiles` keys in chunks of
    :func:`multi_chunk` (:meth:`strip_chunks`); the backward is one
    kernel.

    ``wide``: a head dim past 128 (:func:`wide_plan`): blocks of 64 rows,
    ``windows_per_block`` whole windows at W <= MULTI_WINDOW, else row tiles
    of a window, times ``groups`` output column groups; the backward one
    kernel up to W 64 (``cols`` 64: every key of the block at once), past
    it the dq kernel and the dk / dv kernel over the same blocks.

    ``Dh`` is the true head dim, ``width`` the one the kernels are planned
    and staged at (:func:`head_width`), ``copy_bytes`` each staging copy's
    bytes (:func:`copy_bytes`); ``ragged`` says that the kernels' ragged form
    runs."""
    path: str
    direction: str
    W: int
    causal: bool
    windows: int
    rows: int
    cols: int
    windows_per_block: int
    blocks: int
    smem_bytes: int
    blocks_kv: int
    smem_kv: int
    groups: int = 1
    Dh: int = 0
    width: int = 0
    copy_bytes: int = 16

    @property
    def ragged(self) -> bool:
        """The kernels' ragged form: rows of Dh staged at a wider ``width``, or
        copies narrower than 16 bytes (csrc/k1_tiles.cuh)."""
        return self.Dh != self.width or self.copy_bytes < 16

    @property
    def row_tiles(self) -> int:
        """Tiles of ``rows`` rows a window (mma; wide: of a block's windows)."""
        return _cdiv(self.W * self.windows_per_block if self.path == "wide" else self.W,
                     self.rows)

    def key_tiles(self, query_tile: int) -> range:
        """The key tiles (of ``cols``) that query tile ``query_tile`` reads in
        the forward and the dq kernel: k1_mma.cuh's key_tiles."""
        n = _cdiv(self.W, self.cols)
        if self.causal:
            n = min(n, (query_tile * self.rows + self.rows - 1) // self.cols + 1)
        return range(n)

    def strip_rows(self, strip: int, windows: int) -> range:
        """The block rows of warp ``strip``'s query rows (multi; keys in the
        backward's second half) in a block of ``windows`` windows
        (k1_multi.cuh's multi_strip): up to W 16 the rows of its
        min(4, 16 // W) whole windows, past it one 16-row part of a
        window."""
        W = self.W
        if W <= 16:
            m = multi_per_strip(W)
            first = strip * m
            return range(first * W, max(first, min(windows, first + m)) * W)
        cw = _cdiv(W, 16)
        win, part = divmod(strip, cw)
        start = win * W + 16 * part
        return range(start, start + (max(0, min(16, W - 16 * part)) if win < windows else 0))

    def strip_chunks(self, strip: int) -> list:
        """The block row of each chunk's first key that warp ``strip``
        computes against (and, in the backward, of its queries): up to W 16
        chunk c is the strip's window c, past it keys 16c .. of its window.
        The strip's key at place p is row chunks[p // C] + p % C, C =
        :func:`multi_chunk`."""
        W = self.W
        chunks = self.cols // multi_chunk(W)
        if W <= 16:
            return [(strip * multi_per_strip(W) + c) * W for c in range(chunks)]
        return [strip // _cdiv(W, 16) * W + 16 * c for c in range(chunks)]

    def query_tiles(self, key_tile: int) -> range:
        """The query tiles (of ``cols``) that key tile ``key_tile`` reads in
        the dk / dv kernel: from k1_mma.cuh's first_query_tile on."""
        first = key_tile * self.rows // self.cols if self.causal else 0
        return range(first, _cdiv(self.W, self.cols))


def tile_bytes_per_window(W: int, Dh: int, direction: str) -> int:
    """Shared memory of one window on the window-tile path: padded float32
    rows of q, k, v (and dout) and the (W, W + 1) tiles."""
    if direction == "fwd":
        return 4 * (3 * W * (Dh + 4) + 2 * W * (W + 1) + W)
    return 4 * (4 * W * (Dh + 4) + 3 * W * (W + 1))


def multi_per_strip(W: int) -> int:
    """k1_multi.cuh's multi_per_strip: whole windows a warp's strip of 16
    rows holds up to W 16 (at most 4); past it a window takes several
    strips."""
    return 1 if W > 16 else min(4, 16 // W)


def multi_chunk(W: int) -> int:
    """k1_multi.cuh's multi_chunk: the keys of a chunk, 8 up to W 8 (their
    products m16n8k8), else 16. A window's keys start a chunk of their own."""
    return 8 if W <= 8 else 16


def multi_key_tiles(W: int) -> int:
    """k1_multi.cuh's multi_key_tiles: the 8-key tiles a strip computes
    against: a chunk a window up to W 16 (2 at W 6-8, 3 at W 5, 4 at W 1-4
    in 8-key chunks; 2 at W 9-16), and past 16 the window's two 16-key
    chunks (4)."""
    if W <= 8:
        return multi_per_strip(W)
    return 2 * (_cdiv(W, 16) if W > 16 else multi_per_strip(W))


def multi_windows(W: int) -> int:
    """k1_multi.cuh's multi_windows: whole windows a block of 4 strips (4 at
    W 10, 12 at W 5, 2 at W 17-32)."""
    return 4 // _cdiv(W, 16) if W > 16 else 4 * multi_per_strip(W)


def multi_smem(Dh: int, direction: str, W: int) -> int:
    """The multi-window kernels' shared memory: MULTI_STAGED padded bf16 rows
    of q, k and v (and dout), in the backward one float32 (MULTI_ROWS,
    :func:`multi_tile_stride`) tile that holds p_drop, then ds, and the
    rows' bias inside their windows, a float32 (MULTI_ROWS, W) tile."""
    rows = MULTI_STAGED * mma_row_bytes(head_width(Dh), torch.bfloat16)
    bias = MULTI_ROWS * W * 4
    if direction == "fwd":
        return 3 * rows + bias
    return 4 * rows + MULTI_ROWS * multi_tile_stride(W) * 4 + bias


def multi_tile_stride(W: int) -> int:
    """k1_multi.cuh's multi_tile_stride: a row of the backward's shared tile,
    a window's chunks and 4 floats."""
    return (8 if W <= 8 else 16 * _cdiv(W, 16)) + 4


def mma_row_bytes(Dh: int, dtype: torch.dtype) -> int:
    """A padded row of a tensor-core tile: Dh elements and 16 bytes."""
    return Dh * dtype.itemsize + 16


def window_rows(W: int, Dh: int) -> int:
    """The window-resident backward's rows (k1_mma.cuh's bwd_window_rows):
    64 for W <= 64, 128 for W <= 128 at Dh <= 64 (at Dh 128 neither the
    staged rows and the (128, 132) tile nor a thread's registers fit); 0
    where the window takes two kernels."""
    if W <= MMA_ROWS:
        return MMA_ROWS
    return 2 * MMA_ROWS if Dh <= 64 and W <= 2 * MMA_ROWS else 0


def row_buffer_stride(W: int) -> int:
    """k1_mma.cuh's bwd_buffer_stride: a row of the dq kernel's float32
    buffers, the window's keys in whole tiles and 4 floats."""
    return _cdiv(W, MMA_COLS) * MMA_COLS + 4


def rows_smem(rows: int, W: int, row: int) -> int:
    """The row-buffered dq kernel's shared memory: q and dout rows, two
    stages of (K, V) tiles, two (rows, stride) float32 buffers and the keep
    flags (a 32-bit word a row and key tile)."""
    return ((2 * rows + 4 * MMA_COLS) * row + 8 * rows * row_buffer_stride(W)
            + 4 * rows * _cdiv(W, MMA_COLS))


def plane_stride(W: int) -> int:
    """k1_mma.cuh's bwd_plane_stride: the row stride of the p_drop and ds
    planes between the row-buffered dq kernel and the keys kernel."""
    return _cdiv(W, MMA_COLS) * MMA_COLS


def backward_scratch(plan: "K1Plan") -> int:
    """Floats of scratch the two-kernel backward needs: the p_drop and ds
    planes of every window (the row-buffered dq kernel, ``rows`` 32), or the
    rows' max, 1 / normaliser and D and 4 floats more, which the dk / dv
    kernel's last copies may read (the two-sweep dq kernel, and the wide
    kernels'); 0 for one kernel."""
    if not plan.blocks_kv:
        return 0
    if plan.rows < MMA_ROWS and plan.path != "wide":
        return 2 * plan.windows * plan.W * plane_stride(plan.W)
    return 3 * plan.windows * plan.W + 4


def backward_rows(windows: int, W: int, Dh: int, dtype: torch.dtype) -> int:
    """The rows of the row-buffered dq kernel's blocks (k1_mma.cuh's
    bwd_block_rows): 32 where blocks of 64 rows would number fewer than
    FULL_GRID and the row buffers fit; 0 where the two-sweep dq kernel runs
    (a full card, whose blocks it fits three an SM, or no buffer fits)."""
    full = windows * _cdiv(W, MMA_ROWS) >= FULL_GRID
    fits = rows_smem(MMA_ROWS // 2, W, mma_row_bytes(Dh, dtype)) <= SMEM_LIMIT
    return MMA_ROWS // 2 if not full and fits else 0


def head_width(Dh: int) -> int:
    """The width the kernels stage a head dim of ``Dh`` at and are planned
    at: the least of SUPPORTED_HEAD_DIMS at or above it up to 128, past 128
    Dh itself (the wide kernels' tiles round it up to 16 columns)."""
    if Dh < 1:
        raise ValueError(f"head dim {Dh} is not positive")
    if Dh > SUPPORTED_HEAD_DIMS[-1]:
        return Dh
    return next(d for d in SUPPORTED_HEAD_DIMS if d >= Dh)


def copy_bytes(Dh: int, dtype: torch.dtype, strides: Sequence[int] = (),
               addresses: Sequence[int] = ()) -> int:
    """The bytes of each copy that stages rows of ``Dh`` elements
    (csrc/k1_tiles.cuh layout_copy): the widest of COPY_SIZES that divides
    Dh * E, every stride (in elements) times E and every tensor's address,
    so that every row starts on it (2: bfloat16 at an odd Dh or offset,
    plain loads). Contiguous (BH, S, Dh) rows on 16-byte addresses (the 3-D
    op) take the widest that divides Dh * E."""
    E = dtype.itemsize
    g = Dh * E
    for x in strides:
        g |= x * E
    for a in addresses:
        g |= a
    return next(b for b in COPY_SIZES if g % b == 0)


def _at_head_dim(plan: K1Plan, Dh: int, dtype: torch.dtype) -> K1Plan:
    return plan._replace(Dh=Dh, width=head_width(Dh), copy_bytes=copy_bytes(Dh, dtype))


def k1_plan(BH: int, S: int, W: int, Dh: int, dtype: torch.dtype = torch.float32,
            direction: str = "fwd", causal: bool = False) -> K1Plan:
    """The launch of K1 at (BH, S, Dh), window W, planned at the width
    :func:`head_width` gives: below MIN_MMA_WINDOW the window tiles in
    float32 and the multi-window kernels in bfloat16 (:func:`multi_plan`),
    the tensor-core path (:func:`mma_plan`) from it on, and past 128 the
    wide kernels at every W (:func:`wide_plan`). Raises on what the kernels
    do not take."""
    windows = _windows_of(BH, S, W, Dh, dtype, direction)
    width = head_width(Dh)
    if W >= MIN_MMA_WINDOW or width > SUPPORTED_HEAD_DIMS[-1]:
        return mma_plan(BH, S, W, Dh, dtype, direction, causal)
    if dtype == torch.bfloat16:
        return multi_plan(BH, S, W, Dh, direction, causal)
    per = tile_bytes_per_window(W, width, direction)
    G = min(max(1, TILE_ROWS // W), SMEM_LIMIT // per, max(windows, 1))
    return _at_head_dim(K1Plan("tiles", direction, W, causal, windows, G * W, 0, G,
                               _cdiv(windows, G), G * per, 0, 0), Dh, dtype)


def multi_plan(BH: int, S: int, W: int, Dh: int, direction: str = "fwd",
               causal: bool = False) -> K1Plan:
    """The bfloat16 multi-window kernels' launch (csrc/k1_multi.cuh), below
    MIN_MMA_WINDOW: G = :func:`multi_windows` whole windows a block (at most
    the launch's), ``cols`` = 8 :func:`multi_key_tiles` keys a strip,
    :func:`multi_smem` bytes."""
    windows = _windows_of(BH, S, W, Dh, torch.bfloat16, direction)
    if W >= MIN_MMA_WINDOW:
        raise ValueError(f"window {W}: the multi-window kernels take W < {MIN_MMA_WINDOW}")
    G = min(multi_windows(W), max(windows, 1))
    return _at_head_dim(K1Plan("multi", direction, W, causal, windows, G * W,
                               8 * multi_key_tiles(W), G, _cdiv(windows, G),
                               multi_smem(Dh, direction, W), 0, 0), Dh, torch.bfloat16)


def mma_plan(BH: int, S: int, W: int, Dh: int, dtype: torch.dtype = torch.float32,
             direction: str = "fwd", causal: bool = False) -> K1Plan:
    """The tensor-core path's launch at any W: :func:`k1_plan`'s from
    MIN_MMA_WINDOW on (``tools/k1_phases.py --crossover`` also times it
    below, in a build of its own)."""
    windows = _windows_of(BH, S, W, Dh, dtype, direction)
    return _at_head_dim(_mma_plan_at(windows, W, head_width(Dh), dtype, direction, causal),
                        Dh, dtype)


def _mma_plan_at(windows: int, W: int, width: int, dtype: torch.dtype, direction: str,
                 causal: bool) -> K1Plan:
    """:func:`mma_plan` at the staged ``width``."""
    if width > SUPPORTED_HEAD_DIMS[-1]:
        return wide_plan(windows, W, width, dtype, direction, causal)
    row = mma_row_bytes(width, dtype)
    if direction == "fwd":
        return K1Plan("mma", direction, W, causal, windows, MMA_ROWS, MMA_COLS, 1,
                      windows * _cdiv(W, MMA_ROWS), (MMA_ROWS + 4 * MMA_COLS) * row, 0, 0)
    R = window_rows(W, width)
    if R:   # one window-resident kernel: a block of R rows holds the whole window
        return K1Plan("mma", direction, W, causal, windows, R, R, 1, windows,
                      4 * R * row + R * (R + 4) * 4, 0, 0)
    RB = backward_rows(windows, W, width, dtype)
    blocks = windows * _cdiv(W, RB or MMA_ROWS)
    if RB:   # the row-buffered dq kernel and the keys kernel
        return K1Plan("mma", direction, W, causal, windows, RB, MMA_COLS, 1, blocks,
                      rows_smem(RB, W, row), blocks,
                      4 * MMA_COLS * row + 4 * MMA_COLS * (RB + 4) * 4)
    # the two-sweep dq kernel and the dk / dv kernel
    return K1Plan("mma", direction, W, causal, windows, MMA_ROWS, MMA_COLS, 1, blocks,
                  (2 * MMA_ROWS + 4 * MMA_COLS) * row, blocks,
                  (2 * MMA_ROWS + 4 * MMA_COLS) * row + 2 * 3 * MMA_COLS * 4)


class WideLayout(NamedTuple):
    """One wide kernel's shared memory (csrc/k1_wide.cuh kw::layout):
    ``Dp`` staged columns (Dh rounded up to 16, zero-filled past Dh),
    ``groups`` output column groups of ``group_cols`` (two warps' halves),
    contraction slabs of ``slab`` columns (``slabs`` of them), the block's
    own rows staged once (``resident``) or with each slab, ``merged`` (one
    slab, one group: the products read the slab's tiles), ``stage`` bytes a
    ring stage, ``stages`` of them (3 where they fit, else 2), ``smem`` bytes
    in all."""
    Dp: int
    groups: int
    group_cols: int
    slab: int
    slabs: int
    resident: bool
    merged: bool
    stage: int
    stages: int
    smem: int


def _third_stage(L: WideLayout) -> WideLayout:
    """k1_wide.cuh third_stage: a third ring stage where it fits."""
    if L.smem + L.stage <= SMEM_LIMIT:
        return L._replace(stages=3, smem=L.smem + L.stage)
    return L


def _group_cols(Dp: int, groups: int) -> int:
    return _cdiv(_cdiv(Dp, groups), WIDE_STAGE_ALIGN) * WIDE_STAGE_ALIGN


def wide_groups(Dh: int, row_blocks: int) -> int:
    """The wide kernels' output column groups (k1_wide.cuh groups_of): as
    few as GROUP_COLS columns a group allows, doubled while twice
    ``row_blocks`` times the groups stay within SPLIT_BELOW blocks (one an
    SM) and a group holds more than 64 columns."""
    Dp = _cdiv(Dh, WIDE_STAGE_ALIGN) * WIDE_STAGE_ALIGN
    groups = _cdiv(Dp, GROUP_COLS)
    while 2 * row_blocks * groups <= SPLIT_BELOW and _group_cols(Dp, groups) > 64:
        groups *= 2
    return groups


def wide_layout(Dh: int, dtype: torch.dtype, kernel: str,
                groups: Optional[int] = None) -> WideLayout:
    """``kernel`` fwd, dq or dkv at head dim ``Dh`` past 128 and ``groups``
    output column groups (default as few as GROUP_COLS
    allows): the block's own rows (64 of q; of q and dout; of k and v), a
    two-stage ring of streamed tiles (32 rows of k; of k and v; of q and
    dout) and the float32 exchange tiles and statistics. The first that
    fits SMEM_LIMIT of: whole rows and one column group (merged; the
    forward's stage also holds v's tile), the own rows resident with slabs
    of 256, 128 or 64 columns, every row streamed in slabs; a product
    stage holds one group's columns of one tensor (v; k; dout, then q)."""
    E = dtype.itemsize
    row = lambda w: w * E + 16   # noqa: E731  a staged row, padded by 16 bytes
    Dp = _cdiv(Dh, WIDE_STAGE_ALIGN) * WIDE_STAGE_ALIGN
    groups = groups or _cdiv(Dp, GROUP_COLS)
    CW = _group_cols(Dp, groups)
    A = MMA_ROWS * (1 if kernel == "fwd" else 2)
    B = MMA_COLS * (1 if kernel == "fwd" else 2)
    fixed = ((2 if kernel == "dkv" else 1) * MMA_ROWS * EXCHANGE_STRIDE * 4
             + 4 * {"fwd": 2 * MMA_ROWS, "dq": 6 * MMA_ROWS, "dkv": 9 * MMA_COLS}[kernel]
             + (KEEP_TILES * WIDE_THREADS if kernel == "dq" else 0))
    prod = MMA_COLS * row(CW)
    if groups == 1:
        stage = (2 * MMA_COLS if kernel == "fwd" else B) * row(Dp)
        smem = A * row(Dp) + 2 * stage + fixed
        if smem <= SMEM_LIMIT:
            return _third_stage(WideLayout(Dp, groups, CW, Dp, 1, True, True, stage, 2, smem))
    for resident in (True, False):
        for SW in SLAB_WIDTHS:
            if SW >= Dp:
                continue
            stage = max((B + (0 if resident else A)) * row(SW), prod)
            smem = (A * row(Dp) if resident else 0) + 2 * stage + fixed
            if smem <= SMEM_LIMIT:
                return _third_stage(WideLayout(Dp, groups, CW, SW, _cdiv(Dp, SW), resident,
                                               False, stage, 2, smem))
    raise ValueError(f"head dim {Dh}: no wide {kernel} layout fits {SMEM_LIMIT} bytes")


def wide_window_layout(Dh: int, dtype: torch.dtype, groups: int) -> WideLayout:
    """The one-kernel wide backward (W <= WIDE_WINDOW; k1_wide.cuh
    win_layout): a ring whose stage holds a slab of the block's 64 rows of q,
    dout, k and v or 32 rows of one tensor's group columns, two float32
    (64, 64) tiles and a keep byte an element; the widest slab of 256 down
    to 16 columns with which two stages fit two blocks an SM (WINDOW_SMEM),
    else one block an SM."""
    E = dtype.itemsize
    row = lambda w: w * E + 16   # noqa: E731
    Dp = _cdiv(Dh, WIDE_STAGE_ALIGN) * WIDE_STAGE_ALIGN
    CW = _group_cols(Dp, groups)
    fixed = 2 * MMA_ROWS * WINDOW_STRIDE * 4 + MMA_ROWS * MMA_ROWS
    for limit in (WINDOW_SMEM, SMEM_LIMIT):
        for SW in (256, 128, 64, 32, 16):
            if SW > Dp and SW > 16:
                continue
            stage = max(4 * MMA_ROWS * row(SW), MMA_COLS * row(CW))
            if 2 * stage + fixed <= limit:
                return WideLayout(Dp, groups, CW, SW, _cdiv(Dp, SW), False, False, stage, 2,
                                  2 * stage + fixed)
    raise ValueError(f"head dim {Dh}: no one-kernel wide backward layout fits")


def wide_plan(windows: int, W: int, Dh: int, dtype: torch.dtype, direction: str,
              causal: bool) -> K1Plan:
    """The wide kernels' launch (csrc/k1_wide.cuh) at a head dim ``Dh`` past
    128, at every W: blocks of 64 rows and 8
    warps, each warp 16 rows and half the block's output columns. At W <=
    MULTI_WINDOW a block holds ``windows_per_block`` = 64 // W whole windows
    (6 at W 10, 12 at W 5), else a 64-row tile of one window. A block owns
    every output column of its rows up to GROUP_COLS (256) of them, and
    computes each (row tile, key tile)'s logits once. Past 256 columns (Dh
    512: 2 groups) each block owns one group of at most 256 columns and the
    groups' blocks each compute the logits again, since 8 warps hold at most
    128 columns each in registers. So it is, too, on grids so small that
    twice their blocks still fit the card's SMs (SPLIT_BELOW): the groups
    double while a group keeps more than 64 columns (:func:`wide_groups`;
    the (8, 64, 64) Dh 512 case runs 64 blocks of 64 columns; the Dh-256
    prior's backbone (64, 96, 96), 128 blocks, is not split). Under causal
    with several row tiles a window, grids past SPLIT_BELOW blocks go
    tile-major, the tiles with the most work first. The forward is one
    kernel. The backward at W <= WIDE_WINDOW, where a block holds whole
    windows, is one kernel too (``blocks_kv`` 0; :func:`wide_window_layout`),
    past it the two-sweep dq kernel and the dk / dv kernel over the same
    blocks, with the rows' statistics between them (:func:`backward_scratch`);
    each of those kernels' shared memory is :func:`wide_layout`'s."""
    G = MMA_ROWS // W if W <= MULTI_WINDOW else 1
    tiles = 1 if G > 1 else _cdiv(W, MMA_ROWS)
    row_blocks = _cdiv(windows, G) * tiles
    groups = wide_groups(Dh, row_blocks)
    first = wide_layout(Dh, dtype, "fwd" if direction == "fwd" else "dq", groups)
    blocks = row_blocks * groups
    if direction == "fwd":
        return K1Plan("wide", direction, W, causal, windows, MMA_ROWS, MMA_COLS, G, blocks,
                      first.smem, 0, 0, first.groups)
    if W <= WIDE_WINDOW:
        return K1Plan("wide", direction, W, causal, windows, MMA_ROWS, MMA_ROWS, G, blocks,
                      wide_window_layout(Dh, dtype, groups).smem, 0, 0, groups)
    return K1Plan("wide", direction, W, causal, windows, MMA_ROWS, MMA_COLS, G, blocks,
                  first.smem, blocks, wide_layout(Dh, dtype, "dkv", groups).smem, first.groups)


def _windows_of(BH: int, S: int, W: int, Dh: int, dtype: torch.dtype, direction: str) -> int:
    """The windows of a launch; raises on what the kernels do not take."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction {direction!r} is not fwd or bwd")
    if dtype not in DTYPES:
        raise ValueError(f"q is {dtype}; the kernels take {DTYPES}")
    head_width(Dh)
    resolve_window(S, W)
    if BH < 0:
        raise ValueError(f"BH {BH} is negative")
    return BH * (S // W)


class RowLayout(NamedTuple):
    """Where a launch's rows lie (csrc/k1_tiles.cuh's Head): row n = b * H + h
    of the (B*H, S, Dh) problem keeps position s at element b * batch + h * Dh
    + s * pos of its tensor; q, k and v share ``in_pos`` / ``in_batch``, out
    (dout in the backward) ``out_*``, dq, dk and dv ``grad_*``. The C entry
    points take these after Dh (the forward the first five)."""
    H: int
    in_pos: int
    in_batch: int
    out_pos: int
    out_batch: int
    grad_pos: int = 0
    grad_batch: int = 0

    @staticmethod
    def contiguous(S: int, Dh: int) -> "RowLayout":
        """The 3-D op's (BH, S, Dh) rows: H = 1, a position Dh apart."""
        return RowLayout(1, Dh, S * Dh, Dh, S * Dh, Dh, S * Dh)

    def args(self, direction: str) -> tuple:
        return tuple(self) if direction == "bwd" else tuple(self)[:5]

    def strides(self, direction: str) -> tuple:
        return self.args(direction)[1:]


def qkv_layout(qkv: torch.Tensor, heads: int, out: torch.Tensor,
               grad: Optional[torch.Tensor] = None) -> RowLayout:
    """The fused launch's rows: q, k and v in the (B, S, 3d) ``qkv`` (k and v d
    and 2d columns on), out (dout) in the (B, S, d) ``out``, dq, dk and dv in
    the (B, S, 3d) ``grad``."""
    g = (grad.stride(1), grad.stride(0)) if grad is not None else (0, 0)
    return RowLayout(heads, qkv.stride(1), qkv.stride(0), out.stride(1), out.stride(0), *g)


def row_offset(layout: RowLayout, Dh: int, n: int, s: int, which: str = "in") -> int:
    """The element of position s of row n under ``layout`` (``which`` in, out
    or grad), as csrc/k1_tiles.cuh's flat_at computes it."""
    pos, batch = getattr(layout, which + "_pos"), getattr(layout, which + "_batch")
    b, h = divmod(n, layout.H)
    return b * batch + h * Dh + s * pos


def fold_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H Dh) -> the (B*H, S, Dh) rows, row b * H + h head h of batch row
    b (a copy where H > 1)."""
    B, S, d = x.shape
    return x.reshape(B, S, heads, d // heads).transpose(1, 2).reshape(B * heads, S, d // heads)


def unfold_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """:func:`fold_heads` undone: (B*H, S, Dh) -> (B, S, H Dh)."""
    BH, S, Dh = x.shape
    return x.reshape(BH // heads, heads, S, Dh).transpose(1, 2).reshape(BH // heads, S,
                                                                          heads * Dh)


def split_qkv(qkv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, ...]:
    """The (B*H, S, Dh) rows of q, k and v in a (B, S, 3d) projection output
    (:func:`fold_heads` of each third)."""
    return tuple(fold_heads(t, heads) for t in qkv.chunk(3, dim=-1))


def _check(q, k, v, bias, seed, W, direction, causal=False, extra=()) -> K1Plan:
    """Refuse what the kernels cannot take, and return the launch plan. Any
    (S, S) float32 bias is taken: the block-diagonal window mask, zeros and
    the causal mask are the model's; the kernels read only its diagonal
    (W, W) blocks."""
    BH, S, Dh = q.shape
    _same_shapes(q, ("k", k), ("v", v), *extra)
    if BH * S >= MAX_POSITIONS:
        raise ValueError(f"{BH} rows of {S} positions: K1 addresses fewer than {MAX_POSITIONS}")
    if bias.shape != (S, S):
        raise ValueError(f"bias must be ({S}, {S}), got {tuple(bias.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q is {q.dtype}; the kernels take {DTYPES}")
    for name, t, dtype in (("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype),
                           ("bias", bias, torch.float32),
                           *((n, t, q.dtype) for n, t in extra)):
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if seed is not None and (seed.device != q.device or seed.dtype != torch.int32
                             or seed.numel() < 1 or BH % seed.numel()):
        raise ValueError(f"seed must be int32 on {q.device}, one value per equal group "
                         f"of the {BH} rows")
    return k1_plan(BH, S, W, Dh, q.dtype, direction, causal)


def _seed_args(seed, dropout_rate: float, BH: int) -> Tuple[int, int]:
    """The seed pointer and the rows of a seed group, as the kernels take them."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    if dropout_rate == 0.0:
        return 0, BH
    return seed.data_ptr(), BH // seed.numel()


def _count(direction: str, plan: K1Plan, dtype, fused: bool = False) -> None:
    COUNTER[direction, dtype].add()
    if fused:
        QKV_COUNTER[direction, dtype].add()
    if plan.path == "wide":
        WIDE_COUNTER[direction, dtype].add()
        return
    if plan.path == "multi":
        MULTI_COUNTER[direction, dtype].add()
    if plan.path == "mma":
        MMA_COUNTER[direction, dtype].add()
    if plan.blocks_kv:
        LONG_COUNTER[direction, dtype].add()


def _same_shapes(q, *named) -> None:
    for name, t in named:
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")


def _form(plan: K1Plan) -> str:
    """The entry point's suffix for the plan's form: each entry point's ragged
    form is a library of its own (``<entry>_ragged``), built beside the native
    one; a launch counts on the entry point's counters either way."""
    return "_ragged" if plan.ragged else ""


def _launch_fwd(q, k, v, bias, scale, seed, dropout_rate, window, causal=False):
    """The forward's launch on contiguous (BH, S, Dh) rows, at any head dim
    (the plan's staged width and copies)."""
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    plan = _check(q, k, v, bias, seed, W, "fwd", causal)
    out = torch.empty_like(q)
    _fwd_call(plan, (q, k, v, out), bias, BH, S, Dh, RowLayout.contiguous(S, Dh), scale, seed,
              dropout_rate, causal)
    return out


def _fwd_call(plan: K1Plan, ptrs, bias, BH, S, Dh, layout: RowLayout, scale, seed,
              dropout_rate, causal, fused: bool = False) -> None:
    """The forward's C call: q, k, v and out (tensors or, in the fused form, the
    tensor that holds them and their addresses) at ``layout``. An empty problem
    (no rows or no positions) launches nothing: its output is empty."""
    if BH == 0 or S == 0:
        return
    q = ptrs[0]
    addr = [t if isinstance(t, int) else t.data_ptr() for t in ptrs[1:]]
    plan = plan._replace(copy_bytes=copy_bytes(Dh, q.dtype, layout.strides("fwd"),
                                               (q.data_ptr(), *addr)))
    name = (WIDE_ENTRY if plan.path == "wide" else ENTRY)["fwd", q.dtype] + _form(plan)
    fn = kernels.entry(name)
    status = fn(q.data_ptr(), *addr[:2], bias.data_ptr(), addr[2], BH, S, plan.W, Dh,
                *layout.args("fwd"), float(scale), *_seed_args(seed, dropout_rate, BH),
                keep_threshold(dropout_rate), _inv_keep(dropout_rate),
                int(dropout_rate > 0.0), int(causal), PATH_CODE[plan.path], plan.blocks,
                plan.smem_bytes, plan.copy_bytes, kernels.stream_ptr(q))
    kernels.check(name, status)
    _count("fwd", plan, q.dtype, fused)


def _launch_bwd(q, k, v, bias, dout, scale, seed, dropout_rate, window, causal=False):
    """The backward's launch on contiguous rows, at any head dim (as
    :func:`_launch_fwd`)."""
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    plan = _check(q, k, v, bias, seed, W, "bwd", causal, extra=(("dout", dout),))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _bwd_call(plan, (q, k, v, dout, dq, dk, dv), bias, BH, S, Dh,
              RowLayout.contiguous(S, Dh), scale, seed, dropout_rate, causal)
    return dq, dk, dv


def _bwd_call(plan: K1Plan, ptrs, bias, BH, S, Dh, layout: RowLayout, scale, seed,
              dropout_rate, causal, fused: bool = False) -> None:
    """The backward's C call: q, k, v, dout, dq, dk and dv (tensors or addresses,
    as :func:`_fwd_call`) at ``layout``; an empty problem launches nothing."""
    if BH == 0 or S == 0:
        return
    q = ptrs[0]
    addr = [t if isinstance(t, int) else t.data_ptr() for t in ptrs[1:]]
    plan = plan._replace(copy_bytes=copy_bytes(Dh, q.dtype, layout.strides("bwd"),
                                               (q.data_ptr(), *addr)))
    # what the two-kernel backward's first kernel hands its second
    scratch = backward_scratch(plan)
    stats = torch.empty(scratch, dtype=torch.float32, device=q.device) if scratch else None
    name = (WIDE_ENTRY["bwd", q.dtype] if plan.path == "wide"
            else LONG_ENTRY[q.dtype] if plan.blocks_kv else ENTRY["bwd", q.dtype]) + _form(plan)
    fn = kernels.entry(name)
    status = fn(q.data_ptr(), *addr[:2], bias.data_ptr(), *addr[2:],
                0 if stats is None else stats.data_ptr(),
                BH, S, plan.W, Dh, *layout.args("bwd"), float(scale),
                *_seed_args(seed, dropout_rate, BH),
                keep_threshold(dropout_rate), _inv_keep(dropout_rate),
                int(dropout_rate > 0.0), int(causal), PATH_CODE[plan.path], plan.blocks,
                plan.smem_bytes, plan.blocks_kv, plan.smem_kv, plan.copy_bytes,
                kernels.stream_ptr(q))
    kernels.check(name, status)
    _count("bwd", plan, q.dtype, fused)


def _check_qkv(qkv, heads: int, bias, seed, window, direction, causal, dout=None) -> tuple:
    """Refuse what the fused launch cannot take; return (plan, B, S, d, Dh).
    Any strides whose last is 1 are taken: the kernels address them."""
    if qkv.dim() != 3 or heads < 1 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (B, S, 3 d) with d a multiple of "
                         f"{heads} heads")
    B, S, d3 = qkv.shape
    d = d3 // 3
    Dh, BH = d // heads, B * heads
    if qkv.dtype not in DTYPES:
        raise ValueError(f"qkv is {qkv.dtype}; the kernels take {DTYPES}")
    if bias.shape != (S, S) or bias.dtype != torch.float32 or bias.device != qkv.device:
        raise ValueError(f"bias must be a ({S}, {S}) float32 tensor on {qkv.device}")
    if BH * S >= MAX_POSITIONS:
        raise ValueError(f"{BH} rows of {S} positions: K1 addresses fewer than {MAX_POSITIONS}")
    for name, t, shape in (("qkv", qkv, (B, S, 3 * d)), ("dout", dout, (B, S, d))):
        if t is None:
            continue
        if t.shape != shape or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be a {shape} {qkv.dtype} tensor on {qkv.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if t.stride(1) >= MAX_POSITIONS:
            raise ValueError(f"{name}'s positions lie {t.stride(1)} elements apart: K1 takes "
                             f"fewer than {MAX_POSITIONS}")
    if seed is not None and (seed.device != qkv.device or seed.dtype != torch.int32
                             or seed.numel() < 1 or BH % seed.numel()):
        raise ValueError(f"seed must be int32 on {qkv.device}, one value per equal group "
                         f"of the {BH} rows")
    return k1_plan(BH, S, resolve_window(S, window), Dh, qkv.dtype, direction, causal), B, S, d, Dh


def _launch_qkv_fwd(qkv, heads, bias, scale, seed, dropout_rate, window, causal=False):
    """The forward of the fused layout: q, k, v read where the projection
    wrote them, out written as (B, S, d)."""
    plan, B, S, d, Dh = _check_qkv(qkv, heads, bias, seed, window, "fwd", causal)
    out = torch.empty(B, S, d, dtype=qkv.dtype, device=qkv.device)
    E, base = qkv.dtype.itemsize, qkv.data_ptr()
    layout = qkv_layout(qkv, heads, out)
    _fwd_call(plan, (qkv, base + d * E, base + 2 * d * E, out), bias, B * heads, S, Dh, layout,
              scale, seed, dropout_rate, causal, fused=True)
    return out


def _launch_qkv_bwd(qkv, heads, bias, dout, scale, seed, dropout_rate, window, causal=False):
    """The backward of the fused layout: d(qkv) as one (B, S, 3d) tensor, dq,
    dk and dv each written into its own column block (every element is
    written)."""
    plan, B, S, d, Dh = _check_qkv(qkv, heads, bias, seed, window, "bwd", causal, dout)
    grad = torch.empty(B, S, 3 * d, dtype=qkv.dtype, device=qkv.device)
    E, base, gbase = qkv.dtype.itemsize, qkv.data_ptr(), grad.data_ptr()
    layout = qkv_layout(qkv, heads, dout, grad)
    _bwd_call(plan, (qkv, base + d * E, base + 2 * d * E, dout, grad, gbase + d * E,
                     gbase + 2 * d * E), bias, B * heads, S, Dh, layout, scale, seed,
              dropout_rate, causal, fused=True)
    return grad


# ---------------------------------------------------------------- custom ops
#
# The dispatcher picks the implementation from the tensors' device; no device
# but cuda and cpu has one. ``window`` reaches the ops resolved. Outside a
# trace, CUDA tensors skip the dispatch and call the CUDA implementations
# themselves (``kernels.eager_cuda``).

_FWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? seed, float scale, "
               "float dropout_rate, int window, bool causal=False) -> Tensor")
_BWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor dout, Tensor? seed, "
               "float scale, float dropout_rate, int window, bool causal=False) "
               "-> (Tensor, Tensor, Tensor)")


def _fwd_cpu(q, k, v, bias, seed, scale, dropout_rate, window, causal=False):
    return packed_attention_reference(q, k, v, bias, scale, seed, dropout_rate, window, causal)


def _bwd_cpu(q, k, v, bias, dout, seed, scale, dropout_rate, window, causal=False):
    return packed_attention_bwd_reference(q, k, v, bias, dout, scale, seed, dropout_rate,
                                          window, causal)


fwd_op = torch.library.custom_op("bridgerl::packed_attention_fwd", _fwd_cpu, mutates_args=(),
                                 device_types="cpu", schema=_FWD_SCHEMA)
bwd_op = torch.library.custom_op("bridgerl::packed_attention_bwd", _bwd_cpu, mutates_args=(),
                                 device_types="cpu", schema=_BWD_SCHEMA)


# The kernels read contiguous rows. An exported graph may hand the ops a view
# where the traced batch made a copy (a reshape after the head transpose is a
# view at b = 1), so the CUDA implementations copy such inputs first.

@fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, bias, seed, scale, dropout_rate, window, causal=False):
    q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    return _launch_fwd(q, k, v, bias, scale, seed, dropout_rate, window, causal)


@bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, bias, dout, seed, scale, dropout_rate, window, causal=False):
    q, k, v, bias, dout = (t.contiguous() for t in (q, k, v, bias, dout))
    return _launch_bwd(q, k, v, bias, dout, scale, seed, dropout_rate, window, causal)


@fwd_op.register_fake
def _fwd_fake(q, k, v, bias, seed, scale, dropout_rate, window, causal=False):
    return torch.empty_like(q)


@bwd_op.register_fake
def _bwd_fake(q, k, v, bias, dout, seed, scale, dropout_rate, window, causal=False):
    return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)


def _fwd_setup(ctx, inputs, output):
    q, k, v, bias, seed, scale, dropout_rate, window, *causal = inputs   # causal may be left out
    ctx.save_for_backward(q, k, v, bias, seed)
    ctx.scale, ctx.dropout_rate, ctx.window = scale, dropout_rate, window
    ctx.causal = bool(causal and causal[0])


def _bwd(q, k, v, bias, dout, seed, scale, dropout_rate, window, causal):
    if kernels.eager_cuda(q):
        return _bwd_cuda(q, k, v, bias, dout, seed, scale, dropout_rate, window, causal)
    return bwd_op(q, k, v, bias, dout, seed, scale, dropout_rate, window, causal)


def _fwd_backward(ctx, dout):
    """K1's backward: bias, seed, scale, rate, window and causal get no
    gradient (the TPU kernel gives bias a zero cotangent: it is the constant
    mask)."""
    q, k, v, bias, seed = ctx.saved_tensors
    dq, dk, dv = _bwd(q, k, v, bias, dout, seed, ctx.scale, ctx.dropout_rate, ctx.window,
                      ctx.causal)
    return dq, dk, dv, None, None, None, None, None, None


fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


class _EagerAttention(torch.autograd.Function):
    """The op's CUDA implementation and autograd formula, called without
    the op's dispatch (``kernels.eager_cuda``)."""
    forward = staticmethod(_fwd_cuda)
    setup_context = staticmethod(_fwd_setup)
    backward = staticmethod(_fwd_backward)


def attention_fwd(q, k, v, bias, scale: float, seed: Optional[torch.Tensor],
                  dropout_rate: float = 0.0, window: Optional[int] = None,
                  causal: bool = False) -> torch.Tensor:
    """K1's forward, differentiable in q, k and v (its backward recomputes
    the probabilities and the dropout mask, as the TPU kernel's custom VJP
    does): the kernel for CUDA tensors, the plain version for CPU tensors.
    ``seed`` is an int32 tensor on q's device of one value, or of one per
    equal group of rows (the module docstring), read only when
    ``dropout_rate`` > 0. ``causal``: the bias is the causal bias (module
    docstring)."""
    args = (q, k, v, bias, seed, float(scale), float(dropout_rate),
            resolve_window(q.shape[1], window), bool(causal))
    return _EagerAttention.apply(*args) if kernels.eager_cuda(q) else fwd_op(*args)


def attention_bwd(q, k, v, bias, dout, scale: float, seed: Optional[torch.Tensor],
                  dropout_rate: float = 0.0, window: Optional[int] = None,
                  causal: bool = False):
    """K1's backward (dq, dk, dv): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _bwd(q, k, v, bias, dout, seed, float(scale), float(dropout_rate),
                resolve_window(q.shape[1], window), bool(causal))


# ---------------------------------------------------------------- the fused layout
#
# The same kernels on the projection's (B, S, 3d) output as it is (module docstring). The
# plain versions fold, call the 3-D plain versions and unfold; the CUDA implementations copy
# only an input whose last dimension is not contiguous (an input conversion: the model's
# tensors never take it).

_QKV_FWD_SCHEMA = ("(Tensor qkv, int heads, Tensor bias, Tensor? seed, float scale, "
                   "float dropout_rate, int window, bool causal=False) -> Tensor")
_QKV_BWD_SCHEMA = ("(Tensor qkv, int heads, Tensor bias, Tensor dout, Tensor? seed, "
                   "float scale, float dropout_rate, int window, bool causal=False) -> Tensor")


def _qkv_fwd_cpu(qkv, heads, bias, seed, scale, dropout_rate, window, causal=False):
    q, k, v = split_qkv(qkv, heads)
    return unfold_heads(packed_attention_reference(q, k, v, bias, scale, seed, dropout_rate,
                                                   window, causal), heads)


def _qkv_bwd_cpu(qkv, heads, bias, dout, seed, scale, dropout_rate, window, causal=False):
    q, k, v = split_qkv(qkv, heads)
    grads = packed_attention_bwd_reference(q, k, v, bias, fold_heads(dout, heads), scale, seed,
                                           dropout_rate, window, causal)
    return torch.cat([unfold_heads(t, heads) for t in grads], dim=-1)


qkv_fwd_op = torch.library.custom_op("bridgerl::packed_attention_qkv_fwd", _qkv_fwd_cpu,
                                     mutates_args=(), device_types="cpu",
                                     schema=_QKV_FWD_SCHEMA)
qkv_bwd_op = torch.library.custom_op("bridgerl::packed_attention_qkv_bwd", _qkv_bwd_cpu,
                                     mutates_args=(), device_types="cpu",
                                     schema=_QKV_BWD_SCHEMA)


def _addressable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is where the kernels can address its rows (its last
    dimension contiguous), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


@qkv_fwd_op.register_kernel("cuda")
def _qkv_fwd_cuda(qkv, heads, bias, seed, scale, dropout_rate, window, causal=False):
    return _launch_qkv_fwd(_addressable(qkv), heads, bias.contiguous(), scale, seed,
                           dropout_rate, window, causal)


@qkv_bwd_op.register_kernel("cuda")
def _qkv_bwd_cuda(qkv, heads, bias, dout, seed, scale, dropout_rate, window, causal=False):
    return _launch_qkv_bwd(_addressable(qkv), heads, bias.contiguous(), _addressable(dout),
                           scale, seed, dropout_rate, window, causal)


@qkv_fwd_op.register_fake
def _qkv_fwd_fake(qkv, heads, bias, seed, scale, dropout_rate, window, causal=False):
    B, S, d3 = qkv.shape
    return qkv.new_empty(B, S, d3 // 3)


@qkv_bwd_op.register_fake
def _qkv_bwd_fake(qkv, heads, bias, dout, seed, scale, dropout_rate, window, causal=False):
    return torch.empty_like(qkv, memory_format=torch.contiguous_format)


def _qkv_setup(ctx, inputs, output):
    qkv, heads, bias, seed, scale, dropout_rate, window, *causal = inputs
    ctx.save_for_backward(qkv, bias, seed)
    ctx.heads, ctx.scale, ctx.dropout_rate, ctx.window = heads, scale, dropout_rate, window
    ctx.causal = bool(causal and causal[0])


def _qkv_bwd(qkv, heads, bias, dout, seed, scale, dropout_rate, window, causal):
    if kernels.eager_cuda(qkv):
        return _qkv_bwd_cuda(qkv, heads, bias, dout, seed, scale, dropout_rate, window, causal)
    return qkv_bwd_op(qkv, heads, bias, dout, seed, scale, dropout_rate, window, causal)


def _qkv_backward(ctx, dout):
    """d(qkv) in one tensor; nothing else gets a gradient (as :func:`_fwd_backward`)."""
    qkv, bias, seed = ctx.saved_tensors
    grad = _qkv_bwd(qkv, ctx.heads, bias, dout, seed, ctx.scale, ctx.dropout_rate, ctx.window,
                    ctx.causal)
    return grad, None, None, None, None, None, None, None


qkv_fwd_op.register_autograd(_qkv_backward, setup_context=_qkv_setup)


class _EagerQKV(torch.autograd.Function):
    """The fused op's CUDA implementation and autograd formula, called without
    the op's dispatch (``kernels.eager_cuda``)."""
    forward = staticmethod(_qkv_fwd_cuda)
    setup_context = staticmethod(_qkv_setup)
    backward = staticmethod(_qkv_backward)


def attention_qkv(qkv: torch.Tensor, heads: int, bias: torch.Tensor, scale: float,
                  seed: Optional[torch.Tensor], dropout_rate: float = 0.0,
                  window: Optional[int] = None, causal: bool = False) -> torch.Tensor:
    """K1's forward on the projection's (B, S, 3d) output as it is, out as
    (B, S, d); differentiable in qkv, whose gradient comes back as one (B, S,
    3d) tensor. Rows, seed and arguments as :func:`attention_fwd` on the
    :func:`split_qkv` copies, and bit for bit its result."""
    args = (qkv, int(heads), bias, seed, float(scale), float(dropout_rate),
            resolve_window(qkv.shape[1], window), bool(causal))
    return _EagerQKV.apply(*args) if kernels.eager_cuda(qkv) else qkv_fwd_op(*args)


def attention_qkv_bwd(qkv, heads: int, bias, dout, scale: float, seed: Optional[torch.Tensor],
                      dropout_rate: float = 0.0, window: Optional[int] = None,
                      causal: bool = False) -> torch.Tensor:
    """The fused layout's backward: d(qkv), (B, S, 3d), for dout (B, S, d)."""
    return _qkv_bwd(qkv, int(heads), bias, dout, seed, float(scale), float(dropout_rate),
                    resolve_window(qkv.shape[1], window), bool(causal))


def draw_seed(generator: Optional[Generators], device) -> torch.Tensor:
    """One seed in [0, 2**31 - 1) from ``generator``, kept on ``device`` so
    that drawing it does not wait for the card; given one generator per seed
    of a stacked step, one seed from each, in their order."""
    if generator is None:
        raise ValueError("attention dropout needs an explicit torch.Generator")
    if isinstance(generator, torch.Generator):
        return torch.randint(0, SEED_HIGH, (1,), generator=generator, device=device,
                             dtype=torch.int32)
    return torch.cat([draw_seed(g, device) for g in generator])


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float, dropout_rate: float = 0.0,
                     generator: Optional[Generators] = None,
                     window: Optional[int] = None, causal: bool = False) -> torch.Tensor:
    """dropout(softmax(q k^T * scale + bias)) v for (B*H, S, Dh) q, k, v
    (float32 or bfloat16, out in their dtype) and (S, S) float32 bias, within
    windows of ``window`` positions (default S), differentiable in q, k and v.

    With ``dropout_rate`` > 0 the seed is drawn once from ``generator``;
    with a sequence of G generators (a stacked step's seeds, whose rows are
    G equal groups, seed-major) one seed from each, one launch for all.
    ``causal`` states that ``bias`` is the causal bias (the token prior).
    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    versions. There is no fallback from one to the other.
    """
    seed = draw_seed(generator, q.device) if dropout_rate > 0.0 else None
    return attention_fwd(q, k, v, bias, scale, seed, dropout_rate, window, causal)


def packed_attention_qkv(qkv: torch.Tensor, heads: int, bias: torch.Tensor, scale: float,
                         dropout_rate: float = 0.0, generator: Optional[Generators] = None,
                         window: Optional[int] = None, causal: bool = False) -> torch.Tensor:
    """:func:`packed_attention` on the projection's (B, S, 3d) output: q, k and
    v are its thirds, each ``heads`` heads of d / heads columns; out is (B, S,
    d) (:func:`attention_qkv`). The seed is drawn as :func:`packed_attention`
    draws it."""
    seed = draw_seed(generator, qkv.device) if dropout_rate > 0.0 else None
    return attention_qkv(qkv, heads, bias, scale, seed, dropout_rate, window, causal)
