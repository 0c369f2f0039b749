"""K1: packed-window attention over (B*H, S, Dh) rows, forward and backward.

The counterpart of ``bridgerl_tpu/ops/pallas/attention.py``
(``_packed_attention_fwd`` and ``_packed_attention_bwd``):
``out = dropout(softmax(q k^T * scale + bias)) v`` with an f32 softmax, where
``bias`` is one (S, S) additive term shared by every row: the block-diagonal
window mask as 0 / -1e9, or zeros.

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
``csrc/packed_attention.cu`` (forward) or ``csrc/packed_attention_bwd.cu``
(backward); on a CPU tensor its plain version,
:func:`packed_attention_reference` or :func:`packed_attention_bwd_reference`.

q, k, v and dout are float32 or bfloat16, all four alike; the bias is always
float32. As in the TPU kernel, bfloat16 inputs are widened to float32 as they
are read, everything inside (logits, softmax, dropout, both products) is
float32, and out, dq, dk and dv are rounded to q's dtype once, at the end
(round to nearest even). Each kernel has a float32 and a bfloat16 entry
point, and each counts its launches on its own counter.

The forward op's registered autograd formula calls the backward op, which
recomputes the probabilities and the dropout mask, as the TPU kernel's
custom VJP does.

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

from typing import Optional, Sequence, Tuple, Union

import torch

from . import kernels

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_ROW_WARPS = 8                # kRowWarps in both csrc/packed_attention*.cu
_SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
SEED_HIGH = 2 ** 31 - 1       # seeds are drawn from [0, SEED_HIGH), as in JAX
DTYPES = (torch.float32, torch.bfloat16)

# the C entry point of each kernel and input dtype; a wrapper counts each
# entry point's launches on the counter of the same name
ENTRY = {("fwd", torch.float32): "packed_attention_fwd",
         ("fwd", torch.bfloat16): "packed_attention_fwd_bf16",
         ("bwd", torch.float32): "packed_attention_bwd",
         ("bwd", torch.bfloat16): "packed_attention_bwd_bf16"}
COUNTER = {key: kernels.LaunchCounter(name) for key, name in ENTRY.items()}

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
    """The window length: S when ``window`` is None; it must divide S."""
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


def _probs(q, k, bias, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
    return torch.softmax(s, dim=-1)


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, scale: float, seed: Seed = 0,
                               dropout_rate: float = 0.0,
                               window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K1's forward, window by window, in float32;
    the result is rounded to q's dtype."""
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    p = _probs(_windows(q32, W), _windows(k32, W), _window_bias(bias, W), scale)
    if dropout_rate > 0.0:
        keep = window_dropout_mask(seed, BH, S, W, dropout_rate, q.device)
        p = torch.where(keep, p * _inv_keep(dropout_rate), 0.0)
    return torch.matmul(p, _windows(v32, W)).reshape(BH, S, Dh).to(q.dtype)


def packed_attention_bwd_reference(q, k, v, bias, dout, scale: float, seed: Seed = 0,
                                   dropout_rate: float = 0.0,
                                   window: Optional[int] = None):
    """Plain PyTorch version of K1's backward, window by window, written out
    as the TPU kernel's ``_attn_bwd_kernel`` is: recompute p and the mask,
    then dv = p_drop^T do, dp = keep * (do v^T) / keep_prob,
    ds = p * (dp - sum(dp * p)) * scale, dq = ds k, dk = ds^T q. It computes
    in float32 and rounds dq, dk and dv to q's dtype."""
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    dtype = q.dtype
    q, k, v, dout = (_windows(t.float(), W) for t in (q, k, v, dout))
    p = _probs(q, k, _window_bias(bias, W), scale)
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


# ---------------------------------------------------------------- kernels
#
# Each kernel source has two code paths, and the C launcher picks the first
# whose shared memory fits one block (the formulas below mirror it):
#   window tiles: whole windows staged in shared memory, padded rows of
#     Dh + 4 floats, and the (W, W + 1) probability tiles;
#   rows: for windows too large to tile, one block per window that stages
#     K and V (forward) or two of q, k, v, dout per pass (backward) with
#     rows of Dh + 1, one warp per query row.

def _fwd_smem_bytes(W: int, Dh: int) -> int:
    """Least shared memory a forward block needs for one window."""
    tile = 3 * W * (Dh + 4) + 2 * W * (W + 1) + W
    rows = W * (2 * Dh + 1) + _ROW_WARPS * W
    return 4 * min(tile, rows)


def _bwd_smem_bytes(W: int, Dh: int) -> int:
    """Least shared memory a backward block needs for one window."""
    tile = 4 * W * (Dh + 4) + 3 * W * (W + 1)
    rows = 2 * W * (Dh + 1) + 2 * _ROW_WARPS * W + 3 * W
    return 4 * min(tile, rows)


def _check(q, k, v, bias, seed, W, smem_bytes, extra=()):
    BH, S, Dh = q.shape
    for name, t in (("k", k), ("v", v), *extra):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
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
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {SUPPORTED_HEAD_DIMS}")
    if smem_bytes(W, Dh) > _SMEM_LIMIT:
        raise ValueError(f"window {W}, Dh={Dh} needs more shared memory than a block has")


def _seed_args(seed, dropout_rate: float, BH: int) -> Tuple[int, int]:
    """The seed pointer and the rows of a seed group, as the kernels take them."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    if dropout_rate == 0.0:
        return 0, BH
    return seed.data_ptr(), BH // seed.numel()


def _launch_fwd(q, k, v, bias, scale, seed, dropout_rate, window):
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    _check(q, k, v, bias, seed, W, _fwd_smem_bytes)
    out = torch.empty_like(q)
    if BH == 0:
        return out
    name = ENTRY["fwd", q.dtype]
    fn = kernels.entry(name)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), BH, S, W, Dh, float(scale), *_seed_args(seed, dropout_rate, BH),
                keep_threshold(dropout_rate), _inv_keep(dropout_rate),
                int(dropout_rate > 0.0), kernels.stream_ptr(q))
    kernels.check(name, status)
    COUNTER["fwd", q.dtype].add()
    return out


def _launch_bwd(q, k, v, bias, dout, scale, seed, dropout_rate, window):
    BH, S, Dh = q.shape
    W = resolve_window(S, window)
    _check(q, k, v, bias, seed, W, _bwd_smem_bytes, extra=(("dout", dout),))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if BH == 0:
        return dq, dk, dv
    name = ENTRY["bwd", q.dtype]
    fn = kernels.entry(name)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                BH, S, W, Dh, float(scale), *_seed_args(seed, dropout_rate, BH),
                keep_threshold(dropout_rate), _inv_keep(dropout_rate),
                int(dropout_rate > 0.0), kernels.stream_ptr(q))
    kernels.check(name, status)
    COUNTER["bwd", q.dtype].add()
    return dq, dk, dv


# ---------------------------------------------------------------- custom ops
#
# The dispatcher picks the implementation from the tensors' device; no device
# but cuda and cpu has one. ``window`` reaches the ops resolved. Outside a
# trace, CUDA tensors skip the dispatch and call the CUDA implementations
# themselves (``kernels.eager_cuda``).

_FWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? seed, float scale, "
               "float dropout_rate, int window) -> Tensor")
_BWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor dout, Tensor? seed, "
               "float scale, float dropout_rate, int window) -> (Tensor, Tensor, Tensor)")


def _fwd_cpu(q, k, v, bias, seed, scale, dropout_rate, window):
    return packed_attention_reference(q, k, v, bias, scale, seed, dropout_rate, window)


def _bwd_cpu(q, k, v, bias, dout, seed, scale, dropout_rate, window):
    return packed_attention_bwd_reference(q, k, v, bias, dout, scale, seed, dropout_rate,
                                          window)


fwd_op = torch.library.custom_op("bridgerl::packed_attention_fwd", _fwd_cpu, mutates_args=(),
                                 device_types="cpu", schema=_FWD_SCHEMA)
bwd_op = torch.library.custom_op("bridgerl::packed_attention_bwd", _bwd_cpu, mutates_args=(),
                                 device_types="cpu", schema=_BWD_SCHEMA)


# The kernels read contiguous rows. An exported graph may hand the ops a view
# where the traced batch made a copy (a reshape after the head transpose is a
# view at b = 1), so the CUDA implementations copy such inputs first.

@fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, bias, seed, scale, dropout_rate, window):
    q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    return _launch_fwd(q, k, v, bias, scale, seed, dropout_rate, window)


@bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, bias, dout, seed, scale, dropout_rate, window):
    q, k, v, bias, dout = (t.contiguous() for t in (q, k, v, bias, dout))
    return _launch_bwd(q, k, v, bias, dout, scale, seed, dropout_rate, window)


@fwd_op.register_fake
def _fwd_fake(q, k, v, bias, seed, scale, dropout_rate, window):
    return torch.empty_like(q)


@bwd_op.register_fake
def _bwd_fake(q, k, v, bias, dout, seed, scale, dropout_rate, window):
    return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)


def _fwd_setup(ctx, inputs, output):
    q, k, v, bias, seed, scale, dropout_rate, window = inputs
    ctx.save_for_backward(q, k, v, bias, seed)
    ctx.scale, ctx.dropout_rate, ctx.window = scale, dropout_rate, window


def _bwd(q, k, v, bias, dout, seed, scale, dropout_rate, window):
    if kernels.eager_cuda(q):
        return _bwd_cuda(q, k, v, bias, dout, seed, scale, dropout_rate, window)
    return bwd_op(q, k, v, bias, dout, seed, scale, dropout_rate, window)


def _fwd_backward(ctx, dout):
    """K1's backward: bias, seed, scale, rate and window get no gradient (the
    TPU kernel gives bias a zero cotangent: it is the constant mask)."""
    q, k, v, bias, seed = ctx.saved_tensors
    dq, dk, dv = _bwd(q, k, v, bias, dout, seed, ctx.scale, ctx.dropout_rate, ctx.window)
    return dq, dk, dv, None, None, None, None, None


fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


class _EagerAttention(torch.autograd.Function):
    """The op's CUDA implementation and autograd formula, called without
    the op's dispatch (``kernels.eager_cuda``)."""
    forward = staticmethod(_fwd_cuda)
    setup_context = staticmethod(_fwd_setup)
    backward = staticmethod(_fwd_backward)


def attention_fwd(q, k, v, bias, scale: float, seed: Optional[torch.Tensor],
                  dropout_rate: float = 0.0, window: Optional[int] = None) -> torch.Tensor:
    """K1's forward, differentiable in q, k and v (its backward recomputes
    the probabilities and the dropout mask, as the TPU kernel's custom VJP
    does): the kernel for CUDA tensors, the plain version for CPU tensors.
    ``seed`` is an int32 tensor on q's device of one value, or of one per
    equal group of rows (the module docstring), read only when
    ``dropout_rate`` > 0."""
    args = (q, k, v, bias, seed, float(scale), float(dropout_rate),
            resolve_window(q.shape[1], window))
    return _EagerAttention.apply(*args) if kernels.eager_cuda(q) else fwd_op(*args)


def attention_bwd(q, k, v, bias, dout, scale: float, seed: Optional[torch.Tensor],
                  dropout_rate: float = 0.0, window: Optional[int] = None):
    """K1's backward (dq, dk, dv): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _bwd(q, k, v, bias, dout, seed, float(scale), float(dropout_rate),
                resolve_window(q.shape[1], window))


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
                     window: Optional[int] = None) -> torch.Tensor:
    """dropout(softmax(q k^T * scale + bias)) v for (B*H, S, Dh) q, k, v
    (float32 or bfloat16, out in their dtype) and (S, S) float32 bias, within
    windows of ``window`` positions (default S), differentiable in q, k and v.

    With ``dropout_rate`` > 0 the seed is drawn once from ``generator``;
    with a sequence of G generators (a stacked step's seeds, whose rows are
    G equal groups, seed-major) one seed from each, one launch for all.
    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    versions. There is no fallback from one to the other.
    """
    seed = draw_seed(generator, q.device) if dropout_rate > 0.0 else None
    return attention_fwd(q, k, v, bias, scale, seed, dropout_rate, window)
