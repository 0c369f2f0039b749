"""K1: packed-window attention over (B*H, S, Dh) rows, forward and backward.

The counterpart of ``bridgerl_tpu/ops/pallas/attention.py``
(``_packed_attention_fwd`` and ``_packed_attention_bwd``):
``out = dropout(softmax(q k^T * scale + bias)) v`` with an f32 softmax, where
``bias`` is one (S, S) additive term shared by every row: the block-diagonal
window mask as 0 / -1e9, or zeros.

A CUDA tensor goes to the hand-written kernels ``csrc/packed_attention.cu``
(forward) and ``csrc/packed_attention_bwd.cu`` (backward); a CPU tensor goes
to the plain versions :func:`packed_attention_reference` and
:func:`packed_attention_bwd_reference`. :class:`PackedAttention` ties them
into one autograd function whose backward recomputes the probabilities and
the dropout mask, as the TPU kernel's custom VJP does.

Dropout is counter-based, so the backward regenerates the forward's mask
from the seed alone. The generator is Philox4x32-10 (Salmon et al., SC'11),
written once in CUDA and once here: key (seed, 0), counter
(i*S + j, row, 0, 0), first output word. An element is kept when its word is
below ``uint32(keep * 2**32)`` and is then scaled by ``1 / keep``. Each
(batch*head) row draws its own mask; the TPU kernel does the same (one PRNG
stream per grid program), while flax's default attention shares one mask
across the batch.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import kernels

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_WARPS = 8                    # kWarps in both csrc/packed_attention*.cu
_SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
SEED_HIGH = 2 ** 31 - 1       # seeds are drawn from [0, SEED_HIGH), as in JAX

launch_counter = kernels.LaunchCounter("packed_attention_fwd")
bwd_launch_counter = kernels.LaunchCounter("packed_attention_bwd")

Seed = Union[int, torch.Tensor]

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


def attention_dropout_mask(seed: Seed, BH: int, S: int, dropout_rate: float = 0.1,
                           device=None) -> torch.Tensor:
    """Plain version of the kernels' keep mask: bool (BH, S, S)."""
    seed = int(seed)
    ij = torch.arange(S * S, dtype=torch.int64, device=device)
    row = torch.arange(BH, dtype=torch.int64, device=device)[:, None]
    bits = philox4x32((ij[None, :], row, 0, 0), (seed & _U32, 0))[0]
    return (bits < keep_threshold(dropout_rate)).reshape(BH, S, S)


def _inv_keep(dropout_rate: float) -> float:
    return 1.0 / (1.0 - dropout_rate)


# ---------------------------------------------------------------- plain versions

def _probs(q, k, bias, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
    return torch.softmax(s, dim=-1)


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, scale: float, seed: Seed = 0,
                               dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of K1's forward."""
    p = _probs(q, k, bias, scale)
    if dropout_rate > 0.0:
        keep = attention_dropout_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device)
        p = torch.where(keep, p * _inv_keep(dropout_rate), 0.0)
    return torch.matmul(p, v)


def packed_attention_bwd_reference(q, k, v, bias, dout, scale: float, seed: Seed = 0,
                                   dropout_rate: float = 0.0):
    """Plain PyTorch version of K1's backward, written out as the TPU
    kernel's ``_attn_bwd_kernel`` is: recompute p and the mask, then
    dv = p_drop^T do, dp = keep * (do v^T) / keep_prob,
    ds = p * (dp - sum(dp * p)) * scale, dq = ds k, dk = ds^T q."""
    p = _probs(q, k, bias, scale)
    if dropout_rate > 0.0:
        keep = attention_dropout_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device)
        inv = _inv_keep(dropout_rate)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, torch.matmul(dout, v.transpose(-1, -2)) * inv, 0.0)
    else:
        p_drop = p
        dp = torch.matmul(dout, v.transpose(-1, -2))
    dv = torch.matmul(p_drop.transpose(-1, -2), dout)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * scale
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


# ---------------------------------------------------------------- kernels

def _fwd_smem_bytes(S: int, Dh: int) -> int:
    return 4 * (S * (2 * Dh + 1) + _WARPS * S)


def _bwd_smem_bytes(S: int, Dh: int) -> int:
    return 4 * (2 * S * (Dh + 1) + 2 * _WARPS * S + 3 * S)


def _check(q, k, v, bias, seed, smem_bytes, extra=()):
    BH, S, Dh = q.shape
    for name, t in (("k", k), ("v", v), *extra):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
    if bias.shape != (S, S):
        raise ValueError(f"bias must be ({S}, {S}), got {tuple(bias.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), *extra):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
    if seed is not None and (seed.device != q.device or seed.dtype != torch.int32
                             or seed.numel() != 1):
        raise ValueError(f"seed must be one int32 on {q.device}")
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {SUPPORTED_HEAD_DIMS}")
    if smem_bytes(S, Dh) > _SMEM_LIMIT:
        raise ValueError(f"S={S}, Dh={Dh} needs more shared memory than a block has")


def _seed_ptr(seed, dropout_rate: float) -> int:
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    return seed.data_ptr() if dropout_rate > 0.0 else 0


def _launch_fwd(q, k, v, bias, scale, seed, dropout_rate):
    _check(q, k, v, bias, seed, _fwd_smem_bytes)
    BH, S, Dh = q.shape
    out = torch.empty_like(q)
    if BH == 0:
        return out
    fn = kernels.entry("packed_attention_fwd")
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), BH, S, Dh, float(scale), _seed_ptr(seed, dropout_rate),
                keep_threshold(dropout_rate), _inv_keep(dropout_rate),
                int(dropout_rate > 0.0), kernels.stream_ptr(q))
    kernels.check("packed_attention_fwd", status)
    launch_counter.add()
    return out


def _launch_bwd(q, k, v, bias, dout, scale, seed, dropout_rate):
    _check(q, k, v, bias, seed, _bwd_smem_bytes, extra=(("dout", dout),))
    BH, S, Dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if BH == 0:
        return dq, dk, dv
    fn = kernels.entry("packed_attention_bwd")
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                BH, S, Dh, float(scale), _seed_ptr(seed, dropout_rate),
                keep_threshold(dropout_rate), _inv_keep(dropout_rate),
                int(dropout_rate > 0.0), kernels.stream_ptr(q))
    kernels.check("packed_attention_bwd", status)
    bwd_launch_counter.add()
    return dq, dk, dv


def attention_fwd(q, k, v, bias, scale: float, seed: Optional[torch.Tensor],
                  dropout_rate: float = 0.0) -> torch.Tensor:
    """K1's forward: the kernel for CUDA tensors, the plain version for CPU
    tensors. ``seed`` is a one-element int32 tensor on q's device, read only
    when ``dropout_rate`` > 0."""
    if q.is_cuda:
        return _launch_fwd(q, k, v, bias, scale, seed, dropout_rate)
    return packed_attention_reference(q, k, v, bias, scale, seed, dropout_rate)


def attention_bwd(q, k, v, bias, dout, scale: float, seed: Optional[torch.Tensor],
                  dropout_rate: float = 0.0):
    """K1's backward (dq, dk, dv): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, bias, dout, scale, seed, dropout_rate)
    return packed_attention_bwd_reference(q, k, v, bias, dout, scale, seed, dropout_rate)


class PackedAttention(torch.autograd.Function):
    """K1 forward and backward. bias, seed, scale and rate get no gradient
    (the TPU kernel gives bias a zero cotangent: it is the constant mask)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, dropout_rate):
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.scale, ctx.dropout_rate = scale, dropout_rate
        return attention_fwd(q, k, v, bias, scale, seed, dropout_rate)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, seed = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, bias, dout.contiguous(), ctx.scale, seed,
                                   ctx.dropout_rate)
        return dq, dk, dv, None, None, None, None


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One seed in [0, 2**31 - 1) from ``generator``, kept on ``device`` so
    that drawing it does not wait for the card."""
    if generator is None:
        raise ValueError("attention dropout needs an explicit torch.Generator")
    return torch.randint(0, SEED_HIGH, (1,), generator=generator, device=device,
                         dtype=torch.int32)


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float, dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """dropout(softmax(q k^T * scale + bias)) v for (B*H, S, Dh) q, k, v and
    (S, S) bias, differentiable in q, k and v.

    With ``dropout_rate`` > 0 the seed is drawn once from ``generator``.
    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    versions. There is no fallback from one to the other.
    """
    seed = draw_seed(generator, q.device) if dropout_rate > 0.0 else None
    return PackedAttention.apply(q, k, v, bias, seed, scale, float(dropout_rate))
