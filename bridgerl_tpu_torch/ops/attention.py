"""K1 forward: packed-window attention over (B*H, S, Dh) rows.

The counterpart of ``bridgerl_tpu/ops/pallas/attention.py``'s forward
(``_packed_attention_fwd``): ``out = softmax(q k^T * scale + bias) v`` with
an f32 softmax, where ``bias`` is one (S, S) additive term shared by every
row: the block-diagonal window mask as 0 / -1e9, or zeros.

A CUDA tensor goes to the hand-written kernel ``csrc/packed_attention.cu``;
a CPU tensor goes to the plain version :func:`packed_attention_reference`.
Attention dropout belongs to the training slice and raises here.
"""

from __future__ import annotations

import torch

from . import kernels

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_WARPS = 8                    # kWarps in csrc/packed_attention.cu
_SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use

launch_counter = kernels.LaunchCounter("packed_attention_fwd")


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of K1's forward."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _smem_bytes(S: int, Dh: int) -> int:
    return 4 * (S * (2 * Dh + 1) + _WARPS * S)


def _launch(q, k, v, bias, scale):
    BH, S, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
    if bias.shape != (S, S):
        raise ValueError(f"bias must be ({S}, {S}), got {tuple(bias.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {SUPPORTED_HEAD_DIMS}")
    if _smem_bytes(S, Dh) > _SMEM_LIMIT:
        raise ValueError(f"S={S}, Dh={Dh} needs more shared memory than a block has")
    out = torch.empty_like(q)
    if BH == 0:
        return out
    fn = kernels.entry("packed_attention_fwd")
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), BH, S, Dh, float(scale), kernels.stream_ptr(q))
    kernels.check("packed_attention_fwd", status)
    launch_counter.add()
    return out


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float,
                     dropout_rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v for (B*H, S, Dh) q, k, v and (S, S) bias.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. There is no fallback from one to the other.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout belongs to the training slice (ROADMAP.md)")
    if q.is_cuda:
        return _launch(q, k, v, bias, scale)
    return packed_attention_reference(q, k, v, bias, scale)
