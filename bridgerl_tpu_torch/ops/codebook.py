"""Nearest-codebook search and its assignment statistics.

``nearest_codes`` is K2, the ``torch.library`` custom op
``bridgerl::nearest_codes`` (so that ``torch.export`` can trace through it):
on a CUDA tensor it launches the hand-written kernel (``ops/vq_kernel.py``),
on a CPU tensor it runs the plain version :func:`nearest_codes_plain`, the
counterpart of the JAX package's ``nearest_codes_xla``; no other device has
an implementation. Outside a trace a CUDA tensor calls the op's CUDA
implementation without the op's dispatch (``kernels.eager_cuda``). Both
return (indices (N,) int32, counts (K,), dw (K, D)), so callers never build
the (N, K) one-hot matrix themselves. Given G groups, flat (G, N, D) and
codebook (G, K, D) (the seeds of a stacked multi-seed step, each with its
own codebook), they return (G, N), (G, K) and (G, K, D), group g as a call
on (flat[g], codebook[g]) gives them: one launch on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels
from .vq_kernel import nearest_codes_cuda

Codes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def nearest_codes_plain(flat: torch.Tensor, codebook: torch.Tensor) -> Codes:
    """Plain version of K2: argmin_k ||e_k||^2 - 2 x.e_k in f32 (the constant
    ||x||^2 is dropped), first index on ties, then the statistics; group by
    group for 3-D inputs."""
    if flat.ndim == 3:
        parts = [nearest_codes_plain(f, c) for f, c in zip(flat, codebook)]
        return tuple(torch.stack(t) for t in zip(*parts))
    dist = torch.sum(codebook * codebook, dim=1)[None, :] - 2.0 * (flat @ codebook.t())
    indices = torch.argmin(dist, dim=1).to(torch.int32)
    counts, dw = assignment_stats(flat, indices, codebook.shape[0])
    return indices, counts, dw


def assignment_stats(flat: torch.Tensor, indices: torch.Tensor,
                     num_codes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-code usage counts (K,) and per-code sums of assigned rows (K, D)."""
    idx = indices.long()
    counts = torch.zeros(num_codes, dtype=torch.float32, device=flat.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    dw = torch.zeros(num_codes, flat.shape[1], dtype=torch.float32, device=flat.device)
    dw.index_add_(0, idx, flat)
    return counts, dw


def quantize_lookup(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Row gather: codebook[indices]; with G groups, indices (G, N) into
    codebook (G, K, D) give (G, N, D)."""
    if codebook.ndim == 3:
        G, K, D = codebook.shape
        rows = indices.long() + K * torch.arange(G, device=indices.device)[:, None]
        return codebook.reshape(G * K, D)[rows]
    return codebook[indices.long()]


nearest_codes_op = torch.library.custom_op(
    "bridgerl::nearest_codes", nearest_codes_plain, mutates_args=(), device_types="cpu",
    schema="(Tensor flat, Tensor codebook) -> (Tensor, Tensor, Tensor)")


@nearest_codes_op.register_kernel("cuda")
def _nearest_codes_cuda(flat, codebook):
    # k2_plan sizes the launch at call time, from this call's N
    return nearest_codes_cuda(flat.contiguous(), codebook.contiguous())


@nearest_codes_op.register_fake
def _nearest_codes_fake(flat, codebook):
    return (flat.new_empty(flat.shape[:-1], dtype=torch.int32),
            flat.new_empty(codebook.shape[:-1]), flat.new_empty(codebook.shape))


def nearest_codes(flat: torch.Tensor, codebook: torch.Tensor) -> Codes:
    """The K2 kernel for CUDA tensors, the plain version for CPU tensors."""
    if kernels.eager_cuda(flat):
        return _nearest_codes_cuda(flat, codebook)
    return nearest_codes_op(flat, codebook)
