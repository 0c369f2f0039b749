"""K2: nearest-code search with assignment statistics, as a CUDA kernel.

The counterpart of ``bridgerl_tpu/ops/pallas/vq_kernel.py``
(``nearest_codes_pallas``), with the interface of the plain version
``ops/codebook.py::nearest_codes_plain``: (flat (N, D), codebook (K, D)) ->
(idx (N,) int32, counts (K,) f32, dw (K, D) f32). The kernel is
``csrc/vq_assign.cu``; it adds into ``counts`` and ``dw`` with atomics, so
they are zeroed here first. Shapes it does not take raise: there is no
silent fallback to the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels

MAX_DIM = 512

launch_counter = kernels.LaunchCounter("vq_assign")


def nearest_codes_cuda(flat: torch.Tensor, codebook: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if not (flat.is_cuda and codebook.device == flat.device):
        raise ValueError("nearest_codes_cuda takes CUDA tensors on one device")
    if flat.ndim != 2 or codebook.ndim != 2 or flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"shapes {tuple(flat.shape)} and {tuple(codebook.shape)} "
                         "are not (N, D) and (K, D)")
    N, D = flat.shape
    K = codebook.shape[0]
    if not 1 <= D <= MAX_DIM or K < 1:
        raise ValueError(f"the kernel takes 1 <= D <= {MAX_DIM} and K >= 1, "
                         f"got D={D}, K={K}")
    for name, t in (("flat", flat), ("codebook", codebook)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    idx = torch.empty(N, dtype=torch.int32, device=flat.device)
    counts = torch.zeros(K, dtype=torch.float32, device=flat.device)
    dw = torch.zeros(K, D, dtype=torch.float32, device=flat.device)
    if N == 0:
        return idx, counts, dw
    fn = kernels.entry("vq_assign")
    status = fn(flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(),
                counts.data_ptr(), dw.data_ptr(), N, D, K,
                kernels.stream_ptr(flat))
    kernels.check("vq_assign", status)
    launch_counter.add()
    return idx, counts, dw
