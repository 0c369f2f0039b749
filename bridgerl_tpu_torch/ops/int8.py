"""The int8 feed-forward: a dynamically quantized forward product with a
straight-through backward.

Counterpart of ``bridgerl_tpu/ops/int8.py`` (plain XLA there, not Pallas):

- ``int8_matmul(x, w)``: x (..., K) in the compute dtype, w (N, K) (torch's
  ``Linear`` layout, the JAX kernel transposed). Per-row abs-max scales of x
  and per-output scales of w, ``s = max(absmax / 127, 1e-8)`` in float32;
  ``round(v / s)`` half to even, clipped to +-127, as int8; the int8 x int8
  product summed exactly in int32; the rescale ``(acc * sx) * sw`` in
  float32, then one cast to x's dtype. On a CUDA tensor the product is
  ``torch._int_mm`` (int8 tensor cores), with the rows padded to a
  multiple of 8 and at least 24, and K and N zero-padded to multiples of 8,
  where it needs that (exact: the scales are taken before the padding, and
  a zero product adds nothing to an int32 sum); on a CPU tensor it is the
  plain exact product (float64, exact while |acc| < 2**53).
- The backward treats the quantization as the identity, in x's dtype:
  ``gx = g @ w``, ``gw = g^T x`` (the JAX package's ``custom_vjp``).
- ``models/layers.py::Int8Dense`` is ``Dense`` with that forward product:
  the same parameters and state-dict keys (a checkpoint trained either way
  loads either way), the bias added after the product's rounding, in the
  compute dtype, as the JAX package's ``Int8Dense`` adds it (``Dense``
  rounds the biased product once).

A seed-stacked weight (S, N, K) with x (S, M, K) quantizes and multiplies
each seed on its own (one ``_int_mm`` a seed on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

_INT_MM_MIN_ROWS = 24   # torch._int_mm on CUDA wants more than 16 rows
_INT_MM_MULT = 8        # ... and row, column and inner sizes that are multiples of 8


def quantize(v: torch.Tensor, dim: int):
    """Symmetric abs-max int8 along ``dim``: (int8 values, float32 scales)."""
    s = v.abs().amax(dim=dim, keepdim=True).float()
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python scalar
    # divisor, which can miss the correctly rounded quotient by one ulp
    s = torch.clamp(s / torch.full((), 127.0, device=s.device), min=1e-8)
    q = torch.clamp(torch.round(v.float() / s), -127.0, 127.0)
    return q.to(torch.int8), s


def _mult(n: int) -> int:
    return -(-n // _INT_MM_MULT) * _INT_MM_MULT


def _pad(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``a`` with zero rows and columns up to (rows, cols)."""
    M, K = a.shape
    return a if (rows, cols) == (M, K) else torch.nn.functional.pad(a, (0, cols - K,
                                                                        0, rows - M))


def int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 xq @ wq^T for int8 (M, K) and (N, K), at any M, K, N."""
    if xq.is_cuda:
        (M, K), N = xq.shape, wq.shape[0]
        x = _pad(xq, max(_INT_MM_MIN_ROWS, _mult(M)), _mult(K))
        return torch._int_mm(x, _pad(wq, _mult(N), _mult(K)).t())[:M, :N]
    return torch.matmul(xq.double(), wq.double().t()).to(torch.int32)


def int8_forward(x: torch.Tensor, w: torch.Tensor, seeds: Optional[int] = None
                 ) -> torch.Tensor:
    """The quantized product in x's dtype: x (..., K), w (N, K); or with
    ``seeds`` S, per seed, x (S, M, K) and w (S, N, K)."""
    xq, sx = quantize(x, -1)
    wq, sw = quantize(w, -1)
    if seeds is not None:
        acc = torch.stack([int_product(a, b) for a, b in zip(xq, wq)])
        sw = sw.transpose(1, 2)                               # (S, 1, N)
    else:
        acc = int_product(xq.reshape(-1, xq.shape[-1]), wq).reshape(*x.shape[:-1], -1)
        sw = sw.reshape(-1)                                   # (N,)
    return (acc.float() * sx * sw).to(x.dtype)


class Int8Matmul(torch.autograd.Function):
    """int8 forward, straight-through backward in the inputs' dtypes."""

    @staticmethod
    def forward(x: torch.Tensor, w: torch.Tensor, seeds: Optional[int]) -> torch.Tensor:
        return int8_forward(x, w, seeds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:2])
        ctx.seeds = inputs[2]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = torch.matmul(g, w).to(x.dtype)
        if ctx.seeds is not None:
            gw = torch.bmm(g.transpose(1, 2), x)
        else:
            gw = torch.matmul(g.reshape(-1, g.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        return gx, gw.to(w.dtype), None


def int8_matmul(x: torch.Tensor, w: torch.Tensor, seeds: Optional[int] = None
                ) -> torch.Tensor:
    """x (..., K) @ w (N, K)^T with the int8 forward and the straight-through
    backward; with ``seeds`` S, x (S, M, K) and w (S, N, K) per seed."""
    return Int8Matmul.apply(x, w, seeds)
