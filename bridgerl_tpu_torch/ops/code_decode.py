"""The quantizers' code streams back to the quantized latent z_q.

Counterpart of ``bridgerl_tpu/ops/code_decode.py``: the inverse of the code
streams that every quantizer returns (``motion_codes`` in serving), so that
stored, sent or generated motion tokens decode to robot motion through the
trained decoder. Streams are named as ``motion_codes`` names them:

    standard / ema : {"quantizer"}
    rvq            : {"quantizer/vq_0" .. "quantizer/vq_{n-1}"}
    fsq / lfq      : {"quantizer"}
    hybrid         : {"quantizer/fsq", "quantizer/rvq/vq_0" .. "vq_3"}

A VQ stream decodes by the lookup the forward made, residual stages summed
in stage order in the compute dtype, as ``ResidualVQ`` sums them. An FSQ
index inverts only when the quantizer is bounded (``fsq_bounded``, the
default): each digit then lies in the L integers from ``-(L // 2)``, and the
mixed-radix index is a bijection. The unbounded round lets digits take any
integer, so its index is a hash and decoding it raises. LFQ bits always
invert.

With the straight-through estimator's ``z + (z_q - z)`` taken as the
``z_q`` it stands for, decoding the codes of an eval-mode forward gives back
that forward's ``z_q`` bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

Codes = Mapping[str, torch.Tensor]


def fsq_digit_low(levels) -> torch.Tensor:
    """The lowest digit of each level under the bounded squash: -(L // 2)."""
    return torch.tensor([-(int(l) // 2) for l in levels], dtype=torch.int32)


def fsq_basis(levels) -> torch.Tensor:
    """The mixed-radix basis [1, L0, L0 * L1, ...]."""
    return torch.tensor([math.prod(levels[:i]) for i in range(len(levels))], dtype=torch.int32)


def fsq_index_range(levels) -> Tuple[int, int]:
    """(min_index, num_codes): bounded-FSQ indices lie in
    [min_index, min_index + prod(levels))."""
    lows = [-(int(l) // 2) for l in levels]
    basis = [math.prod(levels[:i]) for i in range(len(levels))]
    return sum(a * b for a, b in zip(lows, basis)), math.prod(levels)


def fsq_codes_to_values(codes: torch.Tensor, levels) -> torch.Tensor:
    """(...,) int32 bounded-FSQ indices -> (..., len(levels)) float32 digits."""
    dev = codes.device
    lv = torch.tensor([int(l) for l in levels], dtype=torch.int32, device=dev)
    low, basis = fsq_digit_low(levels).to(dev), fsq_basis(levels).to(dev)
    shifted = codes.to(torch.int32)[..., None] - torch.sum(low * basis)
    return ((shifted // basis) % lv + low).to(torch.float32)


def lfq_codes_to_signs(codes: torch.Tensor, codebook_dim: int) -> torch.Tensor:
    """(...,) int32 LFQ indices -> (..., codebook_dim) float32 in {-1, +1}."""
    shifts = torch.arange(codebook_dim, dtype=torch.int32, device=codes.device)
    bits = (codes.to(torch.int32)[..., None] >> shifts) & 1
    return (2.0 * bits - 1.0).to(torch.float32)


def _rvq_sum(layers, codes: Codes, prefix: str, dtype: torch.dtype) -> torch.Tensor:
    """The stages' lookups summed in stage order in ``dtype``."""
    out = None
    for i, layer in enumerate(layers):
        q = layer.embedding.weight.float()[codes[f"{prefix}/vq_{i}"].long()].to(dtype)
        out = q if out is None else out + q
    return out


def _require_bounded(cfg) -> None:
    if not cfg.fsq_bounded:
        raise ValueError(f"{cfg.method} decode requires fsq_bounded=True (the default): the "
                         "unbounded FSQ index is a non-invertible hash")


def decode_codes(cfg, model, codes: Codes) -> torch.Tensor:
    """Code streams -> the quantized latent z_q (B, T', hidden_dim).

    ``cfg`` is the ModelConfig, ``model`` the DualMotionVQVAE (or its
    quantizer) whose weights decode, ``codes`` a dict of (B, T') integer
    streams named as ``motion_codes`` names them, on the model's device.
    Returns z_q in the compute dtype, equal to the eval-mode forward's
    quantizer output for the same codes."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    q = getattr(model, "quantizer", model)
    method = cfg.method
    if method in ("standard", "ema"):
        return q.embedding.weight.float()[codes["quantizer"].long()].to(dtype)
    if method == "rvq":
        return _rvq_sum(q.layers, codes, "quantizer", dtype)
    if method == "fsq":
        _require_bounded(cfg)
        return q.project_out(fsq_codes_to_values(codes["quantizer"], cfg.fsq_levels)).to(dtype)
    if method == "lfq":
        return q.project_out(lfq_codes_to_signs(codes["quantizer"], cfg.lfq_dim)).to(dtype)
    if method == "hybrid":
        _require_bounded(cfg)
        z_fsq = q.fsq.project_out(fsq_codes_to_values(codes["quantizer/fsq"],
                                                      cfg.fsq_levels)).to(dtype)
        return z_fsq + _rvq_sum(q.vq.layers, codes, "quantizer/rvq", dtype)
    raise ValueError(f"method {method!r} has no code streams to decode "
                     "('ae' carries no discrete codes)")


def code_vocab_sizes(cfg) -> Dict[str, int]:
    """Vocabulary size of each code stream. FSQ streams report
    prod(levels); their raw indices lie in the shifted range that
    :func:`fsq_index_range` gives (:func:`normalize_codes` maps them to
    [0, vocab))."""
    method = cfg.method
    if method in ("standard", "ema"):
        return {"quantizer": cfg.codebook_size}
    if method == "rvq":
        return {f"quantizer/vq_{i}": cfg.codebook_size for i in range(cfg.n_layers)}
    if method == "fsq":
        return {"quantizer": math.prod(cfg.fsq_levels)}
    if method == "lfq":
        return {"quantizer": 2 ** cfg.lfq_dim}
    if method == "hybrid":
        # the hybrid's residual VQ has 4 stages of 512 codes whatever the config says
        return {"quantizer/fsq": math.prod(cfg.fsq_levels),
                **{f"quantizer/rvq/vq_{i}": 512 for i in range(4)}}
    raise ValueError(f"method {method!r} has no code streams")


def _fsq_streams(cfg) -> Tuple[str, ...]:
    return {"fsq": ("quantizer",), "hybrid": ("quantizer/fsq",)}.get(cfg.method, ())


def normalize_codes(cfg, codes: Mapping) -> Dict:
    """Every stream shifted into [0, vocab) (FSQ indices are range-shifted)."""
    lo, _ = fsq_index_range(cfg.fsq_levels)
    return {k: (v - lo if k in _fsq_streams(cfg) else v) for k, v in codes.items()}


def denormalize_codes(cfg, codes: Mapping) -> Dict:
    """The inverse of :func:`normalize_codes`: [0, vocab) -> raw indices."""
    lo, _ = fsq_index_range(cfg.fsq_levels)
    return {k: (v + lo if k in _fsq_streams(cfg) else v) for k, v in codes.items()}
