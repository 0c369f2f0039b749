"""Transformer towers of the flagship model.

Counterparts of the transformer half of ``bridgerl_tpu/models/layers.py``.
Layout is channel-last ``(B, T, C)``. Submodules carry the reference's
state-dict names (``input_proj``, ``transformer.layers.{i}.self_attn``,
``linear1``, ``norm1``, ...). Attention goes through
``ops/attention.py::packed_attention`` (the K1 kernels on CUDA tensors).

``train=True`` turns on the four dropouts of each block at the config's
rate: on the attention probabilities (inside K1), on the attention output
before ``norm1``, after the ReLU, and on the feed-forward output before
``norm2``. Their random numbers come from the explicit ``generator``.

With ``attn_packing`` P > 1 and a batch divisible by P, P windows of T
frames run as one (P*T)-token attention under the block-diagonal mask,
which is the same math as P separate T-token attentions.

``dtype`` is the compute dtype (float32 or bfloat16), with flax's mixed
precision: the parameters stay float32 and each layer casts at its own
boundary. A :class:`Dense` casts its input, weight and bias to the dtype and
returns it; a :class:`LayerNorm` takes its statistics and normalises in
float32 and returns the input's dtype; the positional table is built in the
dtype, as the JAX package builds it; the mean-pool sums in float32; K1 takes
and returns the dtype with a float32 softmax inside. The residual stream is
therefore in the dtype from the input projection to the output projection.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import packed_attention

LN_EPS = 1e-6     # flax LayerNorm's default (torch's is 1e-5)
MASK_BIAS = -1e9  # additive logit bias across windows


@functools.lru_cache(maxsize=None)
def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """The constant ``c`` rounded to ``dtype``: JAX converts a Python scalar to
    the array's dtype before an operation, torch computes with it unrounded."""
    return float(torch.tensor(c, dtype=dtype))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
            ) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep with probability 1 - rate and
    scale kept values by 1 / (1 - rate), in x's dtype. ``F.dropout`` takes no
    generator."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / _in_dtype(keep, x.dtype), 0.0)


def sinusoidal_pe(max_len: int, d_model: int, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """(max_len, d_model) sinusoidal positional table, computed in ``dtype``
    step by step as the JAX package computes it (in bfloat16 that differs
    from the float32 table rounded once, by up to 0.3 at 80 positions)."""
    position = torch.arange(max_len, dtype=dtype)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=dtype)
                         * _in_dtype(-math.log(10000.0) / d_model, dtype))
    pe = torch.zeros(max_len, d_model, dtype=dtype)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


def block_diagonal_mask(packing: int, seq_len: int) -> torch.Tensor:
    """(P*T, P*T) boolean mask: attention only within each packed window."""
    eye = torch.eye(packing, dtype=torch.float32)
    return torch.kron(eye, torch.ones(seq_len, seq_len)) > 0.5


def attention_bias(packing: int, seq_len: int, device=None) -> torch.Tensor:
    """(S, S) additive f32 bias for K1: 0 within a window, -1e9 across
    windows; zeros when nothing is packed."""
    bias = torch.where(block_diagonal_mask(packing, seq_len), 0.0, MASK_BIAS)
    return bias.to(device=device, dtype=torch.float32)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``, as flax's ``nn.Dense(dtype=...)``:
    input, weight and bias are cast to it, and so is the output. The
    parameters stay float32, so their gradients arrive float32."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and normalisation in
    float32, the result in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch's packed parameters:
    ``in_proj_weight`` (3d, d) and ``in_proj_bias`` (3d,) hold q, k, v in that
    order, heads major within each; ``out_proj`` maps the concatenated heads
    back to d. Both projections compute in ``dtype``."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} is not divisible by n_heads={n_heads}")
        self.n_heads = n_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                window: Optional[int] = None) -> torch.Tensor:
        B, S, d = x.shape
        H = self.n_heads
        Dh = d // H
        dt = self.compute_dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2).reshape(B * H, S, Dh)
                   .contiguous() for t in qkv.chunk(3, dim=-1))
        o = packed_attention(q, k, v, bias, 1.0 / math.sqrt(Dh), dropout_rate, generator,
                             window=window)
        o = o.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, d)
        return self.out_proj(o)


class TransformerBlock(nn.Module):
    """Post-LN encoder layer: x = norm1(x + drop(attn(x)));
    x = norm2(x + drop(ff(x))), with a ReLU feed-forward (dropout after the
    ReLU) and LayerNorm eps 1e-6."""

    def __init__(self, d_model: int, n_heads: int, ff_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.self_attn = SelfAttention(d_model, n_heads, dtype)
        self.linear1 = Dense(d_model, ff_dim, dtype)
        self.linear2 = Dense(ff_dim, d_model, dtype)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                window: Optional[int] = None) -> torch.Tensor:
        rate = self.dropout if train else 0.0
        x = self.norm1(x + dropout(self.self_attn(x, bias, rate, generator, window), rate,
                                   generator))
        h = dropout(F.relu(self.linear1(x)), rate, generator)
        return self.norm2(x + dropout(self.linear2(h), rate, generator))


class TransformerStack(nn.Module):
    """Positional table, then the blocks, over windows of ``seq_len`` frames.
    With ``packing`` P > 1 and a batch divisible by P, P windows share one
    attention row under the block-diagonal bias. Attention always runs with
    ``window=seq_len``, packed or not, so K1 computes only the windows'
    diagonal blocks. The table (in the compute dtype) and both biases
    (float32) are non-persistent buffers, so they follow the model's device."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int, ff_dim: int,
                 seq_len: int, packing: int = 1, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.seq_len, self.packing = seq_len, packing
        self.layers = nn.ModuleList(TransformerBlock(d_model, n_heads, ff_dim, dropout, dtype)
                                    for _ in range(num_layers))
        self.register_buffer("pe", sinusoidal_pe(seq_len, d_model, dtype), persistent=False)
        self.register_buffer("bias_single", attention_bias(1, seq_len), persistent=False)
        self.register_buffer("bias_packed", attention_bias(packing, seq_len),
                             persistent=False)

    def forward(self, h: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, d = h.shape
        if T != self.seq_len:
            raise ValueError(f"windows of {T} frames; this model takes {self.seq_len}")
        h = h + self.pe
        packed = self.packing > 1 and B % self.packing == 0
        P = self.packing if packed else 1
        bias = self.bias_packed if packed else self.bias_single
        h = h.reshape(B // P, P * T, d)
        for layer in self.layers:
            h = layer(h, bias, train, generator, window=self.seq_len)
        return h.reshape(B, T, d)


class TransformerMotionEncoder(nn.Module):
    """Linear -> PE -> transformer blocks -> mean-pool each window to
    ``tokens`` latent tokens -> Linear. Input (B, seq_len, input_dim),
    output (B, tokens, hidden_dim) in the compute dtype."""

    def __init__(self, input_dim: int, hidden_dim: int, seq_len: int,
                 d_model: int = 256, n_heads: int = 4, num_layers: int = 4,
                 ff_dim: int = 512, attn_packing: int = 1, tokens: int = 1,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tokens = tokens
        self.input_proj = Dense(input_dim, d_model, dtype)
        self.transformer = TransformerStack(num_layers, d_model, n_heads, ff_dim,
                                            seq_len, attn_packing, dropout, dtype)
        self.output_proj = Dense(d_model, hidden_dim, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.transformer(self.input_proj(x), train, generator)
        B, T, d = h.shape
        # jnp.mean of bfloat16 sums in float32 and rounds the mean
        h = h.reshape(B, self.tokens, T // self.tokens, d).float().mean(dim=2).to(h.dtype)
        return self.output_proj(h)


class TransformerMotionDecoder(nn.Module):
    """Linear -> repeat each latent token over its T/tokens frames -> PE ->
    transformer blocks -> Linear. Output (B, seq_len, output_dim) in the
    compute dtype."""

    def __init__(self, output_dim: int, hidden_dim: int, seq_len: int,
                 d_model: int = 256, n_heads: int = 4, num_layers: int = 4,
                 ff_dim: int = 512, attn_packing: int = 1, tokens: int = 1,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.seq_len, self.tokens = seq_len, tokens
        self.input_proj = Dense(hidden_dim, d_model, dtype)
        self.transformer = TransformerStack(num_layers, d_model, n_heads, ff_dim,
                                            seq_len, attn_packing, dropout, dtype)
        self.output_proj = Dense(d_model, output_dim, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.input_proj(x)                                                # (B, k, d)
        h = torch.repeat_interleave(h, self.seq_len // self.tokens, dim=1)    # (B, T, d)
        return self.output_proj(self.transformer(h, train, generator))
