"""Encoder and decoder towers of the model zoo.

Counterparts of ``bridgerl_tpu/models/layers.py``: the transformer towers and
the convolutional ones (``ResBlock1D``, ``simple`` / ``resnet``
``ConvEncoder`` and ``ConvDecoder``, the full-resolution ``NoDownsample*``
pair). Every tower takes and returns channel-last ``(B, T, C)``; the
convolutional ones run in torch's ``(B, C, T)`` inside and transpose once at
entry and once at exit. Submodules carry the reference's state-dict names
(``input_proj``, ``transformer.layers.{i}.self_attn``, ``linear1``,
``norm1``; ``model.{i}``, ``model.res_{i}``, ``net.{j}``, ...), and
convolution weights are stored in torch's layouts, so a reference ``.pth``
loads as it is. Attention goes through
``ops/attention.py::packed_attention`` (the K1 kernels on CUDA tensors); the
convolutions are plain ``F.conv1d`` / ``F.conv_transpose1d``, as the JAX
package leaves them to XLA.

BatchNorm is flax's (:class:`BatchNorm`), not torch's: the batch variance is
the biased one, ``E[x^2] - E[x]^2``, and the running variance folds it in as
it is (torch's ``BatchNorm1d`` stores the unbiased one).

``train=True`` turns on the four dropouts of each block at the config's
rate: on the attention probabilities (inside K1), on the attention output
before ``norm1``, after the ReLU, and on the feed-forward output before
``norm2``. Their random numbers come from the explicit ``generator``. With
``cheap_dropout`` the last three draw 8-bit masks (:func:`cheap_dropout`);
the attention dropout stays K1's Philox draw at the exact rate.

With ``attn_packing`` P > 1 and a batch divisible by P, P windows of T
frames run as one (P*T)-token attention under the block-diagonal mask,
which is the same math as P separate T-token attentions.

``int8_ff`` makes each block's feed-forward pair :class:`Int8Dense`: an
int8 forward product with a straight-through backward (``ops/int8.py``).

Seed stacking (``models/stacked.py``): every parameter and persistent
buffer may carry a leading axis of S seeds, and the batch is then S
seed-major groups of B windows. Each layer takes the stacked case from its
own weights: a ``Dense`` multiplies per seed (``torch.baddbmm``), a
``LayerNorm`` scales per seed, attention runs one K1 launch with one
dropout seed per group, a convolution tower folds the seeds into the
channels (``(B, S*C, T)``) so that its convolutions are grouped by seed and
its BatchNorms keep per-seed statistics, and the dropouts draw each seed's
mask from that seed's generator, in the order a single-seed run draws it.

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
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ops.attention import packed_attention
from ..ops.int8 import int8_matmul
from ..ops.linear import linear, seed_count

LN_EPS = 1e-6     # flax LayerNorm's default (torch's is 1e-5)
MASK_BIAS = -1e9  # additive logit bias across windows


@functools.lru_cache(maxsize=None)
def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """The constant ``c`` rounded to ``dtype``: JAX converts a Python scalar to
    the array's dtype before an operation, torch computes with it unrounded."""
    return float(torch.tensor(c, dtype=dtype))


def draw(draw_fn, shape, generator, device) -> torch.Tensor:
    """``draw_fn(shape, generator, device)``, or with one generator per
    seed of a stacked batch (whose first axis is S seed-major groups) each
    seed's share from its own generator."""
    if isinstance(generator, torch.Generator):
        return draw_fn(shape, generator, device)
    per_seed = (shape[0] // len(generator), *shape[1:])
    return torch.cat([draw_fn(per_seed, g, device) for g in generator])


def _uniform(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device)


def _bytes(shape, generator, device):
    return torch.randint(0, 256, shape, generator=generator, device=device, dtype=torch.uint8)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep with probability 1 - rate and
    scale kept values by 1 / (1 - rate), in x's dtype. ``F.dropout`` takes no
    generator."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    keep = 1.0 - rate
    mask = draw(_uniform, x.shape, generator, x.device) < keep
    return torch.where(mask, x / _in_dtype(keep, x.dtype), 0.0)


def cheap_dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``CheapDropout`` in train mode (``bridgerl_tpu/models/layers.py``):
    the mask comes from uint8 random bits, so the drop rate is quantized to
    ``thresh / 256`` with ``thresh = min(round(rate * 256), 255)`` (0.1 ->
    26/256), an element is kept when its bits are >= thresh, and kept values
    are divided by ``1 - thresh / 256`` rounded to x's dtype."""
    thresh = min(int(round(rate * 256.0)), 255)   # 256 overflows uint8
    if rate <= 0.0 or thresh <= 0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    bits = draw(_bytes, x.shape, generator, x.device)
    return torch.where(bits >= thresh, x / _in_dtype(1.0 - thresh / 256.0, x.dtype), 0.0)


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


def causal_bias(seq_len: int, device=None) -> torch.Tensor:
    """(S, S) additive f32 bias for K1 under a causal mask: 0 on and below
    the diagonal, -1e9 above it (position i attends to the j <= i)."""
    return torch.full((seq_len, seq_len), MASK_BIAS, device=device).triu(1)


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
        return linear(x.to(dt), self.weight.to(dt), self.bias.to(dt), seed_count(self))


class Int8Dense(Dense):
    """``Dense`` whose forward product is ``ops/int8.py::int8_matmul`` (int8
    forward, straight-through backward) on the input and weight cast to the
    compute dtype; the bias is added after it, in the compute dtype, as the
    JAX package's ``Int8Dense`` adds it. Parameters and state-dict keys are
    ``Dense``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w, b, S = self.weight.to(dt), self.bias.to(dt), seed_count(self)
        if S is not None:
            y = int8_matmul(x.to(dt).reshape(S, -1, x.shape[-1]), w, S) + b[:, None, :]
            return y.reshape(*x.shape[:-1], w.shape[1])
        return int8_matmul(x.to(dt), w) + b


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and normalisation in
    float32, the result in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if seed_count(self) is None:
            return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                                self.eps).to(x.dtype)
        S, d = self.weight.shape                              # seed-stacked
        y = F.layer_norm(x.float(), self.normalized_shape, None, None, self.eps)
        y = y.reshape(S, -1, d) * self.weight[:, None] + self.bias[:, None]
        return y.reshape(x.shape).to(x.dtype)


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
                generator=None, window: Optional[int] = None) -> torch.Tensor:
        B, S, d = x.shape
        H = self.n_heads
        Dh = d // H
        dt = self.compute_dtype
        qkv = linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt),
                     seed_count(self))
        q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2).reshape(B * H, S, Dh)
                   .contiguous() for t in qkv.chunk(3, dim=-1))
        o = packed_attention(q, k, v, bias, 1.0 / math.sqrt(Dh), dropout_rate, generator,
                             window=window)
        o = o.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, d)
        return self.out_proj(o)


class TransformerBlock(nn.Module):
    """Post-LN encoder layer: x = norm1(x + drop(attn(x)));
    x = norm2(x + drop(ff(x))), with a ReLU feed-forward (dropout after the
    ReLU) and LayerNorm eps 1e-6. ``cheap`` draws those three dropouts'
    masks from 8 bits (:func:`cheap_dropout`); ``int8_ff`` makes the
    feed-forward pair :class:`Int8Dense`."""

    def __init__(self, d_model: int, n_heads: int, ff_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, cheap: bool = False,
                 int8_ff: bool = False):
        super().__init__()
        self.dropout = dropout
        self.cheap = cheap
        self.self_attn = SelfAttention(d_model, n_heads, dtype)
        ff = Int8Dense if int8_ff else Dense
        self.linear1 = ff(d_model, ff_dim, dtype)
        self.linear2 = ff(ff_dim, d_model, dtype)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, train: bool = False,
                generator=None, window: Optional[int] = None) -> torch.Tensor:
        rate = self.dropout if train else 0.0
        drop = cheap_dropout if self.cheap else dropout
        x = self.norm1(x + drop(self.self_attn(x, bias, rate, generator, window), rate,
                                generator))
        h = drop(F.relu(self.linear1(x)), rate, generator)
        return self.norm2(x + drop(self.linear2(h), rate, generator))


class TransformerStack(nn.Module):
    """Positional table, then the blocks, over windows of ``seq_len`` frames.
    With ``packing`` P > 1 and a batch divisible by P, P windows share one
    attention row under the block-diagonal bias. Attention always runs with
    ``window=seq_len``, packed or not, so K1 computes only the windows'
    diagonal blocks. The table (in the compute dtype) and both biases
    (float32) are non-persistent buffers, so they follow the model's device."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int, ff_dim: int,
                 seq_len: int, packing: int = 1, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, cheap_dropout: bool = False,
                 int8_ff: bool = False):
        super().__init__()
        self.seq_len, self.packing = seq_len, packing
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, n_heads, ff_dim, dropout, dtype, cheap_dropout, int8_ff)
            for _ in range(num_layers))
        self.register_buffer("pe", sinusoidal_pe(seq_len, d_model, dtype), persistent=False)
        self.register_buffer("bias_single", attention_bias(1, seq_len), persistent=False)
        self.register_buffer("bias_packed", attention_bias(packing, seq_len),
                             persistent=False)

    def forward(self, h: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        B, T, d = h.shape
        if T != self.seq_len:
            raise ValueError(f"windows of {T} frames; this model takes {self.seq_len}")
        h = h + self.pe
        per_seed = B // (seed_count(self) or 1)   # packs never cross seeds
        packed = self.packing > 1 and per_seed % self.packing == 0
        P = self.packing if packed else 1
        bias = self.bias_packed if packed else self.bias_single
        h = h.reshape(B // P, P * T, d)
        for layer in self.layers:
            h = layer(h, bias, train, generator, window=self.seq_len)
        return h.reshape(B, T, d)


class MaskedTransformerStack(nn.Module):
    """The blocks alone, under an (S, S) float32 bias the caller gives
    (``bridgerl_tpu/models/layers.py::TransformerStack`` with a mask): no
    positional table, any sequence length. Attention runs over whole rows
    (``window`` = S), so K1 reads every entry of the bias."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int, ff_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, n_heads, ff_dim, dropout, dtype)
            for _ in range(num_layers))

    def forward(self, h: torch.Tensor, bias: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h, bias, train, generator, window=h.shape[1])
        return h


class TransformerMotionEncoder(nn.Module):
    """Linear -> PE -> transformer blocks -> mean-pool each window to
    ``tokens`` latent tokens -> Linear. Input (B, seq_len, input_dim),
    output (B, tokens, hidden_dim) in the compute dtype."""

    def __init__(self, input_dim: int, hidden_dim: int, seq_len: int,
                 d_model: int = 256, n_heads: int = 4, num_layers: int = 4,
                 ff_dim: int = 512, attn_packing: int = 1, tokens: int = 1,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 cheap_dropout: bool = False, int8_ff: bool = False):
        super().__init__()
        self.tokens = tokens
        self.input_proj = Dense(input_dim, d_model, dtype)
        self.transformer = TransformerStack(num_layers, d_model, n_heads, ff_dim,
                                            seq_len, attn_packing, dropout, dtype,
                                            cheap_dropout, int8_ff)
        self.output_proj = Dense(d_model, hidden_dim, dtype)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
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
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 cheap_dropout: bool = False, int8_ff: bool = False):
        super().__init__()
        self.seq_len, self.tokens = seq_len, tokens
        self.input_proj = Dense(hidden_dim, d_model, dtype)
        self.transformer = TransformerStack(num_layers, d_model, n_heads, ff_dim,
                                            seq_len, attn_packing, dropout, dtype,
                                            cheap_dropout, int8_ff)
        self.output_proj = Dense(d_model, output_dim, dtype)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        h = self.input_proj(x)                                                # (B, k, d)
        h = torch.repeat_interleave(h, self.seq_len // self.tokens, dim=1)    # (B, T, d)
        return self.output_proj(self.transformer(h, train, generator))


# ---------------------------------------------------------------- conv towers

LEAKY_SLOPE = 0.2
BN_EPS = 1e-5       # flax BatchNorm's epsilon as the JAX package sets it
BN_MOMENTUM = 0.9   # flax's: running = 0.9 * running + 0.1 * batch


class LeakyReLU(nn.Module):
    """``where(x >= 0, x, 0.2 * x)`` with the slope rounded to x's dtype,
    as flax's ``nn.leaky_relu`` computes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * _in_dtype(LEAKY_SLOPE, x.dtype))


class Upsample(nn.Module):
    """Nearest upsampling x2 along time of (B, C, T) (``jnp.repeat``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(x, 2, dim=2)


def _grouped(conv: nn.Module):
    """A convolution's weight, bias and groups: as they are, or for a
    seed-stacked one's (S, a, b, k) and (S, c), the seeds as S groups over
    seed-major channels."""
    S = seed_count(conv)
    if S is None:
        return conv.weight, conv.bias, 1
    return conv.weight.reshape(-1, *conv.weight.shape[2:]), conv.bias.reshape(-1), S


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` over (B, C, T) computing in ``dtype``, as flax's
    ``nn.Conv(dtype=...)``: input, weight and bias are cast to it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w, b, groups = _grouped(self)
        return F.conv1d(x.to(dt), w.to(dt), b.to(dt), self.stride, self.padding,
                        groups=groups)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` over (B, C, T) computing in ``dtype``. With
    k=4, s=2, p=1 it doubles the length, as flax's ``nn.ConvTranspose`` with
    lax padding (2, 2) does on the flipped kernel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w, b, groups = _grouped(self)
        return F.conv_transpose1d(x.to(dt), w.to(dt), b.to(dt), self.stride, self.padding,
                                  groups=groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of
    (B, C, T), with torch's ``BatchNorm1d`` state-dict names.

    In train mode the statistics are float32 whatever x's dtype: the mean and
    the biased variance ``max(E[x^2] - E[x]^2, 0)`` over batch and time,
    folded into the buffers as ``0.9 * running + 0.1 * batch`` (once a call,
    so once a microbatch, and once a branch where both branches run).
    Normalising is float32 too, ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, and the result is cast to x's dtype. In eval mode the running
    statistics take the batch's place. Under a data-parallel group
    (``parallel/``) the train-mode mean and E[x^2] are those of the global
    batch: summed over the ranks by a differentiable all-reduce and divided
    by their number, so every rank folds the same running statistics.
    ``num_batches_tracked`` counts the
    train calls, as torch's does; the JAX package has no such counter.
    Seed-stacked, the (S, C) parameters and statistics serve the S * C
    seed-major channels of the tower's folded layout."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        run_mean, run_var = self.running_mean.view(-1), self.running_var.view(-1)
        if train:
            mean = x32.mean(dim=(0, 2))
            sq = (x32 * x32).mean(dim=(0, 2))
            if parallel.active() is not None:
                # SyncBatchNorm: the ranks' shares are equal, so the global
                # moments are the mean of theirs; the gradient flows through
                # them to every rank's rows, as under the JAX package's mesh
                both = parallel.all_reduce_sum_differentiable(torch.cat([mean, sq]))
                mean, sq = (both / parallel.world_size()).split(mean.shape[0])
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                run_mean.copy_(m * run_mean + (1 - m) * mean)
                run_var.copy_(m * run_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = run_mean, run_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight.view(-1)
        y = (x32 - mean[:, None]) * mul[:, None] + self.bias.view(-1)[:, None]
        return y.to(x.dtype)


def _run(layers: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Apply ``layers`` in order, passing ``train`` to those that take it."""
    for layer in layers:
        x = layer(x, train) if isinstance(layer, (BatchNorm, ResBlock1D)) else layer(x)
    return x


class ResBlock1D(nn.Module):
    """x + (Conv(3) -> BN -> LeakyReLU) x 2, stride 1, over (B, C, T); the
    reference's ``net.{0 conv, 1 bn, 3 conv, 4 bn}``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = nn.Sequential(
            Conv1d(channels, channels, 3, padding=1, dtype=dtype), BatchNorm(channels),
            LeakyReLU(),
            Conv1d(channels, channels, 3, padding=1, dtype=dtype), BatchNorm(channels),
            LeakyReLU())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x + _run(self.net, x, train)


class ConvTower(nn.Module):
    """A convolutional tower: ``model`` applied to (B, C, T), taking and
    returning channel-last (B, T, C). ``generator`` is accepted for the
    towers' common signature; nothing here drops out. Seed-stacked, the
    (S * B, T, C) batch runs as (B, S * C, T), each seed's channels
    together."""

    def __init__(self, layers: "OrderedDict[str, nn.Module]"):
        super().__init__()
        self.model = nn.Sequential(layers)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        S = seed_count(self)
        if S is None:
            return _run(self.model, x.transpose(1, 2), train).transpose(1, 2)
        SB, T, C = x.shape
        h = x.reshape(S, SB // S, T, C).permute(1, 0, 3, 2).reshape(SB // S, S * C, T)
        h = _run(self.model, h, train)
        B, SC, T2 = h.shape
        return h.reshape(B, S, SC // S, T2).permute(1, 0, 3, 2).reshape(SB, T2, SC // S)


def _numbered(layers) -> "OrderedDict[str, nn.Module]":
    return OrderedDict((str(i), m) for i, m in enumerate(layers))


def conv_encoder(input_dim: int, hidden_dim: int, arch: str = "simple",
                 num_res_layers: int = 4, dtype: torch.dtype = torch.float32) -> ConvTower:
    """'simple' / 'resnet' strided encoder, T -> T/4. simple: two stride-2
    Conv(k=4, p=1) + LeakyReLU; resnet: stride-2 conv, N ResBlocks, stride-2
    conv, a final ResBlock (the reference's ``model.{i}`` indices)."""
    down = lambda cin: Conv1d(cin, hidden_dim, 4, stride=2, padding=1, dtype=dtype)
    res = [ResBlock1D(hidden_dim, dtype) for _ in range(num_res_layers)] if arch == "resnet" else []
    tail = [ResBlock1D(hidden_dim, dtype)] if arch == "resnet" else []
    return ConvTower(_numbered([down(input_dim), LeakyReLU(), *res, down(hidden_dim),
                                LeakyReLU(), *tail]))


def conv_decoder(output_dim: int, hidden_dim: int, arch: str = "simple",
                 num_res_layers: int = 4, dtype: torch.dtype = torch.float32) -> ConvTower:
    """'simple' / 'resnet' decoder, T/4 -> T. simple: two ConvTranspose(k=4,
    s=2, p=1); resnet: N ResBlocks, then two (nearest upsample x2 + Conv(3))
    stages with a ResBlock between them."""
    if arch == "resnet":
        conv = lambda cout: Conv1d(hidden_dim, cout, 3, padding=1, dtype=dtype)
        return ConvTower(_numbered([
            *(ResBlock1D(hidden_dim, dtype) for _ in range(num_res_layers)),
            Upsample(), conv(hidden_dim), LeakyReLU(), ResBlock1D(hidden_dim, dtype),
            Upsample(), conv(output_dim)]))
    up = lambda cout: ConvTranspose1d(hidden_dim, cout, 4, stride=2, padding=1, dtype=dtype)
    return ConvTower(_numbered([up(hidden_dim), LeakyReLU(), up(output_dim)]))


def no_downsample_encoder(input_dim: int, hidden_dim: int, num_res_layers: int = 4,
                          dtype: torch.dtype = torch.float32) -> ConvTower:
    """Full-resolution encoder, stride 1: Conv(3) + LeakyReLU, N ResBlocks,
    ``final_conv`` + LeakyReLU."""
    return ConvTower(OrderedDict([
        ("0", Conv1d(input_dim, hidden_dim, 3, padding=1, dtype=dtype)), ("1", LeakyReLU()),
        *((f"res_{i}", ResBlock1D(hidden_dim, dtype)) for i in range(num_res_layers)),
        ("final_conv", Conv1d(hidden_dim, hidden_dim, 3, padding=1, dtype=dtype)),
        ("final_act", LeakyReLU())]))


def no_downsample_decoder(output_dim: int, hidden_dim: int, num_res_layers: int = 4,
                          dtype: torch.dtype = torch.float32) -> ConvTower:
    """Full-resolution decoder, stride 1: N ResBlocks, then ``out_conv``."""
    return ConvTower(OrderedDict([
        *((f"res_{i}", ResBlock1D(hidden_dim, dtype)) for i in range(num_res_layers)),
        ("out_conv", Conv1d(hidden_dim, output_dim, 3, padding=1, dtype=dtype))]))
