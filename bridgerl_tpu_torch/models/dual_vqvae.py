"""DualMotionVQVAE: two encoders, one shared quantizer, one robot decoder.

Counterpart of ``bridgerl_tpu/models/dual_vqvae.py`` for every arch
(``simple``, ``resnet``, ``resnet_no_down``, ``transformer``) and every
quantization method, computing in ``cfg.compute_dtype`` (float32 or bfloat16)
with float32 parameters, as the JAX package's mixed precision does:

- robot branch: robot_encoder -> quantizer -> robot_decoder -> reconstruction
- human branch: human_encoder -> quantizer -> robot_decoder -> retargeted motion

With ``train=True`` the transformer towers drop out (random numbers from
``generator``), the BatchNorms of the convolutional towers normalise with the
batch's statistics and fold them into their buffers, and the quantizer folds
its EMA codebooks. The branches run in that order and share the quantizer
and the decoder, so the human branch sees the codebook the robot branch has
just folded, and the decoder's statistics fold once a branch, as in the JAX
package.

Under bfloat16 the towers and their outputs (``recon``, ``retargeted``,
``z_e``) are bfloat16; the quantizers search and fold in float32 and return
the input's dtype; ``loss_vq`` and the metrics are float32 (``ae``'s zero
loss is in the towers' dtype, as in the JAX package).

``forward`` returns the JAX package's output dict; each branch also carries
``codes``, the quantizer's code streams named as the JAX package names them
in its ``intermediates`` (``quantizer/fsq``, ``quantizer/rvq/vq_0``, ...).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig, compute_dtype
from ..device import resolve_device
from ..ops.quantizers import make_quantizer, prefix_codes
from .layers import (
    LN_EPS,
    BatchNorm,
    SelfAttention,
    TransformerMotionDecoder,
    TransformerMotionEncoder,
    conv_decoder,
    conv_encoder,
    no_downsample_decoder,
    no_downsample_encoder,
)


def _transformer_kw(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(d_model=cfg.d_model, n_heads=cfg.n_heads, num_layers=cfg.n_tf_layers,
                ff_dim=cfg.ff_dim, attn_packing=cfg.attn_packing, tokens=cfg.tf_tokens,
                dropout=cfg.dropout, dtype=compute_dtype(cfg), cheap_dropout=cfg.cheap_dropout,
                int8_ff=cfg.int8_ff)


def make_encoder(cfg: ModelConfig, input_dim: int) -> nn.Module:
    """The arch's encoder, as ``bridgerl_tpu/models/dual_vqvae.py`` dispatches it."""
    dt = compute_dtype(cfg)
    if cfg.arch == "transformer":
        return TransformerMotionEncoder(input_dim, cfg.hidden_dim, cfg.window_size,
                                        **_transformer_kw(cfg))
    if cfg.arch == "resnet_no_down":
        return no_downsample_encoder(input_dim, cfg.hidden_dim, cfg.num_res_layers, dt)
    return conv_encoder(input_dim, cfg.hidden_dim, cfg.arch, cfg.num_res_layers, dt)


def make_decoder(cfg: ModelConfig) -> nn.Module:
    dt = compute_dtype(cfg)
    if cfg.arch == "transformer":
        return TransformerMotionDecoder(cfg.robot_input_dim, cfg.hidden_dim, cfg.window_size,
                                        **_transformer_kw(cfg))
    if cfg.arch == "resnet_no_down":
        return no_downsample_decoder(cfg.robot_input_dim, cfg.hidden_dim,
                                     cfg.num_res_layers, dt)
    return conv_decoder(cfg.robot_input_dim, cfg.hidden_dim, cfg.arch, cfg.num_res_layers, dt)


class DualMotionVQVAE(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.human_encoder = make_encoder(cfg, cfg.human_input_dim)
        self.robot_encoder = make_encoder(cfg, cfg.robot_input_dim)
        self.quantizer = make_quantizer(cfg, generator)
        self.robot_decoder = make_decoder(cfg)

    def _pre_quant(self, z_e: torch.Tensor) -> torch.Tensor:
        """Optional parameter-free LayerNorm before the shared quantizer."""
        if self.cfg.vq_norm:
            return F.layer_norm(z_e.float(), z_e.shape[-1:], eps=LN_EPS)
        return z_e

    def _branch(self, encoder: nn.Module, x: torch.Tensor, out_key: str,
                train: bool, generator: Optional[torch.Generator]) -> Dict[str, Any]:
        z_e = self._pre_quant(encoder(x, train=train, generator=generator))
        loss_vq, z_q, metrics, codes = self.quantizer(z_e, train=train)
        return {out_key: self.robot_decoder(z_q, train=train, generator=generator),
                "loss_vq": loss_vq, "metrics": metrics, "z_e": z_e,
                "codes": prefix_codes("quantizer", codes)}

    def forward(self, x_robot: Optional[torch.Tensor] = None,
                x_human: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Dict[str, Any]]:
        outputs: Dict[str, Dict[str, Any]] = {}
        if x_robot is not None:
            outputs["robot"] = self._branch(self.robot_encoder, x_robot, "recon", train,
                                            generator)
        if x_human is not None:
            outputs["human"] = self._branch(self.human_encoder, x_human,
                                            "retargeted", train, generator)
        return outputs

    def encode_robot(self, x_robot: torch.Tensor) -> torch.Tensor:
        return self._pre_quant(self.robot_encoder(x_robot))

    def encode_human(self, x_human: torch.Tensor) -> torch.Tensor:
        return self._pre_quant(self.human_encoder(x_human))

    def decode_latent(self, z_q: torch.Tensor) -> torch.Tensor:
        """Quantized latent (B, tokens, hidden) -> robot window (B, W, 29)."""
        return self.robot_decoder(z_q)


LECUN_TRUNC = 0.87962566103423978  # stddev of a standard normal truncated to (-2, 2)


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated to (-2, 2), scaled to
    variance 1 / fan_in (drawn by the inverse error function)."""
    lo, hi = ((1.0 + math.erf(b / math.sqrt(2.0))) / 2.0 for b in (-2.0, 2.0))
    with torch.no_grad():
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=g).erfinv_().mul_(math.sqrt(2.0))
        t.clamp_(-2.0, 2.0).mul_(math.sqrt(1.0 / fan_in) / LECUN_TRUNC)


def _conv_fan_in(m: nn.Module) -> int:
    """flax's fan-in of a convolution kernel (k, in, out): in * k, for the
    transposed one too (torch keeps its weight as (in, out, k))."""
    w = m.weight
    return (w.shape[0] if isinstance(m, nn.ConvTranspose1d) else w.shape[1]) * w.shape[2]


def _init_kernels_(model: nn.Module, g: torch.Generator, torch_init: bool) -> None:
    """Kernels as the JAX package draws them, biases at zero, LayerNorm and
    BatchNorm scale 1 and bias 0. ``torch_init``: torch's defaults, Linear
    and convolution weights U(+-sqrt(1/fan_in)), attention q, k, v and
    output projections xavier-uniform, each d x d block on its own. Without
    it, flax's lecun-normal for all of them (fan-in d for the attention
    blocks)."""

    def kernel_(w: torch.Tensor, fan_in: int, xavier: bool = False) -> None:
        if not torch_init:
            _lecun_normal_(w, fan_in, g)
        elif xavier:
            _uniform_(w, math.sqrt(6.0 / (2 * w.shape[1])), g)
        else:
            _uniform_(w, 1.0 / math.sqrt(fan_in), g)

    attn_out = set()
    for m in model.modules():   # pre-order: an attention precedes its out_proj
        if isinstance(m, SelfAttention):
            d = m.in_proj_weight.shape[1]
            for part in m.in_proj_weight.chunk(3, dim=0):
                kernel_(part, d, xavier=True)
            nn.init.zeros_(m.in_proj_bias)
            kernel_(m.out_proj.weight, d, xavier=True)
            nn.init.zeros_(m.out_proj.bias)
            attn_out.add(m.out_proj)
        elif isinstance(m, nn.Linear) and m not in attn_out:
            kernel_(m.weight, m.in_features)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            kernel_(m.weight, _conv_fan_in(m))
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, BatchNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> DualMotionVQVAE:
    """The model with weights drawn from ``seed`` by one explicit CPU
    generator, so a seed gives the same weights on every device, then moved
    to ``device`` (the card by default) in eval mode."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = DualMotionVQVAE(cfg, generator=g)
    _init_kernels_(model, g, cfg.torch_init)
    return model.to(dev).eval()
