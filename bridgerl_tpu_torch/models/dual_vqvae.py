"""DualMotionVQVAE: two encoders, one shared quantizer, one robot decoder.

Counterpart of ``bridgerl_tpu/models/dual_vqvae.py`` for the transformer
towers and the hybrid quantizer, computing in ``cfg.compute_dtype`` (float32
or bfloat16) with float32 parameters, as the JAX package's mixed precision
does:

- robot branch: robot_encoder -> quantizer -> robot_decoder -> reconstruction
- human branch: human_encoder -> quantizer -> robot_decoder -> retargeted motion

With ``train=True`` the towers drop out (random numbers from ``generator``)
and the quantizer folds its EMA codebooks. The branches run in that order
and share the quantizer, so the human branch sees the codebook the robot
branch has just folded, as in the JAX package.

Under bfloat16 the towers and their outputs (``recon``, ``retargeted``,
``z_e``) are bfloat16; the quantizers search and fold in float32 and return
the input's dtype; ``loss_vq`` and the metrics are float32.

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
from .layers import LN_EPS, SelfAttention, TransformerMotionDecoder, TransformerMotionEncoder


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch != "transformer":
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP.md); this slice runs "
            "'transformer'")
    if cfg.int8_ff:
        raise NotImplementedError("int8_ff is not ported yet (ROADMAP.md)")


class DualMotionVQVAE(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        tower = dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                     num_layers=cfg.n_tf_layers, ff_dim=cfg.ff_dim,
                     attn_packing=cfg.attn_packing, tokens=cfg.tf_tokens,
                     dropout=cfg.dropout, dtype=compute_dtype(cfg))
        self.human_encoder = TransformerMotionEncoder(
            cfg.human_input_dim, cfg.hidden_dim, cfg.window_size, **tower)
        self.robot_encoder = TransformerMotionEncoder(
            cfg.robot_input_dim, cfg.hidden_dim, cfg.window_size, **tower)
        self.quantizer = make_quantizer(cfg, generator)
        self.robot_decoder = TransformerMotionDecoder(
            cfg.robot_input_dim, cfg.hidden_dim, cfg.window_size, **tower)

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


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def _torch_init_(model: nn.Module, g: torch.Generator) -> None:
    """Kernels follow torch's defaults, biases start at zero, as in the JAX
    package with ``torch_init=True``: Linear weights U(+-sqrt(1/fan_in));
    attention q, k, v and output projections xavier-uniform, each d x d
    block on its own; LayerNorm scale 1 and bias 0."""
    attn_out = set()
    for m in model.modules():   # pre-order: an attention precedes its out_proj
        if isinstance(m, SelfAttention):
            d = m.in_proj_weight.shape[1]
            for part in m.in_proj_weight.chunk(3, dim=0):
                _uniform_(part, math.sqrt(6.0 / (2 * d)), g)
            nn.init.zeros_(m.in_proj_bias)
            _uniform_(m.out_proj.weight, math.sqrt(6.0 / (2 * d)), g)
            nn.init.zeros_(m.out_proj.bias)
            attn_out.add(m.out_proj)
        elif isinstance(m, nn.Linear) and m not in attn_out:
            _uniform_(m.weight, 1.0 / math.sqrt(m.in_features), g)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> DualMotionVQVAE:
    """The model with weights drawn from ``seed`` by one explicit CPU
    generator, so a seed gives the same weights on every device, then moved
    to ``device`` (the card by default) in eval mode."""
    if not cfg.torch_init:
        raise NotImplementedError(
            "torch_init=False (lecun-normal init) is not ported (ROADMAP.md)")
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = DualMotionVQVAE(cfg, generator=g)
    _torch_init_(model, g)
    return model.to(dev).eval()
