"""Codebook seeding from the data (VQ-VAE-2 / Jukebox-style k-init).

Counterpart of ``bridgerl_tpu/train/codebook_seed.py``. The W64
transformer's mean-pooled latents sit in a small ball far from the origin,
while U(-1/K, 1/K) puts every code near it, so one code wins every window
from the first step and the EMA fold makes it absorb the rest (perplexity
1). Seeding the first-stage EMA codebooks with encoder outputs starts the
codes where the latents are. Residual stages start at the residual's scale
already and are left alone. It changes the init only.

A VQ is first-stage when it is not a stage i >= 1 of a residual stack: the
JAX package tells them apart by its qstats names (``^vq_(\\d+)$``), the port
by the module names of :class:`~bridgerl_tpu_torch.ops.quantizers.ResidualVQ`
(``layers.{i}``). So ``ema``'s quantizer, ``rvq``'s stage 0 and the
hybrid's residual stage 0 are seeded. Methods without EMA state (``fsq``,
``lfq``, ``ae``, ``standard``) are left as they are.

The de-duplicating jitter, 1e-3 of each dimension's spread, is drawn from a
CPU ``torch.Generator`` seeded 0; the JAX package draws it from
``jax.random.key(0)``, which the port cannot reproduce.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..ops.quantizers import VectorQuantizer

JITTER = 1e-3
JITTER_SEED = 0


def first_stage_ema_vqs(quantizer: nn.Module) -> List[Tuple[str, VectorQuantizer]]:
    """The EMA VQs of ``quantizer`` that are no residual stage i >= 1."""
    out = []
    for name, m in quantizer.named_modules():
        if isinstance(m, VectorQuantizer) and m.use_ema:
            parts = name.split(".")
            if len(parts) < 2 or parts[-2] != "layers" or parts[-1] == "0":
                out.append((name, m))
    return out


@torch.no_grad()
def seed_codebooks(model: nn.Module, x_robot: torch.Tensor) -> List[str]:
    """Seed ``model``'s first-stage EMA codebooks, in place, from the robot
    encoder's eval-mode outputs on ``x_robot``: K rows at the even stride
    ``(arange(K) * n) // K`` of the n latent rows, plus the jitter; then
    ``ema_w = embedding`` and cluster sizes 1. Returns the seeded modules'
    names (empty for methods without EMA state)."""
    vqs = first_stage_ema_vqs(model.quantizer)
    if not vqs:
        return []
    z = model.encode_robot(x_robot)
    flat = z.float().reshape(-1, z.shape[-1])
    n = flat.shape[0]
    seeded = []
    for name, vq in vqs:
        emb = vq.embedding.weight
        K, D = emb.shape
        if flat.shape[-1] != D:
            continue   # not this encoder's codebook
        # the largest index, (K - 1) * n // K, is below n; n < K repeats rows
        idx = torch.arange(K, device=flat.device) * max(n, 1) // K
        jitter = JITTER * torch.std(flat, dim=0, correction=0, keepdim=True)
        noise = torch.randn(K, D, generator=torch.Generator().manual_seed(JITTER_SEED))
        samples = flat[idx] + jitter * noise.to(flat.device)
        emb.copy_(samples)
        vq.ema_w.copy_(samples)
        vq.ema_cluster_size.fill_(1.0)
        seeded.append(name)
    return seeded
