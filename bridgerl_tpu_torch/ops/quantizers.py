"""The quantizer zoo: standard and EMA VQ, residual VQ, FSQ, LFQ, the hybrid
FSQ + residual VQ, and the identity of the ``ae`` method.

Counterparts of ``bridgerl_tpu/ops/quantizers.py``. Layout is channel-last
``(B, T, D)``. Every quantizer's ``forward(z)`` returns
``(loss, z_q, metrics, codes)``: the first three as in the JAX package, and
``codes`` the discrete code streams that the JAX package sows into its
``intermediates`` collection, as a dict from stream path ("" for the
module itself, "vq_0", "rvq/vq_0", ...) to an int32 (B, T) tensor.

With ``train=True`` each EMA VQ folds the batch's assignment statistics
(K2's counts and dw) into its buffers, as the JAX package updates its
``qstats`` collection, and quantizes with the folded codebook. A standard VQ
(``use_ema=False``) keeps its codebook as a parameter that the optimizer
updates through the lookup. Every VQ layer searches through
``ops/codebook.py``, so K2 runs on every VQ method on the card.

Seed-stacked (``models/stacked.py``), a quantizer's parameters and buffers
carry a leading axis of S seeds and its input is S seed-major groups of
rows: a VQ searches all seeds in one grouped K2 launch and folds each
seed's codebook from its own statistics, and the loss and metrics come back
as (S,) vectors, one a seed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from .codebook import nearest_codes, quantize_lookup
from .linear import linear, seed_count

Metrics = Dict[str, torch.Tensor]
Codes = Dict[str, torch.Tensor]
QuantOut = Tuple[torch.Tensor, torch.Tensor, Metrics, Codes]

LAPLACE_EPS = 1e-5
LFQ_NORM_EPS = 1e-6   # flax LayerNorm's default
# The hybrid's residual VQ folds at 0.99 with commitment 0.25 whatever
# ``ema_decay`` and ``commitment_cost`` say: the JAX package builds it
# without passing either. So does ``rvq`` for its commitment.
HYBRID_DECAY = 0.99
FIXED_COMMITMENT = 0.25


def ste(z: torch.Tensor, z_q: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator. The value is z + (z_q - z), not z_q: the
    two differ in the last ulp, and residual VQ layers see the difference."""
    return z + (z_q - z).detach()


def unique_count(indices: torch.Tensor, seeds: Optional[int] = None) -> torch.Tensor:
    """Number of distinct values, as an f32 scalar: sorted, k > 1 distinct
    values differ from their cyclic predecessor at k places (one of them
    the wrap-around), and one value at none. (Slicing off one end instead
    would tie an exported program to its traced batch.) With ``seeds`` S,
    per seed over S seed-major groups: (S,)."""
    if seeds is None:
        s = torch.sort(indices.reshape(-1)).values
        return torch.clamp(torch.sum((s != torch.roll(s, 1)).float()), min=1.0)
    s = torch.sort(indices.reshape(seeds, -1), dim=-1).values
    return torch.clamp(torch.sum((s != torch.roll(s, 1, dims=-1)).float(), dim=-1), min=1.0)


def global_unique_count(indices: torch.Tensor, low: int, n: int,
                        seeds: Optional[int] = None) -> torch.Tensor:
    """:func:`unique_count` over every rank's ``indices``: a histogram of
    the n codes ``low`` ... ``low + n - 1`` (per seed with ``seeds``), summed
    over the ranks, and its non-empty bins counted."""
    flat = (indices.reshape(1 if seeds is None else seeds, -1).long() - low)
    S = flat.shape[0]
    offsets = n * torch.arange(S, device=flat.device)[:, None]
    hist = torch.bincount((flat + offsets).reshape(-1), minlength=S * n).float()
    used = torch.sum(parallel.all_reduce_sum(hist).reshape(S, n) > 0, dim=-1).float()
    used = torch.clamp(used, min=1.0)
    return used[0] if seeds is None else used


def code_range(indices: torch.Tensor) -> Tuple[int, int]:
    """(lowest, count) of the integer codes seen on any rank: one
    all-reduce of (-min, max)."""
    ends = torch.stack([-indices.min(), indices.max()]).long()
    lo, hi = parallel.all_reduce_max(ends).tolist()
    return -lo, hi + lo + 1


def seed_mean(x: torch.Tensor, seeds: Optional[int] = None) -> torch.Tensor:
    """The mean of x, or with ``seeds`` S the (S,) means of its S seed-major
    groups."""
    return torch.mean(x) if seeds is None else x.reshape(seeds, -1).mean(dim=1)


def perplexity_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """exp(-sum p log p) over the batch's code-usage histogram (over the
    last axis: one a seed for stacked counts)."""
    probs = counts / torch.clamp(torch.sum(counts, dim=-1, keepdim=True), min=1.0)
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10), dim=-1))


def dcr_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Dead-code ratio: fraction of codes unused in this batch."""
    return 1.0 - torch.sum((counts > 0).float(), dim=-1) / counts.shape[-1]


def prefix_codes(prefix: str, codes: Codes) -> Codes:
    """Code streams of a submodule, named by their path under ``prefix``."""
    return {"/".join(p for p in (prefix, k) if p): v for k, v in codes.items()}


class Codebook(nn.Module):
    """Holder of one codebook, so its state_dict key is ``embedding.weight``
    as in the reference's ``nn.Embedding``: a buffer for an EMA codebook, a
    parameter for a learned one."""

    def __init__(self, weight: torch.Tensor, learned: bool = False):
        super().__init__()
        if learned:
            self.weight = nn.Parameter(weight)
        else:
            self.register_buffer("weight", weight)


class VectorQuantizer(nn.Module):
    """Standard or EMA vector quantizer, codebook U(-1/K, 1/K).

    Standard (``use_ema=False``): the codebook is a parameter; the loss is
    ``||z_q - sg(z)||^2 + commitment * ||sg(z_q) - z||^2``, and its first term
    reaches the codebook through the lookup. EMA: ``embedding``, ``ema_w``
    and ``ema_cluster_size`` are buffers folded at ``decay``; the loss is the
    commitment term. With ``warm_start`` the EMA state starts self-consistent
    (ema_w = embedding, cluster sizes 1); without it, as the reference does
    (normal ema_w, zero cluster sizes)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25, warm_start: bool = True,
                 generator: Optional[torch.Generator] = None, use_ema: bool = True,
                 decay: float = 0.99):
        super().__init__()
        K, D = num_embeddings, embedding_dim
        self.embedding_dim = D
        self.commitment_cost = commitment_cost
        self.use_ema, self.decay = use_ema, decay
        emb = (torch.rand(K, D, generator=generator) * 2.0 - 1.0) / K  # U(-1/K, 1/K)
        self.embedding = Codebook(emb, learned=not use_ema)
        if not use_ema:
            return
        if warm_start:
            self.register_buffer("ema_cluster_size", torch.ones(K))
            self.register_buffer("ema_w", emb.clone())
        else:
            self.register_buffer("ema_cluster_size", torch.zeros(K))
            self.register_buffer("ema_w", torch.randn(K, D, generator=generator))

    @torch.no_grad()
    def _fold(self, counts: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
        """EMA update of the buffers from one batch's statistics, then the
        Laplace-smoothed codebook. The buffers are replaced, not written in
        place, so no tensor that an autograd graph saved changes under it."""
        d = self.decay
        new_cs = self.ema_cluster_size * d + counts * (1.0 - d)
        new_w = self.ema_w * d + dw * (1.0 - d)
        n = torch.sum(new_cs, dim=-1, keepdim=True)
        K = new_cs.shape[-1]
        cluster_size = (new_cs + LAPLACE_EPS) / (n + K * LAPLACE_EPS) * n
        new_embedding = new_w / cluster_size[..., None]
        self.ema_cluster_size = new_cs
        self.ema_w = new_w
        self.embedding.weight = new_embedding
        return new_embedding

    def forward(self, z: torch.Tensor, train: bool = False) -> QuantOut:
        in_dtype = z.dtype
        z = z.float()
        embedding = self.embedding.weight
        S = seed_count(self)
        flat = z.reshape(-1, self.embedding_dim)
        if S is not None:                           # one K2 launch for all seeds
            flat = flat.reshape(S, -1, self.embedding_dim)
        indices, counts, dw = nearest_codes(flat.detach(), embedding.detach())
        if parallel.active() is not None:       # batch-global statistics, one call
            both = parallel.all_reduce_sum(torch.cat([counts.reshape(-1), dw.reshape(-1)]))
            counts, dw = both[:counts.numel()].view_as(counts), both[counts.numel():].view_as(dw)
        if train and self.use_ema:
            # the lookup (and so the commitment loss) uses the folded codebook
            embedding = self._fold(counts, dw)
        z_q = quantize_lookup(indices, embedding).reshape(z.shape)
        loss = self.commitment_cost * seed_mean((z_q.detach() - z) ** 2, S)
        if not self.use_ema:
            loss = seed_mean((z_q - z.detach()) ** 2, S) + loss
        metrics = {"perplexity": perplexity_from_counts(counts),
                   "dcr": dcr_from_counts(counts)}
        codes = {"": indices.reshape(z.shape[:-1])}
        return loss, ste(z, z_q).to(in_dtype), metrics, codes


class ResidualVQ(nn.Module):
    """Stack of EMA VQs, each quantizing the previous residual. Outputs and
    losses are summed; perplexity and dead-code ratio are layer means."""

    def __init__(self, num_quantizers: int, num_embeddings: int,
                 embedding_dim: int, commitment_cost: float = 0.25,
                 warm_start: bool = True,
                 generator: Optional[torch.Generator] = None, decay: float = 0.99):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantizer(num_embeddings, embedding_dim, commitment_cost,
                            warm_start, generator, decay=decay)
            for _ in range(num_quantizers))

    def forward(self, z: torch.Tensor, train: bool = False) -> QuantOut:
        residual = z
        quantized_out = torch.zeros_like(z)
        total_loss = torch.zeros((), device=z.device)
        ppls, dcrs, codes = [], [], {}
        for i, layer in enumerate(self.layers):
            loss, q, m, c = layer(residual, train=train)
            residual = residual - q
            quantized_out = quantized_out + q
            total_loss = total_loss + loss
            ppls.append(m["perplexity"])
            dcrs.append(m["dcr"])
            codes.update(prefix_codes(f"vq_{i}", c))
        metrics = {"perplexity": torch.mean(torch.stack(ppls), dim=0),
                   "dcr": torch.mean(torch.stack(dcrs), dim=0)}
        return total_loss, quantized_out, metrics, codes


class FSQ(nn.Module):
    """Finite scalar quantization: project to len(levels) dims, round with a
    straight-through estimator, project back. ``bounded`` tanh-squashes each
    dim to exactly L integer values first (Mentzer et al. 2023); unbounded
    rounds the raw projection, as the reference does."""

    def __init__(self, levels: Sequence[int], input_dim: int, bounded: bool = False):
        super().__init__()
        self.levels = tuple(int(l) for l in levels)
        self.bounded = bounded
        n = len(self.levels)
        self.project_in = nn.Linear(input_dim, n)
        self.project_out = nn.Linear(n, input_dim)
        lv = torch.tensor(self.levels, dtype=torch.float32)
        half = (lv - 1.0) * (1.0 - 1e-3) / 2.0
        offset = torch.where(lv % 2 == 0, 0.5, 0.0)
        basis = torch.tensor([math.prod(self.levels[:i]) for i in range(n)],
                             dtype=torch.float32)
        self.register_buffer("_half", half, persistent=False)
        self.register_buffer("_offset", offset, persistent=False)
        self.register_buffer("_shift", torch.tan(offset / half), persistent=False)
        self.register_buffer("_basis", basis, persistent=False)
        self._low = -sum((l // 2) * int(b) for l, b in zip(self.levels, basis.tolist()))

    def forward(self, z: torch.Tensor, train: bool = False) -> QuantOut:
        in_dtype = z.dtype
        S = seed_count(self)
        zp = linear(z.float(), self.project_in.weight, self.project_in.bias, S)
        if self.bounded:
            zp = torch.tanh(zp + self._shift) * self._half - self._offset
        hard_vals = torch.round(zp)
        z_hard = ste(zp, hard_vals)
        out = linear(z_hard, self.project_out.weight, self.project_out.bias, S).to(in_dtype)
        # indices from the exact round(): z_hard is integral only to ~ulp
        indices = torch.sum(hard_vals.detach() * self._basis, dim=-1).to(torch.int32)
        if parallel.active() is None:
            uniq = unique_count(indices, S)
        else:
            # bounded: digit i runs over L_i integers from -(L_i // 2); unbounded: any
            low, n = ((self._low, math.prod(self.levels)) if self.bounded
                      else code_range(indices))
            uniq = global_unique_count(indices, low, n, S)
        metrics = {"perplexity": uniq,
                   "dcr": 1.0 - uniq / float(math.prod(self.levels))}
        return torch.zeros((), device=z.device), out, metrics, {"": indices}


class HybridVQ(nn.Module):
    """FSQ base plus a residual EMA VQ on the FSQ residual. Output is
    fsq + rvq, the loss is the RVQ loss; perplexity and dead-code ratio come
    from the FSQ, the RVQ perplexity is reported as ``rvq_ppl``.

    Submodules are ``fsq`` and ``vq`` (the reference's state-dict names);
    the residual VQ's code streams are named ``rvq/vq_i`` as in the JAX
    package."""

    def __init__(self, hidden_dim: int, fsq_levels: Sequence[int] = (8, 5, 5, 5),
                 vq_codebook_size: int = 1024, num_quantizers: int = 4,
                 warm_start: bool = True, fsq_bounded: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fsq = FSQ(fsq_levels, hidden_dim, bounded=fsq_bounded)
        self.vq = ResidualVQ(num_quantizers, vq_codebook_size, hidden_dim,
                             commitment_cost=FIXED_COMMITMENT, warm_start=warm_start,
                             generator=generator, decay=HYBRID_DECAY)

    def forward(self, z: torch.Tensor, train: bool = False) -> QuantOut:
        _, z_fsq, m_fsq, c_fsq = self.fsq(z, train=train)
        loss_vq, z_vq, m_vq, c_vq = self.vq(z - z_fsq, train=train)
        metrics = {"perplexity": m_fsq["perplexity"], "dcr": m_fsq["dcr"],
                   "rvq_ppl": m_vq["perplexity"]}
        codes = {**prefix_codes("fsq", c_fsq), **prefix_codes("rvq", c_vq)}
        return loss_vq, z_fsq + z_vq, metrics, codes


class LFQ(nn.Module):
    """Lookup-free quantization: project to ``codebook_dim`` bits, take signs
    with a straight-through estimator, and reward per-bit entropy (loss
    ``-mean(H) * weight``). ``norm`` puts a parameter-free LayerNorm (eps
    1e-6, float32) on the projection before the sign."""

    def __init__(self, input_dim: int, codebook_dim: int = 10,
                 entropy_loss_weight: float = 0.1, norm: bool = False):
        super().__init__()
        self.codebook_dim = codebook_dim
        self.entropy_loss_weight = entropy_loss_weight
        self.norm = norm
        self.project_in = nn.Linear(input_dim, codebook_dim)
        self.project_out = nn.Linear(codebook_dim, input_dim)
        self.register_buffer("_basis", 2 ** torch.arange(codebook_dim, dtype=torch.int32),
                             persistent=False)

    def forward(self, z: torch.Tensor, train: bool = False) -> QuantOut:
        in_dtype = z.dtype
        S = seed_count(self)
        z_e = linear(z.float(), self.project_in.weight, self.project_in.bias, S)
        if self.norm:
            z_e = F.layer_norm(z_e, z_e.shape[-1:], eps=LFQ_NORM_EPS)
        z_q = ste(z_e, torch.where(z_e > 0, 1.0, -1.0))
        prob = torch.sigmoid(z_e)
        entropy = -(prob * torch.log(prob + 1e-6) + (1 - prob) * torch.log(1 - prob + 1e-6))
        loss = -seed_mean(entropy, S) * self.entropy_loss_weight
        out = linear(z_q, self.project_out.weight, self.project_out.bias, S).to(in_dtype)
        indices = torch.sum((z_q > 0).to(torch.int32) * self._basis, dim=-1, dtype=torch.int32)
        uniq = (unique_count(indices, S) if parallel.active() is None
                else global_unique_count(indices, 0, 2 ** self.codebook_dim, S))
        metrics = {"perplexity": uniq, "dcr": 1.0 - uniq / float(2 ** self.codebook_dim)}
        return loss, out, metrics, {"": indices}


class IdentityVQ(nn.Module):
    """The ``ae`` method: the latent passes through; loss 0, perplexity 1,
    dead-code ratio 0, no code streams."""

    def forward(self, z: torch.Tensor, train: bool = False) -> QuantOut:
        one = torch.ones((), device=z.device)
        metrics = {"perplexity": one, "dcr": torch.zeros_like(one)}
        return torch.zeros((), dtype=z.dtype, device=z.device), z, metrics, {}


def make_quantizer(cfg, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Method dispatch, case for case as the JAX package's. ``rvq`` keeps
    commitment 0.25; the hybrid's residual VQ has 4 layers of K=512 codes at
    decay 0.99 whatever ``codebook_size`` and ``ema_decay`` say."""
    m, K, D = cfg.method, cfg.codebook_size, cfg.hidden_dim
    ws = cfg.ema_warm_start
    if m == "standard":
        return VectorQuantizer(K, D, cfg.commitment_cost, generator=generator, use_ema=False)
    if m == "ema":
        return VectorQuantizer(K, D, cfg.commitment_cost, ws, generator, decay=cfg.ema_decay)
    if m == "rvq":
        return ResidualVQ(cfg.n_layers, K, D, FIXED_COMMITMENT, ws, generator,
                          decay=cfg.ema_decay)
    if m == "fsq":
        return FSQ(tuple(cfg.fsq_levels), D, bounded=cfg.fsq_bounded)
    if m == "lfq":
        return LFQ(D, cfg.lfq_dim, cfg.entropy_loss_weight, norm=cfg.lfq_norm)
    if m == "hybrid":
        return HybridVQ(D, tuple(cfg.fsq_levels), vq_codebook_size=512, warm_start=ws,
                        fsq_bounded=cfg.fsq_bounded, generator=generator)
    if m == "ae":
        return IdentityVQ()
    raise ValueError(f"Unknown quantization method: {m}")
