"""Autoregressive prior over VQ motion-token grids: learn the distribution of
the codes a trained VQ-VAE emits, and sample novel robot motion from it.

Counterpart of ``bridgerl_tpu/models/token_prior.py``:

    windows --(robot encoder + quantizer)--> code grid (N positions x S tokens)
    prior   : causal transformer, teacher-forced next-position prediction
    sample  : one backbone pass a position ("context"), then the cheap
              per-position heads ("position_logits") for its S slots
    decode  : ops/code_decode + DualMotionVQVAE.decode_latent -> motion

A position is one encoder window; its S tokens are the flattened (stream,
latent-timestep) axis (5 for the flagship transformer + hybrid: 1 FSQ and 4
RVQ stages). Factorised heads predict the S tokens of the next position
together; with ``slot_ar`` a small causal depth transformer feeds slot s the
position's own slots < s (RQ-transformer).

Attention runs through K1 under the causal bias (``models/layers.py::
causal_bias``), which ``MaskedTransformerStack`` states to K1 (``causal=True``:
the tiles above the diagonal are skipped): the backbone at S = N positions,
the depth stack at S = the slots. Embeddings and the stacks compute in ``dtype``; the heads and the
losses stay float32, as in the JAX package.

Random draws. ``jax.random.categorical`` is a Gumbel-max draw; the port draws
``argmax(filtered logits + Gumbel noise)`` with the noise from the port's
Philox (:func:`gumbel_noise`), keyed by the call's seed, with the counter
(vocabulary index, row, slot, position). The bits are equal on the CPU and
on the card, there is no generator state, and ``torch.export`` can freeze
the draw. Samples differ from the JAX package's for the same seed; greedy
draws (``top_k=1``) are equal.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import philox4x32
from .layers import Dense, MaskedTransformerStack, causal_bias

Seed = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Prior architecture and the code-space contract it was trained on
    (the port's own copy; the same fields and JSON as the JAX package's).

    ``streams`` / ``vocab_sizes`` / ``tokens_per_stream`` pin the token
    layout (normalised code space, ``ops/code_decode.normalize_codes``), so a
    sampled grid maps back onto the quantizer's streams."""

    streams: Tuple[str, ...]            # sorted stream names
    vocab_sizes: Tuple[int, ...]        # per flattened token slot (len S_total)
    tokens_per_stream: int              # T' of the underlying quantizer
    window: int                         # encoder window (motion frames)
    stride: int                         # window stride on the motion timeline
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    ff_dim: int = 512
    dropout: float = 0.1
    max_len: int = 256                  # max positions (windows) per sequence
    source_experiment: str = ""         # the VQ-VAE experiment id
    class_names: Tuple[str, ...] = ()   # action names; empty = unconditioned
    slot_ar: bool = False               # within-position slot autoregression
    depth_layers: int = 2

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "PriorConfig":
        d = json.loads(s)
        d["streams"] = tuple(d["streams"])
        d["vocab_sizes"] = tuple(d["vocab_sizes"])
        d["class_names"] = tuple(d.get("class_names", ()))
        return PriorConfig(**d)


def flatten_vocab_sizes(stream_sizes: Sequence[Tuple[str, int]],
                        tokens_per_stream: int) -> Tuple[int, ...]:
    """Vocab per flattened token slot: stream-major, T'-minor order."""
    out = []
    for _, v in stream_sizes:
        out.extend([v] * tokens_per_stream)
    return tuple(out)


def _compute_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class MotionTokenPrior(nn.Module):
    """GPT-style causal transformer over flattened motion-token grids.

    Input grid (B, N, S) integers in the normalised code space [0, vocab_s).
    ``forward`` modes:

    - ``"logits"``: teacher-forced, a list of S (B, N, V_s) float32 logits,
      position t predicted from the positions before it;
    - ``"context"``: the backbone only, (B, N, d_model);
    - ``"position_logits"``: ``ctx`` (B, d_model), the context of one
      position, and ``slots`` (B, S), its tokens so far -> a list of S
      (B, V_s) logits: the depth stack (``slot_ar``) or the heads alone.
    """

    def __init__(self, cfg: PriorConfig, dtype="float32"):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dt = _compute_dtype(dtype)
        d, S = cfg.d_model, len(cfg.vocab_sizes)
        self.embed = nn.ModuleList(nn.Embedding(v, d) for v in cfg.vocab_sizes)
        # heads in float32: softmax and CE independent of the compute dtype
        self.head = nn.ModuleList(Dense(d, v, torch.float32) for v in cfg.vocab_sizes)
        self.bos = nn.Parameter(torch.zeros(d))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, d))
        self.class_embed = nn.Embedding(len(cfg.class_names), d) if cfg.class_names else None
        self.stack = MaskedTransformerStack(cfg.n_layers, d, cfg.n_heads, cfg.ff_dim,
                                            cfg.dropout, dt)
        if cfg.slot_ar:
            self.depth_pos = nn.Parameter(torch.zeros(S, d))
            self.depth_stack = MaskedTransformerStack(cfg.depth_layers, d, cfg.n_heads,
                                                      cfg.ff_dim, cfg.dropout, dt)
        offsets = torch.tensor([0, *cfg.vocab_sizes[:-1]], dtype=torch.int64).cumsum(0)
        self.register_buffer("vocab_offsets", offsets, persistent=False)
        self.register_buffer("causal", causal_bias(cfg.max_len), persistent=False)
        self.register_buffer("depth_causal", causal_bias(S), persistent=False)

    def _heads(self, h: torch.Tensor) -> List[torch.Tensor]:
        return [head(h) for head in self.head]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """(..., S) tokens -> (..., S, d) embeddings in the compute dtype, one
        lookup in the slots' tables laid end to end."""
        table = torch.cat([e.weight for e in self.embed])
        out = F.embedding(tokens.long() + self.vocab_offsets, table)
        return out if self.compute_dtype == torch.float32 else out.to(self.compute_dtype)

    def _depth(self, h: torch.Tensor, embs: torch.Tensor, train: bool,
               generator) -> torch.Tensor:
        """The depth sequence [ctx, ctx + emb(tok_0), ..., ctx + emb(tok_{S-2})]
        plus ``depth_pos``, through the causal depth stack: (..., S, d)."""
        shifted = torch.cat([torch.zeros_like(embs[..., :1, :]), embs[..., :-1, :]], dim=-2)
        d_in = h[..., None, :] + shifted
        d_in = d_in + self.depth_pos.to(d_in.dtype)
        shape = d_in.shape
        d_out = self.depth_stack(d_in.reshape(-1, *shape[-2:]), self.depth_causal, train,
                                 generator)
        return d_out.reshape(shape)

    def forward(self, grid: Optional[torch.Tensor] = None, train: bool = False,
                class_ids: Optional[torch.Tensor] = None, *, mode: str = "logits",
                ctx: Optional[torch.Tensor] = None, slots: Optional[torch.Tensor] = None,
                slot: Optional[int] = None, generator=None):
        """``slot`` (``position_logits`` only) asks for that slot's (B, V_s)
        logits alone, in place of the list."""
        c, dt = self.cfg, self.compute_dtype
        S = len(c.vocab_sizes)
        if mode == "position_logits":
            h_t = ctx.to(dt)
            if c.slot_ar:
                h_t = self._depth(h_t, self._embed(slots), train, generator)
                if slot is not None:
                    return self.head[slot](h_t[:, slot])
                return [self.head[s](h_t[:, s]) for s in range(S)]
            return self.head[slot](h_t) if slot is not None else self._heads(h_t)

        B, N, S_in = grid.shape
        if S_in != S:
            raise ValueError(f"grid has {S_in} token slots, config expects {S}")
        if N > c.max_len:
            raise ValueError(f"{N} positions > max_len {c.max_len}")
        embs = self._embed(grid)
        h = embs[..., 0, :]
        for s in range(1, S):
            h = h + embs[..., s, :]
        # shift right: position t sees positions < t; a learned BOS vector
        # stands in for "before the take started"
        h = torch.cat([self.bos.to(dt).expand(B, 1, c.d_model), h[:, :-1]], dim=1)
        h = h + self.pos_embed[:N].to(dt)
        if c.class_names:
            if class_ids is None:
                raise ValueError("class-conditioned prior needs class_ids")
            h = h + F.embedding(class_ids.long(), self.class_embed.weight).to(dt)[:, None, :]
        bias = self.causal[:N, :N].contiguous()
        h = self.stack(h, bias, train, generator)
        if mode == "context":
            return h
        if mode != "logits":
            raise ValueError(f"unknown mode {mode!r}")
        if not c.slot_ar:
            return self._heads(h)
        d_out = self._depth(h, embs, train, generator)
        return [self.head[s](d_out[:, :, s]) for s in range(S)]


def init_prior(cfg: PriorConfig, seed: int = 0, dtype="float32",
               device=None) -> MotionTokenPrior:
    """A prior with weights drawn from ``seed`` by one CPU generator, as the
    JAX package draws them: lecun-normal kernels (``models/dual_vqvae.py``),
    embeddings N(0, 1 / d_model), ``bos``, ``pos_embed`` and ``depth_pos``
    N(0, 0.02^2); then on ``device`` (the card by default) in eval mode."""
    from ..device import resolve_device
    from .dual_vqvae import _init_kernels_

    g = torch.Generator().manual_seed(seed)
    model = MotionTokenPrior(cfg, dtype)
    _init_kernels_(model, g, torch_init=False)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=g)
        for name in ("bos", "pos_embed", "depth_pos"):
            if hasattr(model, name):
                getattr(model, name).normal_(0.0, 0.02, generator=g)
    return model.to(resolve_device(device)).eval()


def prior_loss_sums(logits, grid: torch.Tensor, mask: torch.Tensor):
    """(masked CE sum averaged over slots, mask sum): the chunkable form, so
    a large validation split is evaluated in chunks and recombined as
    ``sum(chunk sums) / sum(chunk weights)``."""
    total = 0.0
    for s, lg in enumerate(logits):
        ce = F.cross_entropy(lg.float().reshape(-1, lg.shape[-1]),
                             grid[..., s].reshape(-1).long(), reduction="none")
        total = total + torch.sum(ce.reshape(mask.shape) * mask)
    return total / len(logits), torch.sum(mask)


def prior_loss(logits, grid: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over valid positions and token slots;
    ``mask`` (B, N) is 1.0 on real positions."""
    total, weight = prior_loss_sums(logits, grid, mask)
    return total / torch.clamp(weight, min=1.0)


def nucleus_filter(lg: torch.Tensor, top_p: float) -> torch.Tensor:
    """Top-p filtering: keep the smallest set of logits whose probability
    mass reaches ``top_p`` (the token that crosses it included); the rest
    go to -inf."""
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_lg, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    keep = exclusive < top_p
    thresh = torch.where(keep, sorted_lg, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(lg < thresh, -torch.inf, lg)


def seed_tensor(seed: Seed, device) -> torch.Tensor:
    """A seed as an int64 scalar tensor on ``device``."""
    if torch.is_tensor(seed):
        return seed.to(device=device, dtype=torch.int64).reshape(())
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def gumbel_noise(seed: torch.Tensor, positions: int, slots: int, rows: int, vocab: int,
                 start: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """(positions, slots, rows, vocab) float32 standard Gumbel noise from
    Philox4x32-10 with key (the seed's low and high 32 bits) and counter
    (vocabulary index, row, slot, position), positions and slots counted
    from ``start``: the first word's top 24 bits give u in (0, 1), and the
    noise is -log(-log(u)). An element depends on its counter alone, so any
    block of the noise is the same numbers however it is cut."""
    dev = seed.device
    ar = lambda n, k0=0: torch.arange(k0, k0 + n, dtype=torch.int64, device=dev)
    t = ar(positions, start[0]).reshape(-1, 1, 1, 1)
    s = ar(slots, start[1]).reshape(1, -1, 1, 1)
    r = ar(rows).reshape(1, 1, -1, 1)
    v = ar(vocab).reshape(1, 1, 1, -1)
    bits = philox4x32((v, r, s, t), (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF))[0]
    u = ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def filter_logits(lg: torch.Tensor, *, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature, then top-k, then nucleus filtering of (B, V) logits."""
    lg = lg / max(temperature, 1e-6)
    if top_k is not None and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -torch.inf, lg)
    if top_p is not None and top_p < 1.0:
        lg = nucleus_filter(lg, top_p)
    return lg


def draw_tokens(lg: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """A categorical draw from filtered (B, V) logits: the Gumbel-max
    argmax of ``lg + noise[:, :V]`` (noise (B, V_max) from
    :func:`gumbel_noise`), int64 (B,)."""
    return torch.argmax(lg.float() + noise[:, :lg.shape[-1]], dim=-1)


def position_noise(model: "MotionTokenPrior", seed: torch.Tensor, length: int,
                   rows: int) -> torch.Tensor:
    """The noise of every draw of a sampling call: (length, S, rows, V_max)."""
    cfg = model.cfg
    return gumbel_noise(seed, length, len(cfg.vocab_sizes), rows, max(cfg.vocab_sizes))


def sample_position_slots(model: MotionTokenPrior, ctx_t: torch.Tensor, noise: torch.Tensor,
                          *, temperature: float = 1.0, top_k: Optional[int] = None,
                          top_p: Optional[float] = None) -> torch.Tensor:
    """All S slots of one position from its backbone context (B, d_model)
    and its noise (S, B, V_max): the heads once, or for a ``slot_ar`` prior
    the depth stack once a slot, so slot s conditions on the slots < s just
    drawn. Returns (B, S) int64."""
    S = len(model.cfg.vocab_sizes)
    slots = torch.zeros(ctx_t.shape[0], S, dtype=torch.int64, device=ctx_t.device)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    logits = None if model.cfg.slot_ar else model(mode="position_logits", ctx=ctx_t)
    for s in range(S):
        lg = (model(mode="position_logits", ctx=ctx_t, slots=slots, slot=s) if logits is None
              else logits[s])
        slots[:, s] = draw_tokens(filter_logits(lg, **kw), noise[s])
    return slots


def _prompt_grid(cfg: PriorConfig, batch: int, length: int, prompt, device):
    """The starting (batch, length, S) int64 grid and the prompt's length."""
    S = len(cfg.vocab_sizes)
    if length > cfg.max_len:
        raise ValueError(f"length {length} > max_len {cfg.max_len}")
    grid = torch.zeros(batch, length, S, dtype=torch.int64, device=device)
    if prompt is None:
        return grid, 0
    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.int64)
    if prompt.ndim == 2:
        prompt = prompt[None].expand(batch, *prompt.shape)
    if prompt.shape[0] != batch or prompt.shape[2] != S:
        raise ValueError(f"prompt shape {tuple(prompt.shape)} incompatible with "
                         f"(batch={batch}, ..., S={S})")
    n_prompt = int(prompt.shape[1])
    if n_prompt >= length:
        raise ValueError(f"prompt length {n_prompt} >= sample length {length}: "
                         "nothing to generate")
    grid[:, :n_prompt] = prompt
    return grid, n_prompt


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def sample_grids(model: MotionTokenPrior, seed: Seed, batch: int, length: int,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, class_ids: Optional[torch.Tensor] = None,
                 prompt=None) -> torch.Tensor:
    """Autoregressively sample (batch, length, S) int32 normalised code grids.

    Each position runs the backbone once on the whole grid so far
    ("context"; the causal bias keeps position t from reading t and later)
    and then :func:`sample_position_slots`. ``class_ids`` (batch,) selects
    the action of a class-conditioned prior. ``prompt`` (P, S) or
    (batch, P, S) fixes the first P positions, and only the rest are drawn
    (prompted continuation)."""
    dev = _device(model)
    grid, n_prompt = _prompt_grid(model.cfg, batch, length, prompt, dev)
    noise = position_noise(model, seed_tensor(seed, dev), length, batch)
    for t in range(n_prompt, length):
        ctx_t = model(grid, class_ids=class_ids, mode="context")[:, t]
        grid[:, t] = sample_position_slots(model, ctx_t, noise[t], temperature=temperature,
                                           top_k=top_k, top_p=top_p)
    return grid.to(torch.int32)


def sample_grids_guided(model: MotionTokenPrior, seed: Seed, batch: int, length: int,
                        decode_window, *, candidates: int = 8, temperature: float = 1.0,
                        top_k: Optional[int] = None, top_p: Optional[float] = None,
                        class_ids: Optional[torch.Tensor] = None, prompt=None,
                        dyn_weight: float = 0.0, return_choices: bool = False):
    """Overlap-consistency guided sampling (best-of-N resampling).

    At each position ``candidates`` continuations a sample are drawn from
    the prior (they share the position's backbone context and ride only the
    heads' and the decoder's batch axis: row b * C + c), each is decoded
    through ``decode_window`` ((B, S) codes of one position -> (B, W, D) raw
    window), and the one whose first W - stride frames best agree (least
    mean squared difference) with the previous chosen window's last frames
    is kept. ``dyn_weight`` > 0 subtracts that multiple of the candidate's
    mean per-frame speed from the score. Without a prompt position 0 keeps
    candidate 0; with one the previous window is the prompt's last
    position's. Returns (batch, length, S) int32, and with
    ``return_choices`` also the (batch, length) chosen candidates (-1 on
    the prompt)."""
    cfg = model.cfg
    S, W, stride = len(cfg.vocab_sizes), cfg.window, cfg.stride
    ov = W - stride
    if ov <= 0:
        raise ValueError(f"guided sampling needs window overlap: W={W} stride={stride}")
    if candidates < 2:
        raise ValueError("guided sampling needs candidates >= 2")
    C, dev = candidates, _device(model)
    grid, n_prompt = _prompt_grid(cfg, batch, length, prompt, dev)
    noise = position_noise(model, seed_tensor(seed, dev), length, batch * C)
    prev = decode_window(grid[:, n_prompt - 1]) if n_prompt else None
    choices = torch.full((batch, length), -1, dtype=torch.int64, device=dev)
    for t in range(n_prompt, length):
        ctx_t = model(grid, class_ids=class_ids, mode="context")[:, t]
        slots = sample_position_slots(model, ctx_t.repeat_interleave(C, dim=0), noise[t],
                                      temperature=temperature, top_k=top_k, top_p=top_p)
        wins = decode_window(slots).reshape(batch, C, W, -1)
        if prev is None:
            choice = torch.zeros(batch, dtype=torch.int64, device=dev)
        else:
            score = torch.mean((wins[:, :, :ov] - prev[:, None, stride:]) ** 2, dim=(2, 3))
            if dyn_weight:
                speed = torch.mean(torch.abs(torch.diff(wins, dim=2)), dim=(2, 3))
                score = score - dyn_weight * speed
            choice = torch.argmin(score, dim=1)
        rows = torch.arange(batch, device=dev)
        grid[:, t] = slots.reshape(batch, C, S)[rows, choice]
        prev = wins[rows, choice]
        choices[:, t] = choice
    grid = grid.to(torch.int32)
    return (grid, choices) if return_choices else grid


def grid_to_codes(cfg: PriorConfig, grid: torch.Tensor) -> dict:
    """(B, N, S_total) normalised grid -> {stream: (B*N, T')} normalised
    codes, one decode row a position."""
    B, N, S = grid.shape
    tp = cfg.tokens_per_stream
    flat = grid.reshape(B * N, S)
    return {name: flat[:, i * tp:(i + 1) * tp] for i, name in enumerate(cfg.streams)}


def codes_to_grid(cfg: PriorConfig, codes: dict, n_positions: int) -> torch.Tensor:
    """The inverse of :func:`grid_to_codes`: {stream: (B*N, T')} ->
    (B, N, S_total) int32."""
    flat = torch.cat([torch.as_tensor(codes[name]) for name in cfg.streams], dim=-1)
    return flat.reshape(-1, n_positions, flat.shape[-1]).to(torch.int32)
