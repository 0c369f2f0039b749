"""Train the motion-token prior: code extraction, training, checkpoints, and
sampling back to motion.

Counterpart of ``bridgerl_tpu/train/prior.py``:

    full_raw sequences --extract_code_grids--> (n_grids, max_len, S) + mask
    train_prior: AdamW + causal CE, 90/10 split, early stopping
    sample_motion: prior sample -> denormalize -> decode_codes ->
                   decode_latent -> overlap-add stitch -> raw (T, 29) motion

Extraction encodes robot windows through the VQ-VAE's robot encoder and
quantizer (K1 in the transformer towers, K2 in the VQ stages) in chunks of
one padded shape. Training keeps the grids on the device; the split and each
epoch's batch order come from the same numpy generators as the JAX
package's, so both see the same batches. Checkpoints are a torch payload
``{"kind": "bridgerl-token-prior", "config_json", "state_dict",
"history"}``, read with ``weights_only=True`` (the JAX package writes flax
msgpack).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.token_prior import (
    MotionTokenPrior,
    PriorConfig,
    draw_tokens,
    flatten_vocab_sizes,
    grid_to_codes,
    gumbel_noise,
    init_prior,
    prior_loss,
    prior_loss_sums,
    sample_grids,
    sample_grids_guided,
)
from ..ops.attention import SEED_HIGH
from ..ops.code_decode import code_vocab_sizes, decode_codes, denormalize_codes, normalize_codes
from ..ops.quantizers import prefix_codes

PRIOR_KIND = "bridgerl-token-prior"


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


# --------------------------------------------------------------- extraction

def robot_codes(model, x_robot: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Normalised robot windows -> {stream: (B, T') int32} code streams, named
    as the JAX package names them (``quantizer/fsq``, ...)."""
    _, _, _, codes = model.quantizer(model.encode_robot(x_robot), train=False)
    return {k: v.to(torch.int32) for k, v in sorted(prefix_codes("quantizer", codes).items())}


def extract_code_grids(model, exp, sequences: List[np.ndarray], mean: np.ndarray,
                       std: np.ndarray, stride: int, max_len: int = 256,
                       batch_windows: int = 4096, phases: Sequence[int] = (0,),
                       return_energy: bool = False):
    """Tokenize raw robot sequences into padded normalised code grids.

    Windows lie on the pure stride grid (start + W <= T); each of ``phases``
    shifts the grid by a start offset in [0, stride). A take longer than
    ``max_len`` positions becomes several grids; a tail of fewer than 2
    positions is dropped. The windows are encoded on the model's device in
    chunks of ``min(batch_windows, total)``, the last zero-padded. Returns
    (grids (n, max_len, S) int32, mask (n, max_len) float32, PriorConfig,
    seq_ids (n,) int32), and with ``return_energy`` also each position's
    raw-window mean per-frame speed (n, max_len) float32."""
    W = exp.model.window_size
    sizes = sorted(code_vocab_sizes(exp.model).items())
    per_seq_windows: List[np.ndarray] = []
    counts: List[int] = []
    seq_ids: List[int] = []
    for si, seq in enumerate(sequences):
        seq = np.asarray(seq, np.float32)
        for phase in phases:
            if not 0 <= phase < max(stride, 1):
                raise ValueError(f"phase {phase} outside [0, stride)")
            wins = [seq[s:s + W] for s in range(phase, seq.shape[0] - W + 1, stride)]
            for off in range(0, len(wins), max_len):
                chunk_wins = wins[off:off + max_len]
                if len(chunk_wins) < 2:
                    continue
                per_seq_windows.append(np.stack(chunk_wins))
                counts.append(len(chunk_wins))
                seq_ids.append(si)
    if not per_seq_windows:
        raise ValueError(f"no sequence yields a full window (W={W})")

    all_wins = np.concatenate(per_seq_windows)
    norm = ((all_wins - mean) / std).astype(np.float32)
    total = norm.shape[0]
    chunk = min(batch_windows, total)
    pad = (-total) % chunk
    if pad:
        norm = np.concatenate([norm, np.zeros((pad, *norm.shape[1:]), np.float32)])
    dev = _device(model)
    chunks: List[Dict[str, np.ndarray]] = []
    with torch.inference_mode():
        for i in range(0, norm.shape[0], chunk):
            out = robot_codes(model, torch.from_numpy(norm[i:i + chunk]).to(dev))
            chunks.append({k: v.cpu().numpy() for k, v in out.items()})
    codes = {k: np.concatenate([c[k] for c in chunks])[:total] for k in chunks[0]}
    codes = normalize_codes(exp.model, codes)

    tokens_per_stream = codes[sizes[0][0]].shape[1]
    pcfg = PriorConfig(
        streams=tuple(name for name, _ in sizes),
        vocab_sizes=flatten_vocab_sizes(sizes, tokens_per_stream),
        tokens_per_stream=tokens_per_stream, window=W, stride=int(stride), max_len=max_len,
        source_experiment=exp.id)
    S = len(pcfg.vocab_sizes)
    flat = np.concatenate([codes[name] for name, _ in sizes], axis=-1)
    grids = np.zeros((len(counts), max_len, S), np.int32)
    mask = np.zeros((len(counts), max_len), np.float32)
    energy = np.zeros((len(counts), max_len), np.float32)
    win_speed = np.abs(np.diff(all_wins, axis=1)).mean(axis=(1, 2))
    off = 0
    for i, n in enumerate(counts):
        grids[i, :n] = flat[off:off + n]
        mask[i, :n] = 1.0
        energy[i, :n] = win_speed[off:off + n]
        off += n
    if return_energy:
        return grids, mask, pcfg, np.asarray(seq_ids, np.int32), energy
    return grids, mask, pcfg, np.asarray(seq_ids, np.int32)


# ----------------------------------------------------------------- training

def energy_tilt_weights(energy: np.ndarray, mask: np.ndarray, lam: float) -> np.ndarray:
    """Per-position CE weights exp(lam * standardised window speed), masked
    and normalised to mean 1 over the valid positions (lam = 0 -> mask)."""
    valid = mask > 0
    e = energy[valid]
    mu, sd = float(e.mean()), float(e.std()) + 1e-8
    w = np.exp(lam * (energy - mu) / sd) * mask
    w *= mask.sum() / np.maximum(w.sum(), 1e-8)
    return w.astype(np.float32)


@dataclasses.dataclass
class PriorTrainConfig:
    epochs: int = 200
    batch_size: int = 32
    lr: float = 3e-4
    weight_decay: float = 0.01
    val_fraction: float = 0.1
    patience: int = 30
    seed: int = 42
    compute_dtype: str = "float32"
    # the metric that picks the returned weights and drives early stopping:
    # "val" (grouped validation CE) or "train" (train CE)
    select: str = "val"
    # the largest probability (ramped linearly from 0 over the planned
    # epochs) of replacing a context position by the model's own draw;
    # 0 = teacher forcing
    scheduled_sampling: float = 0.0


def split_indices(n: int, tcfg: PriorTrainConfig, seq_ids=None,
                  val_take_ids=None) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, val_idx), drawn as the JAX package draws them: by take
    when ``seq_ids`` is given (all grids of a take on one side), pinned to
    ``val_take_ids`` when given, else a seeded permutation of the grids."""
    if val_take_ids is not None and seq_ids is None:
        raise ValueError("val_take_ids requires seq_ids")
    rng = np.random.default_rng(tcfg.seed)
    if seq_ids is None:
        perm = rng.permutation(n)
        n_val = max(1, int(n * tcfg.val_fraction)) if n > 1 else 0
        return perm[n_val:], perm[:n_val]
    seq_ids = np.asarray(seq_ids)
    if seq_ids.shape != (n,):
        raise ValueError(f"seq_ids shape {seq_ids.shape} != ({n},)")
    if val_take_ids is not None:
        all_takes = set(np.unique(seq_ids).tolist())
        val_takes = {int(s) for s in val_take_ids}
        unknown = val_takes - all_takes
        if unknown:
            raise ValueError(f"val_take_ids not in seq_ids: {sorted(unknown)}")
        if not all_takes - val_takes:
            raise ValueError("val_take_ids covers every take; nothing left to train on")
    else:
        takes = rng.permutation(np.unique(seq_ids))
        n_val_takes = max(1, int(len(takes) * tcfg.val_fraction)) if len(takes) > 1 else 0
        val_takes = set(takes[:n_val_takes].tolist())
    is_val = np.asarray([int(s) in val_takes for s in seq_ids])
    val_idx = rng.permutation(np.nonzero(is_val)[0])
    train_idx = rng.permutation(np.nonzero(~is_val)[0])
    return train_idx, val_idx


def epoch_order(train_idx: np.ndarray, tcfg: PriorTrainConfig, epoch: int) -> np.ndarray:
    """The epoch's (steps, batch) index matrix, as the JAX package draws it."""
    bs = min(tcfg.batch_size, train_idx.size)
    steps = train_idx.size // bs
    order = np.random.default_rng(tcfg.seed * 100003 + epoch).permutation(train_idx)
    return order[:steps * bs].reshape(steps, bs)


def scheduled_sample(model: MotionTokenPrior, g: torch.Tensor, c, ss_prob: float,
                     generator: torch.Generator) -> torch.Tensor:
    """Two-pass scheduled sampling's first pass: the model's own draws (its
    eval-mode logits, Philox-Gumbel noise keyed by a seed from
    ``generator``), each whole position of the context replaced by them with
    probability ``ss_prob`` (a Bernoulli from ``generator``)."""
    with torch.no_grad():
        logits = model(g, train=False, class_ids=c)
        seed = torch.randint(0, SEED_HIGH, (), generator=generator, device=g.device)
        B, N = g.shape[:2]
        sampled = torch.stack([
            draw_tokens(lg.reshape(B * N, -1),
                        gumbel_noise(seed, 1, 1, B * N, lg.shape[-1], (0, s))[0, 0]).reshape(B, N)
            for s, lg in enumerate(logits)], dim=-1)
        replace = torch.rand((B, N), generator=generator, device=g.device) < ss_prob
        return torch.where(replace[..., None], sampled, g.long())


def _pad_rows(a: np.ndarray, pad: int) -> np.ndarray:
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a


def train_prior(grids: np.ndarray, mask: np.ndarray, pcfg: PriorConfig,
                tcfg: PriorTrainConfig, verbose: bool = True,
                class_ids: Optional[np.ndarray] = None, seq_ids: Optional[np.ndarray] = None,
                val_take_ids: Optional[Sequence[int]] = None,
                pos_weights: Optional[np.ndarray] = None, device=None,
                initial: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[MotionTokenPrior, Dict[str, List[float]]]:
    """Returns (the prior holding the best weights, in eval mode on
    ``device`` (the card by default), history).

    ``pos_weights`` (n, max_len) multiply the train loss's per-position CE
    (validation stays unweighted). ``class_ids`` (n,) are required exactly
    when ``pcfg.class_names`` is set. ``seq_ids`` (n,) split by take;
    ``val_take_ids`` pin the validation takes. ``initial`` is a state_dict
    to start from (default: fresh weights from ``tcfg.seed``). Dropout and
    scheduled sampling draw from a generator seeded ``tcfg.seed + 1``. The
    best weights are kept on the device."""
    if bool(pcfg.class_names) != (class_ids is not None):
        raise ValueError("class_ids must be given exactly when pcfg.class_names is set")
    if tcfg.select not in ("val", "train"):
        raise ValueError(f"select must be 'val' or 'train', got {tcfg.select}")
    dev = resolve_device(device)
    n = grids.shape[0]
    train_idx, val_idx = split_indices(n, tcfg, seq_ids, val_take_ids)
    if train_idx.size == 0:
        raise ValueError("prior training needs at least one train sequence")
    n_val = val_idx.size

    model = init_prior(pcfg, tcfg.seed, tcfg.compute_dtype, device=dev)
    if initial is not None:
        model.load_state_dict(initial, strict=True)
    opt = torch.optim.AdamW(model.parameters(), lr=tcfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tcfg.weight_decay)

    if pos_weights is not None and pos_weights.shape != mask.shape:
        raise ValueError(f"pos_weights shape {pos_weights.shape} != mask shape {mask.shape}")
    g_dev = torch.as_tensor(grids, dtype=torch.int64).to(dev)
    weights = mask if pos_weights is None else np.asarray(pos_weights, np.float32) * mask
    m_dev = torch.as_tensor(np.asarray(weights, np.float32)).to(dev)
    use_cls = bool(pcfg.class_names)
    c_dev = (torch.as_tensor(np.asarray(class_ids), dtype=torch.int64).to(dev) if use_cls
             else None)
    if n_val:
        # ~32k positions a chunk, the last padded with zero-weight rows
        eval_chunk = max(1, min(n_val, 32768 // max(int(grids.shape[1]), 1)))
        pad = (-n_val) % eval_chunk
        gv = torch.as_tensor(_pad_rows(grids[val_idx], pad), dtype=torch.int64).to(dev)
        mv = torch.as_tensor(_pad_rows(mask[val_idx], pad)).to(dev)
        cv = (torch.as_tensor(_pad_rows(np.asarray(class_ids)[val_idx].astype(np.int64), pad))
              .to(dev) if use_cls else None)

    def eval_fn() -> float:
        total = weight = 0.0
        with torch.no_grad():
            for i in range(0, gv.shape[0], eval_chunk):
                g = gv[i:i + eval_chunk]
                c = cv[i:i + eval_chunk] if use_cls else None
                s, w = prior_loss_sums(model(g, train=False, class_ids=c), g,
                                       mv[i:i + eval_chunk])
                total += float(s)
                weight += float(w)
        return total / max(weight, 1.0)

    generator = torch.Generator(device=dev).manual_seed(tcfg.seed + 1)
    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
    best, best_state, patience = float("inf"), None, 0
    t0 = time.time()
    for ep in range(tcfg.epochs):
        idx_mat = torch.from_numpy(epoch_order(train_idx, tcfg, ep)).to(dev)
        ss_prob = tcfg.scheduled_sampling * ep / max(tcfg.epochs - 1, 1)
        losses = []
        for idx in idx_mat:
            g, m = g_dev[idx], m_dev[idx]
            c = c_dev[idx] if use_cls else None
            g_in = (scheduled_sample(model, g, c, ss_prob, generator)
                    if tcfg.scheduled_sampling > 0.0 else g)
            loss = prior_loss(model(g_in, train=True, class_ids=c, generator=generator), g, m)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        tr = float(torch.stack(losses).mean())
        vl = eval_fn() if n_val else tr
        history["train_loss"].append(tr)
        history["val_loss"].append(vl)
        monitored = vl if tcfg.select == "val" else tr
        if monitored < best - 1e-6:
            best, patience = monitored, 0
            best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        else:
            patience += 1
        if verbose and (ep % 10 == 0 or ep == tcfg.epochs - 1):
            print(f"[prior] ep {ep}: train {tr:.4f} val {vl:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if tcfg.patience > 0 and patience >= tcfg.patience:
            if verbose:
                print(f"[prior] early stop at epoch {ep} (best {best:.4f})", flush=True)
            break
    if best_state is not None:
        model.load_state_dict(best_state)
    return model.eval(), history


def classify_grids(model: MotionTokenPrior, grids: np.ndarray, mask: np.ndarray, *,
                   batch: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Prior as classifier: each grid's mean next-token CE under every class
    token; argmin is the Bayes decision under a uniform class prior. Returns
    (pred (n,) int32, ce (n, C) float32). Batches of one padded shape."""
    C = len(model.cfg.class_names)
    if not C:
        raise ValueError("classify_grids needs a class-conditioned prior")
    n = grids.shape[0]
    b = min(batch, n)
    dev = _device(model)
    out = np.zeros((n, C), np.float32)
    with torch.no_grad():
        for i in range(0, n, b):
            take = min(b, n - i)
            g = np.zeros((b, *grids.shape[1:]), np.int64)
            m = np.zeros((b, mask.shape[1]), np.float32)
            g[:take], m[:take] = grids[i:i + take], mask[i:i + take]
            g, m = torch.from_numpy(g).to(dev), torch.from_numpy(m).to(dev)
            denom = torch.clamp(m.sum(dim=1), min=1.0)
            ce = []
            for cls in range(C):
                logits = model(g, train=False,
                               class_ids=torch.full((b,), cls, dtype=torch.int64, device=dev))
                tot = 0.0
                for s, lg in enumerate(logits):
                    e = torch.nn.functional.cross_entropy(
                        lg.float().reshape(-1, lg.shape[-1]), g[..., s].reshape(-1),
                        reduction="none").reshape(m.shape)
                    tot = tot + (e * m).sum(dim=1) / denom
                ce.append(tot / len(logits))
            out[i:i + take] = torch.stack(ce, dim=1).cpu().numpy()[:take]
    return out.argmin(axis=1).astype(np.int32), out


# ------------------------------------------------------------- checkpointing

def save_prior_checkpoint(path: str, prior: Union[nn.Module, Mapping[str, torch.Tensor]],
                          pcfg: PriorConfig, history: Optional[dict] = None) -> None:
    """Write the prior (a module or its state_dict) with its config and
    history as a torch payload, atomically."""
    state = prior.state_dict() if isinstance(prior, nn.Module) else prior
    payload = {"kind": PRIOR_KIND, "config_json": pcfg.to_json(),
               "state_dict": {k: v.detach().cpu() for k, v in state.items()},
               "history": history or {}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_prior_checkpoint(path: str, device=None, dtype="float32"
                          ) -> Tuple[MotionTokenPrior, PriorConfig]:
    """(the prior in eval mode on ``device`` (the card by default), its
    config). Refuses any other file, the JAX package's msgpack included."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # an unpickling error of any kind: not this format
        raise ValueError(f"{path}: not a token-prior checkpoint of this package ({e})") from e
    if not isinstance(payload, dict) or payload.get("kind") != PRIOR_KIND:
        raise ValueError(f"{path}: not a token-prior checkpoint")
    pcfg = PriorConfig.from_json(payload["config_json"])
    model = MotionTokenPrior(pcfg, dtype)
    model.load_state_dict(payload["state_dict"], strict=True)
    return model.to(resolve_device(device)).eval(), pcfg


# ------------------------------------------------------------- generation

def stitch_windows_torch(windows: torch.Tensor, stride: int) -> torch.Tensor:
    """In-graph overlap-add (``stitch_windows_jax``): (B, N, W, D) windows on
    the stride grid -> (B, stride*(N-1)+W, D), the window sums divided by
    each frame's count."""
    B, N, W, D = windows.shape
    T = stride * (N - 1) + W
    acc = torch.zeros(B, T, D, dtype=windows.dtype, device=windows.device)
    cnt = np.zeros((T, 1), np.float32)
    for i in range(N):
        s = i * stride
        acc[:, s:s + W] = acc[:, s:s + W] + windows[:, i]
        cnt[s:s + W] += 1.0
    return acc / torch.as_tensor(np.maximum(cnt, 1.0), device=windows.device)


def stitch_windows(windows: np.ndarray, stride: int, *, counts_floor: float = 1.0
                   ) -> np.ndarray:
    """Overlap-add average of (N, W, D) windows on the stride grid ->
    (stride * (N-1) + W, D) float32, summed in float64."""
    N, W, D = windows.shape
    T = stride * (N - 1) + W
    acc = np.zeros((T, D), np.float64)
    cnt = np.zeros((T, 1), np.float64)
    for i in range(N):
        s = i * stride
        acc[s:s + W] += windows[i]
        cnt[s:s + W] += 1.0
    return (acc / np.maximum(cnt, counts_floor)).astype(np.float32)


def _stats(mean, std, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(np.asarray(mean, np.float32), device=device),
            torch.as_tensor(np.asarray(std, np.float32), device=device))


def decode_grid(vq_model, exp, pcfg: PriorConfig, grid: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor) -> torch.Tensor:
    """(B, N, S) normalised grid -> (B*N, W, D) raw float32 windows."""
    codes = denormalize_codes(exp.model, grid_to_codes(pcfg, grid))
    z_q = decode_codes(exp.model, vq_model, codes)
    return vq_model.decode_latent(z_q).float() * std + mean


def make_decode_window_fn(vq_model, exp, pcfg: PriorConfig, mean, std):
    """Guided sampling's decoder: (B, S) normalised codes of one position ->
    (B, W, D) raw window, on the VQ model's device."""
    mean_t, std_t = _stats(mean, std, _device(vq_model))
    return lambda codes_pos: decode_grid(vq_model, exp, pcfg, codes_pos[:, None, :], mean_t,
                                         std_t)


def make_generation_fn(vq_model, exp, prior_model: MotionTokenPrior, mean, std, *,
                       n_positions: int, n_samples: int = 1, temperature: float = 1.0,
                       top_k: Optional[int] = None, top_p: Optional[float] = None,
                       guide_candidates: int = 0, guide_dyn: float = 0.0):
    """fn(seed, class_ids=None) -> (batch, stride*(N-1)+W, D) float32 raw
    motion on the models' device: prior sampling (guided with
    ``guide_candidates`` >= 2), code decode, decoder, de-normalisation and
    overlap-add, all torch operations with static shapes, so
    ``export/serialize.py::export_generator_artifact`` freezes it. ``batch``
    is class_ids' length for a conditioned prior, else ``n_samples``."""
    pcfg = prior_model.cfg
    mean_t, std_t = _stats(mean, std, _device(vq_model))
    W = pcfg.window

    def generate(seed, class_ids=None):
        batch = class_ids.shape[0] if class_ids is not None else n_samples
        if guide_candidates >= 2:
            decode_window = make_decode_window_fn(vq_model, exp, pcfg, mean, std)
            grid = sample_grids_guided(prior_model, seed, batch, n_positions, decode_window,
                                       candidates=guide_candidates, temperature=temperature,
                                       top_k=top_k, top_p=top_p, class_ids=class_ids,
                                       dyn_weight=guide_dyn)
        else:
            grid = sample_grids(prior_model, seed, batch, n_positions, temperature=temperature,
                                top_k=top_k, top_p=top_p, class_ids=class_ids)
        wins = decode_grid(vq_model, exp, pcfg, grid, mean_t, std_t)
        return stitch_windows_torch(wins.reshape(batch, n_positions, W, -1), pcfg.stride)

    return generate


def sample_motion(vq_model, exp, prior_model: MotionTokenPrior, mean: np.ndarray,
                  std: np.ndarray, *, n_samples: int = 4, n_positions: int = 32,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None, seed: int = 0,
                  class_ids: Optional[np.ndarray] = None, prompt: Optional[np.ndarray] = None,
                  guide_candidates: int = 0, guide_dyn: float = 0.0,
                  return_windows: bool = False, return_grid: bool = False):
    """Sample token grids and decode them to raw robot motions: a list of
    (T, D) float32 arrays, T = stride*(n_positions-1) + W. ``return_windows``
    adds the pre-stitch windows (n_samples, N, W, D); ``return_grid`` the
    sampled (n_samples, N, S) int32 grid. ``prompt`` ((P, S) or
    (n_samples, P, S) normalised codes) fixes the first P positions;
    ``guide_candidates`` >= 2 samples guided (``guide_dyn`` its dynamics
    weight)."""
    pcfg = prior_model.cfg
    dev = _device(prior_model)
    cls = torch.as_tensor(np.asarray(class_ids), dtype=torch.int64).to(dev) \
        if class_ids is not None else None
    with torch.inference_mode():
        if guide_candidates >= 2:
            decode_window = make_decode_window_fn(vq_model, exp, pcfg, mean, std)
            grid = sample_grids_guided(prior_model, seed, n_samples, n_positions, decode_window,
                                       candidates=guide_candidates, temperature=temperature,
                                       top_k=top_k, top_p=top_p, prompt=prompt, class_ids=cls,
                                       dyn_weight=guide_dyn)
        else:
            grid = sample_grids(prior_model, seed, n_samples, n_positions,
                                temperature=temperature, top_k=top_k, top_p=top_p,
                                prompt=prompt, class_ids=cls)
        mean_t, std_t = _stats(mean, std, _device(vq_model))
        wins = decode_grid(vq_model, exp, pcfg, grid, mean_t, std_t).cpu().numpy()
    wins = wins.reshape(n_samples, n_positions, pcfg.window, -1)
    motions = [stitch_windows(w, pcfg.stride) for w in wins]
    extras = []
    if return_windows:
        extras.append(wins)
    if return_grid:
        extras.append(grid.cpu().numpy().astype(np.int32))
    return (motions, *extras) if extras else motions

