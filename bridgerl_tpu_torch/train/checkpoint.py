"""Checkpoints in the reference's ``.pth`` layout, the teacher->student
transfer, and the transfer init of ``init_from``.

Counterpart of ``bridgerl_tpu/train/checkpoint.py``, writing the reference
PyTorch files (``scripts/train_ablation.py:276-291, 357-364``) instead of
msgpack:

- ``{run_name}_last.pth`` every epoch and ``{run_name}_best.pth`` on
  improvement: a dict of ``epoch``, ``model_state_dict``,
  ``optimizer_state_dict``, ``best_loss`` and ``config`` (a plain dict, as
  the reference's), plus ``patience_counter`` and the ``ExperimentConfig``
  JSON under ``config_json``;
- ``{run_name}_final.pth``: the bare ``state_dict``.

This is the layout ``bridgerl_tpu/export/torch_import.py`` reads, for every
arch and method: the state-dict keys are the reference model's, BatchNorm
layers included (``running_mean``, ``running_var``, ``num_batches_tracked``).
Its FSQ and LFQ projections are k=1 convolutions, so their weights gain a
trailing axis on save and lose it on load. Files are written atomically (temporary file, then rename) and read
with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..config import ExperimentConfig

# the projections of the hybrid's FSQ and of the fsq and lfq methods
PROJECTION_WEIGHTS = tuple(f"quantizer.{sub}{proj}.weight" for sub in ("fsq.", "")
                           for proj in ("project_in", "project_out"))


def to_reference_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's state_dict on the CPU, FSQ and LFQ projections as
    (out, in, 1)."""
    out = {k: v.detach().cpu() for k, v in sd.items()}
    for k in PROJECTION_WEIGHTS:
        if k in out:
            out[k] = out[k][..., None]
    return out


def from_reference_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(sd)
    for k in PROJECTION_WEIGHTS:
        if k in out and out[k].ndim == 3:
            out[k] = out[k][..., 0]
    return out


def reference_config(exp: ExperimentConfig) -> Dict[str, Any]:
    """The plain config dict the reference stores and ``torch_import`` reads."""
    m = exp.model
    return {"arch": m.arch, "method": m.method, "window": m.window_size,
            "hidden_dim": m.hidden_dim, "mode": exp.train.mode}


def _atomic_save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


StateLike = Union[nn.Module, torch.optim.Optimizer, Mapping]


def _state(obj: StateLike) -> Mapping:
    """A module's or optimizer's state_dict, or a state_dict as it is (one
    seed's share of a stacked run, ``models/stacked.py``)."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def save_checkpoint(path: str, *, epoch: int, model: StateLike,
                    optimizer: Optional[StateLike] = None,
                    best_loss: float = float("inf"),
                    config: Optional[ExperimentConfig] = None,
                    patience_counter: int = 0) -> None:
    _atomic_save({
        "epoch": int(epoch),
        "model_state_dict": to_reference_state_dict(_state(model)),
        "optimizer_state_dict": _state(optimizer) if optimizer is not None else {},
        "best_loss": float(best_loss),
        "config": reference_config(config) if config is not None else {},
        # persisted so a kill/resume cycle early-stops where an uninterrupted
        # run would
        "patience_counter": int(patience_counter),
        "config_json": config.to_json() if config is not None else "",
    }, path)


def save_state_dict(path: str, model: StateLike) -> None:
    """The bare reference-layout state_dict (the ``_final`` file)."""
    _atomic_save(to_reference_state_dict(_state(model)), path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Either layout -> {epoch, model_state_dict (the port's keys and
    shapes), optimizer_state_dict, best_loss, patience_counter, config
    (an ExperimentConfig or None)}."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" not in payload:
        payload = {"model_state_dict": payload}
    cfg_json = payload.get("config_json") or ""
    return {
        "epoch": int(payload.get("epoch", 0)),
        "model_state_dict": from_reference_state_dict(payload["model_state_dict"]),
        "optimizer_state_dict": payload.get("optimizer_state_dict") or {},
        "best_loss": float(payload.get("best_loss", float("inf"))),
        "patience_counter": int(payload.get("patience_counter", 0)),
        "config": ExperimentConfig.from_json(cfg_json) if cfg_json else None,
    }


# ---- teacher -> student transfer ----

def resolve_teacher_ckpt(pattern: str, seed: int) -> str:
    """A literal path is shared by every seed; a pattern containing
    ``{seed}`` pairs each student seed with its own teacher."""
    return pattern.format(seed=seed) if "{seed}" in pattern else pattern


def is_human_encoder(name: str) -> bool:
    return name.split(".")[0] == "human_encoder"


def merge_teacher_into_student(student_sd: Mapping[str, torch.Tensor],
                               teacher_sd: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """Every teacher entry except the human encoder's, over the student's
    (parameters and EMA buffers alike)."""
    return {k: (v if is_human_encoder(k) or k not in teacher_sd else teacher_sd[k])
            for k, v in student_sd.items()}


def merge_matching_variables(target_sd: Mapping[str, torch.Tensor],
                             source_sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every ``source_sd`` entry whose key exists in ``target_sd`` with the
    same shape (parameters and buffers alike), in the target's dtype; every
    other entry keeps its init. The transfer init of ``init_from``: an
    ``ae``-pretrained encoder and decoder into a quantized model whose
    quantizer stays fresh (the W64-transformer recipe)."""
    return {k: (source_sd[k].to(v.dtype) if k in source_sd
                and tuple(source_sd[k].shape) == tuple(v.shape) else v)
            for k, v in target_sd.items()}


def trainable_mask(model: nn.Module, mode: str) -> Dict[str, bool]:
    """Per-parameter: the teacher trains everything, the student only the
    human encoder."""
    return {name: mode == "teacher" or is_human_encoder(name)
            for name, _ in model.named_parameters()}
