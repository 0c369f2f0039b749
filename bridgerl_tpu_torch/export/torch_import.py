"""Import reference PyTorch checkpoints into the port, and export the port's
weights as the reference's learned tensors.

Counterpart of ``bridgerl_tpu/export/torch_import.py``. The reference trains
``DualMotionVQVAE`` in torch and ships ``.pth`` files: ``{run}_last/best.pth``
wrap ``model_state_dict`` with a plain ``config`` dict
(``scripts/train_ablation.py:276-284``), and ``_final.pth`` is the bare
state dict (:364). A user moving to the port brings those files; this module
turns one into the port's model, config included, so that every surface
(serving, export, replay, latent analysis, the student stage) runs the same
trained model on the card.

The port's state-dict keys are already the reference model's
(``train/checkpoint.py``), so the import is no tensor-by-tensor layout map
as it is for the JAX package, whose ``build_key_map`` and its transforms
(``_qkv``, ``_out_proj``, ``_convt``, ...) have no counterpart here. It is:

- key hygiene: DataParallel's ``module.`` prefix is stripped, the constant
  buffers the reference saves and the port rebuilds at init (``pe.pe``,
  FSQ/LFQ ``_levels`` / ``_basis``) are dropped, and FSQ/LFQ's k=1
  convolution weights lose their trailing axis
  (``from_reference_state_dict``);
- a strict load: every learned tensor and EMA buffer of the port's model
  must be in the file with its shape, and every other key in the file is an
  error; only ``num_batches_tracked``, which the JAX package's export leaves
  out, is refilled from init where the file has none;
- spec recovery: arch, method and widths from key names and shapes
  (``sniff_spec``), the file's own config dict winning where it has one.

Semantics: an imported experiment has ``fsq_bounded=False`` and
``lfq_norm=False`` unless ``overrides`` says otherwise. Both are the port's
training improvements and change the forward; a reference checkpoint was
trained without them (the reference's FSQ rounds unbounded, its LFQ takes
signs of the raw projection, 0 -> -1).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig, make_experiment
from ..device import resolve_device
from ..models.dual_vqvae import DualMotionVQVAE, init_model
from ..train.checkpoint import from_reference_state_dict, to_reference_state_dict

# buffers the reference saves and the port rebuilds at init, or (the BatchNorm
# counter) counts itself: never an error, never loaded from elsewhere
SKIP_SUFFIXES = ("num_batches_tracked", "pe.pe", "_levels", "_basis")
# the only state of the port's model a file may lack: refilled from init
REFILLED_SUFFIX = "num_batches_tracked"


def strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DataParallel's ``module.`` wrapper (export_motion.py:122-124)."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def split_payload(payload: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(state_dict, meta) from a wrapper dict or a bare state dict.

    Wrapper: ``{'epoch', 'model_state_dict', 'optimizer_state_dict',
    'best_loss', 'config'}`` (train_ablation.py:276-284); ``_final.pth`` is
    the bare state dict (:357-364)."""
    if isinstance(payload, dict) and "model_state_dict" in payload:
        meta = {"epoch": int(payload.get("epoch", 0)),
                "best_loss": float(payload.get("best_loss", float("inf"))),
                "config": payload.get("config") or {}}
        return strip_module_prefix(dict(payload["model_state_dict"])), meta
    if not isinstance(payload, dict):
        raise ValueError(f"unsupported checkpoint payload: {type(payload)}")
    return strip_module_prefix(dict(payload)), {"epoch": 0, "best_loss": float("inf"),
                                                "config": {}}


def sniff_spec(sd: Dict[str, Any], config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """(arch, method, dims, window...) from key names and shapes, the
    checkpoint's embedded config dict winning where it has a value, as the
    reference's own sniffing does (export_motion.py:129-132,
    analyze_latent_space.py:216-231). ``n_heads`` is not in the shapes and
    keeps its default."""
    config = config or {}
    spec: Dict[str, Any] = {}

    def dims(w) -> Tuple[int, int]:
        return int(w.shape[0]), int(w.shape[1])

    if "human_encoder.input_proj.weight" in sd:
        spec["arch"] = "transformer"
        spec["d_model"], spec["human_input_dim"] = dims(sd["human_encoder.input_proj.weight"])
        spec["robot_input_dim"] = int(sd["robot_encoder.input_proj.weight"].shape[1])
        spec["hidden_dim"] = int(sd["human_encoder.output_proj.weight"].shape[0])
        spec["ff_dim"] = int(sd["human_encoder.transformer.layers.0.linear1.weight"].shape[0])
        layer_ids = {int(m.group(1)) for k in sd
                     if (m := re.match(r"human_encoder\.transformer\.layers\.(\d+)\.", k))}
        spec["n_tf_layers"] = max(layer_ids) + 1
    else:
        for arch, key in (("resnet_no_down", "human_encoder.model.final_conv.weight"),
                          ("resnet", "human_encoder.model.2.net.0.weight"),
                          ("simple", "human_encoder.model.0.weight")):
            if key in sd:
                spec["arch"] = arch
                break
        else:
            raise ValueError("cannot identify encoder arch from state_dict keys")
        spec["hidden_dim"], spec["human_input_dim"] = dims(sd["human_encoder.model.0.weight"])
        spec["robot_input_dim"] = int(sd["robot_encoder.model.0.weight"].shape[1])

    if "quantizer.fsq.project_in.weight" in sd:
        spec["method"] = "hybrid"
    elif "quantizer.layers.0.embedding.weight" in sd:
        spec["method"] = "rvq"
        spec["codebook_size"] = int(sd["quantizer.layers.0.embedding.weight"].shape[0])
        spec["n_layers"] = 1 + max(int(m.group(1)) for k in sd
                                   if (m := re.match(r"quantizer\.layers\.(\d+)\.", k)))
    elif "quantizer.ema_w" in sd:
        spec["method"] = "ema"
        spec["codebook_size"] = int(sd["quantizer.embedding.weight"].shape[0])
    elif "quantizer.embedding.weight" in sd:
        spec["method"] = "standard"
        spec["codebook_size"] = int(sd["quantizer.embedding.weight"].shape[0])
    elif "quantizer.project_in.weight" in sd:
        # FSQ projects to len(levels) = 4 dims, LFQ to codebook_dim = 10
        # (vqvae.py:548, 550); the embedded config wins where it has a method
        out_dim = int(sd["quantizer.project_in.weight"].shape[0])
        spec["method"] = "lfq" if out_dim == 10 else "fsq"
    else:
        spec["method"] = "ae"

    for key in ("arch", "method", "window", "hidden_dim"):
        if config.get(key) is not None:
            spec[key] = config[key]
    return spec


def _tensor(v: Any) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _load_strict(model: DualMotionVQVAE, sd: Dict[str, Any]) -> None:
    """Load a reference-layout state dict (prefix already stripped) into
    ``model`` strictly: raises naming the keys when a learned tensor or EMA
    buffer is absent, a key has no destination or a shape differs."""
    sd = from_reference_state_dict({k: _tensor(v) for k, v in sd.items()})
    target = model.state_dict()
    missing = [k for k in target if k not in sd and not k.endswith(REFILLED_SUFFIX)]
    if missing:
        raise ValueError("state-dict entries absent from the checkpoint "
                         f"(arch/method mismatch?): {missing[:8]}")
    extra = [k for k in sd if k not in target and not k.endswith(SKIP_SUFFIXES)]
    if extra:
        raise ValueError(f"torch keys with no destination: {extra[:8]}")
    merged = {}
    for k, want in target.items():
        got = sd.get(k, want)
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{k}: the checkpoint's shape {tuple(got.shape)} is not the "
                             f"model's {tuple(want.shape)}")
        merged[k] = got.to(want.dtype)
    model.load_state_dict(merged, strict=True)


def import_torch_checkpoint(payload: Any, *, window: Optional[int] = None,
                            overrides: Optional[Dict[str, Any]] = None, device=None
                            ) -> Tuple[ExperimentConfig, DualMotionVQVAE, Dict[str, Any]]:
    """A reference torch payload -> (ExperimentConfig, the port's model in
    eval mode on ``device`` (the card by default), meta).

    ``window`` is required where the checkpoint's config dict does not
    record it (the transformer decoder bakes seq_len = window,
    vqvae.py:570)."""
    dev = resolve_device(device)
    sd, meta = split_payload(payload)
    spec = sniff_spec(sd, meta["config"])
    if window is not None:
        spec["window"] = window
    if "window" not in spec:
        raise ValueError("window not recorded in the checkpoint config; pass window= "
                         "(--window on the command line)")
    arch, method, win = spec.pop("arch"), spec.pop("method"), spec.pop("window")
    model_kwargs = {**spec, **(overrides or {})}
    model_kwargs.setdefault("fsq_bounded", False)
    model_kwargs.setdefault("lfq_norm", False)
    mode = meta["config"].get("mode") or "teacher"
    exp = make_experiment(arch, method, window=int(win), mode=mode, **model_kwargs)
    model = init_model(exp.model, 0, device="cpu")
    _load_strict(model, sd)
    return exp, model.to(dev).eval(), meta


def export_reference_state_dict(state_dict: Mapping[str, torch.Tensor], exp: ExperimentConfig
                                ) -> Dict[str, torch.Tensor]:
    """The learned tensors of a port model's ``state_dict`` (parameters,
    BatchNorm statistics, EMA codebook state) in the reference layout on the
    CPU: what
    ``bridgerl_tpu.export.torch_import.export_torch_state_dict`` writes. The
    reference's consumers load with ``strict=False`` and rebuild the
    constant buffers and counters at init, so those do not travel."""
    if exp.model.tf_tokens != 1:
        # the weights would map, but the reference model always mean-pools
        # to one token (vqvae.py:458): a K > 1 checkpoint would compute
        # other semantics through the torch modules
        raise ValueError(f"tf_tokens={exp.model.tf_tokens}: multi-token latents have no torch "
                         "counterpart in the reference; only tf_tokens=1 exports")
    return {k: v for k, v in to_reference_state_dict(state_dict).items()
            if not k.endswith(REFILLED_SUFFIX)}


def load_pth(path: str) -> Any:
    """``torch.load`` with the safe loader first (reference wrapper dicts
    are plain tensors and primitives); the pickle fallback, for files that
    route their dicts through pickle, warns."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:   # torch raises UnpicklingError, RuntimeError or others here
        print("[torch_import] weights_only load failed; retrying with full pickle "
              "(trusted-source checkpoints only)")
        return torch.load(path, map_location="cpu", weights_only=False)
