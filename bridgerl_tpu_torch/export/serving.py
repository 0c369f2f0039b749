"""In-process serving functions: raw motion in, raw motion out.

Counterpart of ``bridgerl_tpu/export/serialize.py``'s ``make_serving_fns``
and ``ServingModule``, without a frozen artifact (that is a later module of
the port): the functions close over a live model on its device.

Functions (float32 in, channel-last, any batch size):
    retarget     (b, W, 126) raw human windows -> (b, W, 29) raw robot joints
    robot_recon  (b, W, 29) raw robot windows  -> (b, W, 29) reconstruction
    motion_codes (b, W, 126) raw human windows -> dict of int32 (b, tokens)
                 code streams named as the JAX package names them
                 (:func:`code_stream_names`); absent for ``ae``, which has
                 no codes, as in the JAX package

Normalisation stats default to identity (raw in, raw out), the JAX
package's default (``ref_normalize=False``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

FORMAT_TAG = "bridgerl-serving-v1"
Stats = Tuple[np.ndarray, np.ndarray]


def identity_stats(dim: int) -> Stats:
    return np.zeros(dim, np.float32), np.ones(dim, np.float32)


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_serving_fns(model, robot_stats: Optional[Stats] = None,
                     human_stats: Optional[Stats] = None) -> Dict[str, Callable]:
    """Raw-in/raw-out inference closures over ``model`` on its device. Each
    takes an array or tensor and returns tensors on the model's device."""
    cfg = model.cfg
    dev = _model_device(model)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    r_mean, r_std = (as_t(a) for a in (robot_stats or identity_stats(cfg.robot_input_dim)))
    h_mean, h_std = (as_t(a) for a in (human_stats or identity_stats(cfg.human_input_dim)))

    def _in(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    @torch.inference_mode()
    def retarget(x_human):
        out = model(x_human=(_in(x_human) - h_mean) / h_std)
        return out["human"]["retargeted"].float() * r_std + r_mean

    @torch.inference_mode()
    def robot_recon(x_robot):
        out = model(x_robot=(_in(x_robot) - r_mean) / r_std)
        return out["robot"]["recon"].float() * r_std + r_mean

    @torch.inference_mode()
    def motion_codes(x_human):
        out = model(x_human=(_in(x_human) - h_mean) / h_std)
        return {k: v.to(torch.int32) for k, v in sorted(out["human"]["codes"].items())}

    fns = {"retarget": retarget, "robot_recon": robot_recon}
    if cfg.method != "ae":
        fns["motion_codes"] = motion_codes
    return fns


def code_stream_names(cfg) -> Tuple[str, ...]:
    """The method's code streams, in the JAX package's names."""
    if cfg.method == "ae":
        return ()
    if cfg.method == "rvq":
        return tuple(f"quantizer/vq_{i}" for i in range(cfg.n_layers))
    if cfg.method == "hybrid":
        return ("quantizer/fsq",) + tuple(f"quantizer/rvq/vq_{i}" for i in range(4))
    return ("quantizer",)


def tokens_per_window(cfg) -> int:
    """Latent tokens of one window: the transformer's pooled tokens, a
    quarter of the window for the strided conv towers, every frame for
    ``resnet_no_down``."""
    if cfg.arch == "transformer":
        return cfg.tf_tokens
    return cfg.window_size if cfg.arch == "resnet_no_down" else cfg.window_size // 4


def function_signatures(cfg) -> Dict[str, Dict[str, Any]]:
    """``meta["functions"]`` as the JAX serving artifact writes it."""
    W, h, r = cfg.window_size, cfg.human_input_dim, cfg.robot_input_dim
    sigs = {
        "retarget": {"input": ["b", W, h], "output": ["b", W, r], "dtype": "float32"},
        "robot_recon": {"input": ["b", W, r], "output": ["b", W, r], "dtype": "float32"},
    }
    if cfg.method != "ae":
        codes = {name: ["b", tokens_per_window(cfg)] for name in code_stream_names(cfg)}
        sigs["motion_codes"] = {"input": ["b", W, h], "output": codes, "dtype": "float32"}
    return sigs


@dataclass
class ServingModule:
    """Serving functions with their metadata, like a loaded JAX artifact."""

    meta: Dict[str, Any]
    fns: Dict[str, Callable]
    device: torch.device

    def retarget(self, x_human) -> torch.Tensor:
        return self.fns["retarget"](x_human)

    def robot_recon(self, x_robot) -> torch.Tensor:
        return self.fns["robot_recon"](x_robot)

    def motion_codes(self, x_human) -> Dict[str, torch.Tensor]:
        return self.fns["motion_codes"](x_human)

    @property
    def window_size(self) -> int:
        return int(self.meta["functions"]["retarget"]["input"][1])


def build_serving_module(model, exp, robot_stats: Optional[Stats] = None,
                         human_stats: Optional[Stats] = None) -> ServingModule:
    """The serving functions over ``model`` with the JAX artifact's metadata
    layout (no checkpoint is involved: the weights are the live model's)."""
    meta = {
        "format": FORMAT_TAG,
        "config_json": exp.to_json(),
        "torch_version": torch.__version__,
        "device": str(_model_device(model)),
        "source_checkpoint": "<in-memory>",
        "ref_normalize": robot_stats is not None or human_stats is not None,
        "functions": function_signatures(exp.model),
    }
    return ServingModule(meta=meta, fns=make_serving_fns(model, robot_stats, human_stats),
                         device=_model_device(model))
