"""In-process serving functions: raw motion in, raw motion out.

Counterpart of ``bridgerl_tpu/export/serialize.py``'s ``make_serving_fns``
and ``ServingModule``. Each function is a :class:`ServingFunction` module
over a model; served live it closes over the model on its device, and
``export/serialize.py`` freezes the same modules into an artifact.

Functions (float32 in, channel-last, any batch size):
    retarget     (b, W, 126) raw human windows -> (b, W, 29) raw robot joints
    robot_recon  (b, W, 29) raw robot windows  -> (b, W, 29) reconstruction
    motion_codes (b, W, 126) raw human windows -> dict of int32 (b, tokens)
                 code streams named as the JAX package names them
                 (:func:`code_stream_names`); absent for ``ae``, which has
                 no codes, as in the JAX package
    decode_codes dict of int32 (b, tokens) code streams -> (b, W, 29) raw
                 robot windows (``ops/code_decode.py``, then the decoder):
                 the inverse of motion_codes; absent for ``ae`` and for
                 unbounded FSQ (``fsq`` and ``hybrid`` with
                 ``fsq_bounded=False``), whose index is not invertible

Normalisation stats default to identity (raw in, raw out), the JAX
package's default (``ref_normalize=False``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.code_decode import decode_codes

# the JAX package's StableHLO artifact is "bridgerl-serving-v1"; the port's
# programs are torch.export ones, so it carries a tag of its own
FORMAT_TAG = "bridgerl-torch-serving-v1"
JAX_FORMAT_TAG = "bridgerl-serving-v1"
Stats = Tuple[np.ndarray, np.ndarray]


def identity_stats(dim: int) -> Stats:
    return np.zeros(dim, np.float32), np.ones(dim, np.float32)


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def has_decode(cfg) -> bool:
    """Whether the method's codes decode: every quantized method but the
    unbounded-FSQ ones."""
    return cfg.method != "ae" and not (cfg.method in ("fsq", "hybrid") and not cfg.fsq_bounded)


def serving_function_names(cfg) -> Tuple[str, ...]:
    names = ("retarget", "robot_recon")
    if cfg.method != "ae":
        names += ("motion_codes",)
    return names + (("decode_codes",) if has_decode(cfg) else ())


class ServingFunction(nn.Module):
    """One serving function over ``model``, with the normalisation stats as
    float32 buffers: raw float32 windows (or, for ``decode_codes``, a dict of
    int32 code streams) in, raw float32 windows (or a dict of int32 code
    streams, for ``motion_codes``) out, in eval mode."""

    def __init__(self, model: nn.Module, name: str, robot_stats: Optional[Stats] = None,
                 human_stats: Optional[Stats] = None):
        super().__init__()
        cfg = model.cfg
        if name not in serving_function_names(cfg):
            raise ValueError(f"{cfg.method} has no serving function {name!r}")
        self.model, self.name = model, name
        dev = _model_device(model)
        for prefix, stats, dim in (("r", robot_stats, cfg.robot_input_dim),
                                   ("h", human_stats, cfg.human_input_dim)):
            mean, std = stats or identity_stats(dim)
            self.register_buffer(f"{prefix}_mean", torch.as_tensor(
                np.asarray(mean, np.float32), device=dev))
            self.register_buffer(f"{prefix}_std", torch.as_tensor(
                np.asarray(std, np.float32), device=dev))

    def _robot_out(self, y: torch.Tensor) -> torch.Tensor:
        return y.float() * self.r_std + self.r_mean

    def forward(self, x):
        if self.name == "retarget":
            out = self.model(x_human=(x - self.h_mean) / self.h_std)
            return self._robot_out(out["human"]["retargeted"])
        if self.name == "robot_recon":
            out = self.model(x_robot=(x - self.r_mean) / self.r_std)
            return self._robot_out(out["robot"]["recon"])
        if self.name == "motion_codes":
            out = self.model(x_human=(x - self.h_mean) / self.h_std)
            return {k: v.to(torch.int32) for k, v in sorted(out["human"]["codes"].items())}
        z_q = decode_codes(self.model.cfg, self.model, x)
        return self._robot_out(self.model.decode_latent(z_q))


def as_codes(codes: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A dict of integer code streams as int32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=torch.int32).to(device) for k, v in codes.items()}


def as_windows(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def call_function(fn: Callable, name: str, x, device):
    """``fn`` on ``x`` moved to ``device`` (code streams as int32, windows
    as float32), without autograd."""
    arg = as_codes(x, device) if name == "decode_codes" else as_windows(x, device)
    with torch.inference_mode():
        return fn(arg)


def make_serving_fns(model, robot_stats: Optional[Stats] = None,
                     human_stats: Optional[Stats] = None) -> Dict[str, Callable]:
    """Raw-in/raw-out inference closures over ``model`` on its device. Each
    takes arrays or tensors (a dict of streams for ``decode_codes``) and
    returns tensors on the model's device."""
    dev = _model_device(model)
    fns = {}
    for name in serving_function_names(model.cfg):
        module = ServingFunction(model, name, robot_stats, human_stats)
        fns[name] = lambda x, module=module, name=name: call_function(module, name, x, dev)
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
    codes = {name: ["b", tokens_per_window(cfg)] for name in code_stream_names(cfg)}
    if cfg.method != "ae":
        sigs["motion_codes"] = {"input": ["b", W, h], "output": codes, "dtype": "float32"}
    if has_decode(cfg):
        sigs["decode_codes"] = {"input": codes, "output": ["b", W, r], "dtype": "int32"}
    return sigs


@dataclass
class ServingModule:
    """Serving functions with their metadata: over a live model
    (:func:`build_serving_module`) or a loaded artifact
    (``export/serialize.py::load_serving_artifact``)."""

    meta: Dict[str, Any]
    fns: Dict[str, Callable]
    device: torch.device

    def __getitem__(self, name: str) -> Callable:
        return self.fns[name]

    def retarget(self, x_human) -> torch.Tensor:
        return self.fns["retarget"](x_human)

    def robot_recon(self, x_robot) -> torch.Tensor:
        return self.fns["robot_recon"](x_robot)

    def motion_codes(self, x_human) -> Dict[str, torch.Tensor]:
        return self.fns["motion_codes"](x_human)

    def decode_codes(self, codes: Mapping[str, Any]) -> torch.Tensor:
        """Code streams -> raw robot windows (absent for ``ae`` and for
        unbounded FSQ)."""
        return self.fns["decode_codes"](codes)

    @property
    def window_size(self) -> int:
        return int(self.meta["functions"]["retarget"]["input"][1])


def serving_meta(exp, source: str, ref_normalize: bool) -> Dict[str, Any]:
    """The artifact's metadata layout: format tag, config, provenance and
    ``functions``."""
    return {
        "format": FORMAT_TAG,
        "config_json": exp.to_json(),
        "torch_version": torch.__version__,
        "source_checkpoint": source,
        "ref_normalize": ref_normalize,
        "functions": function_signatures(exp.model),
    }


def build_serving_module(model, exp, robot_stats: Optional[Stats] = None,
                         human_stats: Optional[Stats] = None) -> ServingModule:
    """The serving functions over ``model`` with the artifact's metadata
    layout (no checkpoint is involved: the weights are the live model's)."""
    dev = _model_device(model)
    meta = serving_meta(exp, "<in-memory>", robot_stats is not None or human_stats is not None)
    meta["device"] = str(dev)
    return ServingModule(meta=meta, fns=make_serving_fns(model, robot_stats, human_stats),
                         device=dev)
