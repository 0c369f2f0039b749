"""Carry weights from the JAX package's variable tree into the port.

``state_dict_from_jax(variables, cfg)`` takes the JAX model's variables
(``params`` and ``qstats``, as numpy arrays or anything ``np.asarray``
reads) and returns the port's ``state_dict``, which
``DualMotionVQVAE.load_state_dict(..., strict=True)`` takes. The keys are the
reference PyTorch model's (``human_encoder.transformer.layers.{i}.self_attn
.in_proj_weight``, ``quantizer.fsq.project_in.weight``,
``quantizer.vq.layers.{i}.ema_w``, ...), with one difference: the FSQ
projections are ``nn.Linear`` here, so the reference's k=1 conv axis is
squeezed.

Layouts converted:

- Dense kernel ``(in, out)``                  -> Linear weight ``(out, in)``
- per-head q/k/v kernels ``(d, heads, head_dim)`` and biases ``(heads,
  head_dim)`` -> packed ``in_proj_weight (3d, d)`` / ``in_proj_bias (3d,)``,
  q then k then v, heads major within each
- attention output kernel ``(heads, head_dim, d)`` -> ``out_proj.weight (d, d)``
- LayerNorm scale/bias -> weight/bias; EMA codebook state copied as is
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

TOWERS = ("human_encoder", "robot_encoder", "robot_decoder")


def _get(tree: Mapping[str, Any], path: str) -> np.ndarray:
    node: Any = tree
    for part in path.split("/"):
        try:
            node = node[part]
        except (KeyError, TypeError):
            raise KeyError(f"JAX variables have no {path!r} (config mismatch?)") from None
    return np.asarray(node, dtype=np.float32)


def _linear(sd: Dict[str, np.ndarray], dst: str, tree, src: str) -> None:
    sd[f"{dst}.weight"] = _get(tree, f"{src}/kernel").T
    sd[f"{dst}.bias"] = _get(tree, f"{src}/bias")


def _attention(sd: Dict[str, np.ndarray], dst: str, tree, src: str) -> None:
    kernels, biases = [], []
    for name in ("query", "key", "value"):
        k = _get(tree, f"{src}/{name}/kernel")          # (d, H, Dh)
        d = k.shape[0]
        kernels.append(k.reshape(d, d).T)
        biases.append(_get(tree, f"{src}/{name}/bias").reshape(-1))
    sd[f"{dst}.in_proj_weight"] = np.concatenate(kernels, axis=0)
    sd[f"{dst}.in_proj_bias"] = np.concatenate(biases, axis=0)
    out = _get(tree, f"{src}/out/kernel")               # (H, Dh, d)
    d = out.shape[-1]
    sd[f"{dst}.out_proj.weight"] = out.reshape(d, d).T
    sd[f"{dst}.out_proj.bias"] = _get(tree, f"{src}/out/bias")


def state_dict_from_jax(variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX variables of a transformer + hybrid model -> the port's state_dict."""
    if cfg.arch != "transformer" or cfg.method != "hybrid" or cfg.scan_layers:
        raise NotImplementedError(
            "weight conversion is ported for the transformer + hybrid model "
            "without scan_layers only (ROADMAP.md)")
    params, qstats = variables["params"], variables["qstats"]
    sd: Dict[str, np.ndarray] = {}
    for tower in TOWERS:
        for proj in ("input_proj", "output_proj"):
            _linear(sd, f"{tower}.{proj}", params, f"{tower}/{proj}")
        for i in range(cfg.n_tf_layers):
            dst, src = f"{tower}.transformer.layers.{i}", f"{tower}/layer_{i}"
            _attention(sd, f"{dst}.self_attn", params, f"{src}/self_attn")
            _linear(sd, f"{dst}.linear1", params, f"{src}/ff1")
            _linear(sd, f"{dst}.linear2", params, f"{src}/ff2")
            for norm in ("norm1", "norm2"):
                sd[f"{dst}.{norm}.weight"] = _get(params, f"{src}/{norm}/scale")
                sd[f"{dst}.{norm}.bias"] = _get(params, f"{src}/{norm}/bias")
    for proj in ("project_in", "project_out"):
        _linear(sd, f"quantizer.fsq.{proj}", params, f"quantizer/fsq/{proj}")
    for i in range(4):   # the hybrid's residual VQ has 4 layers
        src, dst = f"quantizer/rvq/vq_{i}", f"quantizer.vq.layers.{i}"
        sd[f"{dst}.embedding.weight"] = _get(qstats, f"{src}/embedding")
        sd[f"{dst}.ema_w"] = _get(qstats, f"{src}/ema_w")
        sd[f"{dst}.ema_cluster_size"] = _get(qstats, f"{src}/ema_cluster_size")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
