"""Carry weights from the JAX package's variable tree into the port.

``state_dict_from_jax(variables, cfg)`` takes the JAX model's variables
(``params``, and ``batch_stats`` and ``qstats`` where the arch and method
have them, as numpy arrays or anything ``np.asarray`` reads) and returns the
port's ``state_dict``, which ``DualMotionVQVAE.load_state_dict(...,
strict=True)`` takes, for every arch and method and with or without
``scan_layers``. The keys are the reference PyTorch model's: the layout that
``bridgerl_tpu/export/torch_import.py`` maps, kept here in the port's own
copy (``human_encoder.transformer.layers.{i}.self_attn.in_proj_weight``,
``robot_decoder.model.{i}.net.{j}.weight``, ``quantizer.layers.{i}.ema_w``,
...), with one difference: the FSQ and LFQ projections are ``nn.Linear``
here, so the reference's k=1 conv axis is squeezed.

Layouts converted:

- Dense kernel ``(in, out)``                  -> Linear weight ``(out, in)``
- Conv kernel ``(k, in, out)``                -> Conv1d weight ``(out, in, k)``
- ConvTranspose kernel ``(k, in, out)``       -> ConvTranspose1d weight
  ``(in, out, k)``, flipped along k (torch's transposed convolution is the
  adjoint of its cross-correlation; flax's is a fractionally strided one)
- per-head q/k/v kernels ``(d, heads, head_dim)`` and biases ``(heads,
  head_dim)`` -> packed ``in_proj_weight (3d, d)`` / ``in_proj_bias (3d,)``,
  q then k then v, heads major within each
- attention output kernel ``(heads, head_dim, d)`` -> ``out_proj.weight (d, d)``
- LayerNorm and BatchNorm scale/bias -> weight/bias; BatchNorm ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``, ``num_batches_tracked`` 0
- EMA codebook state copied as is; a standard VQ's codebook is a parameter
- ``scan_layers``: the stacked ``stack/layers/block`` leaves, layer i at
  index i, go to ``transformer.layers.{i}`` as the unstacked ``layer_{i}`` do
- ``int8_ff``: the JAX package's ``Int8Dense`` keeps ``nn.Dense``'s tree, so
  its ``ff1`` / ``ff2`` go to ``linear1`` / ``linear2`` as they do without it
- a seed-stacked tree (``bridgerl_tpu/train/multiseed.py``): one state_dict
  per seed (:func:`state_dicts_from_stacked_jax`), or the port's stacked
  model's (:func:`stacked_state_dict_from_jax`)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

TOWERS = ("human_encoder", "robot_encoder", "robot_decoder")
StateDict = Dict[str, np.ndarray]


def _node(tree: Any, path: str) -> Any:
    node = tree
    for part in path.split("/"):
        try:
            node = node[part]
        except (KeyError, TypeError):
            raise KeyError(f"JAX variables have no {path!r} (config mismatch?)") from None
    return node


def _get(tree: Any, path: str) -> np.ndarray:
    return np.asarray(_node(tree, path), dtype=np.float32)


def _layer(tree: Any, i: int) -> Any:
    """Layer i of a tree whose leaves are stacked on their first axis."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _linear(sd: StateDict, dst: str, tree, src: str) -> None:
    sd[f"{dst}.weight"] = _get(tree, f"{src}/kernel").T
    sd[f"{dst}.bias"] = _get(tree, f"{src}/bias")


def _conv(sd: StateDict, dst: str, tree, src: str) -> None:
    sd[f"{dst}.weight"] = _get(tree, f"{src}/kernel").transpose(2, 1, 0)
    sd[f"{dst}.bias"] = _get(tree, f"{src}/bias")


def _conv_transpose(sd: StateDict, dst: str, tree, src: str) -> None:
    sd[f"{dst}.weight"] = _get(tree, f"{src}/kernel")[::-1].transpose(1, 2, 0)
    sd[f"{dst}.bias"] = _get(tree, f"{src}/bias")


def _attention(sd: StateDict, dst: str, tree, src: str) -> None:
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


def _block(sd: StateDict, dst: str, block) -> None:
    """One post-LN transformer block from its (unstacked) parameter tree."""
    _attention(sd, f"{dst}.self_attn", block, "self_attn")
    _linear(sd, f"{dst}.linear1", block, "ff1")
    _linear(sd, f"{dst}.linear2", block, "ff2")
    for norm in ("norm1", "norm2"):
        sd[f"{dst}.{norm}.weight"] = _get(block, f"{norm}/scale")
        sd[f"{dst}.{norm}.bias"] = _get(block, f"{norm}/bias")


def _transformer(sd: StateDict, tower: str, params, cfg) -> None:
    for proj in ("input_proj", "output_proj"):
        _linear(sd, f"{tower}.{proj}", params, f"{tower}/{proj}")
    stacked = _node(params, f"{tower}/stack/layers/block") if cfg.scan_layers else None
    for i in range(cfg.n_tf_layers):
        block = (_layer(stacked, i) if stacked is not None
                 else _node(params, f"{tower}/layer_{i}"))
        _block(sd, f"{tower}.transformer.layers.{i}", block)


def _resblock(sd: StateDict, dst: str, variables, src: str) -> None:
    """ResBlock1D: ``net.{0 conv, 1 bn, 3 conv, 4 bn}``."""
    params, stats = variables["params"], variables["batch_stats"]
    for j, (conv, bn) in enumerate(((0, 1), (3, 4))):
        _conv(sd, f"{dst}.net.{conv}", params, f"{src}/Conv_{j}")
        sd[f"{dst}.net.{bn}.weight"] = _get(params, f"{src}/BatchNorm_{j}/scale")
        sd[f"{dst}.net.{bn}.bias"] = _get(params, f"{src}/BatchNorm_{j}/bias")
        sd[f"{dst}.net.{bn}.running_mean"] = _get(stats, f"{src}/BatchNorm_{j}/mean")
        sd[f"{dst}.net.{bn}.running_var"] = _get(stats, f"{src}/BatchNorm_{j}/var")
        sd[f"{dst}.net.{bn}.num_batches_tracked"] = np.zeros((), np.int64)


def _conv_tower(sd: StateDict, tower: str, variables, cfg) -> None:
    """simple / resnet / resnet_no_down towers at the reference's indices."""
    p, n = variables["params"], cfg.num_res_layers
    m = f"{tower}.model"
    res = lambda idx, name: _resblock(sd, f"{m}.{idx}", variables, f"{tower}/{name}")
    if cfg.arch == "resnet_no_down":
        if tower == "robot_decoder":
            _conv(sd, f"{m}.out_conv", p, f"{tower}/out_conv")
        else:
            _conv(sd, f"{m}.0", p, f"{tower}/Conv_0")
            _conv(sd, f"{m}.final_conv", p, f"{tower}/final_conv")
        for i in range(n):
            res(f"res_{i}", f"res_{i}")
    elif tower == "robot_decoder" and cfg.arch == "simple":
        for j, idx in enumerate((0, 2)):
            _conv_transpose(sd, f"{m}.{idx}", p, f"{tower}/ConvTranspose_{j}")
    elif tower == "robot_decoder":     # resnet: [res x n, up, conv, act, res_mid, up, conv]
        for i in range(n):
            res(i, f"res_{i}")
        _conv(sd, f"{m}.{n + 1}", p, f"{tower}/Conv_0")
        res(n + 3, "res_mid")
        _conv(sd, f"{m}.{n + 5}", p, f"{tower}/Conv_1")
    elif cfg.arch == "simple":
        for j, idx in enumerate((0, 2)):
            _conv(sd, f"{m}.{idx}", p, f"{tower}/Conv_{j}")
    else:                              # resnet: [conv, act, res x n, conv, act, res_final]
        _conv(sd, f"{m}.0", p, f"{tower}/Conv_0")
        for i in range(n):
            res(2 + i, f"res_{i}")
        _conv(sd, f"{m}.{2 + n}", p, f"{tower}/Conv_1")
        res(4 + n, "res_final")


def _ema_vq(sd: StateDict, dst: str, qstats, src: str) -> None:
    sd[f"{dst}.embedding.weight"] = _get(qstats, f"{src}/embedding")
    sd[f"{dst}.ema_w"] = _get(qstats, f"{src}/ema_w")
    sd[f"{dst}.ema_cluster_size"] = _get(qstats, f"{src}/ema_cluster_size")


def _quantizer(sd: StateDict, variables, cfg) -> None:
    """The method's keys, as ``make_quantizer`` builds the method."""
    method, params = cfg.method, variables["params"]

    def projections(dst: str, src: str) -> None:
        for proj in ("project_in", "project_out"):
            _linear(sd, f"{dst}.{proj}", params, f"{src}/{proj}")

    if method == "standard":
        sd["quantizer.embedding.weight"] = _get(params, "quantizer/embedding")
    elif method == "ema":
        _ema_vq(sd, "quantizer", variables["qstats"], "quantizer")
    elif method == "rvq":
        for i in range(cfg.n_layers):
            _ema_vq(sd, f"quantizer.layers.{i}", variables["qstats"], f"quantizer/vq_{i}")
    elif method in ("fsq", "lfq"):
        projections("quantizer", "quantizer")
    elif method == "hybrid":
        projections("quantizer.fsq", "quantizer/fsq")
        for i in range(4):   # the hybrid's residual VQ has 4 layers
            _ema_vq(sd, f"quantizer.vq.layers.{i}", variables["qstats"],
                    f"quantizer/rvq/vq_{i}")


def state_dict_from_jax(variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX variables of a model of ``cfg`` -> the port's state_dict."""
    sd: StateDict = {}
    for tower in TOWERS:
        if cfg.arch == "transformer":
            _transformer(sd, tower, variables["params"], cfg)
        else:
            _conv_tower(sd, tower, variables, cfg)
    _quantizer(sd, variables, cfg)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _seed_tree(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _seed_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dicts_from_stacked_jax(variables: Mapping[str, Any], cfg, seeds: int
                                 ) -> list:
    """A seed-stacked JAX variable tree (every leaf with a leading axis of
    ``seeds``, as ``bridgerl_tpu/train/multiseed.py`` stacks it) -> one port
    state_dict per seed."""
    return [state_dict_from_jax(_seed_tree(variables, i), cfg) for i in range(seeds)]


def stacked_state_dict_from_jax(variables: Mapping[str, Any], cfg, seeds: int
                                ) -> Dict[str, torch.Tensor]:
    """A seed-stacked JAX variable tree -> the state_dict of the port's
    stacked model (``models/stacked.py``): each entry the seeds' stacked."""
    sds = state_dicts_from_stacked_jax(variables, cfg, seeds)
    return {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}
