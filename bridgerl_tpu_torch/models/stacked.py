"""Seed-stacked models: S models of one config trained as one.

The counterpart of what ``jax.vmap`` over a seed axis does to the JAX
package's variables (``bridgerl_tpu/train/multiseed.py:86``,
``tree_map(jnp.stack)``). :func:`stack_models` turns S models of one
``ModelConfig`` into one model of the same classes whose parameters and
persistent buffers carry a leading axis of S, with the same state-dict keys;
seed i's state is index i of every entry (:func:`seed_state_dict`). Its
input batch is S seed-major groups of windows, and every layer computes
each seed on its own weights (``models/layers.py``, ``ops/quantizers.py``):
batched products for the dense layers, seed-grouped convolutions and
BatchNorm statistics, one K1 launch with one dropout seed per group and one
grouped K2 launch per call site. The model's ``generator`` is then a list of
S generators, seed i's dropout drawn from generator i in the order a
single-seed model draws it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch
from torch import nn


def _persistent(model: nn.Module) -> List[str]:
    return list(model.state_dict().keys())


def stack_models(models: Sequence[nn.Module]) -> nn.Module:
    """``models[0]``, its parameters and persistent buffers replaced by those
    of all ``models`` stacked on a new leading axis (the other models are
    left as they are). Non-persistent buffers (tables, masks) stay
    unstacked."""
    base, S = models[0], len(models)
    keys = set(_persistent(base))
    for name, _ in list(base.named_parameters()):
        owner, leaf = _owner(base, name)
        stacked = torch.stack([m.get_parameter(name).detach() for m in models])
        setattr(owner, leaf, nn.Parameter(stacked))
    for name, _ in list(base.named_buffers()):
        if name in keys:
            owner, leaf = _owner(base, name)
            owner._buffers[leaf] = torch.stack([m.get_buffer(name) for m in models])
    for m in base.modules():
        m.stacked_seeds = S
    return base


def _owner(model: nn.Module, name: str):
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def seed_state_dict(state: Mapping[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Seed i's state_dict, copied out of a stacked model's ``state``: the
    keys and shapes of a single-seed model."""
    return {k: v[i].detach().clone() for k, v in state.items()}


def seed_optimizer_state(state: Mapping, i: int) -> Dict:
    """Seed i's share of a stacked optimizer's state_dict: every per-element
    tensor indexed by the seed; the step count (a 0-d tensor) shared."""
    return {"state": {k: {n: (t[i].clone() if torch.is_tensor(t) and t.ndim else t)
                          for n, t in st.items()} for k, st in state["state"].items()},
            "param_groups": state["param_groups"]}


def stack_optimizer_states(states: Sequence[Mapping]) -> Dict:
    """Per-seed optimizer state_dicts -> the stacked optimizer's."""
    first = states[0]["state"]
    return {"state": {k: {n: (torch.stack([s["state"][k][n] for s in states])
                              if torch.is_tensor(t) and t.ndim else t)
                          for n, t in st.items()} for k, st in first.items()},
            "param_groups": states[0]["param_groups"]}
