"""Serving artifacts: a trained retargeter frozen into ``torch.export`` programs.

Counterpart of ``bridgerl_tpu/export/serialize.py``. Each serving function
(``export/serving.py``: ``retarget``, ``robot_recon``, ``motion_codes``,
``decode_codes``) is traced once by ``torch.export.export`` with a symbolic
batch ``Dim("b")``, so one program serves any request size. Weights and
normalisation stats are constants of the program (raw motion in, raw motion
out). Tensors a forward makes on a device are fixed in its graph, so there
is one program per platform: ``cpu`` and ``cuda``.

The towers are exported with ``attn_packing`` 1. Packing tests
``b % P == 0``, which a symbolic batch cannot answer; the JAX artifact
likewise computes unpacked attention at every b (its test is False for a
symbolic b), K1 at S = W. The live serving module keeps packing; the two
compute the same function up to summation order.

Artifact layout (one .zip), as the JAX package's with ``.pt2`` programs in
place of its ``.bin`` StableHLO:

    meta.json              format tag, config JSON, function signatures,
                           platforms, provenance (source checkpoint, torch version)
    <fn>.<platform>.pt2    ``torch.export.save`` of one function's program

The format tag differs from the JAX package's, and each package's loader
refuses the other's zip. Loading needs no model code: the loader imports
``bridgerl_tpu_torch.ops``, which registers the custom ops the programs call
(K1 and K2), and nothing of ``models``, ``train`` or ``config``.
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ops  # noqa: F401  (registers the custom ops the programs call)
from ..device import resolve_device
from .serving import (
    FORMAT_TAG,
    JAX_FORMAT_TAG,
    ServingFunction,
    ServingModule,
    call_function,
    serving_meta,
)

PLATFORMS = ("cpu", "cuda")
EXAMPLE_BATCH = 2   # traced batch size; any b >= 0 runs (0 and 1 would specialise)


def _load_stats_pair(data_dir: Optional[str], mean_name: str, std_name: str,
                     dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Saved per-dim stats, or the identity where there are none (the
    reference's fallback, export_motion.py:16-23), broadcast to full width.
    ``data_dir=None`` asks for the identity."""
    identity = np.zeros(dim, np.float32), np.ones(dim, np.float32)
    if data_dir is None:
        return identity
    try:
        mean = np.load(os.path.join(data_dir, mean_name)).astype(np.float32)
        std = np.load(os.path.join(data_dir, std_name)).astype(np.float32)
    except FileNotFoundError:
        return identity
    return np.broadcast_to(mean, (dim,)).copy(), np.broadcast_to(std, (dim,)).copy()


def _unpacked_copy(model, device: torch.device):
    """The model's weights in a model of the same config with attn_packing 1,
    in eval mode on ``device``."""
    import dataclasses

    from ..models.dual_vqvae import DualMotionVQVAE

    cfg = dataclasses.replace(model.cfg, attn_packing=1)
    copy = DualMotionVQVAE(cfg, generator=torch.Generator().manual_seed(0))
    copy.load_state_dict(model.state_dict(), strict=True)
    return copy.to(device).eval()


def _signature_of(ep) -> Any:
    """The program's output shapes as meta.json writes them: ints, and "b"
    for the symbolic batch."""
    out = next(n for n in ep.graph.nodes if n.op == "output").args[0]
    shapes = [[d if isinstance(d, int) else "b" for d in a.meta["val"].shape] for a in out]
    tree = torch.utils._pytree.tree_unflatten(shapes, ep.call_spec.out_spec)
    return dict(tree) if isinstance(tree, dict) else tree


def _example(name: str, sig: Dict[str, Any], device: torch.device):
    """An example input of EXAMPLE_BATCH and its dynamic-shape spec."""
    b = torch.export.Dim("b")
    if isinstance(sig["input"], dict):
        codes = {k: torch.zeros(EXAMPLE_BATCH, spec[1], dtype=torch.int32, device=device)
                 for k, spec in sig["input"].items()}
        return (codes,), ({k: {0: b} for k in codes},)
    _, W, D = sig["input"]
    return (torch.zeros(EXAMPLE_BATCH, W, D, device=device),), ({0: b},)


def export_program(model, name: str, robot_stats, human_stats, sig: Dict[str, Any]):
    """One serving function of ``model`` (already unpacked, on its device)
    as a ``torch.export`` program; its output shapes must be ``sig``'s."""
    fn = ServingFunction(model, name, robot_stats, human_stats).eval()
    device = next(model.parameters()).device
    args, dynamic = _example(name, sig, device)
    ep = torch.export.export(fn, args, dynamic_shapes=dynamic)
    got = _signature_of(ep)
    if got != sig["output"]:
        raise RuntimeError(f"{name}: the program's output {got} is not {sig['output']}")
    return ep


def build_serving_artifact(model, exp, out_path: str,
                           data_dir: Optional[str] = "data/processed",
                           platforms: Sequence[str] = PLATFORMS, source: str = "<in-memory>",
                           ref_normalize: bool = False) -> Dict[str, Any]:
    """Freeze an in-memory (model, config) pair into ``out_path``; returns the
    metadata (also written as meta.json inside the zip).

    ``ref_normalize=True`` bakes the saved dataset stats into the programs,
    as the reference deployment normalises at inference
    (export_motion.py:47-53), although models train on raw windows; the
    default bakes identity stats (raw in, raw out). A ``cuda`` platform
    needs a card. ``meta["export_seconds"]`` times each platform's
    exports."""
    cfg = exp.model
    stats_src = data_dir if ref_normalize else None
    robot_stats = _load_stats_pair(stats_src, "mean.npy", "std.npy", cfg.robot_input_dim)
    human_stats = _load_stats_pair(stats_src, "human_mean.npy", "human_std.npy",
                                   cfg.human_input_dim)
    meta = serving_meta(exp, source, ref_normalize)
    meta["platforms"] = list(platforms)
    meta["attn_packing"] = 1
    meta["export_seconds"] = {}
    blobs: Dict[str, bytes] = {}
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r}; the port exports {PLATFORMS}")
        t0 = time.perf_counter()
        unpacked = _unpacked_copy(model, resolve_device(platform))
        for name, sig in meta["functions"].items():
            ep = export_program(unpacked, name, robot_stats, human_stats, sig)
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            blobs[f"{name}.{platform}.pt2"] = buf.getvalue()
        meta["export_seconds"][platform] = time.perf_counter() - t0

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = out_path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=2))
        for fname, blob in blobs.items():
            zf.writestr(fname, blob)
    os.replace(tmp, out_path)
    return meta


def export_serving_artifact(ckpt_path: str, out_path: str, data_dir: str = "data/processed",
                            platforms: Sequence[str] = PLATFORMS,
                            ref_normalize: bool = False) -> Dict[str, Any]:
    """Freeze the model of a ``.pth`` checkpoint (its config travels in
    ``config_json``) into a serving artifact."""
    from .motion_export import load_model_from_checkpoint

    model, exp = load_model_from_checkpoint(ckpt_path, device="cpu")
    return build_serving_artifact(model, exp, out_path, data_dir=data_dir, platforms=platforms,
                                  source=os.path.abspath(ckpt_path),
                                  ref_normalize=ref_normalize)


def export_fresh_artifact(out_path: str, arch: str = "transformer", method: str = "hybrid",
                          window: int = 10, data_dir: Optional[str] = None,
                          platforms: Sequence[str] = PLATFORMS) -> Dict[str, Any]:
    """Freeze a model of the given config with weights from seed 0: its
    programs are those of a trained model of that config. A ``data_dir``
    bakes its stats."""
    from ..config import make_experiment
    from ..models import init_model

    exp = make_experiment(arch, method, window=window)
    model = init_model(exp.model, 0, device="cpu")
    return build_serving_artifact(model, exp, out_path, data_dir=data_dir, platforms=platforms,
                                  source="<fresh-init>", ref_normalize=data_dir is not None)


def load_serving_artifact(path: str, device=None) -> ServingModule:
    """The artifact's programs for ``device``'s platform (the card by
    default) as a ServingModule. Raises on another format, the JAX
    package's StableHLO artifact included, and on a platform the artifact
    was not exported for."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        fmt = meta.get("format")
        if fmt != FORMAT_TAG:
            hint = (" (the JAX package's StableHLO artifact: load it with "
                    "bridgerl_tpu.export.load_serving_artifact)" if fmt == JAX_FORMAT_TAG else "")
            raise ValueError(f"{path}: artifact format {fmt!r} is not {FORMAT_TAG!r}{hint}")
        if dev.type not in meta["platforms"]:
            raise ValueError(f"{path} holds programs for {meta['platforms']}, not {dev.type}")
        fns = {}
        for name in meta["functions"]:
            program = torch.export.load(io.BytesIO(zf.read(f"{name}.{dev.type}.pt2"))).module()
            fns[name] = (lambda x, program=program, name=name:
                         call_function(program, name, x, dev))
    meta = {**meta, "device": str(dev)}
    return ServingModule(meta=meta, fns=fns, device=dev)
