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

The generator artifact (:func:`build_generator_artifact`) freezes a token
prior, the VQ-VAE's code decode and decoder, and the overlap-add into one
program per function and platform: ``generate`` (``generate_{action}`` per
class of a conditioned prior) maps an int64 seed to (n_samples,
stride*(N-1)+W, D) raw motion. The N positions are unrolled (N is static at
export); each draws its tokens from Philox-Gumbel noise keyed by the seed
(``models/token_prior.py``), so one seed gives the same motion live and
frozen.

The format tags differ from the JAX package's, and each package's loader
refuses the other's zips. Loading needs no model code: the loader imports
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
    GENERATOR_TAG,
    JAX_FORMAT_TAG,
    JAX_GENERATOR_TAG,
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
            blobs[f"{name}.{platform}.pt2"] = _save_program(ep)
        meta["export_seconds"][platform] = time.perf_counter() - t0

    _write_zip(out_path, meta, blobs)
    return meta


def _write_zip(out_path: str, meta: Dict[str, Any], blobs: Dict[str, bytes]) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = out_path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=2))
        for fname, blob in blobs.items():
            zf.writestr(fname, blob)
    os.replace(tmp, out_path)


def _save_program(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


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


class GeneratorFunction(torch.nn.Module):
    """``train/prior.py::make_generation_fn`` as a module of a seed: an
    int64 scalar tensor in, (n_samples, T, D) float32 raw motion out, for
    one action of a class-conditioned prior (``class_id``) or none."""

    def __init__(self, vq_model, exp, prior_model, mean, std, class_id: Optional[int], *,
                 n_positions: int, n_samples: int, **sampling):
        super().__init__()
        from ..train.prior import make_generation_fn

        self.vq_model, self.prior = vq_model, prior_model
        dev = next(prior_model.parameters()).device
        self.register_buffer("class_ids", None if class_id is None else torch.full(
            (n_samples,), class_id, dtype=torch.int64, device=dev))
        self.fn = make_generation_fn(vq_model, exp, prior_model, mean, std,
                                     n_positions=n_positions, n_samples=n_samples, **sampling)

    def forward(self, seed: torch.Tensor) -> torch.Tensor:
        return self.fn(seed, self.class_ids)


def build_generator_artifact(vq_model, exp, prior_model, out_path: str, mean=None, std=None,
                             *, n_positions: int = 32, n_samples: int = 4,
                             temperature: float = 1.0, top_k: Optional[int] = None,
                             guide_candidates: int = 0, guide_dyn: float = 0.0,
                             platforms: Sequence[str] = PLATFORMS, source: str = "<in-memory>",
                             source_prior: str = "<in-memory>",
                             ref_normalize: bool = False) -> Dict[str, Any]:
    """Freeze an in-memory VQ-VAE and token prior into a generator artifact
    at ``out_path``; returns its metadata. ``mean`` / ``std`` de-normalise
    the decoded windows (identity when None). ``meta["export_seconds"]``
    times each platform's exports; a ``cuda`` platform needs a card."""
    import copy

    pcfg = prior_model.cfg
    D = exp.model.robot_input_dim
    if mean is None:
        mean, std = np.zeros(D, np.float32), np.ones(D, np.float32)
    T = pcfg.stride * (n_positions - 1) + pcfg.window
    classes = list(enumerate(pcfg.class_names)) or [(None, None)]
    meta: Dict[str, Any] = {
        "format": GENERATOR_TAG, "config_json": exp.to_json(),
        "prior_config_json": pcfg.to_json(), "platforms": list(platforms),
        "torch_version": torch.__version__, "source_checkpoint": source,
        "source_prior": source_prior, "n_samples": n_samples, "n_positions": n_positions,
        "temperature": temperature, "top_k": top_k, "guide_candidates": guide_candidates,
        "guide_dyn": guide_dyn, "ref_normalize": ref_normalize,
        "functions": {("generate" if name is None else f"generate_{name}"): {
            "input": [], "dtype": "int64", "kind": "generator",
            "output": [n_samples, T, D]} for _, name in classes},
        "export_seconds": {},
    }
    blobs: Dict[str, bytes] = {}
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r}; the port exports {PLATFORMS}")
        t0 = time.perf_counter()
        dev = resolve_device(platform)
        vq, prior = copy.deepcopy(vq_model).to(dev).eval(), copy.deepcopy(prior_model).to(dev)
        for ci, name in classes:
            fn = GeneratorFunction(vq, exp, prior.eval(), mean, std, ci,
                                   n_positions=n_positions, n_samples=n_samples,
                                   temperature=temperature, top_k=top_k,
                                   guide_candidates=guide_candidates, guide_dyn=guide_dyn)
            fname = "generate" if name is None else f"generate_{name}"
            with torch.no_grad():
                ep = torch.export.export(fn, (torch.zeros((), dtype=torch.int64, device=dev),))
            blobs[f"{fname}.{platform}.pt2"] = _save_program(ep)
        meta["export_seconds"][platform] = time.perf_counter() - t0
    _write_zip(out_path, meta, blobs)
    return meta


def export_generator_artifact(vq_ckpt: str, prior_ckpt: str, out_path: str,
                              data_dir: str = "data/processed", *, n_positions: int = 32,
                              n_samples: int = 4, temperature: float = 1.0,
                              top_k: Optional[int] = None, guide_candidates: int = 0,
                              guide_dyn: float = 0.0, platforms: Sequence[str] = PLATFORMS,
                              ref_normalize: bool = False) -> Dict[str, Any]:
    """Freeze a VQ-VAE ``.pth`` and a token-prior checkpoint into a
    generator artifact (``ref_normalize`` de-normalises with the saved
    robot stats, as the reference deployment does)."""
    from ..train.prior import load_prior_checkpoint
    from .motion_export import load_model_from_checkpoint

    model, exp = load_model_from_checkpoint(vq_ckpt, device="cpu")
    prior, _ = load_prior_checkpoint(prior_ckpt, device="cpu")
    mean, std = _load_stats_pair(data_dir if ref_normalize else None, "mean.npy", "std.npy",
                                 exp.model.robot_input_dim)
    return build_generator_artifact(
        model, exp, prior, out_path, mean, std, n_positions=n_positions, n_samples=n_samples,
        temperature=temperature, top_k=top_k, guide_candidates=guide_candidates,
        guide_dyn=guide_dyn, platforms=platforms, source=os.path.abspath(vq_ckpt),
        source_prior=os.path.abspath(prior_ckpt), ref_normalize=ref_normalize)


def _call_generator(program, seed, device):
    seed = torch.as_tensor(seed).to(device=device, dtype=torch.int64).reshape(())
    with torch.inference_mode():
        return program(seed)


def load_serving_artifact(path: str, device=None) -> ServingModule:
    """The artifact's programs for ``device``'s platform (the card by
    default) as a ServingModule: a serving artifact's functions, or a
    generator artifact's ``generate`` functions. Raises on another format,
    the JAX package's StableHLO artifacts included, and on a platform the
    artifact was not exported for."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        fmt = meta.get("format")
        if fmt not in (FORMAT_TAG, GENERATOR_TAG):
            hint = (" (the JAX package's StableHLO artifact: load it with "
                    "bridgerl_tpu.export.load_serving_artifact)"
                    if fmt in (JAX_FORMAT_TAG, JAX_GENERATOR_TAG) else "")
            raise ValueError(f"{path}: artifact format {fmt!r} is not {FORMAT_TAG!r} or "
                             f"{GENERATOR_TAG!r}{hint}")
        if dev.type not in meta["platforms"]:
            raise ValueError(f"{path} holds programs for {meta['platforms']}, not {dev.type}")
        fns = {}
        for name in meta["functions"]:
            program = torch.export.load(io.BytesIO(zf.read(f"{name}.{dev.type}.pt2"))).module()
            if fmt == GENERATOR_TAG:
                fns[name] = lambda seed, program=program: _call_generator(program, seed, dev)
            else:
                fns[name] = (lambda x, program=program, name=name:
                             call_function(program, name, x, dev))
    meta = {**meta, "device": str(dev)}
    return ServingModule(meta=meta, fns=fns, device=dev)
