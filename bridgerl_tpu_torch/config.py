"""Configuration: dataclass config tree, experiment factory, artifact naming.

The port's own copy of the JAX package's ``bridgerl_tpu/config.py``: the same
fields, defaults and derived names, so a config JSON written by either
package loads in the other. The port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

ARCHS = ("simple", "resnet", "resnet_no_down", "transformer")
METHODS = ("standard", "ema", "rvq", "fsq", "lfq", "hybrid", "ae")
MODES = ("teacher", "student")


@dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (the JAX package's defaults, field for field)."""

    human_input_dim: int = 126
    robot_input_dim: int = 29
    hidden_dim: int = 64
    codebook_size: int = 1024
    arch: str = "transformer"
    method: str = "hybrid"
    n_layers: int = 4          # RVQ depth
    window_size: int = 64
    d_model: int = 256
    n_heads: int = 4
    n_tf_layers: int = 4
    ff_dim: int = 512
    dropout: float = 0.1
    # pack P windows into one attention call under a block-diagonal mask
    attn_packing: int = 1
    scan_layers: bool = False
    # pool each window into k latent tokens (1 = the reference's single token)
    tf_tokens: int = 1
    fused_attention: bool = False
    cheap_dropout: bool = False
    int8_ff: bool = False
    fsq_levels: Tuple[int, ...] = (8, 5, 5, 5)
    # tanh-bounded FSQ (Mentzer et al. 2023); False is the reference's
    # unbounded round
    fsq_bounded: bool = True
    lfq_dim: int = 10
    lfq_norm: bool = True
    # parameter-free LayerNorm on the latent before the quantizer
    vq_norm: bool = False
    commitment_cost: float = 0.25
    ema_decay: float = 0.99
    entropy_loss_weight: float = 0.1
    num_res_layers: int = 4
    compute_dtype: str = "float32"
    # EMA state warm start: ema_w = embedding, cluster sizes = 1
    ema_warm_start: bool = True
    # torch-style kaiming-uniform kernel init (False: lecun-normal)
    torch_init: bool = True

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"Unknown arch {self.arch!r}; expected one of {ARCHS}")
        if self.method not in METHODS:
            raise ValueError(f"Unknown quantization method {self.method!r}; expected one of {METHODS}")
        if self.tf_tokens < 1 or (self.arch == "transformer"
                                  and self.window_size % self.tf_tokens):
            raise ValueError(
                f"tf_tokens={self.tf_tokens} must be >=1 and divide "
                f"window_size={self.window_size}")


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype the towers compute in. Parameters, the quantizers'
    codebook math, the losses and the serving functions' inputs and outputs
    stay float32 whatever it is."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.compute_dtype]


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX package's defaults, field for field)."""

    mode: str = "teacher"
    epochs: int = 400
    batch_size: int = 512
    learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    patience: int = -1
    seeds: Tuple[int, ...] = (42,)
    val_fraction: float = 0.1
    lambda_recon: float = 1.0
    lambda_vq: float = 1.0
    lambda_vel: float = 0.5
    lambda_cross: float = 5.0
    lambda_align: float = 100.0
    lambda_fk: float = 0.0
    temperature: float = 0.07
    resume: bool = False
    teacher_ckpt: Optional[str] = None
    ref_exact_vel: bool = True
    save_every: int = 1
    codebook_data_init: bool = False
    init_from: Optional[str] = None
    data_axis: str = "data"
    donate: bool = True
    accum_chunks: int = 1
    reuse_dropout_mask: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"Unknown mode {self.mode!r}; expected one of {MODES}")
        if self.accum_chunks < 1 or self.batch_size % self.accum_chunks:
            raise ValueError(
                f"accum_chunks={self.accum_chunks} must be >=1 and divide "
                f"batch_size={self.batch_size}")


@dataclass(frozen=True)
class ExperimentConfig:
    """One ablation entry: everything needed to reproduce a run."""

    id: str
    name: str
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    log_dir: str = "results"
    checkpoint_dir: str = "checkpoints"

    def run_name(self, seed: int) -> str:
        return f"{self.name}_{self.model.method}_{self.train.mode}_seed_{seed}"

    def log_name(self, seed: int) -> str:
        if self.train.mode == "student":
            return f"log_{self.id}_student_seed_{seed}.json"
        return f"log_{self.id}_seed_{seed}.json"

    def ckpt_name(self, seed: int, kind: str) -> str:
        assert kind in ("last", "best", "final")
        return f"{self.run_name(seed)}_{kind}"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        d = dict(d)
        model = d.pop("model", {})
        train = d.pop("train", {})
        if isinstance(model.get("fsq_levels"), list):
            model["fsq_levels"] = tuple(model["fsq_levels"])
        if isinstance(train.get("seeds"), list):
            train["seeds"] = tuple(train["seeds"])
        return cls(model=ModelConfig(**model), train=TrainConfig(**train), **d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))


# Window each arch family's bare registry id refers to.
_CANONICAL_WINDOW: Dict[str, int] = {
    "simple": 64, "resnet": 64, "resnet_no_down": 10, "transformer": 10,
}


def make_experiment(
    arch: str,
    method: str,
    *,
    window: int = 64,
    mode: str = "teacher",
    seeds: Sequence[int] = (42,),
    exp_id: Optional[str] = None,
    name: Optional[str] = None,
    **overrides: Any,
) -> ExperimentConfig:
    """Build an ExperimentConfig with the reference's derived names:
    name = "Exp_{arch}_W{window}", id = "{arch}_{method}" at the arch's
    canonical window and "{arch}_{method}_W{window}" elsewhere."""
    model_keys = {f.name for f in dataclasses.fields(ModelConfig)}
    train_keys = {f.name for f in dataclasses.fields(TrainConfig)}
    model_over = {k: v for k, v in overrides.items() if k in model_keys}
    train_over = {k: v for k, v in overrides.items() if k in train_keys}
    other = {k: v for k, v in overrides.items() if k not in model_keys | train_keys}
    if other:
        raise TypeError(f"Unknown config overrides: {sorted(other)}")
    model = ModelConfig(arch=arch, method=method, window_size=window, **model_over)
    train = TrainConfig(mode=mode, seeds=tuple(seeds), **train_over)
    canonical = _CANONICAL_WINDOW.get(arch, 64)
    default_id = f"{arch}_{method}" + ("" if window == canonical else f"_W{window}")
    default_name = f"Exp_{arch}_W{window}"
    if model.tf_tokens != 1:
        default_id += f"_K{model.tf_tokens}"
        default_name += f"_K{model.tf_tokens}"
    return ExperimentConfig(
        id=exp_id or default_id,
        name=name or default_name,
        model=model,
        train=train,
    )


def ref_exact(exp: ExperimentConfig) -> ExperimentConfig:
    """Every documented deviation back to the reference's semantics, for A/B
    runs: the channel-axis velocity difference, torch kernel inits, and the
    reference's cold EMA-state init (normal ema_w, zero cluster sizes)."""
    return dataclasses.replace(
        exp,
        model=dataclasses.replace(exp.model, ema_warm_start=False, torch_init=True),
        train=dataclasses.replace(exp.train, ref_exact_vel=True),
    )


# The ablation registry (reference models/experiment_config.py:9-18): id,
# display name, arch and method; the LaTeX table's rows in this order.
EXPERIMENTS: List[Dict[str, str]] = [
    {"id": "simple_ema", "name": "Baseline(Simple)", "arch": "simple", "method": "ema"},
    {"id": "resnet_ema", "name": "ResNet+EMA", "arch": "resnet", "method": "ema"},
    {"id": "resnet_rvq", "name": "ResNet+RVQ", "arch": "resnet", "method": "rvq"},
    {"id": "resnet_fsq", "name": "FSQ", "arch": "resnet", "method": "fsq"},
    {"id": "resnet_lfq", "name": "LFQ", "arch": "resnet", "method": "lfq"},
    {"id": "resnet_hybrid", "name": "Ours(Dual-Enc+Hybrid)", "arch": "resnet", "method": "hybrid"},
]


# Full metric schema the evaluators expect (reference export_latex_table.py:19-27,
# plot_results.py:11-25); the history JSON carries every key.
HISTORY_KEYS: Tuple[str, ...] = (
    "train_loss",
    "train_recon_loss",
    "train_vq_loss",
    "val_loss",
    "val_recon",
    "val_cross_recon",
    "val_align",
    "val_vel",
    "val_jerk",
    "perplexity",
    "dcr",
    "dead_code_ratio",
    "rvq_ppl",
)
