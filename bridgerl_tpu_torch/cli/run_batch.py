"""Many training runs in one process: one start, one dataset load per
``data_dir``, one touch of the card.

    python -m bridgerl_tpu_torch.cli.run_batch specs.json [--device cpu]

The spec file and keys of ``scripts/run_batch.py``: a JSON list of dicts.
Required: arch, method, data_dir. Optional (defaults in parens): window
(64), mode ("teacher"), seeds ([42]), multiseed (true when len(seeds) > 1),
epochs (300), batch_size (512), patience (-1), teacher_ckpt, save_every
(25), attn_packing (1), accum_chunks (1), bf16 (false), label, log_dir
("results"), checkpoint_dir ("checkpoints"), and any ModelConfig or
TrainConfig field (torch_init, ref_exact_vel, ema_warm_start, fsq_bounded,
lfq_norm, cheap_dropout, entropy_loss_weight, ...). ``prng`` names JAX's
generator, which the port does not have: a spec that sets it to anything
but the default fails, with the reason.

Each stage of the command line pays the start of a process and its first
touch of the card; this pays them once. Datasets are cached on
``--device`` (default ``cuda``; without a card the run stops unless
``--device cpu`` asks for the CPU) per ``data_dir``. A failing spec is
reported and the batch goes on; the last line is ``BATCH DONE
failures=[...]`` and the exit code 1 if any spec failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

from . import cli_device
from .train_ablation import DEFAULT_PRNG

_TOP = ("arch", "method", "data_dir", "window", "mode", "seeds", "multiseed",
        "bf16", "prng", "label", "log_dir", "checkpoint_dir")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("specs", help="JSON list of run specs")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def run_spec(r: dict, ds_cache: dict, device) -> None:
    """Train one spec (raises on any failure)."""
    from ..config import make_experiment
    from ..data.dataset import PairedDataset
    from ..data.pipeline import load_artifacts
    from ..train.multiseed import MultiSeedTrainer
    from ..train.trainer import Trainer

    if r.get("prng", DEFAULT_PRNG) != DEFAULT_PRNG:
        raise ValueError(f"prng={r['prng']!r}: JAX's generator has no counterpart in the "
                         "port, which draws from Philox and torch generators (ROADMAP.md)")
    dd = r["data_dir"]
    if dd not in ds_cache:
        arrays = load_artifacts(dd)
        ds_cache[dd] = PairedDataset.from_numpy(arrays["g1_train.npy"],
                                                arrays["human_train.npy"], device=device)
    ds = ds_cache[dd]
    seeds = list(r.get("seeds", [42]))
    over = {k: v for k, v in r.items() if k not in _TOP}
    exp = make_experiment(
        r["arch"], r["method"], window=r.get("window", 64), mode=r.get("mode", "teacher"),
        seeds=seeds, human_input_dim=ds.human_dim, robot_input_dim=ds.robot_dim,
        compute_dtype="bfloat16" if r.get("bf16") else "float32",
        **{"epochs": 300, "batch_size": 512, "save_every": 25, **over})
    exp = dataclasses.replace(exp, log_dir=r.get("log_dir", "results"),
                              checkpoint_dir=r.get("checkpoint_dir", "checkpoints"))
    stacked = r.get("multiseed", len(seeds) > 1) and len(seeds) > 1
    (MultiSeedTrainer if stacked else Trainer)(exp, device=device).run(ds)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    runs = json.loads(Path(args.specs).read_text())
    device = cli_device("run_batch", args.device)
    if device is None:
        return 1
    ds_cache: dict = {}
    failures = []
    for i, r in enumerate(runs):
        label = r.get("label") or f"run{i}:{r.get('arch')}_{r.get('method')}"
        print(f"=== batch[{i}] {label} start ===", flush=True)
        t0 = time.perf_counter()
        try:
            run_spec(r, ds_cache, device)
            print(f"=== batch[{i}] {label} OK ({time.perf_counter() - t0:.1f}s) ===",
                  flush=True)
        except Exception as e:   # one spec's failure must not stop the batch
            traceback.print_exc()
            failures.append(label)
            print(f"=== batch[{i}] {label} FAILED: {e} ===", flush=True)
    print(f"BATCH DONE failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
