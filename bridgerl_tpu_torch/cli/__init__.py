"""Command-line entry points of the port (``python -m
bridgerl_tpu_torch.cli.<name>``), with the JAX scripts' flags, defaults and
file names, and ``--device`` (default ``cuda``).

The token-prior studies (``exp_prior_ar``, ``exp_prior_sampling``,
``exp_prior_prompted``, ``exp_prior_scaling``, ``exp_prior_conditioned``,
``exp_prior_dynamics``), their plots (``plot_prior_scaling``,
``plot_prior_conditioned``) and the quantizer diagnostics
(``diag_fsq_spread``, ``diag_lfq``) share ``eval/studies.py``."""

from __future__ import annotations

import sys


def cli_device(prog: str, device: str):
    """The ``--device`` as a ``torch.device`` (float32 products without TF32
    on the card), or None after saying on stderr why it cannot be had."""
    import torch

    from ..device import resolve_device

    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"{prog}: {e} (on the command line: --device cpu)", file=sys.stderr)
        return None
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def have_packages(prog: str, purpose: str, *modules: str) -> bool:
    """Whether every module imports; if one does not, says on stderr which
    package ``purpose`` needs."""
    from ..utils.optional import require

    try:
        for module in modules:
            require(module, purpose)
    except ImportError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return False
    return True
