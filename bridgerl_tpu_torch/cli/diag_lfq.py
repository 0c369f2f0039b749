"""Diagnose an LFQ collapse: frozen bits, saturated entropy gradients and
the latent information the binary code keeps.

    python -m bridgerl_tpu_torch.cli.diag_lfq --ckpt <lfq .pth> --data_dir data/dense_w64

``scripts/diag_lfq.py`` for the port. On the first ``--batch`` robot windows
of ``g1_train.npy`` it reports, per bit of the pre-sign projection, its
mean, std, |mean|/std, p(+1), entropy and the entropy regularizer's
gradient magnitude (a bit is frozen outside 0.02 < p(+1) < 0.98); the live
bits and unique codes; and the share of the encoder output's variance that
a least-squares map from the binary code recovers. The encoder runs on
``--device`` (default ``cuda``; without a card the run stops unless
``--device cpu`` asks for the CPU); the statistics are numpy on the host.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from . import cli_device
from .diag_fsq_spread import robot_latents
from ..eval.studies import load_teacher

PROG = "diag_lfq"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data_dir", default="data/dense_w64")
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(PROG, args.device)
    if device is None:
        return 2
    loaded = load_teacher(PROG, args.ckpt, device)
    if loaded is None:
        return 2
    model, exp = loaded
    cfg = exp.model
    if cfg.method != "lfq":
        print(f"{PROG}: method {cfg.method} is not lfq", file=sys.stderr)
        return 2
    print(f"ckpt: {args.ckpt}\narch={cfg.arch} method={cfg.method} W={cfg.window_size}")

    z = robot_latents(model, args.data_dir, args.batch, device)
    print(f"z_e: shape={z.shape} std={z.std():.3f} mean={z.mean():+.3f}")

    q = model.quantizer
    kin = q.project_in.weight.detach().float().cpu().numpy().T   # (in, bits)
    bin_ = q.project_in.bias.detach().float().cpu().numpy()
    zp = z.reshape(-1, z.shape[-1]) @ kin + bin_   # (N, bits) pre-sign
    bits = zp > 0

    print(f"\n{'bit':>4} {'mean':>8} {'std':>8} {'|m|/std':>8} {'p(+1)':>7} "
          f"{'H(bit)':>7} {'|dH/dz|':>9}")
    live = 0
    for b in range(zp.shape[1]):
        m, s = zp[:, b].mean(), zp[:, b].std()
        pb = bits[:, b].mean()
        h = 0.0 if pb in (0.0, 1.0) else -(pb * np.log2(pb) + (1 - pb) * np.log2(1 - pb))
        sig = 1 / (1 + np.exp(-zp[:, b]))
        grad = (sig * (1 - sig)).mean()   # sigmoid'(z): the entropy term's gradient scale
        alive = 0.02 < pb < 0.98
        live += alive
        print(f"{b:>4} {m:>8.2f} {s:>8.2f} {abs(m) / max(s, 1e-9):>8.2f} {pb:>7.3f} "
              f"{h:>7.3f} {grad:>9.4f} {'' if alive else '  FROZEN'}")

    basis = 2 ** np.arange(zp.shape[1])
    idx = (bits.astype(np.int64) * basis).sum(-1)
    uniq = len(np.unique(idx))
    print(f"\nlive bits: {live}/{zp.shape[1]}  unique codes: {uniq}/1024 "
          f"(2^live = {2 ** live})")

    # the variance of z_e a least-squares map recovers from the binary code
    zq = np.where(bits, 1.0, -1.0).astype(np.float32)
    zf = z.reshape(-1, z.shape[-1])
    A = np.concatenate([zq, np.ones((len(zq), 1), np.float32)], 1)
    W, *_ = np.linalg.lstsq(A, zf, rcond=None)
    evr = 1.0 - (zf - A @ W).var() / zf.var()
    print(f"z_e variance expressible through the 10-bit code (lstsq): {evr:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
