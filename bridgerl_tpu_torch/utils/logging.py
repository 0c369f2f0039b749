"""Console logging: ANSI colours and per-epoch status lines with an ETA.

The port's own copy of ``bridgerl_tpu/utils/logging.py``'s ``TermColor``,
``epoch_log`` (the reference's ``scripts/train_ablation.py:26-37, 263-273``)
and ``Throughput``. Data-parallel, the epoch lines print on rank 0 only.
"""

from __future__ import annotations

import datetime
import sys
import time

from .. import parallel


class TermColor:
    HEADER = "\033[95m"
    BLUE = "\033[94m"
    CYAN = "\033[96m"
    GREEN = "\033[92m"
    YELLOW = "\033[93m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    RED = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


def fmt_eta(seconds: float) -> str:
    return str(datetime.timedelta(seconds=int(max(seconds, 0))))


def epoch_log(epoch: int, train_loss: float, val_metric: float, metric_name: str,
              eta_seconds: float, stream=sys.stdout) -> None:
    if not parallel.is_main():
        return
    now = datetime.datetime.now().strftime("%H:%M")
    msg = (
        f"{TermColor.BOLD}[{now}]{TermColor.ENDC} Ep {epoch}: "
        f"Train {TermColor.WARNING}{train_loss:.4f}{TermColor.ENDC} | "
        f"Val({metric_name}) {TermColor.GREEN}{val_metric:.4f}{TermColor.ENDC} | "
        f"ETA {TermColor.CYAN}{fmt_eta(eta_seconds)}{TermColor.ENDC}"
    )
    print(msg, file=stream)


class Throughput:
    """Windows/s since construction."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.windows = 0

    def add(self, n: int) -> None:
        self.windows += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.windows / dt if dt > 0 else 0.0
