"""Run several of the port's command lines one after another in one process.

    python -m bridgerl_tpu_torch.cli.run_queue queue.json
    # queue.json: [["bridgerl_tpu_torch.cli.process_data", "--synthetic"],
    #              ["bridgerl_tpu_torch.cli.import_torch_ckpt", "--pth", "ref.pth", ...]]

``scripts/run_queue.py`` for the port: ``run_batch`` saves the start of a
process and the first touch of the card for training specs, this does it
for any command lines. Each entry is an argv list whose first element is a
module name, run as ``python -m`` runs it (``runpy.run_module`` with
``run_name="__main__"``; the JAX queue takes script paths, and the port's
CLIs are package modules with relative imports). An entry that raises or
exits non-zero is reported and the queue goes on; the exit code is 1 if
any entry failed.

Between entries every ``bridgerl_tpu_torch`` module is dropped from
``sys.modules``, as the JAX queue drops ``bridgerl_tpu``'s, so each entry
runs the code on disk. The compiled kernel libraries stay mapped in the
process: the reloaded ``ops`` find them in ``_build/`` and do not build them
again. A caller of ``main`` may pass ``after_entry``, called with each
entry's label once it has ended and before its modules are dropped (for
example to read ``ops.kernels.COUNTERS``, which the next entry starts
anew).
"""

from __future__ import annotations

import gc
import json
import runpy
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

PACKAGE = "bridgerl_tpu_torch"


def _drop_port_modules() -> None:
    for name in [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    gc.collect()


def main(argv: Optional[Sequence[str]] = None,
         after_entry: Optional[Callable[[str], None]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        print("usage: python -m bridgerl_tpu_torch.cli.run_queue QUEUE.json", file=sys.stderr)
        return 2
    queue = json.loads(Path(argv[0]).read_text())
    failures = []
    for i, entry in enumerate(queue):
        label = f"queue[{i}] {' '.join(entry)}"
        print(f"=== {label} start ===", flush=True)
        t0 = time.perf_counter()
        saved = sys.argv
        try:
            sys.argv = list(entry)
            runpy.run_module(entry[0], run_name="__main__", alter_sys=True)
            print(f"=== {label} OK ({time.perf_counter() - t0:.1f}s) ===", flush=True)
        except SystemExit as e:
            if e.code not in (0, None):
                failures.append(label)
                print(f"=== {label} EXIT {e.code} ===", flush=True)
            else:
                print(f"=== {label} OK ({time.perf_counter() - t0:.1f}s) ===", flush=True)
        except Exception:   # one entry's failure must not stop the queue
            failures.append(label)
            traceback.print_exc()
            print(f"=== {label} FAILED ===", flush=True)
        finally:
            sys.argv = saved
            if after_entry is not None:
                after_entry(label)
            _drop_port_modules()
    if failures:
        print(f"[QUEUE] {len(failures)} failed: {failures}", flush=True)
        return 1
    print("[QUEUE] all entries OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
