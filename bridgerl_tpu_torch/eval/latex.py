"""The LaTeX results table (the reference's export_latex_table.py).

Counterpart of ``bridgerl_tpu/eval/latex.py``. Per experiment of
``config.EXPERIMENTS``, in its order: the mean +- std across seeds of each
seed's last-5-epoch mean, for 7 metrics, as a booktabs table. FSQ's dead
code ratio is special-cased as in the reference (negatives clamp to 0, a
missing one is 0, no percent scaling). The human-branch columns (Cross,
Align) come from the student logs (``log_{id}_student_seed_{s}``) where
those exist: in a teacher-only log the human encoder is untrained.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import EXPERIMENTS

# (key, header, decimals, is_percent) — export_latex_table.py:19-27
METRICS: List[Tuple[str, str, int, bool]] = [
    ("val_recon", r"Recon $\downarrow$", 4, False),
    ("val_cross_recon", r"Cross $\downarrow$", 4, False),
    ("val_align", r"Align $\downarrow$", 4, False),
    ("val_vel", r"Vel $\downarrow$", 4, False),
    ("val_jerk", r"Jerk $\downarrow$", 4, False),
    ("perplexity", r"PPL $\uparrow$", 1, False),
    ("dead_code_ratio", r"DCR \% $\downarrow$", 1, True),
]


def get_final_metrics(log: dict, key: str, n_epochs: int = 5) -> Optional[float]:
    if key not in log or not log[key]:
        return None
    values = log[key]
    return float(np.mean(values[-n_epochs:] if len(values) >= n_epochs else values))


STUDENT_SOURCED = ("val_cross_recon", "val_align")


def load_data(log_dir: str, experiments=None) -> Dict[str, Dict[str, List[float]]]:
    ordered = experiments or EXPERIMENTS
    data = {e["id"]: {m[0]: [] for m in METRICS} for e in ordered}
    student = {e["id"]: {k: [] for k in STUDENT_SOURCED} for e in ordered}
    for fpath in sorted(glob.glob(os.path.join(log_dir, "log_*.json"))):
        fname = os.path.basename(fpath)
        parts = fname.replace("log_", "").replace(".json", "").split("_seed_")
        if len(parts) != 2:
            continue
        exp_key = parts[0]
        stud_of = exp_key[:-8] if exp_key.endswith("_student") else None
        if exp_key not in data and stud_of not in data:
            continue
        try:
            with open(fpath) as f:
                log = json.load(f)
        except (OSError, ValueError):
            continue
        if stud_of is not None:
            for m_key in STUDENT_SOURCED:
                val = get_final_metrics(log, m_key)
                if val is not None:
                    student[stud_of][m_key].append(val)
            continue
        for m_key, _, _, is_percent in METRICS:
            val = get_final_metrics(log, m_key)
            if m_key == "dead_code_ratio":
                if "fsq" in exp_key and val is None:
                    val = 0.0
                elif val is not None and val < 0:
                    val = 0.0
            if val is not None:
                if is_percent and not ("fsq" in exp_key and m_key == "dead_code_ratio"):
                    val *= 100.0
                data[exp_key][m_key].append(val)
    for eid, cols in student.items():
        for m_key, vals in cols.items():
            if vals:
                data[eid][m_key] = vals
    return data


def generate_latex(log_dir: str = "results", experiments=None) -> str:
    ordered = experiments or EXPERIMENTS
    data = load_data(log_dir, ordered)
    lines = [
        r"\begin{table}[h]",
        r"\centering",
        r"\caption{Comparison of different VQ-VAE variants (Expanded Metrics).}",
        r"\label{tab:results}",
        "\\begin{tabular}{l" + " c" * len(METRICS) + "}",
        r"\toprule",
        " & ".join(["Method"] + [m[1] for m in METRICS]) + r" \\",
        r"\midrule",
    ]
    for e in ordered:
        row = [e["name"]]
        for m_key, _, decimal, _ in METRICS:
            values = data[e["id"]][m_key]
            if not values:
                row.append("N/A")
            else:
                row.append(f"{np.mean(values):.{decimal}f} $\\pm$ {np.std(values):.{decimal}f}")
        lines.append(" & ".join(row) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)
