"""Evaluation of the port's outputs: generation statistics, the LaTeX table,
the parity criteria, training plots and the latent-space analysis.
Importing it loads no matplotlib or scikit-learn: the plotting functions
import them when they run."""

from .generation import compare_to_data, format_report, motion_stats
from .latent import analyze_checkpoint, get_latent_vectors, load_paired_data_by_action
from .latex import METRICS, generate_latex, get_final_metrics, load_data
from .parity import Criterion, evaluate_generation, evaluate_parity, render_parity_md
from .plots import (
    ALL_METRICS,
    RADAR_METRICS_MAP,
    load_and_aggregate,
    plot_all,
    plot_metric_curve,
    plot_radar_chart,
    radar_scores,
    smooth,
)
