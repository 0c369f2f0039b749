"""The port stands alone: it and ``chip_smoke.py`` import no JAX and nothing
of ``bridgerl_tpu``, nor matplotlib, imageio or scikit-learn (only the
renders, plots and t-SNE import those, when they run); it asks for the card by default and never falls back to
the CPU on its own; ``chip_smoke.py`` fails, printing nothing, where there is
no card or no repository beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bridgerl_tpu_torch.device import resolve_device
from bridgerl_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "bridgerl_tpu_torch", "bridgerl_tpu_torch.config", "bridgerl_tpu_torch.device",
    "bridgerl_tpu_torch.convert", "bridgerl_tpu_torch.ops", "bridgerl_tpu_torch.models",
    "bridgerl_tpu_torch.export.serving", "bridgerl_tpu_torch.export.server",
    "bridgerl_tpu_torch.export.client", "bridgerl_tpu_torch.export.reconstruct",
    "bridgerl_tpu_torch.data.rotations", "bridgerl_tpu_torch.data.pipeline",
    "bridgerl_tpu_torch.data.synthetic", "bridgerl_tpu_torch.cli.process_data",
    "bridgerl_tpu_torch.cli.train_ablation", "bridgerl_tpu_torch.train.trainer",
    "bridgerl_tpu_torch.ops.code_decode", "bridgerl_tpu_torch.export.serialize",
    "bridgerl_tpu_torch.export.streaming", "bridgerl_tpu_torch.export.motion_export",
    "bridgerl_tpu_torch.utils.alignment", "bridgerl_tpu_torch.train.codebook_seed",
    "bridgerl_tpu_torch.cli.export_serving", "bridgerl_tpu_torch.cli.export_motion",
    "bridgerl_tpu_torch.cli.serve_http", "bridgerl_tpu_torch.sim", "bridgerl_tpu_torch.sim.motion",
    "bridgerl_tpu_torch.sim.replay", "bridgerl_tpu_torch.sim.urdf", "bridgerl_tpu_torch.sim.render",
    "bridgerl_tpu_torch.sim.mesh", "bridgerl_tpu_torch.sim.live", "bridgerl_tpu_torch.eval",
    "bridgerl_tpu_torch.eval.latent", "bridgerl_tpu_torch.eval.plots",
    "bridgerl_tpu_torch.eval.latex", "bridgerl_tpu_torch.eval.parity",
    "bridgerl_tpu_torch.export.torch_import", "bridgerl_tpu_torch.data.manifest",
    "bridgerl_tpu_torch.utils.profiling", "bridgerl_tpu_torch.utils.logging",
    "bridgerl_tpu_torch.parallel", "bridgerl_tpu_torch.parallel.mesh",
    "bridgerl_tpu_torch.train.multiseed", "bridgerl_tpu_torch.runtime",
    "bridgerl_tpu_torch.runtime.native", "bridgerl_tpu_torch.eval.studies",
    *(f"bridgerl_tpu_torch.cli.{name}" for name in (
        "play_g1_npy", "render_video", "render_viewport", "live_viewer", "render_mesh_demo",
        "debug_camera_views", "csv_to_npz", "extract_urdf_spec", "analyze_latent_space",
        "plot_results", "export_latex_table", "check_parity", "generate_motions",
        "import_torch_ckpt", "export_torch_ckpt", "inspect_npz", "gen_datasets",
        "demo_stream_retarget", "run_batch", "run_queue", "exp_prior_ar", "exp_prior_sampling",
        "exp_prior_prompted", "exp_prior_scaling", "exp_prior_conditioned",
        "exp_prior_dynamics", "plot_prior_scaling", "plot_prior_conditioned",
        "diag_fsq_spread", "diag_lfq")),
]
# packages that only the renders, plots and t-SNE need; the card's machine
# has none of them
PLOTTING = ("matplotlib", "mpl_toolkits", "imageio", "sklearn")
# modules a client host runs without torch
TORCH_FREE = ["bridgerl_tpu_torch.export.streaming", "bridgerl_tpu_torch.export.client"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bridgerl_tpu")

_PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in {forbidden})))
"""


def _run(args, cwd=REPO, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120, **kw)


@pytest.mark.parametrize("modules", [PORT_MODULES, ["chip_smoke"]], ids=["package", "chip_smoke"])
def test_no_jax_or_reference_package_is_loaded(modules):
    probe = _PROBE.replace("{forbidden}", repr(set(FORBIDDEN)))
    r = _run(["-c", probe, *modules])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("modules", [PORT_MODULES, ["chip_smoke"]], ids=["package", "chip_smoke"])
def test_no_plotting_package_is_loaded(modules):
    probe = _PROBE.replace("{forbidden}", repr(set(PLOTTING)))
    r = _run(["-c", probe, *modules])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_streaming_and_the_client_import_no_torch():
    probe = _PROBE.replace("{forbidden}", repr({"torch", *FORBIDDEN}))
    r = _run(["-c", probe, *TORCH_FREE])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_source_mentions_no_jax_import():
    for path in [*sorted((REPO / "bridgerl_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in FORBIDDEN, f"{path}: {line}"


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")


def test_init_model_without_cuda_raises(monkeypatch):
    from bridgerl_tpu_torch.config import make_experiment
    from bridgerl_tpu_torch.models import init_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_experiment("transformer", "hybrid", window=10, d_model=32, ff_dim=64,
                          n_tf_layers=1, hidden_dim=16).model
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg, 0)


def test_chip_smoke_without_cuda_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs in full there")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA is not available" in r.stderr


def test_chip_smoke_alone_fails_and_prints_nothing(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""


def test_kernel_sources_and_signatures_agree():
    """Every C entry point the wrappers bind is defined in its csrc source,
    with as many parameters as its ctypes signature; every source is bound."""
    assert sorted({lib for lib, _ in kernels.SIGNATURES.values()}) == sorted(
        p.stem for p in kernels.CSRC.glob("*.cu"))
    for fn, (lib, argtypes) in kernels.SIGNATURES.items():
        src = (kernels.CSRC / f"{lib}.cu").read_text()
        assert f'extern "C" int {fn}(' in src
        params = src.split(f'extern "C" int {fn}(')[1].split(")")[0]
        assert len(params.split(",")) == len(argtypes), fn
        assert "cudaGetLastError()" in src
        assert "Replaces:" in src


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edited header rebuilds the kernels that include it."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels._lib_path(tmp_path / "a.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kernels._lib_path(tmp_path / "a.cu") != first


def test_counters_reset():
    for c in kernels.COUNTERS.values():
        c.add()
    kernels.reset_counters()
    assert {c.count for c in kernels.COUNTERS.values()} == {0}
    assert sorted(kernels.COUNTERS) == ["packed_attention_bwd", "packed_attention_bwd_bf16",
                                        "packed_attention_fwd", "packed_attention_fwd_bf16",
                                        "vq_assign"]
