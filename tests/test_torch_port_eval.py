"""The port's evaluation tools and the slice's command lines, on the CPU,
against the JAX package's:

- ``load_paired_data_by_action`` arrays equal; ``get_latent_vectors``
  within 1e-5 of JAX's, relative to the latents' scale as in the zoo tests
  (random conv towers give latents of ~40), for a transformer (one token, squeezed; packed
  batches and an unpacked last one) and a conv tower (flattened), weights
  carried over by ``convert.state_dict_from_jax``; ``analyze_checkpoint``
  writes both plots of a port ``.pth``;
- ``smooth``, ``load_and_aggregate``, ``radar_scores`` and ``plot_all``'s file
  names equal; ``generate_latex``, ``evaluate_parity``,
  ``evaluate_generation`` and ``render_parity_md`` equal, on the
  repository's ``results/`` and ``abruns/`` (read only) and on the logs of a
  port-trained run;
- the command lines: ``play_g1_npy --render --volumetric``, ``csv_to_npz``
  within 1e-5 of the JAX script's npz (run in this process; relative to
  each array's scale, since the velocities divide float32 differences by
  dt),
  ``render_video``, ``render_viewport``, ``debug_camera_views``,
  ``live_viewer --html``, ``render_mesh_demo``, ``extract_urdf_spec``,
  ``plot_results``, ``export_latex_table``, ``check_parity`` and
  ``analyze_latent_space``; a missing plotting package stops a render flag
  with its name.
"""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bridgerl_tpu.utils
from bridgerl_tpu.eval import latent as jlatent
from bridgerl_tpu.eval import latex as jlatex
from bridgerl_tpu.eval import parity as jparity
from bridgerl_tpu.eval import plots as jplots
from bridgerl_tpu_torch.cli import (
    analyze_latent_space,
    check_parity,
    csv_to_npz,
    debug_camera_views,
    export_latex_table,
    extract_urdf_spec,
    live_viewer,
    play_g1_npy,
    plot_results,
    render_mesh_demo,
    render_video,
    render_viewport,
)
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.data.dataset import PairedDataset
from bridgerl_tpu_torch.data.synthetic import HUMAN_JOINTS, synth_pair
from bridgerl_tpu_torch.eval import latent, latex, parity, plots
from bridgerl_tpu_torch.sim.urdf import chain_to_urdf, load_g1_chain
from bridgerl_tpu_torch.train.checkpoint import save_checkpoint
from bridgerl_tpu_torch.train.trainer import Trainer

from test_torch_port_zoo import assert_scaled_close, one_torch_thread, pair  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LATENT_RTOL = 1e-5   # of the latents' largest magnitude (at least 1e-3), as the zoo tests
CSV_RTOL = 1e-5      # of each array's largest magnitude: velocities divide by dt
STATS = {"mean": 0.0, "std": 1.0, "human_mean": 0.0, "human_std": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_raw_takes(raw_dir, actions=("walk", "run"), takes=2, frames=60, seed=1):
    """Raw npz takes named by action keyword, and one without a keyword."""
    os.makedirs(raw_dir, exist_ok=True)
    g = np.random.default_rng(seed)
    for action in (*actions, "idle"):
        for i in range(takes):
            robot, human_aa = synth_pair(g, frames)
            np.savez(os.path.join(raw_dir, f"{action}_motion_{i}.npz"), joint_pos=robot,
                     smplx_pose_body=human_aa.reshape(frames, HUMAN_JOINTS, 3))
    return raw_dir


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    return write_raw_takes(str(tmp_path_factory.mktemp("raw")))


@pytest.fixture(scope="module")
def port_logs(tmp_path_factory):
    """Histories and checkpoints of a few tiny runs of the port's Trainer:
    resnet_no_down + ae (2 seeds), the transformer + hybrid teacher and its
    student, so that several parity criteria are evaluable."""
    d = tmp_path_factory.mktemp("port_run")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    g = np.random.default_rng(0)
    robot = g.normal(size=(96, 10, 29)).astype(np.float32) * 0.3
    human = g.normal(size=(96, 10, 126)).astype(np.float32) * 0.3
    ds = PairedDataset.from_numpy(robot, human, device="cpu")
    small = dict(window=10, epochs=3, batch_size=32, hidden_dim=16, num_res_layers=1,
                 d_model=16, n_tf_layers=1, ff_dim=32, n_heads=2)
    runs = [make_experiment("resnet_no_down", "ae", seeds=(1, 2), **small),
            make_experiment("transformer", "hybrid", **small)]
    for exp in runs:
        exp = dataclasses.replace(exp, log_dir=str(d / "results"),
                                  checkpoint_dir=str(d / "ckpts"))
        Trainer(exp, device="cpu", verbose=False).run(ds)
    teacher = runs[1]
    student = make_experiment("transformer", "hybrid", mode="student",
                              teacher_ckpt=str(d / "ckpts" / (teacher.ckpt_name(42, "best")
                                                               + ".pth")), **small)
    Trainer(dataclasses.replace(student, log_dir=str(d / "results"),
                                checkpoint_dir=str(d / "ckpts")), device="cpu",
            verbose=False).run(ds)
    torch.set_num_threads(n)
    return d


# ---------- latent ----------

def test_load_paired_data_by_action_equal(raw_dir):
    stats = {"mean": np.full(29, 0.1, np.float32), "std": np.full(29, 2.0, np.float32),
             "human_mean": np.zeros(126, np.float32), "human_std": np.ones(126, np.float32)}
    got = latent.load_paired_data_by_action(raw_dir, 10, stats, max_per_action=15)
    want = jlatent.load_paired_data_by_action(raw_dir, 10, stats, max_per_action=15)
    assert list(got) == list(want) == ["walk", "run"]
    for action in got:
        assert got[action][0].shape == (15, 10, 29) and got[action][1].shape == (15, 10, 126)
        for g, w in zip(got[action], want[action]):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("arch,method,over,tokens", [
    ("transformer", "hybrid", {"attn_packing": 2}, 1),      # one token: squeezed
    ("resnet", "ae", {}, 2),                                # W 8 / 4: flattened
], ids=["transformer", "conv"])
def test_get_latent_vectors_match_jax(arch, method, over, tokens, one_torch_thread):
    exp, jmodel, variables, texp, model = pair(arch, method, **over)
    model.eval()
    g = np.random.default_rng(2)
    for side, dim in (("robot", 29), ("human", 126)):
        x = g.normal(size=(15, exp.model.window_size, dim)).astype(np.float32)
        got = latent.get_latent_vectors(model, x, side, batch=6)   # 6, 6 and 3 windows
        want = jlatent.get_latent_vectors(jmodel, variables, x, side, batch=6)
        assert got.shape == want.shape == (15, tokens * exp.model.hidden_dim)
        assert_scaled_close(got, want, side, rtol=LATENT_RTOL)


def test_analyze_checkpoint_writes_both_plots(tmp_path, raw_dir, one_torch_thread):
    _, _, _, texp, model = pair("transformer", "hybrid")
    texp = dataclasses.replace(texp, model=dataclasses.replace(texp.model, window_size=10))
    ckpt = str(tmp_path / "tiny_best.pth")
    from bridgerl_tpu_torch.models import init_model
    save_checkpoint(ckpt, epoch=0, model=init_model(texp.model, 0, device="cpu"), config=texp)
    written = latent.analyze_checkpoint(ckpt, raw_dir, out_dir=str(tmp_path / "plots"),
                                        max_per_action=12, tsne_perplexity=5.0, device="cpu")
    assert [os.path.basename(w) for w in written] == ["tiny_best_domain.png",
                                                      "tiny_best_actions.png"]
    assert all(os.path.getsize(w) > 0 for w in written)
    assert latent.analyze_checkpoint(ckpt, str(tmp_path / "empty"), device="cpu") == []


# ---------- plots, LaTeX, parity ----------

LOG_DIRS = ["repo", "port"]


@pytest.fixture(params=LOG_DIRS)
def log_dir(request, port_logs):
    return str(REPO / "results") if request.param == "repo" else str(port_logs / "results")


def test_smooth_equal():
    x = np.random.default_rng(3).normal(size=40)
    for w in (0.0, 0.5, 0.8):
        assert np.array_equal(plots.smooth(x, w), jplots.smooth(x, w))
    assert plots.smooth([]).shape == (0,)


def test_aggregate_and_radar_equal(log_dir):
    got, want = plots.load_and_aggregate(log_dir), jplots.load_and_aggregate(log_dir)
    assert got == want and got
    assert plots.load_and_aggregate(log_dir, "seed_42") == jplots.load_and_aggregate(
        log_dir, "seed_42")
    (cats, scores), (jcats, jscores) = plots.radar_scores(got), jplots.radar_scores(want)
    assert cats == jcats and list(scores) == list(jscores)
    for k in scores:
        assert np.array_equal(scores[k], jscores[k])


def test_plot_all_writes_the_same_files(tmp_path, port_logs):
    log_dir = str(port_logs / "results")
    got = plots.plot_all(log_dir, str(tmp_path / "port" / "metrics"))
    want = jplots.plot_all(log_dir, str(tmp_path / "jax" / "metrics"))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert "radar_chart.png" in {os.path.basename(p) for p in got}
    assert all(os.path.getsize(p) > 0 for p in got)
    assert plots.plot_all(str(tmp_path / "none"), str(tmp_path / "x")) == []


def test_latex_equal(log_dir):
    assert latex.generate_latex(log_dir) == jlatex.generate_latex(log_dir)
    assert latex.load_data(log_dir) == jlatex.load_data(log_dir)
    log = {"val_recon": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]}
    assert latex.get_final_metrics(log, "val_recon") == jlatex.get_final_metrics(log, "val_recon")


def _rows(crits):
    return [dataclasses.astuple(c) for c in crits]


def test_parity_equal(log_dir):
    got, want = parity.evaluate_parity(log_dir), jparity.evaluate_parity(log_dir)
    assert _rows(got) == _rows(want)
    assert parity.render_parity_md(got, log_dir) == jparity.render_parity_md(want, log_dir)


def test_port_run_makes_criteria_evaluable(port_logs):
    crits = {c.cid: c for c in parity.evaluate_parity(str(port_logs / "results"))}
    for cid in ("C5", "C6.1", "C6.2", "C6.3", "C7", "C8"):
        assert crits[cid].passed is not None, (cid, crits[cid].detail)


def test_generation_criteria_equal(tmp_path):
    paths = dict(scaling_paths=tuple(str(REPO / p) for p in jparity._SCALING_PATHS),
                 cond_path=str(REPO / jparity._COND_PATH),
                 prompted_path=str(REPO / jparity._PROMPTED_PATH))
    got, want = parity.evaluate_generation(**paths), jparity.evaluate_generation(**paths)
    assert _rows(got) == _rows(want) and any(c.passed is not None for c in got)
    missing = dict(scaling_paths=(str(tmp_path / "s.json"),), cond_path=str(tmp_path / "c"),
                   prompted_path=str(tmp_path / "p"))
    assert _rows(parity.evaluate_generation(**missing)) == \
        _rows(jparity.evaluate_generation(**missing))
    md = parity.render_parity_md(got)
    assert md == jparity.render_parity_md(want) and "evaluable criteria pass" in md


def test_g1_reports_a_failure_beside_a_missing_row(tmp_path):
    """An arm that fails G1 beside one without its prompted row: the port
    reports the failure; the JAX package's loop reports n/a (ADVICE.md,
    ``eval/parity.py:348``). Without the failure both agree."""
    def arm(tm, prompted=True):
        rep = {"val_nn_floor": 1.0, "recon_floor": 0.004, "val_ce_epoch0": 4.0,
               "val_ce_best": 3.0, "free_run": {"vel_ratio": 0.2, "overlap_disagreement": 0.1}}
        if prompted:
            rep["prompted_val_P8"] = {"truth_mse_by_offset": [tm, tm]}
        return rep

    paths = {}
    for name, arms in (("fail", {"takes160": arm(2.0), "takes320": arm(0.5, False)}),
                       ("pass", {"takes160": arm(0.5), "takes320": arm(0.5, False)})):
        paths[name] = str(tmp_path / f"{name}.json")
        Path(paths[name]).write_text(json.dumps(arms))
    none = str(tmp_path / "none")

    def g1(pkg, name):
        return next(c for c in pkg.evaluate_generation((paths[name],), none, none)
                    if c.cid == "G1")

    assert g1(parity, "fail").passed is False and g1(jparity, "fail").passed is None
    assert g1(parity, "pass").passed is None and g1(jparity, "pass").passed is None
    assert g1(parity, "fail").detail == g1(jparity, "fail").detail


# ---------- the command lines ----------

@pytest.fixture(scope="module")
def motion_npy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("motion") / "walk_take.npy")
    np.save(path, np.random.default_rng(4).uniform(-0.3, 0.3, size=(10, 29)).astype(np.float32))
    return path


def test_play_g1_npy_renders_volumetric(tmp_path, motion_npy, capsys):
    gif = str(tmp_path / "x.gif")
    assert play_g1_npy.main(["--input_file", motion_npy, "--render", gif, "--volumetric",
                             "--mesh", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "23 frames @ 50fps" in out and "steps/sec on cpu" in out
    assert "falling back to --volumetric" in out       # no vendor meshes here
    assert len(imageio.mimread(gif)) == 23


def test_render_clis(tmp_path, motion_npy, capsys):
    out = tmp_path / "out"
    assert render_video.main(["--input", motion_npy, "--output_dir", str(out / "v"),
                              "--max_frames", "2", "--device", "cpu"]) == 0
    assert len(imageio.mimread(out / "v" / "walk_take.gif")) == 2   # 12 frames, stride 6
    assert render_viewport.main(["--input", os.path.dirname(motion_npy), "--output_dir",
                                 str(out / "vp"), "--max_shots", "2", "--keep_frames",
                                 "--device", "cpu"]) == 0
    assert sorted(os.listdir(out / "vp")) == ["walk_take.gif", "walk_take_shot000.png",
                                              "walk_take_shot001.png"]
    assert debug_camera_views.main(["--input_file", motion_npy, "--output_dir",
                                    str(out / "cam"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(out / "cam")) == [f"view_{v}.png"
                                               for v in ("back", "far", "front", "side")]
    assert live_viewer.main(["--input_file", motion_npy, "--html", str(out / "v.html"),
                             "--volumetric", "--device", "cpu"]) == 0
    assert "const VOLS = [[[" in (out / "v.html").read_text()
    assert render_mesh_demo.main(["--input", motion_npy, "--device", "cpu"]) == 1
    assert "nothing to demo" in capsys.readouterr().err
    assert play_g1_npy.main(["--input_file", motion_npy]) == (0 if torch.cuda.is_available()
                                                              else 1)


def test_a_missing_plotting_package_is_named(monkeypatch, motion_npy, capsys):
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)     # import raises ImportError
    assert play_g1_npy.main(["--input_file", motion_npy, "--render", "x.gif",
                             "--device", "cpu"]) == 2
    assert "'matplotlib' package" in capsys.readouterr().err


def _jax_csv_to_npz():
    spec = importlib.util.spec_from_file_location("jax_csv_to_npz",
                                                  REPO / "scripts" / "csv_to_npz.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_csv_to_npz_matches_the_jax_script(tmp_path, monkeypatch):
    g = np.random.default_rng(5)
    T = 50
    root = np.cumsum(g.normal(scale=0.01, size=(T, 3)), axis=0) + [0.0, 0.0, 0.74]
    ang = np.linspace(0.0, 1.5, T)
    quat_xyzw = np.stack([0.1 * np.sin(ang / 2), 0.05 * np.sin(ang / 2), np.sin(ang / 2),
                          np.cos(ang / 2)], -1)
    dof = g.uniform(-0.4, 0.4, size=(T, 29))
    csv = str(tmp_path / "m.csv")
    np.savetxt(csv, np.concatenate([root, quat_xyzw, dof], 1).astype(np.float32), delimiter=",")
    flags = ["--input_file", csv, "--input_fps", "30", "--output_fps", "50"]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert csv_to_npz.main(flags + ["--output_file", ours, "--device", "cpu"]) == 0
    monkeypatch.setattr(bridgerl_tpu.utils, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["csv_to_npz.py", *flags, "--output_file", theirs])
    _jax_csv_to_npz().main()
    got, want = np.load(ours), np.load(theirs)
    assert sorted(got.files) == sorted(want.files)
    n = len(np.arange(0.0, (T - 1) / 30, 1 / 50))
    assert got["joint_pos"].shape == (n, 29) and got["body_quat_w"].shape == (n, 30, 4)
    for k in want.files:
        assert_scaled_close(got[k], want[k], k, rtol=CSV_RTOL)
    assert csv_to_npz.main(flags + ["--output_file", ours, "--frame_range", "3", "20",
                                    "--device", "cpu"]) == 0
    assert np.load(ours)["joint_pos"].shape[0] == len(np.arange(0.0, 17 / 30, 1 / 50))


@pytest.mark.parametrize("angle", [0.3, 2.0, np.pi - 1e-3, np.pi])
def test_matrix_to_wxyz_is_a_unit_quaternion_up_to_half_turns(angle):
    """The JAX script divides by w, which goes to 0 at half turns: there its
    quaternions are far from unit length. The port's (Shepperd's method)
    stay unit and give the matrix back; elsewhere the two agree."""
    from bridgerl_tpu_torch.data.rotations import axis_angle_to_matrix, quat_to_matrix

    axes = np.random.default_rng(6).normal(size=(200, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    R = axis_angle_to_matrix(torch.as_tensor(axes * angle, dtype=torch.float32)).numpy()
    q = csv_to_npz.matrix_to_wxyz(R)
    assert np.abs(np.linalg.norm(q, axis=-1) - 1.0).max() <= 1e-6 and (q[:, 0] >= 0).all()
    back = quat_to_matrix(torch.as_tensor(q), scalar_first=True).numpy()
    assert np.abs(back - R).max() <= 1e-6
    jq = _jax_csv_to_npz().matrix_to_wxyz(R)
    if angle < 2.5:
        assert np.abs(q - jq).max() <= 1e-6
    else:
        assert np.abs(np.linalg.norm(jq, axis=-1) - 1.0).max() > 0.5


def test_extract_urdf_spec(tmp_path, capsys):
    urdf = tmp_path / "g1.urdf"
    urdf.write_text(chain_to_urdf(load_g1_chain()))
    spec = str(tmp_path / "spec.json")
    assert extract_urdf_spec.main(["--urdf", str(urdf), "--spec", spec, "--write"]) == 0
    assert extract_urdf_spec.main(["--urdf", str(urdf), "--spec", spec]) == 0
    assert "OK:" in capsys.readouterr().out
    # the bundled spec carries collision primitives that this text lacks
    assert extract_urdf_spec.main(["--urdf", str(urdf)]) == 1
    assert "count 29 != 0" in capsys.readouterr().out


def test_eval_clis(tmp_path, port_logs, raw_dir, monkeypatch, capsys):
    logs = str(port_logs / "results")
    assert plot_results.main(["--dir", logs, "--out", str(tmp_path / "plots" / "metrics")]) == 0
    assert os.path.exists(tmp_path / "plots" / "radar_chart.png")
    assert export_latex_table.main(["--dir", logs]) == 0
    assert jlatex.generate_latex(logs) in capsys.readouterr().out
    monkeypatch.chdir(REPO)      # the generation criteria read abruns/ from here
    md = str(tmp_path / "PARITY.md")
    rc = check_parity.main(["--log_dir", logs, "--out", md])
    crits = jparity.evaluate_parity(logs) + jparity.evaluate_generation()
    assert rc == (1 if any(c.passed is False for c in crits) else 0)
    assert Path(md).read_text() == jparity.render_parity_md(crits, logs)
    ckpts = sorted((port_logs / "ckpts").glob("*hybrid_teacher*_best.pth"))
    assert analyze_latent_space.main(["--ckpt", str(ckpts[0]), "--raw_dir", raw_dir, "--out",
                                      str(tmp_path / "latent"), "--max_per_action", "10",
                                      "--device", "cpu"]) == 0
    assert len(os.listdir(tmp_path / "latent")) == 2
