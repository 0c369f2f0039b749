"""The port's run drivers, profiling hooks and streaming demo on the CPU:
``cli/run_batch.py`` (many training specs in one process),
``cli/run_queue.py`` (many command lines in one process),
``utils/profiling.py`` (``trace``, ``StepTimer``), ``utils/logging.py``
(``Throughput``) and ``cli/demo_stream_retarget.py``. Only the demo's GIF
test imports the plotting packages."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bridgerl_tpu_torch.cli import demo_stream_retarget, run_batch
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.data.synthetic import generate_synthetic_dataset
from bridgerl_tpu_torch.export import serialize
from bridgerl_tpu_torch.export.reconstruct import reconstruct_long_sequence
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.sim import G1ReplayScene
from bridgerl_tpu_torch.train.checkpoint import save_checkpoint
from bridgerl_tpu_torch.utils.logging import Throughput
from bridgerl_tpu_torch.utils.profiling import TRACE_NAME, StepTimer, trace
from test_torch_port_zoo import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_dim=8, num_res_layers=1, batch_size=32)


def _spec(tmp_path, data_dir, **kw):
    return {"arch": "resnet_no_down", "method": "ae", "data_dir": data_dir, "window": 10,
            "epochs": 2, "seeds": [42], "save_every": 1, **SMALL,
            "log_dir": str(tmp_path / "results"), "checkpoint_dir": str(tmp_path / "ckpts"), **kw}


def test_run_batch_runs_specs_and_isolates_failures(tmp_path, capsys, one_torch_thread):
    data_dir = str(tmp_path / "data")
    generate_synthetic_dataset(data_dir, n_sequences=6, min_len=40, max_len=60, window=10,
                               step=2, seed=0)
    teacher = str(tmp_path / "ckpts" / "Exp_resnet_no_down_W10_ae_teacher_seed_42_best.pth")
    specs = [
        _spec(tmp_path, data_dir, label="bad", method="nosuch"),
        _spec(tmp_path, data_dir, label="good"),
        _spec(tmp_path, data_dir, label="jax_prng", prng="rbg"),
        _spec(tmp_path, data_dir, label="student", mode="student", teacher_ckpt=teacher,
              epochs=1),
        _spec(tmp_path, data_dir, label="default_prng", prng="threefry2x32", epochs=1,
              log_dir=str(tmp_path / "r2"), checkpoint_dir=str(tmp_path / "c2")),
    ]
    path = tmp_path / "specs.json"
    path.write_text(json.dumps(specs))
    assert run_batch.main([str(path), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "BATCH DONE failures=['bad', 'jax_prng']"
    assert "=== batch[2] jax_prng FAILED: prng='rbg'" in out
    for i, label in ((1, "good"), (3, "student"), (4, "default_prng")):
        assert f"=== batch[{i}] {label} OK (" in out
    results, ckpts = tmp_path / "results", tmp_path / "ckpts"
    hist = json.loads((results / "log_resnet_no_down_ae_seed_42.json").read_text())
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert (ckpts / "Exp_resnet_no_down_W10_ae_teacher_seed_42_final.pth").exists()
    assert (results / "log_resnet_no_down_ae_student_seed_42.json").exists()
    assert (ckpts / "Exp_resnet_no_down_W10_ae_student_seed_42_final.pth").exists()


def test_run_batch_without_a_card_names_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "specs.json"
    path.write_text("[]")
    assert run_batch.main([str(path)]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_run_queue_isolates_entries_and_reloads_the_port(tmp_path):
    """Module entries in one process: argv threaded, an entry that exits 2
    and one that raises reported, the rest run; the port's modules are
    loaded anew for each entry."""
    (tmp_path / "q_ok.py").write_text(
        "import sys, pathlib\n"
        "import bridgerl_tpu_torch.config as c\n"
        "pathlib.Path(sys.argv[1]).write_text(','.join(sys.argv[2:]) + f';{id(c)}')\n")
    (tmp_path / "q_boom.py").write_text("raise RuntimeError('boom')\n")
    (tmp_path / "q_exit.py").write_text("import sys; sys.exit(2)\n")
    (tmp_path / "q_clean.py").write_text("import sys; sys.exit(0)\n")
    out1, out2 = tmp_path / "out1.txt", tmp_path / "out2.txt"
    npz = tmp_path / "m.npz"
    np.savez(npz, joint_pos=np.zeros((3, 29), np.float32))
    queue = [["q_ok", str(out1), "alpha", "beta"], ["q_boom"], ["q_exit"], ["q_clean"],
             ["bridgerl_tpu_torch.cli.inspect_npz", str(npz)], ["q_ok", str(out2)]]
    qpath = tmp_path / "queue.json"
    qpath.write_text(json.dumps(queue))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]))
    r = subprocess.run([sys.executable, "-m", "bridgerl_tpu_torch.cli.run_queue", str(qpath)],
                       capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "[QUEUE] 2 failed: ['queue[1] q_boom', 'queue[2] q_exit']" in r.stdout
    assert "=== queue[2] q_exit EXIT 2 ===" in r.stdout
    assert "RuntimeError: boom" in r.stderr
    assert r.stdout.count(" OK (") == 4
    assert "joint_pos: shape=(3, 29) dtype=float32" in r.stdout
    args1, id1 = out1.read_text().split(";")
    args2, id2 = out2.read_text().split(";")
    assert (args1, args2) == ("alpha,beta", "") and id1 != id2


def test_run_queue_all_ok_exits_0(tmp_path):
    (tmp_path / "q_hello.py").write_text("print('hello')\n")
    qpath = tmp_path / "queue.json"
    qpath.write_text(json.dumps([["q_hello"]]))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]))
    r = subprocess.run([sys.executable, "-m", "bridgerl_tpu_torch.cli.run_queue", str(qpath)],
                       capture_output=True, text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[QUEUE] all entries OK" in r.stdout and "hello" in r.stdout


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        torch.ones(3).sum()
    assert not any(tmp_path.iterdir())
    with trace(str(tmp_path / "prof")):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    events = json.loads((tmp_path / "prof" / TRACE_NAME).read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_step_timer_and_throughput_count(monkeypatch):
    timer = StepTimer(window_batch=512)
    timer.step()
    timer.step(3)
    time.sleep(0.01)
    sps = timer.steps_per_sec
    assert 0 < sps <= 4 / 0.01
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert timer.windows_per_sec_per_chip == pytest.approx(timer.steps_per_sec * 128, rel=0.05)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert timer.windows_per_sec_per_chip > 0
    timer.reset()
    assert timer.steps_per_sec == 0.0
    tp = Throughput()
    tp.add(100)
    tp.add(28)
    time.sleep(0.01)
    assert tp.windows == 128 and 0 < tp.rate() <= 128 / 0.01


def _small_flagship(tmp_path):
    exp = make_experiment("transformer", "hybrid", window=10, d_model=32, ff_dim=64,
                          n_tf_layers=1, hidden_dim=16)
    model = init_model(exp.model, 0, device="cpu")
    ckpt = str(tmp_path / "small.pth")
    save_checkpoint(ckpt, epoch=1, model=model, config=exp)
    return exp, model, ckpt


@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    """A cpu serving artifact of the small flagship."""
    tmp = tmp_path_factory.mktemp("artifact")
    exp, model, _ = _small_flagship(tmp)
    art = str(tmp / "a.zip")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serialize.build_serving_artifact(model, exp, art, data_dir=None, platforms=("cpu",))
    finally:
        torch.set_num_threads(n)
    return art


def test_stream_feed_equals_offline_overlap_add(small_artifact, one_torch_thread):
    mod = serialize.load_serving_artifact(small_artifact, device="cpu")
    feed = demo_stream_retarget.human_feed(None, 40)
    assert feed.shape == (40, 126)
    robot, push_ms, released = demo_stream_retarget.stream_feed(mod, feed, 5)
    assert robot.shape == (40, 29) and len(push_ms) == 40
    # each frame leaves W + 1 frames after it came in; the flush brings the last W
    assert np.cumsum(released).tolist() == [max(n - 10, 0) for n in range(1, 41)]
    offline = reconstruct_long_sequence(mod.fns["retarget"], feed, 10, 5, np.zeros(1),
                                        np.ones(1), device="cpu")
    np.testing.assert_allclose(robot, offline, atol=1e-5, rtol=0)
    traj = demo_stream_retarget.drive_g1(robot, 25, "cpu")
    scene = G1ReplayScene(device="cpu")
    scene.load(robot, 25.0, 25.0)
    assert traj.shape == (39, 30, 3)     # resampled at its own rate: the last frame's span
    assert torch.equal(traj, scene.rollout())


def test_demo_stream_retarget_writes_a_gif(tmp_path, capsys, one_torch_thread):
    import imageio.v2 as imageio

    _, _, ckpt = _small_flagship(tmp_path)
    gif = str(tmp_path / "x.gif")
    assert demo_stream_retarget.main(["--ckpt", ckpt, "--frames", "40", "--render", gif,
                                      "--device", "cpu", "--data_dir",
                                      str(tmp_path / "none")]) == 0
    out = capsys.readouterr().out
    assert "streamed 40 human frames -> 40 robot frames" in out and "latency 11 frames" in out
    assert len(imageio.mimread(gif)) > 1


def test_demo_stream_retarget_stops_before_streaming(small_artifact, tmp_path, monkeypatch,
                                                    capsys):
    feed = tmp_path / "short.npy"
    np.save(feed, np.zeros((8, 126), np.float32))
    flags = ["--artifact", small_artifact, "--input_file", str(feed), "--render", "live",
             "--device", "cpu"]
    assert demo_stream_retarget.main(flags) == 1
    assert "feed too short" in capsys.readouterr().err
    np.save(feed, np.zeros((30, 100), np.float32))
    assert demo_stream_retarget.main(flags) == 1
    assert "(T, 126)" in capsys.readouterr().err
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)      # import raises ImportError
    assert demo_stream_retarget.main(["--render", "x.gif", "--device", "cpu"]) == 2
    assert "'matplotlib' package" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert demo_stream_retarget.main(["--render", "live"]) == 1
    assert "--device cpu" in capsys.readouterr().err
