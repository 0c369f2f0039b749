"""The port's frozen serving artifact (``export/serialize.py``), on the CPU.

Two artifacts with ``cpu`` programs: the transformer + hybrid at small
widths (d_model 32, 2 layers, hidden 16; packing 8 in the live model, which
the artifact drops) and resnet_no_down + ae. Checked: ``meta.json``'s
function names and signatures against the JAX package's artifact of the
same config; every function against the live serving module at b in
{1, 3, 16} (float32 within 1e-6, codes equal); ``decode_codes(motion_codes(x))``
against ``retarget(x)`` within 1e-5; a child process loads it without
importing ``models``, ``train`` or ``config``; each package's loader refuses
the other's zip; ``ae`` has no code functions; the HTTP host serves
``decode_codes`` from the artifact in npz and in JSON and answers 400 to
malformed bodies; and the command lines ``export_serving --check`` and
``serve_http --max_requests``.
"""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bridgerl_tpu.export.serialize import build_serving_artifact as jax_build_artifact
from bridgerl_tpu.export.serialize import load_serving_artifact as jax_load_artifact
from bridgerl_tpu_torch.cli import export_serving
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.export import serialize
from bridgerl_tpu_torch.export.client import ServingClient, ServingError
from bridgerl_tpu_torch.export.server import make_server
from bridgerl_tpu_torch.export.serving import FORMAT_TAG, build_serving_module
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.train.checkpoint import save_checkpoint

from test_torch_port_model import jax_and_port, windows
from test_torch_port_zoo import pair, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-6
BATCHES = (1, 3, 16)
IN_DIM = {"retarget": 126, "robot_recon": 29, "motion_codes": 126}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _artifact(tmp_path_factory, name, exp, jmodel, variables, texp, model):
    """The JAX side, the port's model, its cpu artifact (path, meta) and the
    artifact loaded."""
    path = str(tmp_path_factory.mktemp("art") / f"{name}.zip")
    meta = serialize.build_serving_artifact(model, texp, path, data_dir=None,
                                            platforms=("cpu",))
    return SimpleNamespace(exp=exp, jmodel=jmodel, variables=variables, texp=texp, model=model,
                           path=path, meta=meta,
                           art=serialize.load_serving_artifact(path, device="cpu"))


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The small transformer + hybrid, packing 8 in the live model."""
    return _artifact(tmp_path_factory, "flagship", *jax_and_port(attn_packing=8))


@pytest.fixture(scope="module")
def ae_artifact(tmp_path_factory):
    return _artifact(tmp_path_factory, "ae", *pair("resnet_no_down", "ae"))


@pytest.fixture(scope="module")
def jax_zip(flagship, tmp_path_factory):
    """The JAX package's artifact of the flagship's weights: (path, meta)."""
    path = str(tmp_path_factory.mktemp("jax") / "jax.zip")
    f = flagship
    return path, jax_build_artifact(f.jmodel, f.variables, f.exp, path, data_dir=None,
                                    platforms=("cpu",))


@pytest.mark.parametrize("which", ["flagship", "ae_artifact"])
def test_meta_matches_the_jax_artifact(which, request, tmp_path):
    a = request.getfixturevalue(which)
    if which == "flagship":
        _, jmeta = request.getfixturevalue("jax_zip")
    else:
        jmeta = jax_build_artifact(a.jmodel, a.variables, a.exp, str(tmp_path / "jax.zip"),
                                   data_dir=None, platforms=("cpu",))
    assert a.meta["functions"] == jmeta["functions"]
    assert json.loads(a.meta["config_json"]) == json.loads(jmeta["config_json"])
    assert a.meta["format"] == FORMAT_TAG != jmeta["format"]
    with zipfile.ZipFile(a.path) as zf:
        assert sorted(zf.namelist()) == sorted(
            ["meta.json"] + [f"{fn}.cpu.pt2" for fn in jmeta["functions"]])
        assert json.loads(zf.read("meta.json")) == a.meta


def test_ae_has_no_code_functions(ae_artifact):
    assert sorted(ae_artifact.meta["functions"]) == ["retarget", "robot_recon"]
    assert sorted(ae_artifact.art.fns) == ["retarget", "robot_recon"]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("which", ["flagship", "ae_artifact"])
def test_artifact_matches_the_live_module(which, b, request):
    a = request.getfixturevalue(which)
    art, live = a.art, build_serving_module(a.model, a.texp)
    W = a.texp.model.window_size
    for fn in ("retarget", "robot_recon"):
        x = windows(b, b, W, IN_DIM[fn])
        got, want = art.fns[fn](x), live.fns[fn](x)
        assert got.dtype == torch.float32 and got.shape == want.shape == (b, W, 29)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    if "motion_codes" not in a.meta["functions"]:
        return
    x = windows(b + 100, b, W, 126)
    codes, want = art.motion_codes(x), live.motion_codes(x)
    assert sorted(codes) == sorted(want) == sorted(a.meta["functions"]["motion_codes"]["output"])
    for k in want:
        assert codes[k].dtype == torch.int32 and torch.equal(codes[k], want[k]), k
    decoded = art.decode_codes(codes)
    np.testing.assert_allclose(decoded.numpy(), live.decode_codes(want).numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(decoded.numpy(), art.retarget(x).numpy(), atol=1e-5, rtol=0)


_LOAD_PROBE = """
import json, sys
import numpy as np
from bridgerl_tpu_torch.export.serialize import load_serving_artifact
mod = load_serving_artifact(sys.argv[1], device="cpu")
out = mod.retarget(np.zeros((2, mod.window_size, 126), np.float32))
print(json.dumps({"shape": list(out.shape), "modules": sorted(
    m for m in sys.modules if m.split(".")[:2] in (["bridgerl_tpu_torch", "models"],
                                                  ["bridgerl_tpu_torch", "train"],
                                                  ["bridgerl_tpu_torch", "config"])
    or m.split(".")[0] in ("jax", "bridgerl_tpu"))}))
"""


def test_a_child_loads_it_without_model_code(flagship):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _LOAD_PROBE, flagship.path], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"shape": [2, 10, 29], "modules": []}


def test_each_loader_refuses_the_other_packages_zip(flagship, jax_zip):
    with pytest.raises(ValueError, match="JAX package's StableHLO"):
        serialize.load_serving_artifact(jax_zip[0], device="cpu")
    with pytest.raises(ValueError, match="unknown artifact format"):
        jax_load_artifact(flagship.path)


def test_no_fallback_to_the_cpu(flagship, monkeypatch):
    """The card is the default; without one, loading or exporting for it
    raises rather than serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serialize.load_serving_artifact(flagship.path)
    with pytest.raises(RuntimeError, match="CUDA"):
        serialize.build_serving_artifact(flagship.model, flagship.texp, "unused.zip",
                                         data_dir=None, platforms=("cuda",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="holds programs for"):
        serialize.load_serving_artifact(flagship.path, device="cuda")


@pytest.fixture(scope="module")
def server(flagship):
    srv = make_server(flagship.path, port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address
    yield srv, ServingClient(f"http://{host}:{port}")
    srv.shutdown()
    srv.server_close()
    t.join()


def _post(srv, path, body, ctype):
    host, port = srv.server_address
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 headers={"Content-Type": ctype}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_decode_codes_npz_and_json(server, flagship):
    srv, client = server
    art = flagship.art
    assert client.health()["functions"] == sorted(flagship.meta["functions"])
    assert client.meta()["format"] == FORMAT_TAG
    x = windows(21, 5, 10, 126)
    codes = client.motion_codes(x)
    want = art.decode_codes(codes).numpy()
    got = client.decode_codes(codes)
    assert got.dtype == np.float32 and got.shape == (5, 10, 29)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    status, body = _post(srv, "/v1/decode_codes",
                         json.dumps({"codes": {k: v.tolist() for k, v in codes.items()}}).encode(),
                         "application/json")
    assert status == 200
    np.testing.assert_allclose(np.asarray(json.loads(body)["windows"], np.float32), want,
                               atol=ATOL, rtol=0)


def _npz(**streams):
    buf = io.BytesIO()
    np.savez(buf, **streams)
    return buf.getvalue()


def test_http_decode_codes_refuses_malformed_bodies(server, flagship):
    srv, client = server
    good = {k: np.zeros((2, 1), np.int32)
            for k in flagship.meta["functions"]["decode_codes"]["input"]}
    missing = dict(list(good.items())[1:])
    wide = {k: np.zeros((2, 3), np.int32) for k in good}
    ragged = dict(good, **{next(iter(good)): np.zeros((3, 1), np.int32)})
    floats = {k: v.astype(np.float32).tolist() for k, v in good.items()}
    npy = io.BytesIO()
    np.save(npy, np.zeros((2, 1), np.int32))
    bodies = [(_npz(**missing), "application/octet-stream"),
              (_npz(**wide), "application/octet-stream"),
              (_npz(**ragged), "application/octet-stream"),
              (npy.getvalue(), "application/octet-stream"),
              (b"", "application/octet-stream"),
              (json.dumps({"codes": floats}).encode(), "application/json"),
              (json.dumps({"windows": [[0]]}).encode(), "application/json"),
              (b"{not json", "application/json")]
    for body, ctype in bodies:
        status, reply = _post(srv, "/v1/decode_codes", body, ctype)
        assert status == 400, (body[:60], reply)
    with pytest.raises(ServingError) as e:
        client.decode_codes(missing)
    assert e.value.status == 400
    assert _post(srv, "/v1/decode_codes", _npz(**good), "application/octet-stream")[0] == 200


def test_cli_export_serving_check_and_serve_http(ae_artifact, tmp_path, capsys):
    texp, model = ae_artifact.texp, ae_artifact.model
    ckpt = str(tmp_path / "model.pth")
    save_checkpoint(ckpt, epoch=0, model=model, config=texp)
    out = str(tmp_path / "serving" / "model.zip")
    assert export_serving.main(["--ckpt", ckpt, "--out", out, "--platforms", "cpu", "--check",
                                "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    W = texp.model.window_size
    assert f"check ok: retarget (2, {W}, 126) -> (2, {W}, 29) on cpu" in printed
    assert "robot_recon" in printed
    art = serialize.load_serving_artifact(out, device="cpu")
    x = windows(5, 3, W, 126)
    np.testing.assert_allclose(art.retarget(x).numpy(),
                               build_serving_module(model, texp).retarget(x).numpy(),
                               atol=ATOL, rtol=0)
    assert export_serving.main(["--ckpt", ckpt, "--out", out, "--prior", "p.ckpt"]) == 2
    assert "ROADMAP.md" in capsys.readouterr().err

    # serve_http, as a child process, answers --max_requests requests and exits 0
    port = _free_port()
    child = subprocess.Popen(
        [sys.executable, "-m", "bridgerl_tpu_torch.cli.serve_http", "--artifact", out,
         "--port", str(port), "--max_requests", "1", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        got = _retry(lambda: ServingClient(f"http://127.0.0.1:{port}").retarget(x))
        _, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err
    np.testing.assert_allclose(got, art.retarget(x).numpy(), atol=ATOL, rtol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _retry(fn, tries: int = 300):
    """``fn()``, retried while the server is not listening yet."""
    for _ in range(tries - 1):
        try:
            return fn()
        except (ConnectionError, urllib.error.URLError):
            time.sleep(0.1)
    return fn()


def test_programs_call_the_ports_kernels_unpacked(flagship):
    """The exported retarget graph calls K1 once a transformer block (in
    eval mode, with no seed) on rows of one window (S = W: the towers export
    unpacked), and K2 once a residual VQ layer; decode_codes calls K1 in the
    decoder only."""
    cfg = flagship.texp.model
    ep = serialize.export_program(serialize._unpacked_copy(flagship.model, torch.device("cpu")),
                                  "retarget", None, None, flagship.meta["functions"]["retarget"])
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    k1 = [n for n in calls if "packed_attention_fwd" in str(n.target)]
    k2 = [n for n in calls if "nearest_codes" in str(n.target)]
    assert len(k1) == 2 * cfg.n_tf_layers and len(k2) == 4
    for n in k1:
        q, seed, rate, window = n.args[0], n.args[4], n.args[6], n.args[7]
        assert q.meta["val"].shape[1:] == (cfg.window_size, cfg.d_model // cfg.n_heads)
        assert seed is None and rate == 0.0 and window == cfg.window_size
    ep = serialize.export_program(serialize._unpacked_copy(flagship.model, torch.device("cpu")),
                                  "decode_codes", None, None,
                                  flagship.meta["functions"]["decode_codes"])
    names = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum("packed_attention_fwd" in t for t in names) == cfg.n_tf_layers
    assert not any("nearest_codes" in t for t in names)


def test_fresh_artifact_bakes_the_stats_it_is_given(tmp_path):
    """export_fresh_artifact: the seed-0 model of the config, with a
    data_dir's saved stats baked in (raw windows normalised in,
    de-normalised out), as the live module serves it with those stats."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(5)
    stats = {"mean.npy": rng.normal(size=29), "std.npy": rng.uniform(0.5, 2, 29),
             "human_mean.npy": rng.normal(size=126), "human_std.npy": rng.uniform(0.5, 2, 126)}
    for name, a in stats.items():
        np.save(data / name, a.astype(np.float32))
    path = str(tmp_path / "fresh.zip")
    meta = serialize.export_fresh_artifact(path, "resnet_no_down", "ae", window=8,
                                           data_dir=str(data), platforms=("cpu",))
    assert meta["ref_normalize"] and meta["source_checkpoint"] == "<fresh-init>"
    exp = make_experiment("resnet_no_down", "ae", window=8)
    live = build_serving_module(init_model(exp.model, 0, device="cpu"), exp,
                                robot_stats=(stats["mean.npy"], stats["std.npy"]),
                                human_stats=(stats["human_mean.npy"], stats["human_std.npy"]))
    art = serialize.load_serving_artifact(path, device="cpu")
    for fn, dim in (("retarget", 126), ("robot_recon", 29)):
        x = windows(6, 2, 8, dim)
        np.testing.assert_allclose(art.fns[fn](x).numpy(), live.fns[fn](x).numpy(),
                                   atol=ATOL, rtol=0)
