"""The port's serving surface against the JAX package, on the CPU: the three
serving functions that take windows against ``make_serving_fns`` (1e-5
absolute, codes exact), ``meta["functions"]`` (the fourth, ``decode_codes``,
included) against a JAX serving artifact's, ``ServingApp`` bucketing, a
``make_server`` round trip on localhost with the port's client, and
overlap-add against the JAX ``reconstruct_long_sequence``. The artifact and
``decode_codes`` have their own tests (``test_torch_port_artifact.py``,
``test_torch_port_code_decode.py``)."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.export import reconstruct as jax_reconstruct
from bridgerl_tpu.export.serialize import build_serving_artifact
from bridgerl_tpu.export.serialize import make_serving_fns as jax_make_serving_fns
from bridgerl_tpu_torch.export import reconstruct
from bridgerl_tpu_torch.export.client import ServingClient, ServingError
from bridgerl_tpu_torch.export.server import ServingApp, _bucket, make_server
from bridgerl_tpu_torch.export.serving import FORMAT_TAG, build_serving_module, identity_stats

from test_torch_port_model import jax_and_port, windows

ATOL = 1e-5
FNS = ("retarget", "robot_recon", "motion_codes")
IN_DIM = {"retarget": 126, "robot_recon": 29, "motion_codes": 126}


def _pair(**over):
    """(JAX serving fns, the port's serving module) over the same weights."""
    _, jmodel, variables, texp, model = jax_and_port(**over)
    jfns = jax_make_serving_fns(jmodel, variables, identity_stats(29), identity_stats(126))
    return jfns, build_serving_module(model, texp)


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("packing", [1, 4])
def test_serving_functions_match_jax(fn, packing):
    jfns, module = _pair(attn_packing=packing)
    x = windows(31, 8, 10, IN_DIM[fn])
    _assert_same(module.fns[fn](x), jfns[fn](jnp.asarray(x)))


def test_serving_stats_are_applied():
    """Non-identity stats: normalise the input, de-normalise the output."""
    _, jmodel, variables, texp, model = jax_and_port()
    rng = np.random.default_rng(4)
    rs = (rng.normal(size=29).astype(np.float32), rng.uniform(0.5, 2, 29).astype(np.float32))
    hs = (rng.normal(size=126).astype(np.float32), rng.uniform(0.5, 2, 126).astype(np.float32))
    jfns = jax_make_serving_fns(jmodel, variables, rs, hs)
    module = build_serving_module(model, texp, robot_stats=rs, human_stats=hs)
    assert module.meta["ref_normalize"]
    for fn in ("retarget", "robot_recon"):
        x = windows(5, 4, 10, IN_DIM[fn])
        _assert_same(module.fns[fn](x), jfns[fn](jnp.asarray(x)))


def test_meta_functions_match_jax_artifact(tmp_path):
    exp, jmodel, variables, texp, model = jax_and_port()
    meta = build_serving_artifact(jmodel, variables, exp, str(tmp_path / "a.zip"),
                                  data_dir=None, platforms=("cpu",))
    ours = build_serving_module(model, texp).meta
    assert sorted(ours["functions"]) == sorted(meta["functions"]) == sorted(FNS + ("decode_codes",))
    for fn in meta["functions"]:
        assert ours["functions"][fn] == meta["functions"][fn], fn
    # the port's programs are not StableHLO: its format tag is its own
    assert ours["format"] == FORMAT_TAG != meta["format"]
    assert json.loads(ours["config_json"]) == json.loads(meta["config_json"])


@pytest.mark.parametrize("b,bucket", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (9, 16)])
def test_bucket(b, bucket):
    assert _bucket(b) == bucket


@pytest.fixture(scope="module")
def module():
    return _pair(attn_packing=4)[1]


@pytest.mark.parametrize("fn", FNS)
def test_app_pads_to_bucket_and_slices(module, fn):
    seen = []
    real = module.fns[fn]
    spy = dict(module.fns, **{fn: lambda x: seen.append(x.shape) or real(x)})
    app = ServingApp(type(module)(module.meta, spy, module.device))
    x = windows(9, 5, 10, IN_DIM[fn])
    out = app.call(fn, x)
    assert seen == [(8, 10, IN_DIM[fn])]
    want = real(x)
    if fn == "motion_codes":
        assert all(out[k].shape == (5, 1) for k in out)
        for k, v in want.items():
            np.testing.assert_array_equal(out[k], v.numpy())
    else:
        assert out.shape == (5, 10, 29) and out.dtype == np.float32
        np.testing.assert_allclose(out, want.numpy(), atol=ATOL)


def test_app_exact_shapes_without_bucketing(module):
    seen = []
    real = module.fns["retarget"]
    spy = dict(module.fns, retarget=lambda x: seen.append(x.shape) or real(x))
    app = ServingApp(type(module)(module.meta, spy, module.device), bucket_batches=False)
    app.call("retarget", windows(9, 5, 10, 126))
    assert seen == [(5, 10, 126)]


def test_app_rejects_bad_requests(module):
    app = ServingApp(module)
    with pytest.raises(KeyError):
        app.call("generate", windows(0, 2, 10, 126))
    with pytest.raises(ValueError, match="dict of code streams"):
        app.call("decode_codes", windows(0, 2, 10, 126))
    with pytest.raises(ValueError, match="expects"):
        app.call("retarget", windows(0, 2, 10, 29))
    with pytest.raises(ValueError, match="single array"):
        app.call("retarget", [[0.0]])


@pytest.fixture(scope="module")
def server(module):
    srv = make_server(module, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address
    yield srv, ServingClient(f"http://{host}:{port}")
    srv.shutdown()
    srv.server_close()
    t.join()


def test_http_health_and_meta(server, module):
    _, client = server
    health = client.health()
    assert health == {"ok": True, "device": "cpu", "platform": "cpu", "window": 10,
                      "functions": sorted(FNS + ("decode_codes",))}
    assert client.meta() == json.loads(json.dumps(module.meta))


@pytest.mark.parametrize("b", [1, 3, 16])
def test_http_retarget_and_recon_roundtrip(server, module, b):
    _, client = server
    xh, xr = windows(b, b, 10, 126), windows(b + 1, b, 10, 29)
    np.testing.assert_allclose(client.retarget(xh), module.retarget(xh).numpy(), atol=ATOL)
    np.testing.assert_allclose(client.robot_recon(xr), module.robot_recon(xr).numpy(),
                               atol=ATOL)


def test_http_motion_codes_npz(server, module):
    _, client = server
    x = windows(7, 6, 10, 126)
    got = client.motion_codes(x)
    want = module.motion_codes(x)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k].numpy())


def _post(srv, path, body, ctype):
    host, port = srv.server_address
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 headers={"Content-Type": ctype}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_json_roundtrip(server, module):
    srv, _ = server
    x = windows(8, 2, 10, 126)
    status, body = _post(srv, "/v1/retarget", json.dumps({"windows": x.tolist()}).encode(),
                         "application/json")
    assert status == 200
    np.testing.assert_allclose(np.asarray(json.loads(body)["windows"], np.float32),
                               module.retarget(x).numpy(), atol=ATOL)
    status, body = _post(srv, "/v1/motion_codes",
                         json.dumps({"windows": x.tolist()}).encode(), "application/json")
    assert status == 200 and sorted(json.loads(body)["codes"]) == sorted(module.meta[
        "functions"]["motion_codes"]["output"])


@pytest.mark.parametrize("path,body,ctype,status", [
    ("/v1/retarget", b"", "application/octet-stream", 400),
    ("/v1/retarget", b"not json", "application/json", 400),
    ("/v1/retarget", b'{"x": 1}', "application/json", 400),
    ("/v1/decode_codes", b"", "application/octet-stream", 400),
    ("/v1/generate", b"", "application/octet-stream", 404),
    ("/v2/retarget", b"", "application/octet-stream", 404),
])
def test_http_errors(server, path, body, ctype, status):
    srv, _ = server
    assert _post(srv, path, body, ctype)[0] == status


def test_client_raises_serving_error(server):
    _, client = server
    with pytest.raises(ServingError) as e:
        client.retarget(windows(0, 2, 10, 29))
    assert e.value.status == 400


@pytest.mark.parametrize("T,W,step", [(3000, 10, 5), (57, 10, 3), (23, 10, 10),
                                      (11, 10, 4), (10, 10, 2), (64, 64, 20)])
def test_window_starts_match_jax(T, W, step):
    np.testing.assert_array_equal(reconstruct.window_starts(T, W, step),
                                  jax_reconstruct.window_starts(T, W, step))


@pytest.mark.parametrize("T,step", [(57, 3), (40, 10)])
def test_overlap_add_matches_jax(T, step):
    _, jmodel, variables, texp, model = jax_and_port(attn_packing=4)
    rng = np.random.default_rng(T)
    seq = rng.normal(size=(T, 29)).astype(np.float32)
    mean = rng.normal(size=29).astype(np.float32)
    std = rng.uniform(0.5, 2.0, 29).astype(np.float32)
    japply = lambda x: jmodel.apply(variables, x_robot=x, train=False)["robot"]["recon"]
    want = jax_reconstruct.reconstruct_long_sequence(japply, seq, 10, step, mean, std)
    fns = build_serving_module(model, texp).fns
    got = reconstruct.reconstruct_long_sequence(fns["robot_recon"], seq, 10, step, mean, std,
                                                device="cpu")
    assert got.shape == (T, 29)
    np.testing.assert_allclose(got, want, atol=ATOL)
    single = reconstruct.reconstruct_single_window(fns["robot_recon"], seq, 10, mean, std,
                                                   device="cpu")
    np.testing.assert_allclose(
        single, jax_reconstruct.reconstruct_single_window(japply, seq, 10, mean, std),
        atol=ATOL)


def test_overlap_add_short_sequence_is_none():
    assert reconstruct.reconstruct_long_sequence(lambda x: x, np.zeros((10, 29)), 10, 2,
                                                 np.zeros(29), np.ones(29),
                                                 device="cpu") is None


def test_overlap_add_of_identity_is_identity():
    seq = np.random.default_rng(0).normal(size=(103, 7)).astype(np.float32)
    got = reconstruct.reconstruct_long_sequence(lambda x: x, seq, 10, 3, np.zeros(7),
                                                np.ones(7), device="cpu")
    np.testing.assert_allclose(got, seq, atol=1e-6)
