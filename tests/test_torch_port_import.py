"""The port's reference-checkpoint importer and exporter
(``bridgerl_tpu_torch/export/torch_import.py``, ``cli/import_torch_ckpt.py``,
``cli/export_torch_ckpt.py``) against the stock-torch reference twin and
against the JAX package's importer, on the CPU.

The migration source is the twin of ``tests/test_torch_import.py``: the
reference ``DualMotionVQVAE`` rebuilt from stock torch modules at its small
size (human 6-D, robot 5-D, hidden 16, window 8, K 32, d_model 32, 2
layers), its weights drawn from a seed. Tolerances: against the twin,
rtol 1e-4 / atol 2e-5 (the JAX test's); against the JAX importer's forward,
1e-5 of the output's scale, codes equal; an export back into a fresh twin,
bit for bit.
"""

import argparse
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from bridgerl_tpu.export import torch_import as jimport
from bridgerl_tpu.models import init_model as jax_init_model
from bridgerl_tpu_torch.cli import export_motion, export_torch_ckpt, import_torch_ckpt
from bridgerl_tpu_torch.config import ARCHS, METHODS
from bridgerl_tpu_torch.data.synthetic import generate_synthetic_dataset
from bridgerl_tpu_torch.export import torch_import
from bridgerl_tpu_torch.export.motion_export import load_model_from_checkpoint
from bridgerl_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_import import CASES, H, HDIM, K, RDIM, WINDOW, _Dual, _randomize
from test_torch_port_zoo import assert_scaled_close, jax_codes, one_torch_thread  # noqa: F401

ALL = list(itertools.product(ARCHS, METHODS))
TWIN_RTOL, TWIN_ATOL = 1e-4, 2e-5
JAX_RTOL = 1e-5


def twin(arch, method, seed=0, hdim=HDIM, rdim=RDIM):
    return _randomize(_Dual(arch, method, hdim, rdim, H, WINDOW, K), seed)


def payload(model, arch, method, prefix=""):
    """The reference's wrapper dict: numpy tensors, a plain config dict."""
    return {"model_state_dict": {prefix + k: v.numpy() for k, v in model.state_dict().items()},
            "epoch": 7, "best_loss": 0.125,
            "config": {"arch": arch, "method": method, "window": WINDOW, "mode": "teacher"}}


def inputs(seed, b=4, hdim=HDIM, rdim=RDIM):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, WINDOW, rdim)).astype(np.float32),
            rng.normal(size=(b, WINDOW, hdim)).astype(np.float32))


def twin_forward(model, xr, xh):
    with torch.no_grad():
        recon, ret = model(torch.from_numpy(xr.transpose(0, 2, 1)),
                           torch.from_numpy(xh.transpose(0, 2, 1)))
    return recon.numpy().transpose(0, 2, 1), ret.numpy().transpose(0, 2, 1)


def port_forward(model, xr, xh):
    with torch.no_grad():
        out = model(torch.from_numpy(xr), torch.from_numpy(xh))
    return out


@pytest.mark.parametrize("arch,method", ALL, ids=[f"{a}-{m}" for a, m in ALL])
def test_import_matches_the_reference_twin(arch, method, one_torch_thread):
    ref = twin(arch, method)
    exp, model, meta = torch_import.import_torch_checkpoint(payload(ref, arch, method),
                                                            device="cpu")
    assert meta == {"epoch": 7, "best_loss": 0.125, "config": payload(ref, arch, method)["config"]}
    m = exp.model
    assert (m.arch, m.method, m.window_size) == (arch, method, WINDOW)
    assert (m.human_input_dim, m.robot_input_dim, m.hidden_dim) == (HDIM, RDIM, H)
    assert m.fsq_bounded is False and m.lfq_norm is False and not model.training
    xr, xh = inputs(1)
    recon, ret = twin_forward(ref, xr, xh)
    out = port_forward(model, xr, xh)
    np.testing.assert_allclose(out["robot"]["recon"].numpy(), recon, rtol=TWIN_RTOL,
                               atol=TWIN_ATOL)
    np.testing.assert_allclose(out["human"]["retargeted"].numpy(), ret, rtol=TWIN_RTOL,
                               atol=TWIN_ATOL)


@pytest.mark.parametrize("arch,method", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_import_matches_the_jax_import(arch, method, one_torch_thread):
    """One payload through both importers: the same config and the same
    forward, codes equal."""
    p = payload(twin(arch, method, seed=3), arch, method)
    jexp, variables, jmeta = jimport.import_torch_checkpoint(p)
    exp, model, meta = torch_import.import_torch_checkpoint(p, device="cpu")
    assert meta == jmeta
    jd, d = dataclasses.asdict(jexp), dataclasses.asdict(exp)
    assert {k: d["model"][k] for k in d["model"]} == {k: jd["model"][k] for k in d["model"]}
    assert (exp.id, exp.name, exp.train.mode) == (jexp.id, jexp.name, jexp.train.mode)
    xr, xh = inputs(4)
    jmodel, _ = jax_init_model(jexp.model, jax.random.key(0))
    ref, mods = jmodel.apply(variables, xr, xh, train=False, mutable=["intermediates"])
    got = port_forward(model, xr, xh)
    for call, (branch, key) in enumerate((("robot", "recon"), ("human", "retargeted"))):
        assert_scaled_close(got[branch][key].numpy(), ref[branch][key], f"{branch}/{key}",
                            rtol=JAX_RTOL)
        want = jax_codes(mods.get("intermediates", {}), call) if method != "ae" else {}
        assert sorted(got[branch]["codes"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[branch]["codes"][k].numpy(), v, err_msg=k)


BARE = [("transformer", "hybrid"), ("resnet", "rvq"), ("resnet_no_down", "ae"),
        ("simple", "lfq"), ("resnet", "fsq"), ("simple", "standard"), ("resnet", "ema")]


@pytest.mark.parametrize("arch,method", BARE, ids=[f"{a}-{m}" for a, m in BARE])
def test_sniff_spec_equals_jax_on_bare_files(arch, method):
    """A bare ``_final.pth`` state dict: everything but the window from key
    names and shapes, as the JAX sniffer reads it, also at the reference
    dataset's 252-D human input; without a window the import refuses."""
    for hdim in (HDIM, 252):
        sd = {k: v.numpy() for k, v in twin(arch, method, hdim=hdim).state_dict().items()}
        assert torch_import.sniff_spec(sd) == jimport.sniff_spec(sd)
        assert torch_import.sniff_spec(sd)["human_input_dim"] == hdim
        with pytest.raises(ValueError, match="window"):
            torch_import.import_torch_checkpoint(sd, device="cpu")
        exp, model, meta = torch_import.import_torch_checkpoint(sd, window=WINDOW, device="cpu")
        assert meta == {"epoch": 0, "best_loss": float("inf"), "config": {}}
        assert (exp.model.arch, exp.model.method, exp.model.human_input_dim) == (arch, method,
                                                                                 hdim)


@pytest.mark.parametrize("arch,method", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_sniff_spec_equals_jax_with_a_config(arch, method):
    p = payload(twin(arch, method), arch, method)
    sd, meta = torch_import.split_payload(p)
    jsd, jmeta = jimport.split_payload(p)
    assert meta == jmeta and sorted(sd) == sorted(jsd)
    assert torch_import.sniff_spec(sd, meta["config"]) == jimport.sniff_spec(jsd, jmeta["config"])


def test_module_prefix_is_stripped_and_bad_files_raise():
    ref = twin("resnet", "ema", seed=5)
    p = payload(ref, "resnet", "ema", prefix="module.")
    exp, model, _ = torch_import.import_torch_checkpoint(p, device="cpu")
    xr, xh = inputs(6)
    np.testing.assert_allclose(port_forward(model, xr, xh)["robot"]["recon"].numpy(),
                               twin_forward(ref, xr, xh)[0], rtol=TWIN_RTOL, atol=TWIN_ATOL)
    # the wrong embedded arch: fails loudly, never a partial load
    wrong = {**p, "config": {**p["config"], "arch": "simple"}}
    with pytest.raises(ValueError, match="no destination|absent"):
        torch_import.import_torch_checkpoint(wrong, device="cpu")
    unknown = {**p, "model_state_dict": {**p["model_state_dict"], "quantizer.extra": np.ones(3)}}
    with pytest.raises(ValueError, match="no destination.*quantizer.extra"):
        torch_import.import_torch_checkpoint(unknown, device="cpu")
    for key in ("quantizer.ema_w", "human_encoder.model.2.net.1.running_var",
                "robot_decoder.model.0.net.0.weight"):
        lost = {**p, "model_state_dict": {k: v for k, v in p["model_state_dict"].items()
                                          if k != "module." + key}}
        with pytest.raises(ValueError, match="absent.*" + key.replace(".", r"\.")):
            torch_import.import_torch_checkpoint(lost, device="cpu")
    shaped = {**p, "model_state_dict": {**p["model_state_dict"],
                                        "module.quantizer.ema_w": np.ones((3, 3), np.float32)}}
    with pytest.raises(ValueError, match="quantizer.ema_w"):
        torch_import.import_torch_checkpoint(shaped, device="cpu")
    # the constant buffers a reference file may carry are dropped, not errors
    extra = {**p["model_state_dict"], "module.quantizer._levels": np.ones(4),
             "module.quantizer._basis": np.ones(4)}
    torch_import.import_torch_checkpoint({**p, "model_state_dict": extra}, device="cpu")


@pytest.mark.parametrize("arch,method", [("resnet", "ema"), ("transformer", "hybrid")])
def test_the_jax_export_loads_in_the_port(arch, method):
    """``export_torch_state_dict`` writes the learned tensors only (no
    ``num_batches_tracked``, no PE table): the port refills the counters
    from init and computes the forward of JAX's variables."""
    p = payload(twin(arch, method, seed=8), arch, method)
    jexp, variables, _ = jimport.import_torch_checkpoint(p)
    m = jexp.model
    sd = jimport.export_torch_state_dict(variables, arch, method, n_tf_layers=m.n_tf_layers,
                                         n_heads=m.n_heads, num_res_layers=m.num_res_layers,
                                         rvq_layers=m.n_layers)
    assert not any(k.endswith(("num_batches_tracked", "pe.pe")) for k in sd)
    exp, model, _ = torch_import.import_torch_checkpoint(
        {"model_state_dict": sd, "config": p["config"]}, device="cpu")
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 0, k
    xr, xh = inputs(9)
    jmodel, _ = jax_init_model(m, jax.random.key(0))
    ref = jmodel.apply(variables, xr, xh, train=False)
    got = port_forward(model, xr, xh)
    assert_scaled_close(got["robot"]["recon"].numpy(), ref["robot"]["recon"], "recon",
                        rtol=JAX_RTOL)
    assert_scaled_close(got["human"]["retargeted"].numpy(), ref["human"]["retargeted"],
                        "retargeted", rtol=JAX_RTOL)


@pytest.mark.parametrize("arch,method", [("transformer", "hybrid"), ("resnet", "rvq"),
                                         ("simple", "standard"), ("resnet_no_down", "ae")])
def test_both_clis_round_trip_into_a_fresh_twin(arch, method, tmp_path, capsys,
                                                one_torch_thread):
    """A reference .pth -> ``import_torch_ckpt --check`` -> the port's
    checkpoint (``load_checkpoint``, ``export_motion``) ->
    ``export_torch_ckpt`` -> a fresh twin loaded with ``strict=False``:
    the twin's forward bit for bit, only the counters and the PE table
    missing."""
    ref = twin(arch, method, seed=10, hdim=126, rdim=29)
    pth, ours, back = (str(tmp_path / n) for n in ("ref_best.pth", "port.pth", "back.pth"))
    torch.save(payload(ref, arch, method), pth)
    assert import_torch_ckpt.main(["--pth", pth, "--out", ours, "--check",
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"check ok: recon (2, {WINDOW}, 29), retargeted (2, {WINDOW}, 29) on cpu" in out

    ck = load_checkpoint(ours)
    assert ck["epoch"] == 7 and ck["best_loss"] == 0.125
    assert (ck["config"].model.arch, ck["config"].model.fsq_bounded) == (arch, False)
    raw = torch.load(ours, weights_only=True)
    assert raw["config"] == {"arch": arch, "method": method, "window": WINDOW,
                             "hidden_dim": H, "mode": "teacher"}
    model, _ = load_model_from_checkpoint(ours, device="cpu")
    xr, xh = inputs(11, hdim=126, rdim=29)
    np.testing.assert_allclose(port_forward(model, xr, xh)["robot"]["recon"].numpy(),
                               twin_forward(ref, xr, xh)[0], rtol=TWIN_RTOL, atol=TWIN_ATOL)
    data = str(tmp_path / "data")
    generate_synthetic_dataset(data, n_sequences=2, min_len=30, max_len=40, window=WINDOW,
                               step=4, seed=0)
    assert export_motion.main(["--ckpt", ours, "--data_dir", data, "--output_dir",
                               str(tmp_path / "motions"), "--device", "cpu"]) == 0
    assert (tmp_path / "motions" / f"recon_{arch}_FullSeq_W{WINDOW}_idx0.npy").exists()

    assert export_torch_ckpt.main(["--ckpt", ours, "--out", back]) == 0
    exported = torch.load(back, weights_only=True)
    assert exported["optimizer_state_dict"] == {} and exported["epoch"] == 7
    assert exported["config"] == {"arch": arch, "method": method, "window": WINDOW,
                                  "mode": "teacher", "hidden_dim": H, "id": ck["config"].id,
                                  "name": ck["config"].name}
    fresh = _Dual(arch, method, 126, 29, H, WINDOW, K)
    missing, unexpected = fresh.load_state_dict(exported["model_state_dict"], strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith(("num_batches_tracked", "pe.pe")) for k in missing), missing
    fresh.eval()
    for a, b in zip(twin_forward(ref, xr, xh), twin_forward(fresh, xr, xh)):
        np.testing.assert_array_equal(a, b)
    # and the exported file imports back to the same tensors
    exp2, model2, _ = torch_import.import_torch_checkpoint(exported, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k


def test_import_cli_refuses_a_bare_file_without_a_window(tmp_path, capsys):
    ref = twin("transformer", "hybrid", seed=12)
    bare = str(tmp_path / "ref_final.pth")
    torch.save(ref.state_dict(), bare)
    out = str(tmp_path / "port.pth")
    assert import_torch_ckpt.main(["--pth", bare, "--out", out, "--device", "cpu"]) == 1
    assert "window" in capsys.readouterr().err
    assert import_torch_ckpt.main(["--pth", bare, "--out", out, "--window", str(WINDOW),
                                   "--check", "--device", "cpu"]) == 0
    assert load_checkpoint(out)["config"].model.window_size == WINDOW


def test_import_cli_without_a_card_names_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert import_torch_ckpt.main(["--pth", "x.pth", "--out", str(tmp_path / "y.pth")]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_export_refuses_several_tokens(tmp_path):
    from bridgerl_tpu_torch.config import make_experiment
    from bridgerl_tpu_torch.models import init_model
    from bridgerl_tpu_torch.train.checkpoint import save_checkpoint

    exp = make_experiment("transformer", "ae", window=WINDOW, tf_tokens=2, d_model=32,
                          ff_dim=64, n_tf_layers=1, hidden_dim=H)
    model = init_model(exp.model, 0, device="cpu")
    with pytest.raises(ValueError, match="tf_tokens=2"):
        torch_import.export_reference_state_dict(model.state_dict(), exp)
    ckpt = str(tmp_path / "k2.pth")
    save_checkpoint(ckpt, epoch=1, model=model, config=exp)
    assert export_torch_ckpt.main(["--ckpt", ckpt, "--out", str(tmp_path / "o.pth")]) == 1


def test_import_keeps_the_reference_semantics():
    """``fsq_bounded`` and ``lfq_norm`` are False after an import (a bounded
    import of an FSQ twin computes another function), and the LFQ sign of
    exactly 0 is -1, as the reference's ``h > 0`` test gives."""
    ref = twin("resnet", "fsq", seed=13)
    p = payload(ref, "resnet", "fsq")
    xr, xh = inputs(14)
    recon = twin_forward(ref, xr, xh)[0]
    _, bounded, _ = torch_import.import_torch_checkpoint(p, overrides={"fsq_bounded": True},
                                                         device="cpu")
    assert not np.allclose(port_forward(bounded, xr, xh)["robot"]["recon"].numpy(), recon,
                           rtol=TWIN_RTOL, atol=TWIN_ATOL)
    ref = twin("simple", "lfq", seed=15)
    with torch.no_grad():
        ref.quantizer.project_in.weight.zero_()
        ref.quantizer.project_in.bias.zero_()
    p = payload(ref, "simple", "lfq")
    exp, model, _ = torch_import.import_torch_checkpoint(p, device="cpu")
    assert exp.model.lfq_norm is False
    got = port_forward(model, xr, xh)
    np.testing.assert_allclose(got["robot"]["recon"].numpy(), twin_forward(ref, xr, xh)[0],
                               rtol=TWIN_RTOL, atol=TWIN_ATOL)
    assert int(got["robot"]["codes"]["quantizer"].max()) == 0    # every bit -1


def test_load_pth_falls_back_to_pickle_with_a_warning(tmp_path, capsys):
    ref = twin("simple", "ema", seed=16)
    path = str(tmp_path / "ref_last.pth")
    torch.save({**payload(ref, "simple", "ema"), "args": argparse.Namespace(lr=2e-4)}, path)
    loaded = torch_import.load_pth(path)
    assert "weights_only load failed" in capsys.readouterr().out
    assert loaded["args"].lr == 2e-4
    torch_import.import_torch_checkpoint(loaded, device="cpu")
