"""The port's generation surface on the CPU, against the JAX package's:

- ``sample_motion`` with greedy draws (``top_k=1``), plain and guided,
  through a tiny transformer + hybrid VQ-VAE (the flagship's 5 slots a
  position): grids equal and motions within 1e-5 of JAX's;
- ``stitch_windows`` (numpy) and ``stitch_windows_torch`` equal to JAX's
  ``stitch_windows`` / ``stitch_windows_jax`` within 1e-6;
- every function of ``eval/generation.py`` within 1e-6 of JAX's;
- the generator artifact: exported for the CPU, loaded, ``generate`` equal
  to the live ``make_generation_fn`` for the same seed, one HTTP
  ``{"seed": N}`` request, and refusal of the JAX package's zip;
- the CLIs end to end on the CPU: ``train_prior``, ``generate_motions
  --eval`` (plain and ``--guide``), ``export_serving --prior --check``, and
  the flags that need unported modules exiting 2 naming ROADMAP.md.
"""

import json
import os
import threading
import urllib.request
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.eval import generation as jgen
from bridgerl_tpu.models import token_prior as jtp
from bridgerl_tpu.train import prior as jprior
from bridgerl_tpu_torch.cli import export_serving, generate_motions, process_data, train_prior
from bridgerl_tpu_torch.eval import generation as tgen
from bridgerl_tpu_torch.export.serialize import build_generator_artifact, load_serving_artifact
from bridgerl_tpu_torch.export.server import make_server
from bridgerl_tpu_torch.train import prior as tprior
from bridgerl_tpu_torch.train.checkpoint import save_checkpoint

from test_torch_port_prior import jax_prior, port_prior
from test_torch_port_zoo import jax_tree, one_torch_thread  # noqa: F401  (fixture)

ZERO, ONE = np.zeros(29, np.float32), np.ones(29, np.float32)


TINY_TF = dict(window=10, d_model=16, n_tf_layers=1, ff_dim=32, n_heads=2, hidden_dim=16)


@pytest.fixture(scope="module")
def stack():
    """A tiny transformer + hybrid VQ-VAE in both packages (5 slots a
    position, as the flagship), and a tiny slot-AR prior over its codes."""
    from bridgerl_tpu.config import make_experiment as jax_make_experiment
    from bridgerl_tpu.models import DualMotionVQVAE as JaxVQ
    from bridgerl_tpu.ops import code_vocab_sizes
    from bridgerl_tpu_torch.config import ExperimentConfig
    from bridgerl_tpu_torch.convert import state_dict_from_jax
    from bridgerl_tpu_torch.models import init_model

    exp = jax_make_experiment("transformer", "hybrid", **TINY_TF)
    jv = jax_tree(exp, 0)
    texp = ExperimentConfig.from_json(exp.to_json())
    tm = init_model(texp.model, 0, device="cpu")
    tm.load_state_dict(state_dict_from_jax(jv, texp.model), strict=True)
    sizes = sorted(code_vocab_sizes(exp.model).items())
    pcfg = jtp.PriorConfig(
        streams=tuple(n for n, _ in sizes), vocab_sizes=jtp.flatten_vocab_sizes(sizes, 1),
        tokens_per_stream=1, window=10, stride=5, d_model=16, n_heads=2, n_layers=1,
        ff_dim=32, dropout=0.0, max_len=8, slot_ar=True, depth_layers=1)
    jp, jpv = jax_prior(pcfg, seed=1)
    return exp, JaxVQ(exp.model), jv, texp, tm, pcfg, jp, jpv, port_prior(pcfg, jpv)


def tiny_transformer():
    """A tiny transformer + hybrid VQ-VAE of the port (5 slots a position,
    as the flagship) and a tiny prior over its codes, fresh from seeds."""
    from bridgerl_tpu_torch.config import make_experiment
    from bridgerl_tpu_torch.models import init_model
    from bridgerl_tpu_torch.models.token_prior import PriorConfig, flatten_vocab_sizes, init_prior
    from bridgerl_tpu_torch.ops.code_decode import code_vocab_sizes

    texp = make_experiment("transformer", "hybrid", **TINY_TF)
    sizes = sorted(code_vocab_sizes(texp.model).items())

    def prior(**over):
        pcfg = PriorConfig(streams=tuple(n for n, _ in sizes),
                           vocab_sizes=flatten_vocab_sizes(sizes, 1), tokens_per_stream=1,
                           window=10, stride=5, d_model=16, n_heads=2, n_layers=1, ff_dim=32,
                           max_len=8, **over)
        return init_prior(pcfg, 1, device="cpu")

    return texp, init_model(texp.model, 0, device="cpu"), prior


@pytest.mark.parametrize("guide", [0, 3])
def test_greedy_sample_motion_equals_jax(stack, guide):
    exp, jm, jv, texp, tm, pcfg, jp, jpv, tp = stack
    kw = dict(n_samples=2, n_positions=4, top_k=1, guide_candidates=guide, guide_dyn=0.1,
              return_windows=True, return_grid=True)
    jmot, jwins, jgrid = jprior.sample_motion(jm, jv, exp, jp, jpv, ZERO, ONE, seed=3, **kw)
    tmot, twins, tgrid = tprior.sample_motion(tm, texp, tp, ZERO, ONE, seed=9, **kw)
    np.testing.assert_array_equal(tgrid, np.asarray(jgrid))
    assert twins.shape == jwins.shape == (2, 4, 10, 29)
    np.testing.assert_allclose(twins, jwins, atol=1e-5)
    for a, b in zip(tmot, jmot):
        assert a.shape == (5 * 3 + 10, 29)
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_stitch_functions_equal_jax():
    wins = np.random.default_rng(5).normal(size=(2, 7, 10, 29)).astype(np.float32)
    got = tprior.stitch_windows_torch(torch.from_numpy(wins), 4).numpy()
    np.testing.assert_allclose(got, np.asarray(jprior.stitch_windows_jax(jnp.asarray(wins), 4)),
                               atol=1e-6)
    for b in range(2):
        np.testing.assert_allclose(tprior.stitch_windows(wins[b], 4),
                                   jprior.stitch_windows(wins[b], 4), atol=1e-6)
        np.testing.assert_allclose(got[b], jprior.stitch_windows(wins[b], 4), atol=1e-6)


def _close(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _close(a[k], b[k])
    elif isinstance(b, (list, tuple)) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   atol=1e-6)
    else:
        assert a == pytest.approx(b, abs=1e-6)


def test_generation_eval_equals_jax():
    rng = np.random.default_rng(0)
    gen = [rng.normal(size=(t, 29)).astype(np.float32) for t in (40, 33)]
    data = [rng.normal(size=(t, 29)).astype(np.float32) * 0.5 for t in (50, 20, 2)]
    _close(tgen.motion_stats(gen), jgen.motion_stats(gen))
    rep = tgen.compare_to_data(gen, data)
    _close(rep, jgen.compare_to_data(gen, data))
    assert tgen.format_report(rep) == jgen.format_report(rep)
    wins = rng.normal(size=(6, 10, 29)).astype(np.float32)
    _close(tgen.overlap_disagreement(wins, 5), jgen.overlap_disagreement(wins, 5))
    assert tgen.overlap_disagreement(wins, 10) == 0.0
    g = rng.integers(0, 3, size=(3, 6, 2))
    d = rng.integers(0, 3, size=(4, 8, 2))
    dm = (rng.uniform(size=(4, 8)) > 0.2).astype(np.float32)
    _close(tgen.code_novelty(g, d, dm), jgen.code_novelty(g, d, dm))
    _close(tgen.slot_histograms(d, dm, (3, 3)), jgen.slot_histograms(d, dm, (3, 3)))
    gc, dc = np.asarray([0, 1, 1]), np.asarray([0, 0, 1, 1])
    _close(tgen.class_histogram_match(g, gc, d, dc, (3, 3), dm),
           jgen.class_histogram_match(g, gc, d, dc, (3, 3), dm))
    bank = rng.normal(size=(40, 10, 29)).astype(np.float32)
    _close(tgen.nearest_data_distance(wins, bank, chunk=16),
           jgen.nearest_data_distance(wins, bank, chunk=16))
    cont = rng.normal(size=(2, 9, 10, 29)).astype(np.float32)
    true = rng.normal(size=(2, 9, 10, 29)).astype(np.float32)
    _close(tgen.continuation_curves(cont, true, bank), jgen.continuation_curves(cont, true, bank))


def test_generator_artifact_on_the_cpu(tmp_path, one_torch_thread):  # noqa: F811
    texp, tm, make_prior = tiny_transformer()
    tp = make_prior(slot_ar=True, depth_layers=1)
    path = str(tmp_path / "gen.zip")
    meta = build_generator_artifact(tm, texp, tp, path, n_positions=2, n_samples=2,
                                    guide_candidates=2, guide_dyn=0.1, platforms=("cpu",))
    assert meta["format"] == "bridgerl-torch-generator-v1"
    assert meta["functions"] == {"generate": {"input": [], "dtype": "int64",
                                              "kind": "generator", "output": [2, 15, 29]}}
    art = load_serving_artifact(path, device="cpu")
    assert art.window_size == 10
    live = tprior.make_generation_fn(tm, texp, tp, ZERO, ONE, n_positions=2, n_samples=2,
                                     guide_candidates=2, guide_dyn=0.1)
    with torch.inference_mode():
        want = live(11)
    got = art.generate(11)
    assert got.shape == (2, 15, 29) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert not torch.equal(art.generate(12), got)
    with pytest.raises(KeyError, match="generate_walk"):
        art.generate(0, action="walk")

    srv = make_server(path, port=0, device="cpu")
    threading.Thread(target=srv.handle_request, daemon=True).start()
    host, port = srv.server_address
    req = urllib.request.Request(f"http://{host}:{port}/v1/generate",
                                 data=json.dumps({"seed": 11}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    srv.server_close()
    np.testing.assert_allclose(np.asarray(body["windows"], np.float32), want.numpy(), atol=1e-5)

    jax_zip = str(tmp_path / "jax_gen.zip")
    with zipfile.ZipFile(jax_zip, "w") as zf:
        zf.writestr("meta.json", json.dumps({"format": "bridgerl-generator-v1"}))
    with pytest.raises(ValueError, match="JAX package"):
        load_serving_artifact(jax_zip, device="cpu")


def test_class_conditioned_generator_functions(tmp_path, one_torch_thread):  # noqa: F811
    texp, tm, make_prior = tiny_transformer()
    prior = make_prior(class_names=("walk", "run"))
    meta = build_generator_artifact(tm, texp, prior, str(tmp_path / "c.zip"), n_positions=2,
                                    n_samples=1, platforms=("cpu",))
    assert sorted(meta["functions"]) == ["generate_run", "generate_walk"]
    art = load_serving_artifact(str(tmp_path / "c.zip"), device="cpu")
    live = tprior.make_generation_fn(tm, texp, prior, ZERO, ONE, n_positions=2, n_samples=1)
    with torch.inference_mode():
        want = live(5, torch.ones(1, dtype=torch.int64))
    torch.testing.assert_close(art.generate(5, action="run"), want, rtol=0, atol=1e-5)


def test_prior_clis_end_to_end(tmp_path, monkeypatch, capsys, one_torch_thread):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    assert process_data.main(["--synthetic", "--window", "10", "--step", "2",
                              "--n_sequences", "4"]) == 0
    texp, vq, _ = tiny_transformer()
    ckpt = "checkpoints/vq.pth"
    os.makedirs("checkpoints")
    save_checkpoint(ckpt, epoch=0, model=vq, config=texp)
    assert train_prior.main(["--ckpt", ckpt, "--epochs", "2", "--max_len", "16", "--d_model",
                             "16", "--ff_dim", "32", "--n_layers", "1", "--n_heads", "2",
                             "--device", "cpu"]) == 0
    hist = json.load(open("checkpoints/prior.history.json"))
    assert len(hist["train_loss"]) == 2 and all(np.isfinite(hist["val_loss"]))
    gen = ["--ckpt", ckpt, "--prior", "checkpoints/prior.ckpt", "--num", "2", "--positions",
           "4", "--device", "cpu"]
    assert generate_motions.main(gen + ["--eval"]) == 0
    assert generate_motions.main(gen + ["--guide", "4", "--guide_dyn", "0.1", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "generation vs data statistics" in out and "overlap disagreement" in out
    files = sorted(os.listdir("motions/generated"))
    assert len(files) == 4 and files[0].startswith(f"gen_{texp.id}_N4_T1_seed0_idx0")
    assert np.load(os.path.join("motions/generated", files[0])).shape == (25, 29)
    assert export_serving.main(["--ckpt", ckpt, "--prior", "checkpoints/prior.ckpt", "--out",
                                "serving/gen.zip", "--platforms", "cpu", "--positions", "3",
                                "--num", "2", "--check", "--device", "cpu"]) == 0
    assert "check ok: generate(seed=0) -> (2, 20, 29)" in capsys.readouterr().out
    assert generate_motions.main(gen + ["--render"]) == 2
    assert train_prior.main(["--ckpt", ckpt, "--prng", "rbg", "--device", "cpu"]) == 2
    assert "ROADMAP.md" in capsys.readouterr().err
