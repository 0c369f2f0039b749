"""The port's token-prior studies (``bridgerl_tpu_torch/cli/exp_prior_*.py``)
against the JAX scripts (``scripts/exp_prior_*.py``) on the CPU, at tiny
sizes: a transformer + hybrid teacher (window 8, packing 2, d_model 16)
saved by each package from the same weights, 8 short synthetic takes,
priors at d_model 16 with one layer and dropout 0 (both packages'
``dataclasses.replace`` of a ``PriorConfig`` is narrowed the same way), 2
epochs. Each JAX script runs once (module-scoped fixtures); the port's
training starts from JAX's initial prior weights.

This file holds the set-up, ``exp_prior_ar`` (a slot-AR arm over one phase
and a factorized arm over 4, both against JAX), ``exp_prior_sampling``,
``exp_prior_prompted``, the diagnostics, the plots and the checks of all
ten CLIs; ``test_torch_port_research_studies.py`` holds the scaling,
dynamics and conditioned studies on the same set-up (two files, so that
each adds less to one test worker; in one process each JAX run after the
first finds most of its operations compiled). Required of each study:

- the same JSON keys, the tokenized grids and masks equal;
- the decode+stitch ceiling, the floors and every other number that does
  not depend on a draw within 1e-5;
- the CE histories within 1e-5 relative;
- greedy (``top_k`` 1) sweep rows within 1e-5 of JAX's;
- every sampled number in the port's JSON within 1e-6 of the JAX
  package's metric functions applied to the port's own samples (the port
  draws from Philox, JAX from threefry: two draws are never compared).

Of the diagnostics and plots (``diag_fsq_spread``, ``diag_lfq``,
``plot_prior_scaling``, ``plot_prior_conditioned``): each diagnostic prints
JAX's report line for line (the checkpoint's path aside) on the same
weights and windows; each plot draws JAX's series from the committed
``abruns/`` JSONs (both drawn into a recorder; the real figure where
matplotlib is installed). And of all ten CLIs: ``--help`` works; without a
card the default ``--device`` exits non-zero with ``cli_device``'s message;
the JAX package's ``.ckpt`` and prior files are refused, naming what
converts them.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bridgerl_tpu.utils
import bridgerl_tpu_torch.utils.optional
from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.eval import generation as jgen
from bridgerl_tpu.models import token_prior as jtp
from bridgerl_tpu.ops.code_decode import decode_codes, denormalize_codes
from bridgerl_tpu.train import checkpoint as jckpt
from bridgerl_tpu.train import prior as jprior
from bridgerl_tpu_torch.cli import (
    diag_fsq_spread,
    diag_lfq,
    exp_prior_ar,
    exp_prior_conditioned,
    exp_prior_dynamics,
    exp_prior_prompted,
    exp_prior_sampling,
    exp_prior_scaling,
    plot_prior_conditioned,
    plot_prior_scaling,
)
from bridgerl_tpu_torch.config import ExperimentConfig
from bridgerl_tpu_torch.convert import prior_state_dict_from_jax, state_dict_from_jax
from bridgerl_tpu_torch.data.synthetic import synth_robot_takes
from bridgerl_tpu_torch.models import init_model
from bridgerl_tpu_torch.models import token_prior as ttp
from bridgerl_tpu_torch.train import prior as tprior
from bridgerl_tpu_torch.train.checkpoint import save_checkpoint

from test_torch_port_zoo import jax_tree, one_torch_thread  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
TINY_VQ = dict(window=8, d_model=16, n_tf_layers=1, ff_dim=32, n_heads=2, hidden_dim=16,
               tf_tokens=1, attn_packing=2)
SMALL_PRIOR = dict(d_model=16, ff_dim=32, n_layers=1, n_heads=2, depth_layers=1, dropout=0.0)
STRIDE, MAX_LEN = 4, 12
# takes of one length: a grid of MAX_LEN positions each, so that JAX compiles
# one decode for the ceiling
TAKES, TAKE_FRAMES = 8, 8 + STRIDE * (MAX_LEN - 1)
# the studies' flags at this size
TRAIN = ["--stride", str(STRIDE), "--max_len", str(MAX_LEN), "--epochs", "2",
         "--batch_size", "4"]
SAMPLE = ["--n_samples", "2", "--positions", "8"]
DET_ATOL = 1e-5       # numbers that do not depend on a draw
CE_RTOL = 1e-5
METRIC_ATOL = 1e-6    # the port's numbers against JAX's functions on the port's samples


# ------------------------------------------------------------------ set-up

def write_takes(data_dir: Path, takes) -> None:
    """``g1_train_full_raw.npy`` (the takes) and ``g1_train.npy`` (windows)."""
    data_dir.mkdir(parents=True, exist_ok=True)
    arr = np.empty(len(takes), object)
    arr[:] = list(takes)
    np.save(data_dir / "g1_train_full_raw.npy", arr, allow_pickle=True)
    W = TINY_VQ["window"]
    np.save(data_dir / "g1_train.npy",
            np.stack([t[i:i + W] for t in takes for i in range(0, t.shape[0] - W + 1, W)]))


def teacher_files(root: Path, method: str = "hybrid", seed: int = 0, **over):
    """One tiny transformer teacher saved by both packages from the same
    weights: (JAX ``.ckpt``, port ``.pth``, JAX experiment)."""
    exp = jax_make_experiment("transformer", method, **{**TINY_VQ, **over})
    variables = jax_tree(exp, seed)
    jax_path, port_path = root / f"{method}.ckpt", root / f"{method}.pth"
    jckpt.save_checkpoint(str(jax_path), epoch=0, variables=variables, config=exp)
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, seed, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    save_checkpoint(str(port_path), epoch=0, model=model, config=texp)
    return str(jax_path), str(port_path), exp


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("study")
    jax_ckpt, port_ckpt, exp = teacher_files(root)
    takes = synth_robot_takes(TAKES, TAKE_FRAMES, TAKE_FRAMES, 3)
    write_takes(root / "data", takes)
    return SimpleNamespace(root=root, jax_ckpt=jax_ckpt, port_ckpt=port_ckpt, exp=exp,
                           takes=takes, data=str(root / "data"))


def jax_initial(pcfg, seed: int, shape):
    """The prior variables JAX's ``train_prior`` starts from."""
    model = jtp.MotionTokenPrior(pcfg)
    key = jax.random.key(seed)
    cls = jnp.zeros((2,), jnp.int32) if pcfg.class_names else None
    init = jax.jit(lambda g: model.init({"params": key, "dropout": key}, g, train=False,
                                        class_ids=cls))
    return jax.tree_util.tree_map(np.asarray, init(jnp.zeros((2, *shape[1:]), jnp.int32)))


def prior_files(root: Path, pcfg, seed: int = 1):
    """A prior of JAX's init at ``seed`` saved by both packages as
    ``prior.ckpt``: (JAX file, port file)."""
    variables = jax_initial(pcfg, seed, (2, pcfg.max_len, len(pcfg.vocab_sizes)))
    jax_path, port_path = root / "jax" / "prior.ckpt", root / "port" / "prior.ckpt"
    jprior.save_prior_checkpoint(str(jax_path), variables, pcfg)
    tpcfg = ttp.PriorConfig.from_json(pcfg.to_json())
    tprior.save_prior_checkpoint(str(port_path), prior_state_dict_from_jax(variables, tpcfg),
                                 tpcfg)
    return str(jax_path), str(port_path)


def jckpt_model(path: str):
    """(JAX model, variables, experiment) of a JAX checkpoint."""
    from bridgerl_tpu.export.motion_export import load_model_from_checkpoint
    return load_model_from_checkpoint(path)


def jax_history(path: str) -> dict:
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())["history"]


def _narrow_prior_configs(mp) -> None:
    """Both packages' ``dataclasses.replace`` of a PriorConfig also applies
    SMALL_PRIOR (the studies widen their priors through it)."""
    real = dataclasses.replace

    def replace(obj, **kw):
        out = real(obj, **kw)
        if isinstance(out, (jtp.PriorConfig, ttp.PriorConfig)):
            out = real(out, **SMALL_PRIOR)
        return out

    mp.setattr(dataclasses, "replace", replace)


def _recorder(mp, owner, name: str, log: list, **inject):
    """Wrap ``owner.name`` so that each call's (args, kwargs, result) is
    appended to ``log``; ``inject(args, kwargs)`` may add keyword arguments."""
    real = getattr(owner, name)

    def wrapped(*a, **kw):
        for key, make in inject.items():
            kw[key] = make(*a, **kw)
        out = real(*a, **kw)
        log.append((a, kw, out))
        return out

    mp.setattr(owner, name, wrapped)


def _port_initial(grids, mask, pcfg, tcfg, **kw):
    """train_prior's ``initial``: JAX's initial variables for ``pcfg``."""
    jp = jtp.PriorConfig.from_json(pcfg.to_json())
    return prior_state_dict_from_jax(jax_initial(jp, tcfg.seed, grids.shape), pcfg)


def jax_script(name: str):
    """``scripts/<name>.py`` loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_pair(name: str, port_module, jax_argv, port_argv):
    """Run JAX's ``scripts/<name>.py`` and the port's module once each, with
    the prior configs narrowed, recording both sides' code extraction and
    prior training and the port's samples and decodes. Returns the records
    by side and function."""
    logs = {side: {fn: [] for fn in ("extract_code_grids", "train_prior", "sample_motion",
                                     "decode_grid_rows")} for side in ("jax", "port")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as one_torch_thread: workers share the host's cores
    with pytest.MonkeyPatch.context() as mp:
        _narrow_prior_configs(mp)
        mp.setattr(bridgerl_tpu.utils, "enable_compilation_cache", lambda: None)
        for fn in ("extract_code_grids", "train_prior"):
            _recorder(mp, jprior, fn, logs["jax"][fn])
        for fn in ("extract_code_grids", "sample_motion", "decode_grid_rows"):
            if hasattr(port_module, fn):
                _recorder(mp, port_module, fn, logs["port"][fn])
        if hasattr(port_module, "train_prior"):
            _recorder(mp, port_module, "train_prior", logs["port"]["train_prior"],
                      initial=_port_initial)
        mp.setattr(sys, "argv", [f"{name}.py", *jax_argv])
        jax_script(name).main()
        assert port_module.main([*port_argv, "--device", "cpu"]) == 0
    torch.set_num_threads(threads)
    return logs


def assert_same_keys(got, want, where=""):
    assert isinstance(got, dict) == isinstance(want, dict), where
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_same_keys(got[k], want[k], f"{where}/{k}")


def assert_numbers_close(got, want, atol, where="", rtol=0.0):
    """Every number of ``want`` (nested dicts and lists) within atol + rtol *
    |want| of ``got``'s, and everything else equal."""
    if isinstance(want, dict):
        for k in want:
            assert_numbers_close(got[k], want[k], atol, f"{where}/{k}", rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_numbers_close(g, w, atol, f"{where}[{i}]", rtol)
    elif isinstance(want, (int, float, np.number)) and not isinstance(want, bool):
        assert abs(float(got) - float(want)) <= atol + rtol * abs(float(want)), \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def assert_extractions_equal(port_log, jax_log):
    assert len(port_log) == len(jax_log) > 0
    for (_, _, got), (_, _, want) in zip(port_log, jax_log):
        for i, name in enumerate(("grids", "mask", "pcfg", "seq_ids")):
            if name == "pcfg":
                assert got[i].to_json() == want[i].to_json()
            else:
                np.testing.assert_array_equal(got[i], np.asarray(want[i]), err_msg=name)


def assert_histories_close(port_log, jax_log):
    """Each port training's CE history within CE_RTOL of JAX's, in order."""
    assert len(port_log) == len(jax_log) > 0
    for (_, _, (_, got)), (_, _, (_, want)) in zip(port_log, jax_log):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=CE_RTOL, err_msg=k)


def bank(takes, W: int, stride: int, keep=None) -> np.ndarray:
    """The JAX scripts' raw window bank, written out here."""
    idx = range(len(takes)) if keep is None else keep
    return np.concatenate([
        np.stack([np.asarray(takes[i], np.float32)[j:j + W]
                  for j in range(0, takes[i].shape[0] - W + 1, stride)])
        for i in idx if takes[i].shape[0] >= W])


def sample_metrics(motions, windows, grid, takes, grids, mask, data_wins, stride) -> dict:
    """exp_prior_ar's and exp_prior_sampling's scores of one sample, by JAX's
    functions."""
    rep = jgen.compare_to_data(motions, takes)
    rep["overlap_disagreement"] = float(np.mean(
        [jgen.overlap_disagreement(w, stride) for w in windows]))
    rep.update(jgen.code_novelty(grid, grids, mask))
    rep.update(jgen.nearest_data_distance(windows, data_wins))
    return rep


# ------------------------------------------------------------ exp_prior_ar

# the arms run in both packages: a slot-AR head over one phase and a factorized head
# over 4 phases (tokenized again at 4 offsets); the port runs the other two alone
AR_ARMS = "ar,fact_ph4"
AR_PHASES = {"ar": 1, "fact_ph4": 4}


@pytest.fixture(scope="module")
def ar(study):
    out = study.root / "ar"
    flags = ["--data_dir", study.data, *TRAIN, *SAMPLE, "--arms", AR_ARMS]
    logs = run_pair("exp_prior_ar", exp_prior_ar,
                    ["--ckpt", study.jax_ckpt, *flags, "--out_dir", str(out / "jax")],
                    ["--ckpt", study.port_ckpt, *flags, "--out_dir", str(out / "port")])
    read = lambda side: json.loads((out / side / "summary.json").read_text())   # noqa: E731
    return SimpleNamespace(out=out, logs=logs, jax=read("jax"), port=read("port"))


def test_exp_prior_ar_writes_the_jax_scripts_keys_and_files(ar):
    assert_same_keys(ar.port, ar.jax)
    for arm in AR_ARMS.split(","):
        for side in ("jax", "port"):
            assert (ar.out / side / f"prior_{arm}.ckpt").exists()
            for i in range(2):
                assert np.load(ar.out / side / f"gen_{arm}_idx{i}.npy").shape == (4 * 7 + 8, 29)


def test_exp_prior_ar_tokenizes_trains_and_bounds_as_jax(ar):
    assert_extractions_equal(ar.logs["port"]["extract_code_grids"],
                             ar.logs["jax"]["extract_code_grids"])
    # one phase for the ceiling and "ar", then fact_ph4's 4 offsets
    for side in ("port", "jax"):
        assert [list(kw["phases"]) for _, kw, _ in ar.logs[side]["extract_code_grids"]] == \
            [[0], [0, 1, 2, 3]], side
    assert_numbers_close(ar.port["ceiling"], ar.jax["ceiling"], DET_ATOL, "ceiling")
    assert_histories_close(ar.logs["port"]["train_prior"], ar.logs["jax"]["train_prior"])
    for arm in AR_ARMS.split(","):
        got, want = ar.port["arms"][arm], ar.jax["arms"][arm]
        for k in ("best_val_ce", "best_train_ce"):
            assert got[k] == pytest.approx(want[k], rel=CE_RTOL)
        assert got["epochs_run"] == want["epochs_run"] == 2
        path = str(ar.out / "port" / f"prior_{arm}.ckpt")
        assert tprior.load_prior_checkpoint(path, device="cpu")[1].slot_ar == (arm == "ar")
        saved = torch.load(path, weights_only=True)["history"]
        for k, want in jax_history(str(ar.out / "jax" / f"prior_{arm}.ckpt")).items():
            np.testing.assert_allclose(saved[k], want, rtol=CE_RTOL, err_msg=k)


def test_exp_prior_ar_scores_its_samples_as_jax_does(ar, study):
    # each arm's novelty is against its own tokenization
    grids = {len(kw["phases"]): out[:2] for _, kw, out in ar.logs["port"]["extract_code_grids"]}
    data_wins = bank(study.takes, 8, STRIDE)
    samples = ar.logs["port"]["sample_motion"]
    assert len(samples) == len(AR_ARMS.split(","))
    for arm, (_, _, (motions, windows, grid)) in zip(AR_ARMS.split(","), samples):
        want = sample_metrics(motions, windows, grid, study.takes, *grids[AR_PHASES[arm]],
                              data_wins, STRIDE)
        assert_numbers_close({k: ar.port["arms"][arm][k] for k in want}, want, METRIC_ATOL,
                             arm)
        for i, m in enumerate(motions):
            np.testing.assert_array_equal(np.load(ar.out / "port" / f"gen_{arm}_idx{i}.npy"), m)




def test_exp_prior_ar_runs_every_arm(ar, study, tmp_path, one_torch_thread):  # noqa: F811
    """The arms not run against JAX above (a factorized head over one phase,
    a slot-AR head over 4), with the keys of JAX's arm rows."""
    flags = ["--data_dir", study.data, *TRAIN, *SAMPLE, "--out_dir", str(tmp_path)]
    with pytest.MonkeyPatch.context() as mp:
        _narrow_prior_configs(mp)
        assert exp_prior_ar.main(["--ckpt", study.port_ckpt, *flags,
                                  "--arms", "fact,ar_ph4", "--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert sorted(summary["arms"]) == ["ar_ph4", "fact"]
    for arm, rep in summary["arms"].items():
        assert sorted(rep) == sorted(ar.jax["arms"]["ar"]), arm
        assert np.isfinite([v for v in rep.values()]).all(), arm
        pcfg = tprior.load_prior_checkpoint(str(tmp_path / f"prior_{arm}.ckpt"),
                                            device="cpu")[1]
        assert pcfg.slot_ar == arm.startswith("ar")
    assert exp_prior_ar.main(["--ckpt", study.port_ckpt, *flags, "--arms", "nope",
                              "--device", "cpu"]) == 2


# ------------------------------------------------------ exp_prior_sampling

# (guided greedy draws equal JAX's in test_torch_port_prior_generation.py)
SWEEP = ["--temperatures", "1.0", "--top_ks", "0,1"]


@pytest.fixture(scope="module")
def priors(study):
    """One slot-AR prior over the study's code space, saved by both
    packages from the same weights."""
    grids, mask, pcfg, _ = jprior.extract_code_grids(
        *jckpt_model(study.jax_ckpt), study.takes, np.zeros(1, np.float32),
        np.ones(1, np.float32), STRIDE, max_len=MAX_LEN)
    pcfg = dataclasses.replace(pcfg, slot_ar=True, **SMALL_PRIOR)
    return prior_files(study.root, pcfg)


@pytest.fixture(scope="module")
def sweep(study, priors):
    jax_prior, port_prior = priors
    out = study.root / "sweep"
    flags = ["--data_dir", study.data, *SAMPLE, *SWEEP]
    logs = run_pair("exp_prior_sampling", exp_prior_sampling,
                    ["--ckpt", study.jax_ckpt, "--priors", jax_prior, *flags,
                     "--out", str(out / "jax.json")],
                    ["--ckpt", study.port_ckpt, "--priors", port_prior, *flags,
                     "--out", str(out / "port.json")])
    return SimpleNamespace(logs=logs, jax=json.loads((out / "jax.json").read_text()),
                           port=json.loads((out / "port.json").read_text()))


def test_exp_prior_sampling_sweeps_the_jax_scripts_points(sweep):
    assert sorted(sweep.port) == sorted(sweep.jax) == ["prior|T1.0|k0", "prior|T1.0|k1"]
    assert_same_keys(sweep.port, sweep.jax)
    assert_extractions_equal(sweep.logs["port"]["extract_code_grids"],
                             sweep.logs["jax"]["extract_code_grids"])


def test_exp_prior_sampling_greedy_rows_equal_jax(sweep):
    key = "prior|T1.0|k1"
    got = {k: v for k, v in sweep.port[key].items() if k != "sample_s"}
    want = {k: v for k, v in sweep.jax[key].items() if k != "sample_s"}
    assert_numbers_close(got, want, DET_ATOL, key)


def test_exp_prior_sampling_scores_its_samples_as_jax_does(sweep, study):
    grids, mask = sweep.logs["port"]["extract_code_grids"][0][2][:2]
    data_wins = bank(study.takes, 8, STRIDE)
    keys = ["prior|T1.0|k0", "prior|T1.0|k1"]
    samples = sweep.logs["port"]["sample_motion"]
    assert len(samples) == len(keys)
    for key, (_, kw, (motions, windows, grid)) in zip(keys, samples):
        want = sample_metrics(motions, windows, grid, study.takes, grids, mask, data_wins,
                              STRIDE)
        assert_numbers_close({k: sweep.port[key][k] for k in want}, want, METRIC_ATOL, key)
    assert [kw["top_k"] for _, kw, _ in samples] == [None, 1]


# ------------------------------------------------------ exp_prior_prompted

PROMPTS = "0,2"


@pytest.fixture(scope="module")
def prompted(study, priors):
    jax_prior, port_prior = priors
    out = study.root / "prompted"
    flags = ["--data_dir", study.data, *SAMPLE, "--prompt_positions", PROMPTS]
    printed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("builtins.print", lambda *a, **kw: printed.append(" ".join(map(str, a))))
        logs = run_pair("exp_prior_prompted", exp_prior_prompted,
                        ["--ckpt", study.jax_ckpt, "--priors", jax_prior, *flags,
                         "--out", str(out / "jax.json")],
                        ["--ckpt", study.port_ckpt, "--priors", port_prior, *flags,
                         "--out", str(out / "port.json")])
    rows = [line.split("prompt rows=")[1] for line in printed if "prompt rows=" in line]
    return SimpleNamespace(logs=logs, rows=rows,
                           jax=json.loads((out / "jax.json").read_text()),
                           port=json.loads((out / "port.json").read_text()))


def test_exp_prior_prompted_prompts_the_jax_scripts_rows(prompted):
    assert sorted(prompted.port) == sorted(prompted.jax) == ["prior|P0", "prior|P2"]
    assert_same_keys(prompted.port, prompted.jax)
    assert len(prompted.rows) == 2 and prompted.rows[0] == prompted.rows[1]
    for key in prompted.port:
        assert prompted.port[key]["offsets"] == prompted.jax[key]["offsets"]


def test_exp_prior_prompted_scores_its_continuations_as_jax_does(prompted, study):
    (_, _, (grids, mask, _, _)), = prompted.logs["port"]["extract_code_grids"]
    (_, _, true_wins), = prompted.logs["port"]["decode_grid_rows"]
    data_wins = bank(study.takes, 8, STRIDE)
    # the true continuation, decoded by JAX from the same rows
    (_, _, (jgrids, _, _, _)), = prompted.logs["jax"]["extract_code_grids"]
    sel = json.loads(prompted.rows[0])
    jm, jv, jexp = jckpt_model(study.jax_ckpt)
    pcfg = tprior.load_prior_checkpoint(
        str(study.root / "port" / "prior.ckpt"), device="cpu")[1]
    codes = jtp.grid_to_codes(jtp.PriorConfig.from_json(pcfg.to_json()),
                              jnp.asarray(np.asarray(jgrids)[sel, :8]))
    z_q = decode_codes(jexp.model, jv, denormalize_codes(jexp.model, codes))
    want_true = np.asarray(jm.apply(jv, z_q, method="decode_latent")).reshape(2, 8, 8, -1)
    np.testing.assert_allclose(true_wins, want_true, atol=DET_ATOL)
    for P, (_, _, (_, wins, grid)) in zip((0, 2), prompted.logs["port"]["sample_motion"]):
        cont = wins[:, P:]
        want = jgen.compare_to_data([jprior.stitch_windows(w, STRIDE) for w in cont],
                                    study.takes)
        want["overlap_disagreement_seam"] = float(np.mean(
            [jgen.overlap_disagreement(w[max(P - 1, 0):], STRIDE) for w in wins]))
        want["overlap_disagreement_cont"] = float(np.mean(
            [jgen.overlap_disagreement(w, STRIDE) for w in cont]))
        want.update(jgen.code_novelty(grid[:, P:], grids, mask))
        want.update(jgen.nearest_data_distance(cont, data_wins))
        probe = prompted.port[f"prior|P{P}"]["offsets"]
        want["nn_mse_by_offset"] = [
            jgen.nearest_data_distance(cont[:, j], data_wins)["nn_mse_mean"] for j in probe]
        want["truth_mse_by_offset"] = [float(np.mean((cont[:, j] - true_wins[:, P + j]) ** 2))
                                       for j in probe]
        assert_numbers_close({k: prompted.port[f"prior|P{P}"][k] for k in want}, want,
                             METRIC_ATOL, f"P{P}")
        if P:
            np.testing.assert_array_equal(grid[:, :P], np.asarray(grids)[sel, :P])


# ------------------------------------------------ diagnostics, plots, CLIs

STUDIES = (exp_prior_ar, exp_prior_sampling, exp_prior_prompted, exp_prior_scaling,
           exp_prior_conditioned, exp_prior_dynamics)
DEVICE_CLIS = STUDIES + (diag_fsq_spread, diag_lfq)
PLOTS = (plot_prior_scaling, plot_prior_conditioned)


@pytest.fixture(scope="module")
def diag_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("diag")
    takes = [np.random.default_rng(i).normal(size=(40, 29)).astype(np.float32)
             for i in range(12)]
    write_takes(root / "data", takes)
    return root, {m: teacher_files(root, m, seed=2)[:2] for m in ("fsq", "lfq")}


@pytest.mark.parametrize("port,name,method", [(diag_fsq_spread, "diag_fsq_spread", "fsq"),
                                              (diag_lfq, "diag_lfq", "lfq")])
def test_diagnostics_print_the_jax_scripts_report(port, name, method, diag_files, capsys,
                                                  monkeypatch):
    root, files = diag_files
    jax_ckpt, port_ckpt = files[method]
    data = ["--data_dir", str(root / "data"), "--batch", "64"]
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--ckpt", jax_ckpt, *data])
    jax_script(name).main()
    want = capsys.readouterr().out.splitlines()
    assert port.main(["--ckpt", port_ckpt, *data, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == f"ckpt: {port_ckpt}" and want[0] == f"ckpt: {jax_ckpt}"
    assert got[1:] == want[1:]
    assert len(got) > 10


def test_diagnostics_refuse_a_quantizer_they_do_not_read(diag_files, capsys):
    root, files = diag_files
    data = ["--data_dir", str(root / "data"), "--device", "cpu"]
    assert diag_lfq.main(["--ckpt", files["fsq"][1], *data]) == 2
    assert "not lfq" in capsys.readouterr().err
    assert diag_fsq_spread.main(["--ckpt", files["lfq"][1], *data]) == 2
    assert "no FSQ stage" in capsys.readouterr().err


class Recorder:
    """A stand-in for pyplot that keeps the (x, y) of every ``plot`` call,
    in order, and answers every other attribute, call or item with another
    recorder."""

    def __init__(self, lines, name=""):
        self.lines, self.name = lines, name

    def __getattr__(self, name):
        return Recorder(self.lines, name)

    def __call__(self, *args, **kwargs):
        if self.name == "plot":
            self.lines.append([np.asarray(a, np.float64).tolist() for a in args[:2]])
        if self.name == "subplots":
            return Recorder(self.lines), (Recorder(self.lines), Recorder(self.lines))
        return Recorder(self.lines)

    def __getitem__(self, key):
        return Recorder(self.lines)


@pytest.mark.parametrize("port,name", [(plot_prior_scaling, "plot_prior_scaling"),
                                       (plot_prior_conditioned, "plot_prior_conditioned")])
def test_plots_draw_the_jax_scripts_series(port, name, monkeypatch, tmp_path):
    jax_lines, port_lines = [], []
    module = jax_script(name)
    monkeypatch.setattr(module, "plt", Recorder(jax_lines))
    module.main()
    monkeypatch.setattr(bridgerl_tpu_torch.utils.optional, "pyplot",
                        lambda purpose="": Recorder(port_lines))
    assert port.main([]) == 0
    assert len(port_lines) == len(jax_lines) >= 5
    for got, want in zip(port_lines, jax_lines):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    series = port.series(port.load_arms(REPO))
    x = series["takes"] if port is plot_prior_scaling else series["per_class"]
    assert x == port_lines[0][0]


@pytest.mark.parametrize("port", PLOTS)
def test_plots_draw_a_figure_where_matplotlib_is_installed(port, tmp_path):
    pytest.importorskip("matplotlib")
    out = port.draw(port.series(port.load_arms(REPO)), tmp_path / "fig.png")
    assert out.exists() and out.stat().st_size > 10_000


@pytest.mark.parametrize("port", PLOTS)
def test_plots_name_a_missing_matplotlib(port, monkeypatch, capsys):
    for mod in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, mod, None)   # import raises ImportError
    assert port.main([]) == 2
    assert "'matplotlib' package" in capsys.readouterr().err


@pytest.mark.parametrize("cli", DEVICE_CLIS + PLOTS, ids=lambda m: m.__name__.split(".")[-1])
def test_every_study_cli_has_help(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
@pytest.mark.parametrize("cli", DEVICE_CLIS, ids=lambda m: m.__name__.split(".")[-1])
def test_without_a_card_the_default_device_stops(cli, capsys):
    argv = ["--ckpt", "unused.pth"] + (["--priors", "unused.ckpt"]
                                       if cli in (exp_prior_sampling, exp_prior_prompted) else [])
    assert cli.main(argv) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_the_jax_packages_checkpoints_are_refused(diag_files, capsys, tmp_path):
    root, files = diag_files
    jax_ckpt, port_ckpt = files["fsq"]
    for cli in DEVICE_CLIS:
        argv = ["--ckpt", jax_ckpt, "--device", "cpu"]
        if cli in (exp_prior_sampling, exp_prior_prompted):
            argv += ["--priors", "unused.ckpt"]
        assert cli.main(argv) == 2, cli.__name__
        assert "import_torch_ckpt" in capsys.readouterr().err, cli.__name__
    not_a_prior = tmp_path / "prior.ckpt"
    not_a_prior.write_bytes(open(jax_ckpt, "rb").read())
    assert exp_prior_sampling.main(["--ckpt", port_ckpt, "--priors", str(not_a_prior),
                                    "--device", "cpu"]) == 2
    assert "not a token-prior checkpoint" in capsys.readouterr().err


def test_run_queue_calls_after_entry_before_it_drops_the_port(tmp_path):
    """``run_queue.main``'s ``after_entry``: called with each entry's label
    after its OK line and while its modules are loaded, which the next entry
    loads anew (how ``chip_smoke.py``'s research phase reads each entry's
    kernel launches)."""
    queue = tmp_path / "queue.json"
    queue.write_text(json.dumps([["bridgerl_tpu_torch.cli.diag_lfq", "--help"],
                                 ["bridgerl_tpu_torch.cli.diag_fsq_spread", "--help"]]))
    probe = ("import sys\n"
             "from bridgerl_tpu_torch.cli import run_queue\n"
             "def after(label):\n"
             "    cli = sys.modules['bridgerl_tpu_torch.cli']\n"
             "    print('AFTER', label, '|', hasattr(cli, 'marked'))\n"
             "    cli.marked = True\n"
             "sys.exit(run_queue.main(sys.argv[1:], after_entry=after))\n")
    r = subprocess.run([sys.executable, "-c", probe, str(queue)], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [line for line in r.stdout.splitlines() if line.startswith(("===", "AFTER"))]
    labels = [f"queue[{i}] bridgerl_tpu_torch.cli.{m} --help"
              for i, m in enumerate(("diag_lfq", "diag_fsq_spread"))]
    assert [line.split(" (")[0].split(" |")[0] for line in lines] == [
        f"=== {labels[0]} start ===", f"=== {labels[0]} OK", f"AFTER {labels[0]}",
        f"=== {labels[1]} start ===", f"=== {labels[1]} OK", f"AFTER {labels[1]}"]
    # the mark the first call left went with the dropped modules
    assert [line.split("| ")[1] for line in lines if line.startswith("AFTER")] == ["False"] * 2
