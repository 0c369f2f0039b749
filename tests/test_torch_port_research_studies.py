"""The port's ``exp_prior_scaling``, ``exp_prior_dynamics`` and
``exp_prior_conditioned`` against the JAX scripts on the CPU, on the tiny
set-up of ``test_torch_port_research.py`` and to its rules: the same JSON
keys, tokenized grids and masks equal, every number that does not depend on
a draw within 1e-5, CE histories within 1e-5 relative at dropout 0, and
every sampled number within 1e-6 of the JAX package's metric functions
applied to the port's own samples. Each JAX script runs once.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from bridgerl_tpu.data.synthetic import ACTION_BANDS
from bridgerl_tpu.data.synthetic import synth_labeled_takes as jax_synth_labeled_takes
from bridgerl_tpu.data.synthetic import synth_robot_takes as jax_synth_robot_takes
from bridgerl_tpu.eval import generation as jgen
from bridgerl_tpu.train import prior as jprior
from bridgerl_tpu_torch.cli import exp_prior_conditioned, exp_prior_dynamics, exp_prior_scaling

from test_torch_port_research import (  # noqa: F401  (study: fixture)
    DET_ATOL,
    METRIC_ATOL,
    SAMPLE,
    STRIDE,
    TAKE_FRAMES,
    TAKES,
    TRAIN,
    _narrow_prior_configs,
    assert_extractions_equal,
    assert_histories_close,
    assert_numbers_close,
    assert_same_keys,
    bank,
    run_pair,
    study,
)
from test_torch_port_zoo import one_torch_thread  # noqa: F401  (fixture)


# ------------------------------------------------------ exp_prior_scaling

N_TAKES = 9   # the 8 pinned takes and one fresh take
PROMPT = 2    # scaling's and dynamics' prompt positions
SCALING = ["--arms", str(N_TAKES), "--min_len", str(TAKE_FRAMES), "--max_len_frames",
           str(TAKE_FRAMES), "--n_phases", "2", "--prompt_len", str(PROMPT), "--d_model", "16",
           "--n_layers", "1", "--n_heads", "2", "--prior_dropout", "0", *TRAIN, *SAMPLE]
SCALING_DETERMINISTIC = ("n_grids", "n_positions", "n_val_takes", "best_train_ce",
                         "val_ce_epoch0", "val_ce_best", "val_ce_best_epoch", "val_ce_final",
                         "epochs_run", "recon_floor", "val_nn_floor")


@pytest.fixture(scope="module")
def scaling(study):
    out = study.root / "scale"
    logs = run_pair("exp_prior_scaling", exp_prior_scaling,
                    ["--ckpt", study.jax_ckpt, "--data_dir", study.data, *SCALING,
                     "--out_dir", str(out / "jax")],
                    ["--ckpt", study.port_ckpt, "--data_dir", study.data, *SCALING,
                     "--out_dir", str(out / "port")])
    read = lambda side: json.loads((out / side / "scaling.json").read_text())  # noqa: E731
    return SimpleNamespace(out=out, logs=logs, jax=read("jax"), port=read("port"))


def test_exp_prior_scaling_arm_equals_jax_where_nothing_is_drawn(scaling):
    arm = f"takes{N_TAKES}"
    assert list(scaling.port) == list(scaling.jax) == [arm]
    assert_same_keys(scaling.port, scaling.jax)
    assert_extractions_equal(scaling.logs["port"]["extract_code_grids"],
                             scaling.logs["jax"]["extract_code_grids"])
    assert_histories_close(scaling.logs["port"]["train_prior"], scaling.logs["jax"]["train_prior"])
    got, want = scaling.port[arm], scaling.jax[arm]
    assert_numbers_close({k: got[k] for k in SCALING_DETERMINISTIC},
                         {k: want[k] for k in SCALING_DETERMINISTIC}, DET_ATOL, rtol=1e-5)
    assert got["n_val_takes"] == 1 and (scaling.out / "port" / f"prior_{arm}.ckpt").exists()


def test_exp_prior_scaling_scores_its_samples_as_jax_does(scaling, study):
    arm = scaling.port[f"takes{N_TAKES}"]
    (_, _, (grids, mask, _, ids)) = scaling.logs["port"]["extract_code_grids"][0]
    (_, _, true_wins) = scaling.logs["port"]["decode_grid_rows"][0]   # the held-out rows
    takes = study.takes + jax_synth_robot_takes(1, TAKE_FRAMES, TAKE_FRAMES, 9000)
    # the take-grouped split as JAX's train_prior draws it at seed 42
    order = np.random.default_rng(42).permutation(np.unique(ids))
    val_takes = set(order[:max(1, int(len(order) * 0.1))].tolist())
    train_bank = bank(takes, 8, STRIDE, [i for i in range(N_TAKES) if i not in val_takes])
    (_, _, (motions, wins, grid)), (_, _, (_, wins_p, grid_p)) = \
        scaling.logs["port"]["sample_motion"]
    free = jgen.compare_to_data(motions, takes)
    free["overlap_disagreement"] = float(np.mean(
        [jgen.overlap_disagreement(w, STRIDE) for w in wins]))
    free.update(jgen.code_novelty(grid, grids, mask))
    free.update(jgen.nearest_data_distance(wins, train_bank))
    assert_numbers_close(arm["free_run"], free, METRIC_ATOL, "free_run")
    cont = wins_p[:, PROMPT:]
    pr = jgen.compare_to_data([jprior.stitch_windows(w, STRIDE) for w in cont], takes)
    pr.update(jgen.code_novelty(grid_p[:, PROMPT:], grids, mask))
    pr.update(jgen.continuation_curves(cont, true_wins[:, PROMPT:], train_bank))
    assert_numbers_close(arm[f"prompted_val_P{PROMPT}"], pr, METRIC_ATOL, "prompted")


# ---------------------------------------------------- exp_prior_dynamics

DYN_SEED = 42
DYNAMICS = ["--takes", str(TAKES), "--seeds", str(DYN_SEED), "--n_phases", "2",
            "--guide", "3", "--prompt_len", str(PROMPT), *TRAIN, *SAMPLE]
DYNAMICS_DETERMINISTIC = ("lam", "seed", "n_grids", "best_train_ce", "val_ce_epoch0",
                          "val_ce_best", "val_ce_best_epoch", "epochs_run")


@pytest.fixture(scope="module")
def dynamics(study):
    out = study.root / "dyn"
    flags = ["--data_dir", study.data, *DYNAMICS, "--lams", "0.75"]
    logs = run_pair("exp_prior_dynamics", exp_prior_dynamics,
                    ["--ckpt", study.jax_ckpt, *flags, "--out_dir", str(out / "jax")],
                    ["--ckpt", study.port_ckpt, *flags, "--out_dir", str(out / "port")])
    read = lambda side: json.loads((out / side / "dynamics.json").read_text())  # noqa
    return SimpleNamespace(out=out, logs=logs, jax=read("jax"), port=read("port"))


def test_exp_prior_dynamics_arm_equals_jax_where_nothing_is_drawn(dynamics):
    arm = f"lam0.75_seed{DYN_SEED}"
    assert list(dynamics.port) == list(dynamics.jax) == [arm]
    assert_same_keys(dynamics.port, dynamics.jax)
    assert_extractions_equal(dynamics.logs["port"]["extract_code_grids"],
                             dynamics.logs["jax"]["extract_code_grids"])
    (_, pkw, _), = dynamics.logs["port"]["train_prior"]
    (_, jkw, _), = dynamics.logs["jax"]["train_prior"]
    np.testing.assert_allclose(pkw["pos_weights"], jkw["pos_weights"], atol=1e-6)
    assert_histories_close(dynamics.logs["port"]["train_prior"],
                           dynamics.logs["jax"]["train_prior"])
    got, want = dynamics.port[arm], dynamics.jax[arm]
    assert_numbers_close({k: got[k] for k in DYNAMICS_DETERMINISTIC},
                         {k: want[k] for k in DYNAMICS_DETERMINISTIC}, DET_ATOL, rtol=1e-5)
    assert got["free_unguided"]["frames"] == want["free_unguided"]["frames"]


def test_exp_prior_dynamics_scores_its_samples_as_jax_does(dynamics, study):
    rep = dynamics.port[f"lam0.75_seed{DYN_SEED}"]
    (_, _, (grids, mask, _, ids, _)), = dynamics.logs["port"]["extract_code_grids"]
    (_, _, true_wins), = dynamics.logs["port"]["decode_grid_rows"]
    order = np.random.default_rng(DYN_SEED).permutation(np.unique(ids))
    val_takes = set(order[:max(1, int(len(order) * 0.1))].tolist())
    train_bank = bank(study.takes, 8, STRIDE, [i for i in range(TAKES) if i not in val_takes])
    samples = dynamics.logs["port"]["sample_motion"]
    assert [kw.get("guide_candidates", 0) for _, kw, _ in samples] == [0, 3, 0]
    for key, (_, _, (motions, wins, grid)) in zip(("free_unguided", "free_guided"), samples):
        free = jgen.compare_to_data(motions, study.takes)
        free["overlap_disagreement"] = float(np.mean(
            [jgen.overlap_disagreement(w, STRIDE) for w in wins]))
        free.update(jgen.code_novelty(grid, grids, mask))
        free.update(jgen.nearest_data_distance(wins, train_bank))
        free["frames"] = int(sum(m.shape[0] for m in motions))
        assert_numbers_close({k: rep[key][k] for k in free}, free, METRIC_ATOL, key)
    (_, _, (_, wins_p, grid_p)) = samples[2]
    cont = wins_p[:, PROMPT:]
    pr = jgen.compare_to_data([jprior.stitch_windows(w, STRIDE) for w in cont], study.takes)
    pr.update(jgen.code_novelty(grid_p[:, PROMPT:], grids, mask))
    pr.update(jgen.continuation_curves(cont, true_wins[:, PROMPT:], train_bank))
    assert_numbers_close(rep[f"prompted_val_P{PROMPT}"], pr, METRIC_ATOL, "prompted")


def test_exp_prior_dynamics_baseline_arm_and_resume(dynamics, study,
                                                   one_torch_thread):  # noqa: F811
    """lam 0 trains unweighted; an arm already in dynamics.json is skipped."""
    out = dynamics.out / "port"
    with pytest.MonkeyPatch.context() as mp:
        _narrow_prior_configs(mp)
        assert exp_prior_dynamics.main(["--ckpt", study.port_ckpt, "--data_dir", study.data,
                                        *DYNAMICS, "--lams", "0.0,0.75", "--out_dir", str(out),
                                        "--device", "cpu"]) == 0
    rows = json.loads((out / "dynamics.json").read_text())
    assert sorted(rows) == [f"lam0.75_seed{DYN_SEED}", f"lam0_seed{DYN_SEED}"]
    assert rows[f"lam0.75_seed{DYN_SEED}"] == dynamics.port[f"lam0.75_seed{DYN_SEED}"]
    assert sorted(rows[f"lam0_seed{DYN_SEED}"]) == sorted(dynamics.jax[f"lam0.75_seed{DYN_SEED}"])


# ------------------------------------------------- exp_prior_conditioned

PER_CLASS = 2
CONDITIONED = ["--arms", str(PER_CLASS), "--min_len", str(TAKE_FRAMES), "--max_len_frames",
               str(TAKE_FRAMES), "--n_phases", "1", "--gen_per_class", "1", "--positions",
               "8", *TRAIN]
CONDITIONED_DETERMINISTIC = ("n_takes", "n_grids", "cond_val_ce_best", "cond_val_ce_epoch0",
                             "uncond_val_ce_best", "uncond_val_ce_epoch0",
                             "conditioning_gain_nats", "classifier_accuracy_val",
                             "classifier_confusion", "classifier_accuracy_train")


@pytest.fixture(scope="module")
def conditioned(study):
    out = study.root / "cond"
    logs = run_pair("exp_prior_conditioned", exp_prior_conditioned,
                    ["--ckpt", study.jax_ckpt, *CONDITIONED, "--out_dir", str(out / "jax")],
                    ["--ckpt", study.port_ckpt, *CONDITIONED, "--out_dir", str(out / "port")])
    read = lambda side: json.loads((out / side / "conditioned.json").read_text())  # noqa
    return SimpleNamespace(out=out, logs=logs, jax=read("jax"), port=read("port"))


def test_exp_prior_conditioned_arm_equals_jax_where_nothing_is_drawn(conditioned):
    arm = f"perclass{PER_CLASS}"
    assert list(conditioned.port) == list(conditioned.jax) == [arm]
    assert_same_keys(conditioned.port, conditioned.jax)
    assert_extractions_equal(conditioned.logs["port"]["extract_code_grids"],
                             conditioned.logs["jax"]["extract_code_grids"])
    # the conditioned prior, then the unconditioned control
    assert_histories_close(conditioned.logs["port"]["train_prior"],
                           conditioned.logs["jax"]["train_prior"])
    got, want = conditioned.port[arm], conditioned.jax[arm]
    assert_numbers_close({k: got[k] for k in CONDITIONED_DETERMINISTIC},
                         {k: want[k] for k in CONDITIONED_DETERMINISTIC}, DET_ATOL, rtol=1e-5)
    assert got["n_takes"] == PER_CLASS * len(ACTION_BANDS)


def test_exp_prior_conditioned_scores_its_samples_as_jax_does(conditioned):
    rep = conditioned.port[f"perclass{PER_CLASS}"]
    actions = tuple(ACTION_BANDS)
    C = len(actions)
    takes, labels = jax_synth_labeled_takes(PER_CLASS, TAKE_FRAMES, TAKE_FRAMES, 9100,
                                            actions=actions)
    (_, _, (grids, mask, pcfg, ids)), = conditioned.logs["port"]["extract_code_grids"]
    class_ids = np.asarray([actions.index(labels[i]) for i in ids], np.int32)
    train = ~np.isin(ids, list(range(C)))
    (_, kw, (motions, _, gen_grid)), = conditioned.logs["port"]["sample_motion"]
    gen_cls = np.asarray(kw["class_ids"])
    np.testing.assert_array_equal(gen_cls, np.arange(C))
    hm = jgen.class_histogram_match(gen_grid, gen_cls, grids[train], class_ids[train],
                                    pcfg.vocab_sizes, data_mask=mask[train])
    hm["predicted"] = {actions[c]: actions[k] for c, k in hm["predicted"].items()}
    hm["margins"] = {actions[c]: round(v, 4) for c, v in hm["margins"].items()}
    assert_numbers_close(rep["histogram_match"], json.loads(json.dumps(hm)), METRIC_ATOL)
    vel = {actions[c]: round(jgen.compare_to_data(
        [m for m, g in zip(motions, gen_cls) if g == c],
        [t for t, lab in zip(takes, labels) if lab == actions[c]])["vel_ratio"], 3)
        for c in range(C)}
    assert rep["vel_ratio_by_class"] == vel
