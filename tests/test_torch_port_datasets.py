"""The rest of the port's synthetic data and its two command lines, and the
dataset manifest, against the JAX package on the CPU: ``synth_robot_takes``,
``ACTION_BANDS`` and ``synth_labeled_takes`` (``data/synthetic.py``),
``cli/gen_datasets.py``, ``cli/inspect_npz.py`` and ``data/manifest.py``.
Everything here is numpy on the host from seeded generators, so every
array is held equal, not close."""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from bridgerl_tpu.data import manifest as jmanifest
from bridgerl_tpu.data import synthetic as jsynthetic
from bridgerl_tpu_torch.cli import gen_datasets, inspect_npz
from bridgerl_tpu_torch.data import manifest, synthetic
from bridgerl_tpu_torch.eval.latent import ACTION_KEYWORDS

REPO = Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _equal_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 11])
def test_synth_robot_takes_equal_jax(seed):
    got = synthetic.synth_robot_takes(5, 40, 90, seed)
    _equal_lists(got, jsynthetic.synth_robot_takes(5, 40, 90, seed))
    assert all(t.shape[1] == synthetic.G1_DOF and 40 <= len(t) <= 90 for t in got)


@pytest.mark.parametrize("seed", [0, 11])
def test_synth_labeled_takes_equal_jax_and_grow_by_prefix(seed):
    takes, labels = synthetic.synth_labeled_takes(3, 50, 80, seed)
    jtakes, jlabels = jsynthetic.synth_labeled_takes(3, 50, 80, seed)
    assert labels == jlabels == [a for _ in range(3) for a in synthetic.ACTION_BANDS]
    _equal_lists(takes, jtakes)
    # each action's takes at n_per_action 2 are a prefix of those at 3
    few, few_labels = synthetic.synth_labeled_takes(2, 50, 80, seed)
    for action in synthetic.ACTION_BANDS:
        small = [t for t, l in zip(few, few_labels) if l == action]
        big = [t for t, l in zip(takes, labels) if l == action]
        _equal_lists(small, big[:len(small)])
    sub, sub_labels = synthetic.synth_labeled_takes(2, 50, 80, seed, actions=("run", "fall"))
    jsub, jsub_labels = jsynthetic.synth_labeled_takes(2, 50, 80, seed, actions=("run", "fall"))
    assert sub_labels == jsub_labels
    _equal_lists(sub, jsub)


def test_action_bands_equal_both_jax_tables():
    assert synthetic.ACTION_BANDS == jsynthetic.ACTION_BANDS
    assert synthetic.ACTION_BANDS == _jax_script("gen_datasets").ACTION_BANDS
    assert set(ACTION_KEYWORDS) == set(synthetic.ACTION_BANDS)


def _tree_arrays(root):
    out = {}
    for path in sorted(Path(root).rglob("*")):
        rel = str(path.relative_to(root))
        if path.suffix == ".npy":
            out[rel] = np.load(path, allow_pickle=True)
        elif path.suffix == ".npz":
            with np.load(path) as z:
                out.update({f"{rel}:{k}": z[k] for k in z.files})
    return out


def test_gen_datasets_writes_the_jax_scripts_arrays(tmp_path, monkeypatch, capsys):
    flags = ["--n_sequences", "2", "--min_len", "120", "--max_len", "140"]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert gen_datasets.main(flags + ["--root", str(ours)]) == 0
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["gen_datasets.py", *flags, "--root", str(theirs)])
    _jax_script("gen_datasets").main()
    jax_out = capsys.readouterr().out
    assert port_out.replace(str(ours), "ROOT") == jax_out.replace(str(theirs), "ROOT")
    got, want = _tree_arrays(ours), _tree_arrays(theirs)
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("raw_actions")]) == 2 * 3 * len(ACTION_KEYWORDS)
    for k, w in want.items():
        if w.dtype == object:    # the ragged full-raw sequences
            _equal_lists(list(got[k]), list(w))
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_inspect_npz_prints_what_the_jax_script_prints(tmp_path, monkeypatch, capsys):
    root = synthetic.synthetic_npz_tree(str(tmp_path / "raw"), n_files=2, T=30)
    jax_script = _jax_script("inspect_npz")
    for target in (root, manifest.candidate_files(root)[1], str(tmp_path / "empty")):
        assert inspect_npz.main([target]) == 0
        ours = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["inspect_npz.py", target])
        jax_script.main()
        assert ours == capsys.readouterr().out
        assert ours.startswith("== ") or ours.startswith("No npz files")


def _report(r, root):
    d = dataclasses.asdict(r)
    d["errors"] = [e.replace(root, "ROOT") for e in d["errors"]]
    return d


def _both(root_a, root_b):
    """The port's report on one copy of a tree, JAX's on the other."""
    return _report(manifest.verify_tree(root_a), root_a), _report(jmanifest.verify_tree(root_b),
                                                                  root_b)


def _pickled(d):
    np.savez(os.path.join(d, "evil.npz"), joint_pos=np.array([{"x": 1}], dtype=object),
             smplx_pose_body=np.zeros((50, 21, 3), np.float32))


def _wrong_dof(d):
    np.savez(os.path.join(d, "bad.npz"), joint_pos=np.zeros((50, 17), np.float32),
             smplx_pose_body=np.zeros((50, 21, 3), np.float32))


def _quaternions(d):
    np.savez(os.path.join(d, "q.npz"), joint_pos=np.zeros((50, 29), np.float32),
             smplx_pose_body=np.zeros((50, 21, 4), np.float32))


def _short_body(d):
    np.savez(os.path.join(d, "t.npz"), joint_pos=np.zeros((50, 29), np.float32),
             smplx_pose_body=np.zeros((40, 63), np.float32))


@pytest.mark.parametrize("bad", [_pickled, _wrong_dof, _quaternions, _short_body])
def test_verify_tree_rejects_what_jax_rejects(tmp_path, bad):
    roots = []
    for side in ("port", "jax"):
        root = str(tmp_path / side)
        os.makedirs(os.path.join(root, "train_bad"))
        bad(os.path.join(root, "train_bad"))
        roots.append(root)
    got, want = _both(*roots)
    assert got == want and not got["ok"] and got["errors"]
    assert not os.path.exists(os.path.join(roots[0], manifest.MANIFEST_NAME))


def test_verify_tree_records_then_enforces_as_jax_does(tmp_path):
    assert manifest.MANIFEST_NAME == jmanifest.MANIFEST_NAME
    assert manifest.DATASET == jmanifest.DATASET
    roots = [synthetic.synthetic_npz_tree(str(tmp_path / "port"), n_files=3, T=60),
             str(tmp_path / "jax")]
    shutil.copytree(roots[0], roots[1])
    got, want = _both(*roots)
    assert got == want and got["ok"] and got["recorded"] == 3
    assert (json.loads(Path(roots[0], manifest.MANIFEST_NAME).read_text())
            == json.loads(Path(roots[1], manifest.MANIFEST_NAME).read_text()))
    got, want = _both(*roots)          # all known, all matching
    assert got == want and got["ok"] and got["recorded"] == 0
    for root in roots:                 # one file changed
        victim = manifest.candidate_files(root)[0]
        data = dict(np.load(victim))
        np.savez(victim, **{**data, "joint_pos": data["joint_pos"] + 0.1})
    got, want = _both(*roots)
    assert got == want and any("checksum mismatch" in e for e in got["errors"])
    for root in roots:                 # one file gone
        os.remove(manifest.candidate_files(root)[1])
    got, want = _both(*roots)
    assert got == want and any("missing from tree" in e for e in got["errors"])
    assert manifest.verify_tree(str(tmp_path / "none")).summary() == \
        jmanifest.verify_tree(str(tmp_path / "none")).summary()
