"""The port's data pipeline against the JAX package's, on the CPU: the 6D
rotation conversion (1e-6), the synthetic generator (equal arrays for a
seed), and the artifacts that preprocessing writes from one raw npz tree
(equal files)."""

import os

import numpy as np
import pytest

from bridgerl_tpu.data import pipeline as jax_pipeline
from bridgerl_tpu.data import rotations as jax_rotations
from bridgerl_tpu.data import synthetic as jax_synthetic
from bridgerl_tpu_torch.data import pipeline, rotations, synthetic


@pytest.mark.parametrize("layout", ["axis_angle", "quaternion", "tiny_angles"])
def test_6d_rotation_matches_jax(layout):
    rng = np.random.default_rng(0)
    if layout == "quaternion":   # 22 joints: 88 features, which 3 does not divide
        x = rng.normal(size=(30, 22 * 4))
    elif layout == "tiny_angles":
        x = rng.normal(scale=1e-9, size=(30, 21 * 3))
    else:
        x = rng.normal(size=(30, 21, 3))
    got = rotations.compute_6d_rotation(x)
    assert got.shape == (30, (132 if layout == "quaternion" else 126))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jax_rotations.compute_6d_rotation(x), atol=1e-6)
    with pytest.raises(ValueError):
        rotations.compute_6d_rotation(rng.normal(size=(5, 7)))


def test_synthetic_pair_and_dataset_equal_jax(tmp_path):
    a = synthetic.synth_pair(np.random.default_rng(3), 50)
    b = jax_synthetic.synth_pair(np.random.default_rng(3), 50)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    kw = dict(n_sequences=3, min_len=40, max_len=90, window=10, step=3, seed=5)
    ours = synthetic.generate_synthetic_dataset(str(tmp_path / "port"), **kw)
    ref = jax_synthetic.generate_synthetic_dataset(str(tmp_path / "jax"), **kw)
    assert sorted(ours) == sorted(ref) == sorted(pipeline.ARTIFACTS)
    for name in pipeline.ARTIFACTS:
        _assert_artifact_equal(tmp_path / "port" / name, tmp_path / "jax" / name, name)


def _assert_artifact_equal(p, q, name):
    a, b = np.load(p, allow_pickle=True), np.load(q, allow_pickle=True)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    if a.dtype == object:
        for x, y in zip(a.reshape(-1), b.reshape(-1)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_pipeline_artifacts_from_one_npz_tree_equal_jax(tmp_path):
    raw = synthetic.synthetic_npz_tree(str(tmp_path / "raw"), n_files=3, T=70, seed=2)
    jax_raw = jax_synthetic.synthetic_npz_tree(str(tmp_path / "raw_jax"), n_files=3, T=70,
                                               seed=2)
    for name in sorted(os.listdir(os.path.join(raw, "train_set"))):
        for k, v in np.load(os.path.join(raw, "train_set", name)).items():
            np.testing.assert_array_equal(v, np.load(os.path.join(jax_raw, "train_set",
                                                                  name))[k])
    ours = pipeline.process_paired_data(raw, str(tmp_path / "port"), window=16, step=5,
                                        verbose=False)
    ref = jax_pipeline.process_paired_data(raw, str(tmp_path / "jax"), window=16, step=5,
                                           verbose=False)
    assert sorted(ours) == sorted(ref)
    for name in pipeline.ARTIFACTS:
        _assert_artifact_equal(tmp_path / "port" / name, tmp_path / "jax" / name, name)
    loaded = pipeline.load_artifacts(str(tmp_path / "port"))
    want = jax_pipeline.load_artifacts(str(tmp_path / "jax"))
    assert sorted(loaded) == sorted(want)
    np.testing.assert_array_equal(loaded["g1_train.npy"], want["g1_train.npy"])
    # existing artifacts are kept unless overwrite is asked for
    assert pipeline.process_paired_data(raw, str(tmp_path / "port"), verbose=False) is None
    npz = os.path.join(raw, "train_set", "motion_000.npz")
    assert pipeline.inspect_npz(npz) == jax_pipeline.inspect_npz(npz)


@pytest.mark.parametrize("T,window,stride", [(10, 4, 3), (3, 4, 1), (64, 64, 20)])
def test_slice_windows_matches_jax(T, window, stride):
    x = np.arange(T * 5, dtype=np.float32).reshape(T, 5)
    np.testing.assert_array_equal(pipeline.slice_windows(x, window, stride),
                                  jax_pipeline.slice_windows(x, window, stride))


def test_load_artifacts_needs_the_window_pair(tmp_path):
    with pytest.raises(FileNotFoundError, match="process_data"):
        pipeline.load_artifacts(str(tmp_path))
