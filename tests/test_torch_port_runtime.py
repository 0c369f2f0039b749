"""The port's native runtime (``bridgerl_tpu_torch/runtime/native.py`` over
its own copy of ``motiondata.cpp``) against the JAX package's
(``bridgerl_tpu.runtime``) and against its own numpy versions, on seeded
inputs: npy v1 and v2 files, an unsupported dtype, windows, statistics,
the shuffle and in-place normalisation. The library builds into
``bridgerl_tpu_torch/_build/``, and a failed build raises.
"""

import os

import numpy as np
import pytest

from bridgerl_tpu import runtime as jrt
from bridgerl_tpu_torch import runtime as rt
from bridgerl_tpu_torch.runtime import native

STATS_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both libraries built (the JAX package's in its own tree, as its tests
    build it)."""
    assert jrt.ensure_built()
    return rt.ensure_built()


def test_the_library_builds_into_the_build_directory(built):
    assert built.parent == native.BUILD_DIR and built.name.startswith("libmotiondata-")
    assert built.exists() and rt.available()
    src = native.SOURCE
    assert src.parent.name == "csrc" and not (src.parent / "libmotiondata.so").exists()
    assert rt.load_library() is rt.load_library()


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.ensure_built(rebuild=True)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setenv("CXX", "g++")
    with pytest.raises(RuntimeError, match="bad.cpp") as e:
        native.ensure_built()
    assert "error" in str(e.value)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
@pytest.mark.parametrize("shape", [(100, 29), (50, 10, 29), (7,), (3, 4, 5, 6)])
def test_load_npy_f32_is_bit_equal_to_jax_and_numpy(tmp_path, version, shape):
    a = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    path = str(tmp_path / "a.npy")
    with open(path, "wb") as f:
        np.lib.format.write_array(f, a, version=version)
    got = rt.load_npy_f32(path)
    assert got.dtype == np.float32 and got.shape == a.shape
    for want in (jrt.load_npy_f32(path), rt.load_npy_f32_numpy(path), a):
        np.testing.assert_array_equal(got, want)


def test_load_npy_f32_refuses_what_the_library_cannot_read(tmp_path):
    """An unsupported dtype raises (the JAX package falls back to numpy);
    the numpy version reads and casts it as JAX's fallback does."""
    a = np.random.default_rng(1).normal(size=(10, 3))
    path = str(tmp_path / "f64.npy")
    np.save(path, a)
    with pytest.raises(ValueError, match="float32"):
        rt.load_npy_f32(path)
    np.testing.assert_array_equal(rt.load_npy_f32_numpy(path), jrt.load_npy_f32(path))
    with pytest.raises(FileNotFoundError):
        rt.load_npy_f32(str(tmp_path / "missing.npy"))


@pytest.mark.parametrize("window,stride", [(10, 1), (10, 3), (64, 20), (157, 1), (200, 1)])
def test_slice_windows_is_bit_equal_to_jax_and_numpy(window, stride):
    motion = np.random.default_rng(window + stride).normal(size=(157, 29)).astype(np.float32)
    got = rt.slice_windows(motion, window, stride)
    for want in (jrt.slice_windows(motion, window, stride),
                 rt.slice_windows_numpy(motion, window, stride)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(5000, 29), (40, 64, 29), (3, 126)])
def test_mean_std_equals_jax_and_numpy(shape):
    data = np.random.default_rng(len(shape)).normal(2.0, 3.0, size=shape).astype(np.float32)
    mean, std = rt.mean_std(data)
    jmean, jstd = jrt.mean_std(data)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    nmean, nstd = rt.mean_std_numpy(data)
    np.testing.assert_allclose(mean, nmean, rtol=0, atol=STATS_ATOL)
    np.testing.assert_allclose(std, nstd, rtol=0, atol=STATS_ATOL)
    assert mean.dtype == std.dtype == np.float32


@pytest.mark.parametrize("n,seed", [(1000, 42), (1, 0), (0, 3), (4097, 2 ** 63 + 5)])
def test_shuffle_indices_is_bit_equal_to_jax_and_numpy(n, seed):
    got = rt.shuffle_indices(n, seed)
    np.testing.assert_array_equal(got, jrt.shuffle_indices(n, seed))
    np.testing.assert_array_equal(got, rt.shuffle_indices_numpy(n, seed))
    assert sorted(got.tolist()) == list(range(n))
    if n > 1:
        assert not np.array_equal(got, rt.shuffle_indices(n, seed + 1))


def test_normalize_inplace_is_bit_equal_to_jax_and_numpy():
    rng = np.random.default_rng(7)
    data = rng.normal(5, 2, size=(200, 3, 29)).astype(np.float32)
    mean, std = rt.mean_std(data)
    want = rt.normalize_inplace_numpy(data, mean, std)
    np.testing.assert_array_equal(jrt.normalize_inplace(data.copy(), mean, std), want)
    buf = data.copy()
    out = rt.normalize_inplace(buf, mean, std)
    assert out is buf   # a contiguous float32 array is written in place
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(rt.normalize_inplace(data.astype(np.float64), mean, std),
                                  want)


def test_nothing_on_the_main_path_imports_the_runtime():
    import subprocess
    import sys
    probe = ("import sys, bridgerl_tpu_torch.train.trainer, bridgerl_tpu_torch.export.serving, "
             "bridgerl_tpu_torch.data.pipeline; "
             "print(any(m.startswith('bridgerl_tpu_torch.runtime') for m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
