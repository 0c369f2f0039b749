"""Streaming overlap-add (``export/streaming.py``) against the JAX package's,
on the CPU.

Both streamers run over the same numpy window function (a fixed seeded
linear map with a frame-dependent term, so that overlapping windows
disagree and the averaging shows): every push emits the same frames at the
same time and the values are equal; the port's stream equals its offline
overlap-add (``export/reconstruct.py``) within 1e-5, and each frame comes
out exactly W + 1 frames after it went in. The port's stream also runs over
its own artifact's ``retarget`` (resnet_no_down + ae, cpu programs). That
the module imports no torch is held in ``test_torch_port_imports.py``.
"""

import numpy as np
import pytest
import torch

from bridgerl_tpu.export.streaming import StreamingRetargeter as JaxStreamingRetargeter
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.export import reconstruct, serialize
from bridgerl_tpu_torch.export.streaming import StreamingRetargeter, window_starts
from bridgerl_tpu_torch.models import init_model

from test_torch_port_zoo import ZOO, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _window_fn(in_dim, out_dim, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(in_dim, out_dim)).astype(np.float32) / np.sqrt(in_dim)

    def fn(x):   # (k, W, in_dim) -> (k, W, out_dim)
        ramp = np.arange(x.shape[1], dtype=np.float32)[None, :, None]
        return (x @ w + 0.1 * ramp).astype(np.float32)

    return fn


def _drive(streamer, seq):
    """Every push's output and the flush's, as a list of arrays."""
    return [streamer.push(f) for f in seq] + [streamer.flush()]


def _joined(outputs):
    """The emitted frames in order (pushes before the first window return
    (0, 0) arrays)."""
    return np.concatenate([o for o in outputs if len(o)])


@pytest.mark.parametrize("T,W,S", [(240, 10, 5), (57, 10, 3), (23, 10, 10), (11, 10, 4),
                                   (10, 10, 2), (130, 64, 20)])
def test_stream_matches_jax(T, W, S):
    fn = _window_fn(7, 5, T)
    seq = np.random.default_rng(T + W).normal(size=(T, 7)).astype(np.float32)
    got = _drive(StreamingRetargeter(fn, W, S, in_dim=7), seq)
    want = _drive(JaxStreamingRetargeter(fn, W, S, in_dim=7), seq)
    assert [g.shape[0] for g in got] == [w.shape[0] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert StreamingRetargeter(fn, W, S, in_dim=7).latency_frames == W + 1


@pytest.mark.parametrize("T,W,S", [(240, 10, 5), (57, 10, 3), (41, 8, 8)])
def test_stream_equals_offline_and_emits_w_plus_1_later(T, W, S):
    fn = _window_fn(7, 5, 1)
    seq = np.random.default_rng(2).normal(size=(T, 7)).astype(np.float32)
    sr = StreamingRetargeter(fn, W, S, in_dim=7)
    out, emitted_at = [], []
    for n, frame in enumerate(seq, start=1):
        frames = sr.push(frame)
        out.append(frames)
        emitted_at += [n] * len(frames)
    tail = sr.flush()
    out.append(tail)
    # frame i is emitted on push i + W + 1 (1-based), or by the flush
    assert emitted_at == [i + W + 1 for i in range(len(emitted_at))]
    assert len(emitted_at) + len(tail) == T
    offline = reconstruct.reconstruct_long_sequence(
        lambda x: torch.from_numpy(fn(x.numpy())), seq, W, S, np.zeros(1), np.ones(1),
        device="cpu")
    np.testing.assert_allclose(_joined(out), offline, atol=1e-5, rtol=0)


def test_short_stream_and_bad_input():
    sr = StreamingRetargeter(_window_fn(3, 2), 10, 5, in_dim=3)
    for f in np.zeros((10, 3), np.float32):
        assert sr.push(f).shape[0] == 0
    assert sr.flush().shape[0] == 0
    with pytest.raises(ValueError, match="frame shape"):
        sr.push(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="positive"):
        StreamingRetargeter(_window_fn(3, 2), 10, 0, in_dim=3)
    np.testing.assert_array_equal(window_starts(57, 10, 3),
                                  reconstruct.window_starts(57, 10, 3))


def test_stream_over_the_ports_artifact(tmp_path):
    """The artifact's retarget (resnet_no_down + ae, window 8), one window
    per call, streamed: equal to the offline overlap-add over the same
    function."""
    texp = make_experiment("resnet_no_down", "ae", **ZOO)
    model = init_model(texp.model, 0, device="cpu")
    path = str(tmp_path / "a.zip")
    serialize.build_serving_artifact(model, texp, path, data_dir=None, platforms=("cpu",))
    mod = serialize.load_serving_artifact(path, device="cpu")
    seq = np.random.default_rng(3).normal(size=(47, 126)).astype(np.float32)
    sr = StreamingRetargeter(mod.retarget, window=8, step=4, in_dim=126)
    got = _joined(_drive(sr, seq))
    assert got.shape == (47, 29) and got.dtype == np.float32
    offline = reconstruct.reconstruct_long_sequence(mod.retarget, seq, 8, 4, np.zeros(1),
                                                    np.ones(1), device="cpu")
    np.testing.assert_allclose(got, offline, atol=1e-5, rtol=0)

