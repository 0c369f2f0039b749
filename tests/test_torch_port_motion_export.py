"""Motion export and the retargeting API against the JAX package's, on the CPU.

One set of weights (the small transformer + hybrid of
``test_torch_port_model.py``) is saved as a JAX checkpoint and as the port's
``.pth``; the port's synthetic generator writes the data. ``export_motions``
writes the same file names from both, with values within 1e-5, on the
overlap-add path (full-raw sequences), with the reference's
normalise-at-inference, and on the single-window path (sliced data only);
the command line writes what the function does. ``MotionRetargeter``'s
``human_to_robot`` agrees within 1e-5, and so does its ``robot_fk`` (the
batched G1 kinematics) on random joint windows.
"""

import os
import shutil

import numpy as np
import pytest

from bridgerl_tpu.export.motion_export import export_motions as jax_export_motions
from bridgerl_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from bridgerl_tpu.utils.alignment import MotionRetargeter as JaxMotionRetargeter
from bridgerl_tpu.utils.alignment import load_and_align_data as jax_load_and_align
from bridgerl_tpu_torch.cli import export_motion
from bridgerl_tpu_torch.data.synthetic import generate_synthetic_dataset
from bridgerl_tpu_torch.export.motion_export import export_motions, load_model_from_checkpoint
from bridgerl_tpu_torch.train.checkpoint import save_checkpoint
from bridgerl_tpu_torch.utils.alignment import MotionRetargeter, load_and_align_data

from test_torch_port_model import jax_and_port
from test_torch_port_zoo import one_torch_thread  # noqa: F401 (fixture)

ATOL = 1e-5

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(data dir, sliced-only data dir, JAX checkpoint, port checkpoint)."""
    root = tmp_path_factory.mktemp("motion")
    exp, _, variables, texp, model = jax_and_port(attn_packing=4)
    jckpt, pckpt = str(root / "model.ckpt"), str(root / "model.pth")
    jax_save_checkpoint(jckpt, epoch=0, variables=variables, config=exp)
    save_checkpoint(pckpt, epoch=0, model=model, config=texp)
    data = str(root / "data")
    generate_synthetic_dataset(data, n_sequences=3, window=10, step=5, seed=0)
    sliced = str(root / "sliced")
    shutil.copytree(data, sliced)
    os.remove(os.path.join(sliced, "g1_train_full_raw.npy"))
    return data, sliced, jckpt, pckpt


def _files(out_dir):
    return {name: np.load(os.path.join(out_dir, name)) for name in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("data,ref_normalize", [("full", False), ("full", True),
                                                ("sliced", False)])
def test_export_motions_matches_jax(setup, tmp_path, data, ref_normalize):
    full, sliced, jckpt, pckpt = setup
    data_dir = full if data == "full" else sliced
    kw = dict(data_dir=data_dir, num_samples=2, start_idx=1, ref_normalize=ref_normalize,
              verbose=False)
    want_paths = jax_export_motions(jckpt, output_dir=str(tmp_path / "jax"), **kw)
    got_paths = export_motions(pckpt, output_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert [os.path.basename(p) for p in got_paths] == [os.path.basename(p) for p in want_paths]
    names = [os.path.basename(p) for p in got_paths]
    if data == "full":
        assert names == ["idx1_gt.npy", "recon_transformer_FullSeq_W10_idx1.npy",
                         "idx2_gt.npy", "recon_transformer_FullSeq_W10_idx2.npy"]
    else:
        assert names == ["idx1_gt.npy", "recon_transformer_W10_hybrid_idx1.npy",
                         "idx2_gt.npy", "recon_transformer_W10_hybrid_idx2.npy"]
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == np.float32, name
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=0, err_msg=name)


def test_cli_writes_what_the_function_does(setup, tmp_path):
    full, _, _, pckpt = setup
    assert export_motion.main(["--ckpt", pckpt, "--data_dir", full, "--output_dir",
                               str(tmp_path / "cli"), "--num_samples", "2",
                               "--device", "cpu"]) == 0
    export_motions(pckpt, data_dir=full, output_dir=str(tmp_path / "fn"), num_samples=2,
                   verbose=False, device="cpu")
    got, want = _files(tmp_path / "cli"), _files(tmp_path / "fn")
    assert sorted(got) == sorted(want) and len(got) == 4
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_checkpoint_without_config_is_refused(setup, tmp_path):
    import torch

    path = str(tmp_path / "bare.pth")
    torch.save(torch.load(setup[3], weights_only=True)["model_state_dict"], path)
    with pytest.raises(ValueError, match="carries no config"):
        load_model_from_checkpoint(path, device="cpu")


@pytest.mark.parametrize("with_stats", [False, True])
def test_motion_retargeter_matches_jax(setup, with_stats):
    full, _, jckpt, pckpt = setup
    data_dir = full if with_stats else None
    human = np.load(os.path.join(full, "human_train.npy"))[:6]
    ours = MotionRetargeter(pckpt, data_dir=data_dir, device="cpu")
    theirs = JaxMotionRetargeter(jckpt, data_dir=data_dir)
    assert ours.window == theirs.window == 10
    got, want = ours.human_to_robot(human), np.asarray(theirs.human_to_robot(human))
    assert got.shape == (6, 10, 29) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours.human_to_robot(human[0]), want[:1], atol=ATOL, rtol=0)
    q = np.random.default_rng(4).uniform(-1.5, 1.5, size=(3, 10, 29)).astype(np.float32)
    fk = ours.robot_fk(q)
    assert fk.shape == (3, 10, 30, 3) and fk.dtype == np.float32
    np.testing.assert_allclose(fk, np.asarray(theirs.robot_fk(q)), atol=ATOL, rtol=0)


def test_load_and_align_data_matches_jax(setup, tmp_path):
    full = setup[0]
    robot = os.path.join(full, "g1_train.npy")
    human = str(tmp_path / "human_short.npy")
    np.save(human, np.load(os.path.join(full, "human_train.npy"))[:-3])
    for a, b in zip(load_and_align_data(robot, human), jax_load_and_align(robot, human)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32
