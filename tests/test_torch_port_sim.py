"""The port's sim layer against the JAX package's, on the CPU:

- the device half of ``data/rotations.py`` within 1e-6 (small angles,
  antipodal and nearly equal quaternions, ``scalar_first``);
- ``resample_indices`` equal, ``load_motion`` within 1e-6 with and without
  a root, down to one and zero frames;
- ``G1ReplayScene``: the step sequence and its wrap-around flags equal;
  ``step``, ``rollout``, ``rollout_full`` and ``fk_windows`` within 1e-5;
- the URDF layer: ``chain_to_urdf`` text equal, the parse and build of it
  ``chains_equal`` to JAX's, collision parsing and rows, ``matrix_to_rpy``;
- the renderer: ``skeleton_segments`` and the primitives' surface grids
  equal; ``render_frame`` writes a PNG, ``render_motion`` a GIF of the
  expected frame count;
- the live viewer: ``build_viewer_html`` equal to JAX's string (skeleton,
  volumes, meshes), and the server answers;
- the meshes: STL parsing (binary and ASCII), decimation, visual entries
  and the folded link meshes of a written URDF equal to JAX's; the vendor
  lookup gives None where nothing is found.
"""

import os
import struct
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.data import rotations as jrot
from bridgerl_tpu.sim import live as jlive
from bridgerl_tpu.sim import mesh as jmesh
from bridgerl_tpu.sim import motion as jmotion
from bridgerl_tpu.sim import render as jrender
from bridgerl_tpu.sim import replay as jreplay
from bridgerl_tpu.sim import urdf as jurdf
from bridgerl_tpu_torch.data import rotations as trot
from bridgerl_tpu_torch.sim import live, mesh, motion, render, replay, urdf

ROT_ATOL = 1e-6
FK_ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _close(got, want, atol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------- rotations ----------

def test_axis_angle_to_matrix_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.uniform(-3.0, 3.0, size=(64, 3)).astype(np.float32)
    v[:4] = 0.0
    v[4:8] *= 1e-9                                  # below the small-angle cut
    v[8:12] *= 1e-6
    _close(trot.axis_angle_to_matrix(_t(v)), jrot.axis_angle_to_matrix(jnp.asarray(v)), ROT_ATOL)


@pytest.mark.parametrize("scalar_first", [False, True])
def test_quat_to_matrix_matches_jax(scalar_first):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 7, 4)).astype(np.float32) * 3.0   # not normalised
    q[0, 0] = 0.0                                               # the zero quaternion
    _close(trot.quat_to_matrix(_t(q), scalar_first=scalar_first),
           jrot.quat_to_matrix(jnp.asarray(q), scalar_first=scalar_first), ROT_ATOL)


def test_matrix_to_6d_and_back_match_jax():
    rng = np.random.default_rng(2)
    R = np.asarray(jrot.quat_to_matrix(jnp.asarray(_quats(rng, 32))))
    _close(trot.matrix_to_6d(_t(R)), jrot.matrix_to_6d(jnp.asarray(R)), ROT_ATOL)
    d6 = rng.normal(size=(8, 3, 6)).astype(np.float32)
    _close(trot.rotation_6d_to_matrix(_t(d6)), jrot.rotation_6d_to_matrix(jnp.asarray(d6)),
           ROT_ATOL)


@pytest.mark.parametrize("case", ["random", "antipodal", "near", "equal"])
def test_quat_slerp_matches_jax(case):
    rng = np.random.default_rng(3)
    q0 = _quats(rng, 48)
    q1 = {"random": _quats(rng, 48), "antipodal": -q0, "equal": q0.copy(),
          "near": q0 + rng.normal(scale=1e-4, size=q0.shape).astype(np.float32)}[case]
    t = rng.uniform(0.0, 1.0, size=(48, 1)).astype(np.float32)
    t[:2] = [[0.0], [1.0]]
    _close(trot.quat_slerp(_t(q0), _t(q1), _t(t)),
           jrot.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)), ROT_ATOL)


# ---------- motion ----------

@pytest.mark.parametrize("frames,fps_in,fps_out", [(11, 10, 20), (400, 20, 50), (37, 30, 50),
                                                   (50, 50, 20), (2, 20, 20), (1, 20, 50)])
def test_resample_indices_equal(frames, fps_in, fps_out):
    for got, want in zip(motion.resample_indices(frames, fps_in, fps_out),
                         jmotion.resample_indices(frames, fps_in, fps_out)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _trajectory(T, seed=4, root=True):
    rng = np.random.default_rng(seed)
    dof = rng.uniform(-0.2, 0.2, size=(T, 29)).astype(np.float32)
    if not root:
        return dof, None, None
    pos = np.cumsum(rng.normal(scale=0.01, size=(T, 3)), axis=0).astype(np.float32)
    pos[:, 2] += 0.74
    ang = np.linspace(0.0, 2.5, T)                   # yaw turning past pi / 2
    rot = np.stack([np.cos(ang / 2), 0.1 * np.sin(ang / 2), 0.2 * np.sin(ang / 2),
                    np.sin(ang / 2)], -1).astype(np.float32)
    return dof, pos, rot


MOTION_FIELDS = ("dof_pos", "dof_vel", "base_pos", "base_rot", "base_lin_vel", "base_ang_vel")


@pytest.mark.parametrize("T,fps_in,fps_out,root", [(40, 20, 50, False), (40, 20, 50, True),
                                                   (33, 30, 50, True), (2, 20, 20, True),
                                                   (1, 20, 50, False)],
                         ids=["fake_root", "root", "30to50", "one_frame", "zero_frames"])
def test_load_motion_matches_jax(T, fps_in, fps_out, root):
    dof, pos, rot = _trajectory(T, root=root)
    got = motion.load_motion(dof, fps_in, fps_out, base_pos=pos, base_rot=rot, device="cpu")
    want = jmotion.load_motion(dof, fps_in, fps_out, base_pos=pos, base_rot=rot)
    assert got.num_frames == want.num_frames and got.fps == want.fps
    for name in MOTION_FIELDS:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape and g.device.type == "cpu", name
        _close(g, w, ROT_ATOL, name)


def test_load_motion_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        motion.load_motion(np.zeros((4, 29), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay.G1ReplayScene()


# ---------- replay ----------

@pytest.fixture(scope="module")
def scenes():
    dof, _, _ = _trajectory(16, seed=5)
    ts, js = replay.G1ReplayScene(device="cpu"), jreplay.G1ReplayScene()
    ts.load(dof, 20, 50)
    js.load(dof, 20, 50)
    return ts, js


def test_replay_step_sequence_and_wraparound(scenes):
    ts, js = scenes
    ts.current_idx = js.current_idx = 0
    n = ts.motion.num_frames
    assert n == js.motion.num_frames
    flags = []
    for i in range(n + 2):
        (state, wrapped), (jstate, jwrapped) = ts.get_next_state(), js.get_next_state()
        assert wrapped == jwrapped and ts.current_idx == js.current_idx
        flags.append(wrapped)
        for g, w in zip(state, jstate):
            _close(g, w, ROT_ATOL)
    assert flags.index(True) == n - 1 and flags.count(True) == 1
    ts.current_idx = js.current_idx = 3
    for g, w in zip(ts.step(), js.step()):
        _close(g, w, FK_ATOL)


def test_replay_rollouts_match_jax(scenes):
    ts, js = scenes
    _close(ts.rollout(), js.rollout(), FK_ATOL)
    for g, w in zip(ts.rollout_full(), js.rollout_full()):
        _close(g, w, FK_ATOL)
    q = np.random.default_rng(6).uniform(-1.0, 1.0, size=(3, 5, 29)).astype(np.float32)
    out = ts.fk_windows(q)
    assert tuple(out.shape) == (3, 5, 30, 3)
    _close(out, js.fk_windows(jnp.asarray(q)), FK_ATOL)


def test_benchmark_steps_per_sec_runs(scenes):
    assert scenes[0].benchmark_steps_per_sec(frames=64, warmup=1) > 0


# ---------- URDF ----------

def test_chain_to_urdf_text_equal_and_roundtrips(tmp_path):
    chain, jchain = urdf.load_g1_chain(), jurdf.load_g1_chain()
    text = urdf.chain_to_urdf(chain)
    assert text == jurdf.chain_to_urdf(jchain)
    path = tmp_path / "g1.urdf"
    path.write_text(text)
    built = urdf.load_g1_chain(str(path))
    assert urdf.chains_equal(built, chain) == []
    assert jurdf.chains_equal(built, jchain) == []
    assert built.to_json() == jurdf.build_chain(jurdf.parse_urdf_joints(str(path)),
                                                jurdf.G1_JOINT_NAMES).to_json()
    # keep_fixed and the default actuation order also agree
    for kw in ({"keep_fixed": True}, {}):
        assert (urdf.build_chain(urdf.parse_urdf_joints(str(path)), **kw).to_json()
                == jurdf.build_chain(jurdf.parse_urdf_joints(str(path)), **kw).to_json())


def test_collisions_match_jax(tmp_path):
    prims, jprims = urdf.load_g1_collisions(), jurdf.load_g1_collisions()
    assert urdf.collisions_to_rows(prims) == jurdf.collisions_to_rows(jprims)
    assert urdf.collisions_equal(prims, urdf.collisions_from_rows(
        urdf.collisions_to_rows(prims))) == []
    body = "".join(
        f'<link name="{n}"><collision><origin xyz="0.1 0 {i}" rpy="0 0.2 0"/><geometry>{g}'
        f'</geometry></collision></link>'
        for i, (n, g) in enumerate([("a", '<sphere radius="0.05"/>'),
                                    ("b", '<cylinder radius="0.03" length="0.2"/>'),
                                    ("c", '<box size="0.1 0.2 0.3"/>'),
                                    ("d", '<mesh filename="x.stl"/>')]))
    path = tmp_path / "c.urdf"
    path.write_text(f'<robot name="r">{body}<link name="e"/></robot>')
    got, want = urdf.parse_urdf_collisions(str(path)), jurdf.parse_urdf_collisions(str(path))
    assert [p.kind for p in got] == ["sphere", "cylinder", "box"]
    assert urdf.collisions_to_rows(got) == jurdf.collisions_to_rows(want)
    assert urdf.collisions_equal(got[:2], got) == ["count 2 != 3"]


def test_matrix_to_rpy_equal():
    rng = np.random.default_rng(7)
    mats = [urdf.rpy_to_matrix(r) for r in rng.uniform(-3.0, 3.0, size=(20, 3))]
    mats += [urdf.rpy_to_matrix([0.3, np.pi / 2, 0.0]), urdf.rpy_to_matrix([0.1, -np.pi / 2, 1.0])]
    for R in mats:
        assert urdf.matrix_to_rpy(R) == jurdf.matrix_to_rpy(R)
        np.testing.assert_allclose(urdf.rpy_to_matrix(urdf.matrix_to_rpy(R)), R, atol=1e-5)


def test_vendor_urdf_matches_bundled_spec():
    """Runs only where a vendor main.urdf is present, as the JAX test does."""
    cand = os.environ.get("G1_URDF_PATH", "assets/g1_local/urdf/g1/main.urdf")
    if not os.path.exists(cand):
        pytest.skip(f"no vendor URDF at {cand}")
    assert urdf.chains_equal(urdf.load_g1_chain(), urdf.load_g1_chain(cand)) == []


# ---------- render ----------

def test_skeleton_segments_and_grids_equal():
    chain = urdf.load_g1_chain()
    pos = np.random.default_rng(8).normal(size=(30, 3)).astype(np.float32)
    assert np.array_equal(render.skeleton_segments(chain, _t(pos)),
                          jrender.skeleton_segments(jurdf.load_g1_chain(), pos))
    prims = urdf.load_g1_collisions() + [urdf.CollisionPrim("pelvis", "box", [0.1, 0.2, 0.3],
                                                            [0, 0, 0], [0, 0, 0])]
    assert {p.kind for p in prims} == {"sphere", "cylinder", "box"}
    for p in prims:
        jp = jurdf.CollisionPrim(p.link, p.kind, p.size, p.origin_pos, p.origin_rpy)
        assert np.array_equal(render._prim_local_grid(p), jrender._prim_local_grid(jp))
    with pytest.raises(ValueError):
        render._prim_local_grid(urdf.CollisionPrim("pelvis", "cone", [1.0], [0] * 3, [0] * 3))


def test_render_frame_and_motion(tmp_path):
    import imageio.v2 as imageio

    scene = replay.G1ReplayScene(device="cpu")
    scene.load(_trajectory(8, seed=9, root=False)[0], 20, 20)
    traj, rots = scene.rollout_full()
    png = render.render_frame(scene.chain, traj[0], str(tmp_path / "frame.png"))
    vol = render.render_frame(scene.chain, traj[0], str(tmp_path / "vol.png"), rotations=rots[0],
                              collisions=urdf.load_g1_collisions())
    ink = [(imageio.imread(p)[..., :3] < 250).any(-1).sum() for p in (png, vol)]
    assert 0 < ink[0] < ink[1]              # the volumes cover more than the lines
    assert scene.motion.num_frames == 7
    gif = render.render_motion(scene.chain, traj, str(tmp_path / "m.gif"), max_frames=3)
    assert len(imageio.mimread(gif)) == 4   # 7 frames at stride 7 // 3
    gif = render.render_scene(scene, str(tmp_path / "v.gif"), 10, volumetric=True, max_frames=2)
    assert len(imageio.mimread(gif)) == 3   # at stride 7 // 2


# ---------- live viewer ----------

def test_viewer_html_equal_to_jax():
    chain, jchain = urdf.load_g1_chain(), jurdf.load_g1_chain()
    q = np.random.default_rng(10).uniform(-0.3, 0.3, size=(4, 29)).astype(np.float32)
    pos = live.motion_to_frames(chain, q)
    assert np.array_equal(pos, jlive.motion_to_frames(jchain, q))
    assert live.build_viewer_html(chain, pos, fps=20.0, title="t") == \
        jlive.build_viewer_html(jchain, pos, fps=20.0, title="t")
    prims, jprims = urdf.load_g1_collisions(), jurdf.load_g1_collisions()
    vols = live.motion_to_volumes(chain, q, prims)
    assert np.array_equal(vols, jlive.motion_to_volumes(jchain, q, jprims))
    assert live.build_viewer_html(chain, pos, volumes=vols) == \
        jlive.build_viewer_html(jchain, pos, volumes=vols)
    ppos, prot = live.motion_to_poses(chain, q)
    for g, w in zip((ppos, prot), jlive.motion_to_poses(jchain, q)):
        assert np.array_equal(g, w)
    tris = np.random.default_rng(11).normal(size=(300, 3, 3)).astype(np.float32)
    meshes = [mesh.LinkMesh("pelvis", tris, (0.5, 0.5, 0.5)),
              mesh.LinkMesh("off_chain", tris[:10], (1.0, 0.0, 0.0))]
    jmeshes = [jmesh.LinkMesh(m.link, m.tris, m.color) for m in meshes]
    payload = live.meshes_payload(chain, meshes, total_budget=120)
    assert payload == jlive.meshes_payload(jchain, jmeshes, total_budget=120)
    assert live.build_viewer_html(chain, ppos, meshes=payload, rotations=prot) == \
        jlive.build_viewer_html(jchain, ppos, meshes=payload, rotations=prot)
    with pytest.raises(ValueError, match="zero frames"):
        live.build_viewer_html(chain, np.zeros((0, 30, 3), np.float32))
    with pytest.raises(ValueError, match="rotations"):
        live.build_viewer_html(chain, ppos, meshes=payload)


def test_viewer_server_answers():
    html = live.build_viewer_html(urdf.load_g1_chain(), np.zeros((2, 30, 3), np.float32))
    port = 8747
    t = threading.Thread(target=live.serve_viewer, args=(html, port, 8), daemon=True)
    t.start()
    deadline, body = time.time() + 20, b""
    while body != html.encode():
        try:
            body = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
        except (urllib.error.URLError, ConnectionError, TimeoutError):
            pass
        if body != html.encode():
            assert time.time() < deadline, f"the viewer never served the page ({len(body)} B)"
            time.sleep(0.05)


# ---------- meshes ----------

def _write_binary_stl(path, tris):
    with open(path, "wb") as f:
        f.write(b"solid fake".ljust(80))         # vendor files say 'solid' in binary too
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(np.zeros(3, "<f4").tobytes() + t.astype("<f4").tobytes())
            f.write(struct.pack("<H", 0))


def _write_ascii_stl(path, tris):
    lines = ["solid a"]
    for t in tris:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {v[0]!r} {v[1]!r} {v[2]!r}" for v in t.tolist()]
        lines += ["endloop", "endfacet"]
    path.write_text("\n".join(lines + ["endsolid a"]))


def test_stl_parsing_and_decimation_equal(tmp_path):
    tris = np.random.default_rng(12).normal(size=(500, 3, 3)).astype(np.float32)
    _write_binary_stl(tmp_path / "b.stl", tris)
    _write_ascii_stl(tmp_path / "a.stl", tris[:40])
    for name, want in (("b.stl", tris), ("a.stl", tris[:40])):
        got = mesh.load_stl(str(tmp_path / name))
        assert np.array_equal(got, want) and np.array_equal(got, jmesh.load_stl(str(tmp_path / name)))
    for budget in (20, 200, 1000):
        dec = mesh.decimate(tris, budget)
        assert dec.shape[0] <= budget and np.array_equal(dec, jmesh.decimate(tris, budget))


def test_link_meshes_of_a_written_urdf_equal(tmp_path):
    rng = np.random.default_rng(13)
    for i, n in enumerate((300, 40, 60)):
        _write_binary_stl(tmp_path / f"m{i}.stl", rng.normal(scale=0.05, size=(n, 3, 3)))
    # a visual on a chain link, one on a fixed child of it, one on a dangling link
    robot = (
        '<robot name="r">'
        '<link name="pelvis"><visual><origin xyz="0 0 0.1" rpy="0 0 0.3"/><geometry>'
        '<mesh filename="m0.stl"/></geometry><material name="g"><color rgba="0.2 0.3 0.4 1"/>'
        '</material></visual></link>'
        '<link name="logo"><visual><geometry><mesh filename="m1.stl"/></geometry></visual></link>'
        '<link name="loose"><visual><geometry><mesh filename="m2.stl"/></geometry></visual></link>'
        '<link name="nomesh"><visual><geometry><box size="1 1 1"/></geometry></visual></link>'
        '<joint name="logo_joint" type="fixed"><origin xyz="0.1 0 0" rpy="0.5 0 0"/>'
        '<parent link="pelvis"/><child link="logo"/></joint></robot>')
    path = str(tmp_path / "main.urdf")
    with open(path, "w") as f:
        f.write(robot)
    entries = mesh.parse_urdf_visual_entries(path)
    assert entries == jmesh.parse_urdf_visual_entries(path) and len(entries) == 3
    got = mesh.load_link_meshes(urdf.load_g1_chain(), path, total_budget=200)
    want = jmesh.load_link_meshes(jurdf.load_g1_chain(), path, total_budget=200)
    assert [(m.link, m.color) for m in got] == [(m.link, m.color) for m in want]
    assert [m.link for m in got] == ["pelvis", "pelvis"]
    for g, w in zip(got, want):
        assert np.array_equal(g.tris, w.tris)


def test_vendor_lookup_gives_none_where_absent(monkeypatch, tmp_path):
    monkeypatch.delenv("BRIDGERL_G1_URDF", raising=False)
    monkeypatch.setattr(mesh, "VENDOR_URDF_CANDIDATES", (str(tmp_path / "none.urdf"),))
    assert mesh.find_vendor_urdf() is None
    assert mesh.load_link_meshes(urdf.load_g1_chain(), None) is None
    monkeypatch.setenv("BRIDGERL_G1_URDF", str(tmp_path / "also_none.urdf"))
    assert mesh.find_vendor_urdf() is None
    assert mesh.load_g1_meshes(urdf.load_g1_chain(), total_budget=123) is None
