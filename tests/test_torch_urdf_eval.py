"""URDF reading, forward kinematics, joint evaluation and the native host
library of the port, against the JAX package on the CPU.

Both packages' parser, FK and joint evaluation are float64 numpy and scipy
on the same inputs, so link transforms, joint world frames, sampled
surfaces (the same ``default_rng(0)`` draws), ``compare_joints`` errors and
joint and direction maps must agree to 1e-12.  The native host library is
held against the numpy marching-tetrahedra extractor (the same surface:
vertices and faces equal in a canonical order, as the C++ extractor numbers
vertices in another order) and against the numpy PLY reader (clouds equal).
"""

import os

import numpy as np
import pytest
import torch
from test_end_to_end import TWO_LINK_URDF
from test_eval import BIPED_GT, BIPED_PRED, COLLINEAR, TWO_LINK
from test_sim_io_urdf import TEST_URDF
from test_structure_joints_mesh import make_hinge_coordmap
from test_torch_urdf_stage import _canon

from autourdf_tpu.eval import joints_eval as j_eval
from autourdf_tpu.io import native as j_native
from autourdf_tpu.urdf import fk as j_fk
from autourdf_tpu.urdf import parser as j_parser
from autourdf_tpu_torch.eval import compare_joints, joint_error
from autourdf_tpu_torch.eval.joints_eval import _joint_ancestor_matrix
from autourdf_tpu_torch.io import native
from autourdf_tpu_torch.io.mesh_io import TriMesh, save_stl
from autourdf_tpu_torch.io.ply import read_ply, write_ply
from autourdf_tpu_torch.joints.screw import JointEstimate
from autourdf_tpu_torch.mesh import marching_tetrahedra
from autourdf_tpu_torch.structure import CoordMap
from autourdf_tpu_torch.structure.tree import LinkNode
from autourdf_tpu_torch.urdf import (
    forward_kinematics,
    joint_world_frames,
    link_points_world,
    load_urdf,
    sample_link_surfaces,
    write_urdf,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-12
TRACKED = {name: os.path.join(REPO, "data_ab5", "urdf", f"{name}_20_seg", "4_deg_20_cams.urdf")
           for name in ("wx200_5", "ur5")}
STRINGS = {"two_link": TEST_URDF, "toy_hinge": TWO_LINK_URDF, "eval_two_link": TWO_LINK,
           "collinear": COLLINEAR, "biped_gt": BIPED_GT, "biped_pred": BIPED_PRED}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor operations, and
    under pytest-xdist every worker's full thread pool contends for the same
    cores (the loop fixture ran eleven times slower in a parallel run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _written_urdf(tmp_path) -> str:
    """A URDF written by the port's own write_urdf, with box meshes."""
    cm_j = make_hinge_coordmap()
    cm = CoordMap(cm_j.matrices, cm_j.coords, cm_j.cluster_points, cm_j.cluster_labels,
                  cm_j.bbox_diag, raw_clouds=cm_j.raw_clouds)
    mesh_dir = tmp_path / "meshes"
    os.makedirs(mesh_dir, exist_ok=True)
    for i, size in ((0, 0.3), (3, 0.2)):
        box = j_parser._make_box(np.array([size, 0.1, 0.05]))
        save_stl(str(mesh_dir / f"{i:04}.stl"), TriMesh(box.vertices, box.faces))
    links = [LinkNode(id=0, cluster_idx={0, 1, 2}, parent_id=None, tree_id=0),
             LinkNode(id=3, cluster_idx={3, 4, 5}, parent_id=0, tree_id=1)]
    joint = JointEstimate(parent_link=0, child_link=3, local_axis=np.array([0.0, 0.0, 1.0]),
                          local_pos=np.array([0.01, 0.02, 0.0]),
                          global_pos=np.array([0.02, -0.01, 0.03]),
                          global_axis=np.array([0.1, -0.2, 0.97]))
    return write_urdf(links, [joint], cm, str(tmp_path / "written.urdf"),
                      mesh_dir=str(mesh_dir), robot_name="written")


@pytest.fixture(params=sorted(STRINGS) + sorted(TRACKED) + ["written"])
def urdf_path(request, tmp_path):
    if request.param in TRACKED:
        return TRACKED[request.param]
    if request.param == "written":
        return _written_urdf(tmp_path)
    p = tmp_path / f"{request.param}.urdf"
    p.write_text(STRINGS[request.param])
    return str(p)


def _configs(model, rng):
    n = len(model.movable_joints)
    return [None, np.zeros(n), rng.uniform(-1.0, 1.0, n),
            {j.name: float(v) for j, v in zip(model.movable_joints, rng.uniform(-2, 2, n))}]


def test_parser_matches_jax(urdf_path):
    for scale in (1.0, 1.7):
        a = load_urdf(urdf_path, global_scale=scale)
        b = j_parser.load_urdf(urdf_path, global_scale=scale)
        assert (a.name, a.root, list(a.links)) == (b.name, b.root, list(b.links))
        for ja, jb in zip(a.joints, b.joints, strict=True):
            assert (ja.name, ja.type, ja.parent, ja.child, ja.index) == \
                (jb.name, jb.type, jb.parent, jb.child, jb.index)
            np.testing.assert_allclose(ja.origin, jb.origin, atol=ATOL, rtol=0)
            np.testing.assert_allclose(ja.axis, jb.axis, atol=ATOL, rtol=0)
            assert (ja.lower, ja.upper) == (jb.lower, jb.upper)
        for name in a.links:
            for kind in ("visuals", "collisions"):
                ga, gb = getattr(a.links[name], kind), getattr(b.links[name], kind)
                assert len(ga) == len(gb)
                for x, y in zip(ga, gb):
                    np.testing.assert_allclose(x.origin, y.origin, atol=ATOL, rtol=0)
                    assert (x.mesh is None) == (y.mesh is None) and x.mesh_path == y.mesh_path
                    if x.mesh is not None:
                        np.testing.assert_allclose(x.mesh.vertices, y.mesh.vertices,
                                                   atol=ATOL, rtol=0)
                        np.testing.assert_array_equal(x.mesh.faces, y.mesh.faces)
        np.testing.assert_array_equal(a.joint_limits(), b.joint_limits())
    if urdf_path == TRACKED["wx200_5"]:
        # the tracked estimate's STL meshes resolve by walking up from its dir
        assert all(g.mesh is not None and len(g.mesh.faces) for link in a.links.values()
                   for g in link.visuals)


def test_fk_frames_and_surfaces_match_jax(urdf_path):
    a, b = load_urdf(urdf_path), j_parser.load_urdf(urdf_path)
    rng = np.random.default_rng(3)
    base = np.eye(4)
    base[:3, :3] = j_parser._rpy_to_matrix(np.array([0.3, -0.2, 1.1]))
    base[:3, 3] = [0.1, -0.4, 0.2]
    for q in _configs(a, rng):
        for bs in (None, base):
            wa, wb = forward_kinematics(a, q, bs), j_fk.forward_kinematics(b, q, bs)
            assert list(wa) == list(wb)
            for name in wa:
                np.testing.assert_allclose(wa[name], wb[name], atol=ATOL, rtol=0)
            fa, fb = joint_world_frames(a, q, bs), j_fk.joint_world_frames(b, q, bs)
            for x, y in zip(fa, fb, strict=True):
                assert x.name == y.name
                np.testing.assert_allclose(x.position, y.position, atol=ATOL, rtol=0)
                np.testing.assert_allclose(x.axis, y.axis, atol=ATOL, rtol=0)
    sa = sample_link_surfaces(a, total_points=3000)
    sb = j_fk.sample_link_surfaces(b, total_points=3000)
    assert list(sa) == list(sb)
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name])
    q = _configs(a, rng)[2]
    np.testing.assert_allclose(link_points_world(a, sa, q, base),
                               j_fk.link_points_world(b, sb, q, base), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# joint evaluation (the cases of tests/test_eval.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ([0, 0, 0], [0, 0, 1], [0, 0, 0], [0, 0, 1]),
    ([0, 0, 0], [0, 0, 1], [0.3, 0, 0], [0, 0, 1]),
    ([0, 0, 0], [1, 0, 0], [0, 0, 0.5], [0, 1, 0]),
    ([0, 0, 0], [0, 0, 0], [0, 0, 1], [0, 0, 1]),
    ([0.1, -0.2, 0.3], [0.2, 0.9, -0.1], [-0.4, 0.5, 0.0], [0.7, 0.1, 0.7]),
    ([0, 0, 0], [0, 0, 1], [0, 0, 1], [0, 0, -1]),
])
def test_joint_error_matches_jax(case):
    assert joint_error(*map(np.asarray, case)) == j_eval.joint_error(*map(np.asarray, case))


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


ONE_JOINT = """<?xml version="1.0"?>
<robot name="p">
  <link name="base"/><link name="arm"/>
  <joint name="only" type="revolute">
    <parent link="base"/><child link="arm"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 0 1"/>
    <limit lower="-1" upper="1" effort="1" velocity="1"/>
  </joint>
</robot>
"""


def _cases(tmp_path):
    two = _write(tmp_path, "two.urdf", TWO_LINK)
    flipped = _write(tmp_path, "f.urdf",
                     TWO_LINK.replace('<axis xyz="0 0 1"/>', '<axis xyz="0 0 -1"/>'))
    coll = _write(tmp_path, "c.urdf", COLLINEAR)
    one = _write(tmp_path, "one.urdf", ONE_JOINT)
    gt, pred = _write(tmp_path, "gt.urdf", BIPED_GT), _write(tmp_path, "pred.urdf", BIPED_PRED)
    wx = TRACKED["wx200_5"]
    return {
        "identical": dict(pred_urdf_path=two, gt_urdf_path=two, dof=2, offset=np.zeros(2)),
        "collinear": dict(pred_urdf_path=coll, gt_urdf_path=coll, dof=3, offset=np.zeros(3)),
        "flipped": dict(pred_urdf_path=flipped, gt_urdf_path=two, dof=2, offset=np.zeros(2)),
        "hand map": dict(pred_urdf_path=two, gt_urdf_path=two, dof=2, offset=np.zeros(2),
                         joint_map=np.asarray([1, 0])),
        "under-discovered": dict(pred_urdf_path=one, gt_urdf_path=two, dof=2,
                                 offset=np.zeros(2)),
        "biped": dict(pred_urdf_path=pred, gt_urdf_path=gt, dof=4, offset=np.zeros(4)),
        "wx200 vs itself, offset, orientations": dict(
            pred_urdf_path=wx, gt_urdf_path=wx, dof=5,
            offset=np.array([0.1, -0.2, 0.3, 0.0, 0.4]), sim_ori=(0.0, -0.3, 0.2),
            pred_ori=(0.1, 0.0, 0.0)),
        "ur5 against wx200": dict(pred_urdf_path=TRACKED["ur5"], gt_urdf_path=wx, dof=5,
                                  offset=np.zeros(5)),
        "wx200 against ur5, scaled": dict(pred_urdf_path=wx, gt_urdf_path=TRACKED["ur5"],
                                          dof=5, offset=np.full(5, 0.2), global_scale=1.3),
    }


CASE_NAMES = ["identical", "collinear", "flipped", "hand map", "under-discovered", "biped",
              "wx200 vs itself, offset, orientations", "ur5 against wx200",
              "wx200 against ur5, scaled"]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_compare_joints_matches_jax(tmp_path, name):
    kw = _cases(tmp_path)[name]
    a, b = compare_joints(**kw), j_eval.compare_joints(**kw)
    np.testing.assert_array_equal(np.asarray(a.joint_map), np.asarray(b.joint_map))
    assert a.direction_map == b.direction_map
    assert (a.matched, a.total) == (b.matched, b.total)
    for f in ("pos_errors", "dir_errors", "pos_errors_complete", "dir_errors_complete"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=ATOL, rtol=0, err_msg=f)
    for f in ("dir_mean_matched", "pos_mean_matched", "dir_mean_complete", "pos_mean_complete"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=ATOL, rtol=0, err_msg=f)
    if name == "biped":          # the legs are not crossed (tests/test_eval.py)
        anc = _joint_ancestor_matrix(load_urdf(kw["pred_urdf_path"], load_meshes=False))
        assert anc[a.joint_map[0], a.joint_map[1]] and anc[a.joint_map[2], a.joint_map[3]]


@pytest.mark.parametrize("name", ["biped_gt", "biped_pred", "collinear", "wx200_5", "ur5"])
def test_ancestor_matrix_matches_jax(tmp_path, name):
    path = TRACKED.get(name) or _write(tmp_path, f"{name}.urdf", STRINGS[name])
    a = _joint_ancestor_matrix(load_urdf(path, load_meshes=False))
    b = j_eval._joint_ancestor_matrix(j_parser.load_urdf(path, load_meshes=False))
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the native host library
# ---------------------------------------------------------------------------

def _volumes():
    rng = np.random.default_rng(0)
    vol = np.zeros((9, 8, 7), bool)
    vol[2:7, 2:6, 1:6] = True
    vol[4, 3, 3] = False                               # a cavity
    vol[rng.integers(0, 9, 12), rng.integers(0, 8, 12), rng.integers(0, 7, 12)] = True
    g = np.indices((17, 15, 13)).transpose(1, 2, 3, 0) - np.array([8, 7, 6])
    sphere = (g ** 2).sum(-1) <= 30
    return {"blocks": vol, "sphere": sphere, "noise": rng.random((12, 10, 11)) > 0.6,
            "single": np.pad(np.ones((1, 1, 1), bool), 2), "empty": np.zeros((4, 4, 4), bool)}


def test_native_library_builds_into_the_package():
    assert native.available(), native.build_log
    so = native.library_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == os.path.join(REPO, "autourdf_tpu_torch", "_build")


@pytest.mark.parametrize("name", sorted(_volumes()))
def test_native_marching_matches_numpy_and_jax(name, monkeypatch):
    vol = _volumes()[name]
    origin = np.array([0.1, -0.2, 0.3])
    nat = marching_tetrahedra(vol, 0.01, origin)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        ref = marching_tetrahedra(vol, 0.01, origin)
    assert len(nat.faces) == len(ref.faces) and len(nat.vertices) == len(ref.vertices)
    for a, b in zip(_canon(nat), _canon(ref)):
        np.testing.assert_array_equal(a, b)
    padded = np.pad(vol, 1)
    got = native.marching_tetrahedra_native(padded)
    if j_native.available():
        want = j_native.marching_tetrahedra_native(padded)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_native_ply_read_matches_numpy(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(1234, 3)).astype(np.float32)
    path = str(tmp_path / "c.ply")
    write_ply(path, pts)
    got = native.read_ply_native(path)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        ref = read_ply(path)
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(ref, pts)
    np.testing.assert_array_equal(read_ply(path), pts)
    colored = str(tmp_path / "rgb.ply")
    write_ply(colored, pts, colors=rng.random((1234, 3)))
    np.testing.assert_array_equal(read_ply(colored), pts)       # numpy path: rgb layout


def test_native_opt_out(tmp_path):
    """AUTOURDF_NATIVE=0 forces the numpy fallback, as in the JAX package."""
    import subprocess
    import sys

    code = ("from autourdf_tpu_torch.io import native; "
            "assert not native.available(); print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "AUTOURDF_NATIVE": "0"})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
