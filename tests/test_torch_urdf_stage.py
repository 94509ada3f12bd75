"""The port's ``urdf`` stage against the JAX package on the CPU: meshing,
the URDF writer, and the slice as a whole.

Whole slice: a small synthetic hinge is registered by the JAX package's
``run_registration``; its ``part/`` artifacts and raw clouds then go through
``run_build_urdf`` of both packages, each on its own copy of the data root:
with the defaults (the chain fit, short; the motion tree; with the unknown
DoF the probe ladder, short) and with ``refine="none", tree="mst"``.  Everything after the registration is float64
numpy in both packages except the carry test's search, the link ICP and the
screw decomposition (fp32): link count and tree must be equal, joint axes
and origins agree to 1e-4 (the link ICP's tolerance does not reach them;
they come from the fp32 screws), XML numbers to 1e-6 where they do not
depend on the meshes.

Meshes are compared in a canonical order (vertices sorted, faces rotated
and sorted), because the JAX package may extract the isosurface with its
host C++ library, which numbers vertices differently from the numpy
extractor that the port carries.
"""

import os
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from test_structure_joints_mesh import make_hinge_coordmap, make_wrist_trap_chain

from autourdf_tpu import config as jconfig
from autourdf_tpu import workflow as jworkflow
from autourdf_tpu.joints.screw import JointEstimate as JJointEstimate
from autourdf_tpu.mesh import cloud_to_mesh as j_cloud_to_mesh
from autourdf_tpu.mesh import marching_tetrahedra as j_marching
from autourdf_tpu.structure.tree import LinkNode as JLinkNode
from autourdf_tpu.urdf.writer import write_urdf as j_write_urdf
from autourdf_tpu_torch import config as tconfig
from autourdf_tpu_torch import workflow as tworkflow
from autourdf_tpu_torch.io.artifacts import save_registration
from autourdf_tpu_torch.io.mesh_io import load_stl, sample_surface, save_stl
from autourdf_tpu_torch.io.ply import write_ply
from autourdf_tpu_torch.joints.screw import JointEstimate
from autourdf_tpu_torch.mesh import (
    cloud_to_mesh,
    generate_link_meshes,
    is_watertight,
    marching_tetrahedra,
)
from autourdf_tpu_torch.structure import CoordMap
from autourdf_tpu_torch.structure.tree import LinkNode
from autourdf_tpu_torch.urdf.writer import write_urdf


def _canon(mesh):
    """Vertices sorted lexicographically, faces renumbered, rotated to start
    at their smallest vertex (orientation kept) and sorted."""
    v = np.asarray(mesh.vertices)
    order = np.lexsort(np.round(v, 6).T[::-1])
    rank = np.empty(len(v), int)
    rank[order] = np.arange(len(v))
    f = rank[np.asarray(mesh.faces)]
    shift = np.argmin(f, axis=1)
    f = np.stack([np.roll(row, -s) for row, s in zip(f, shift)]) if len(f) else f
    return v[order], f[np.lexsort(f.T[::-1])] if len(f) else f


def _volume(seed=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros((9, 8, 7), bool)
    vol[2:7, 2:6, 1:6] = True
    vol[4, 3, 3] = False                               # a cavity
    vol[rng.integers(0, 9, 12), rng.integers(0, 8, 12), rng.integers(0, 7, 12)] = True
    return vol


# ---------------------------------------------------------------------------
# meshing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_marching_tetrahedra_matches_jax(seed):
    vol = _volume(seed)
    origin = np.array([0.1, -0.2, 0.3])
    mt = marching_tetrahedra(vol, 0.05, origin)
    mj = j_marching(vol, 0.05, origin)
    assert is_watertight(mt) and len(mt.faces) > 100
    (vt, ft), (vj, fj) = _canon(mt), _canon(mj)
    np.testing.assert_allclose(vt, vj, atol=1e-12)
    np.testing.assert_array_equal(ft, fj)
    empty = marching_tetrahedra(np.zeros((3, 3, 3), bool))
    assert len(empty.faces) == 0 and len(empty.vertices) == 0


def test_cloud_to_mesh_matches_jax_and_is_watertight():
    rng = np.random.default_rng(2)
    cloud = rng.uniform([-0.2, -0.1, -0.05], [0.2, 0.1, 0.05], size=(3000, 3))
    cloud = np.concatenate([cloud, [[1.5, 1.5, 1.5]]])          # one outlier, removed
    mt = cloud_to_mesh(cloud, 0.02)
    mj = j_cloud_to_mesh(cloud, 0.02)
    assert is_watertight(mt)
    assert np.abs(mt.vertices).max() < 0.4
    (vt, ft), (vj, fj) = _canon(mt), _canon(mj)
    # projection and smoothing sum neighbours in vertex order: round-off only
    np.testing.assert_allclose(vt, vj, atol=1e-9)
    np.testing.assert_array_equal(ft, fj)


def test_generate_link_meshes_and_stl_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    clouds = [rng.uniform(-0.1, 0.1, size=(1500, 3)), rng.uniform(0.0, 0.3, size=(2000, 3))]
    paths = generate_link_meshes(clouds, str(tmp_path / "m"), 0.03)
    assert [os.path.basename(p) for p in paths] == ["0000.stl", "0001.stl"]
    mesh = load_stl(paths[1])
    assert is_watertight(cloud_to_mesh(clouds[1], 0.03)) and len(mesh.faces) > 50
    save_stl(str(tmp_path / "again.stl"), mesh)
    again = load_stl(str(tmp_path / "again.stl"))
    np.testing.assert_allclose(again.vertices[again.faces], mesh.vertices[mesh.faces], atol=1e-7)
    pts = sample_surface(mesh, 500, np.random.default_rng(0))
    assert pts.shape == (500, 3) and pts.min() > -0.05 and pts.max() < 0.35


# ---------------------------------------------------------------------------
# URDF writer
# ---------------------------------------------------------------------------

def _urdf_numbers(path):
    """{(tag path, attribute): floats} of every numeric attribute, plus names."""
    root = ET.parse(path).getroot()
    out, names = {}, []
    for el in root.iter():
        if el.tag in ("link", "joint"):
            names.append((el.tag, el.get("name"), el.get("type")))
    for kind in ("link", "joint"):
        for el in root.findall(kind):
            for sub in el.iter():
                for key, val in sub.attrib.items():
                    try:
                        nums = [float(v) for v in val.split()]
                    except ValueError:
                        names.append((el.get("name"), sub.tag, key, os.path.basename(val)))
                        continue
                    out[(el.get("name"), sub.tag, key)] = out.get(
                        (el.get("name"), sub.tag, key), []) + nums
    return root.get("name"), names, out


def test_write_urdf_same_xml_as_jax(tmp_path):
    cm_j = make_hinge_coordmap()
    cm_t = CoordMap(cm_j.matrices, cm_j.coords, cm_j.cluster_points, cm_j.cluster_labels,
                    cm_j.bbox_diag, raw_clouds=cm_j.raw_clouds)
    fields = dict(parent_link=0, child_link=3, local_axis=np.array([0.0, 0.0, 1.0]),
                  local_pos=np.array([0.01, 0.02, 0.0]),
                  global_pos=np.array([0.02, -0.01, 0.03]),
                  global_axis=np.array([0.1, -0.2, 0.97]))
    mk = lambda cls: [cls(id=0, cluster_idx={0, 1, 2}, parent_id=None, tree_id=0),
                      cls(id=3, cluster_idx={3, 4, 5}, parent_id=0, tree_id=1)]
    pj = j_write_urdf(mk(JLinkNode), [JJointEstimate(**fields)], cm_j, str(tmp_path / "j.urdf"),
                      mesh_dir="meshes", robot_name="toy")
    pt = write_urdf(mk(LinkNode), [JointEstimate(**fields)], cm_t, str(tmp_path / "t.urdf"),
                    mesh_dir="meshes", robot_name="toy")
    nj, tj, numj = _urdf_numbers(pj)
    nt, tt, numt = _urdf_numbers(pt)
    assert nt == nj == "toy" and tt == tj
    assert ("joint", "joint_3", "revolute") in tt and ("link", "link_3", None) in tt
    assert numt.keys() == numj.keys()
    for key in numj:
        np.testing.assert_allclose(numt[key], numj[key], atol=1e-6, err_msg=str(key))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _register_robot(name, num_seg, dof, voxel):
    for mod in (jconfig, tconfig):
        mod.ROBOTS[name] = mod.RobotConfig(name=name, num_seg=num_seg, dof=dof,
                                           gt_urdf="none.urdf", voxel_size=voxel)


def _hinge_cloud_frames(num_frames, step, n=300, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform([-0.6, -0.15, -0.1], [-0.1, 0.15, 0.1], size=(n, 3))
    arm0 = rng.uniform([0.1, -0.1, -0.08], [0.7, 0.1, 0.08], size=(n, 3))
    out = []
    for t in range(num_frames):
        a = t * step
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        out.append(np.concatenate([base, arm0 @ rot.T]).astype(np.float32))
    return out


# chain steps of the default builds (the JAX default is 1,200)
SLICE_STEPS = 20


@pytest.fixture(scope="module")
def hinge_slice(tmp_path_factory):
    """A hinge registered by the JAX package, then built into a URDF by both."""
    _register_robot("toy_hinge_slice", 6, 1, 0.03)
    root = tmp_path_factory.mktemp("slice")
    kw = dict(robot="toy_hinge_slice", num_step=5, num_videos=2, epochs=60, end_steps=5,
              step_size_deg=8)
    cfg_j = jconfig.PipelineConfig(data_root=str(root / "data_j"), **kw)
    for s, step in enumerate((0.14, 0.2)):
        for t, cloud in enumerate(_hinge_cloud_frames(5, step, seed=s)):
            write_ply(os.path.join(cfg_j.raw_dir(), f"V{s:04}", f"{t:04}", "robot.ply"), cloud)
    jworkflow.run_registration(cfg_j, chamfer_backend="xla", verbose=False)
    shutil.copytree(root / "data_j", root / "data_t")
    cfg_t = tconfig.PipelineConfig(data_root=str(root / "data_t"), **kw)
    parity = dict(refine="none", tree="mst")
    out = {}
    # the default builds first: the last build's files stay on disk
    for label, extra in (("default known", dict(unknown_dof=False, refine_steps=SLICE_STEPS)),
                         ("default unknown", dict(unknown_dof=True, refine_steps=SLICE_STEPS,
                                                  dof_probe_steps=6, dof_probe_points=32)),
                         ("known", dict(unknown_dof=False, **parity)),
                         ("unknown", dict(unknown_dof=True, dof_probe=False, **parity))):
        build = dict(end_video=2, verbose=False, **extra)
        out[label] = (jworkflow.run_build_urdf(cfg_j, **build),
                      tworkflow.run_build_urdf(cfg_t, device="cpu", **build))
    return cfg_j, cfg_t, out


@pytest.mark.parametrize("label", ["known", "unknown", "default known", "default unknown"])
def test_urdf_slice_structure_and_joints_match_jax(hinge_slice, label):
    _, _, out = hinge_slice
    oj, ot = out[label]
    assert ot["num_links"] == oj["num_links"] and ot["dof"] == oj["dof"]
    assert set(ot) == set(oj)
    facts = lambda ls: sorted((l.id, l.parent_id, l.tree_id, tuple(sorted(l.cluster_idx)))
                              for l in ls)
    assert facts(ot["links"]) == facts(oj["links"])
    assert len(ot["joints"]) == len(oj["joints"]) == ot["num_links"] - 1
    for a, b in zip(ot["joints"], oj["joints"]):
        assert (a.parent_link, a.child_link) == (b.parent_link, b.child_link)
        for f in ("global_axis", "global_pos", "local_axis", "local_pos"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-4, err_msg=f)
    if label in ("known", "default known"):
        assert ot["num_links"] == 2 and abs(abs(ot["joints"][0].global_axis[2]) - 1) < 0.05


def test_urdf_slice_files_match_jax(hinge_slice):
    cfg_j, cfg_t, out = hinge_slice
    oj, ot = out["unknown"]                       # the last build: its files are on disk
    nj, tj, numj = _urdf_numbers(oj["urdf_path"])
    nt, tt, numt = _urdf_numbers(ot["urdf_path"])
    assert nt == nj == "estimated_toy_hinge_slice" and tt == tj
    for key in numj:
        np.testing.assert_allclose(numt[key], numj[key], atol=1e-4, err_msg=str(key))
    link_dir = os.path.dirname(ot["mesh_paths"][0])
    for sub in ("matrix", "cluster", "cluster_wf", "cluster_rf"):
        assert len(os.listdir(os.path.join(link_dir, sub))) == 5
    assert len(ot["mesh_paths"]) == ot["num_links"]
    for pj, pt in zip(oj["mesh_paths"], ot["mesh_paths"]):
        mj, mt = load_stl(pj), load_stl(pt)
        assert os.path.basename(pj) == os.path.basename(pt) and len(mt.faces) > 20
        # the link ICP moves the canonical clouds by up to 1e-4, which can
        # flip a voxel: compare the surfaces, not the triangles
        assert abs(len(mt.faces) - len(mj.faces)) <= 0.05 * len(mj.faces)
        np.testing.assert_allclose(mt.vertices.min(0), mj.vertices.min(0), atol=0.03)
        np.testing.assert_allclose(mt.vertices.max(0), mj.vertices.max(0), atol=0.03)
    score = os.path.join(cfg_t.part_dir(), "V0000", "score", "silhouette_score.txt")
    assert "Number of Links" in open(score).read()


def _write_fixture_dataset(cfg, cms):
    """``part/`` artifacts and raw clouds of analytic CoordMaps, in the
    simulated layout."""
    for s, cm in enumerate(cms):
        save_registration(os.path.join(cfg.part_dir(), f"V{s:04}"), np.asarray(cm.matrices),
                          cm.cluster_points, cm.cluster_labels)
        for t, cloud in enumerate(cm.raw_clouds):
            write_ply(os.path.join(cfg.raw_dir(), f"V{s:04}", f"{t:04}", "robot.ply"),
                      np.asarray(cloud, np.float32))


def test_unported_urdf_options_raise_naming_their_roadmap_item(tmp_path):
    """The options that raised NotImplementedError until the chain fit was
    ported (the default ``refine="chain"``, the DoF probe ladder, the tree
    arbitration) now run; an unknown ``refine`` still raises ValueError.

    On the wrist trap the motion tree and the proximity MST disagree.  The
    arbitration (``_select_tree_by_chain_fit``) picks the same tree in both
    packages from per-candidate probe losses equal to 1e-5 relative (8 probe
    steps here; the stage runs 100, where the two packages' fits on this
    input part beyond that: ROADMAP.md Queue 3), and the port's default
    build runs it end to end.  The trap carries registration error (see
    test_torch_chain.jittered)."""
    import autourdf_tpu.joints.chain as jchain
    import autourdf_tpu_torch.joints.chain as tchain
    from autourdf_tpu.structure import cluster_mst as j_mst
    from autourdf_tpu.structure import kinematics_tree as j_tree
    from autourdf_tpu.structure import motion_tree as j_motion
    from test_torch_chain import jittered, port_links
    from test_torch_structure import coord_map_from_jax

    _register_robot("toy_trap", 7, 3, 0.03)
    _register_robot("toy_hinge_fix", 6, 1, 0.03)
    cms = [jittered(make_wrist_trap_chain(seed=s), seed=s) for s in (0, 1)]
    trap = tconfig.PipelineConfig(robot="toy_trap", data_root=str(tmp_path / "trap"),
                                  num_videos=2, end_steps=8)
    _write_fixture_dataset(trap, cms)
    base = dict(unknown_dof=False, end_video=2, verbose=False, device="cpu")
    with pytest.raises(ValueError):
        tworkflow.run_build_urdf(trap, refine="polish", **base)

    groups = [{0, 1}, {2, 3}, {4}, {5, 6}]
    cand_j = {"motion": j_motion(cms, groups, 8), "proximity-mst": j_tree(cms[0], groups,
                                                                          j_mst(cms[0]))}
    assert ({frozenset((l.id, l.parent_id)) for l in cand_j["motion"] if l.parent_id is not None}
            != {frozenset((l.id, l.parent_id)) for l in cand_j["proximity-mst"]
                if l.parent_id is not None})
    frames = np.stack([np.stack(cm.raw_clouds) for cm in cms]).astype(np.float32)
    losses = {}
    picks = {}
    for label, mod, chain, cand, maps in (
            ("j", jworkflow, jchain, cand_j, cms),
            ("t", tworkflow, tchain, {k: port_links(v) for k, v in cand_j.items()},
             [coord_map_from_jax(c) for c in cms])):
        inner, out = chain.refine_chain, []

        def recording(*a, **k):
            refined, res = inner(*a, **k)
            out.append(float(res.loss))
            return refined, res

        chain.refine_chain = recording
        try:
            kw = {} if label == "j" else dict(device="cpu")
            picks[label] = mod._select_tree_by_chain_fit(cand, maps, frames, None, 8, False,
                                                         probe_steps=8, **kw)
        finally:
            chain.refine_chain = inner
        losses[label] = out
    facts = lambda ls: sorted((l.id, l.parent_id, tuple(sorted(l.cluster_idx))) for l in ls)
    assert facts(picks["t"]) == facts(picks["j"])
    assert len(losses["t"]) == 2
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=1e-5)

    # the default build (chain fit, short; motion tree, arbitrated)
    out = tworkflow.run_build_urdf(trap, refine_steps=10, **base)
    assert out["num_links"] >= 2 and len(out["joints"]) == out["num_links"] - 1
    assert all(abs(np.linalg.norm(j.global_axis) - 1.0) < 1e-6 for j in out["joints"])
    mst = tworkflow.run_build_urdf(trap, refine="none", tree="mst", **base)
    assert mst["num_links"] == 4 and len(mst["joints"]) == 3

    # on the hinge the two trees agree, so tree="motion" equals tree="mst"
    hinge = tconfig.PipelineConfig(robot="toy_hinge_fix", data_root=str(tmp_path / "hinge"),
                                   num_videos=2, end_steps=8)
    _write_fixture_dataset(hinge, [make_hinge_coordmap(seed=s) for s in (0, 1)])
    a = tworkflow.run_build_urdf(hinge, refine="none", tree="motion", **base)
    b = tworkflow.run_build_urdf(hinge, refine="none", tree="mst", **base)
    assert a["num_links"] == b["num_links"] == 2
    np.testing.assert_allclose(a["joints"][0].global_axis, b["joints"][0].global_axis, atol=1e-9)
    assert abs(abs(a["joints"][0].global_axis[2]) - 1.0) < 1e-3


def test_cli_urdf_on_cpu(tmp_path, capsys):
    import json

    from autourdf_tpu_torch import cli

    _register_robot("toy_hinge_cli", 6, 1, 0.03)
    cfg = tconfig.PipelineConfig(robot="toy_hinge_cli", data_root=str(tmp_path / "d"),
                                 num_videos=2, end_steps=8)
    _write_fixture_dataset(cfg, [make_hinge_coordmap(seed=s) for s in (0, 1)])
    rc = cli.main(["urdf", "--robot", "toy_hinge_cli", "--data-root", str(tmp_path / "d"),
                   "--end-steps", "8", "--end-video", "2", "--refine", "none", "--tree", "mst",
                   "--unknown-dof", "--no-dof-probe", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["links"] == 2 and out["dof"] == 1 and os.path.exists(out["urdf"])
    root = ET.parse(out["urdf"]).getroot()
    assert len(root.findall("link")) == 2 and len(root.findall("joint")) == 1
    axis = np.array([float(v) for v in root.find("joint/axis").get("xyz").split()])
    assert abs(np.linalg.norm(axis) - 1.0) < 1e-9


def test_cli_urdf_defaults_on_cpu(tmp_path, capsys):
    """``cli urdf`` with the JAX CLI's defaults (chain fit, motion tree, and
    with ``--unknown-dof`` the probe ladder at its 60 steps); the chain fit
    cut to 10 steps."""
    import json

    from autourdf_tpu_torch import cli

    _register_robot("toy_hinge_cli_defaults", 6, 1, 0.03)
    cfg = tconfig.PipelineConfig(robot="toy_hinge_cli_defaults", data_root=str(tmp_path / "d"),
                                 num_videos=2, end_steps=8)
    _write_fixture_dataset(cfg, [make_hinge_coordmap(seed=s) for s in (0, 1)])
    for extra in ([], ["--unknown-dof"]):
        rc = cli.main(["urdf", "--robot", "toy_hinge_cli_defaults", "--data-root",
                       str(tmp_path / "d"), "--end-steps", "8", "--end-video", "2",
                       "--refine-steps", "10", "--device", "cpu", *extra])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and out["links"] == 2 and out["dof"] == 1 and os.path.exists(out["urdf"])
        axis = np.array([float(v) for v in
                         ET.parse(out["urdf"]).getroot().find("joint/axis").get("xyz").split()])
        assert abs(np.linalg.norm(axis) - 1.0) < 1e-9 and abs(abs(axis[2]) - 1.0) < 0.05
