"""Parity of the port's structure and joint stages
(autourdf_tpu_torch.structure / .joints / urdf.writer.jet) with the JAX
package on the CPU.

Both packages start from the same object: the JAX package's synthetic
fixtures (a 2-link hinge, the 4-link "wrist trap" chain, a drifting rigid
shell) are built once and their fields handed to the port's ``CoordMap``
by ``coord_map_from_jax``.  Everything here is float64 numpy on both
sides except the quaternion conversion, the nearest-neighbour search of the
carry test and the link ICP (fp32, on tensors); tolerances stand beside
the assertions.  The silhouette is also held against scikit-learn's and the
jet ramp against matplotlib's.
"""

import matplotlib
import networkx as nx
import numpy as np
import pytest
from sklearn.metrics import silhouette_score as sk_silhouette
from test_structure_joints_mesh import (
    make_drift_coordmap,
    make_hinge_coordmap,
    make_wrist_trap_chain,
)

from autourdf_tpu import joints as jjoints
from autourdf_tpu import structure as jst
from autourdf_tpu.structure.tree import LinkNode as JLinkNode
from autourdf_tpu_torch import joints as tjoints
from autourdf_tpu_torch import structure as tst
from autourdf_tpu_torch.structure.tree import LinkNode, minimum_spanning_edges
from autourdf_tpu_torch.urdf.writer import jet

FIXTURES = {
    "hinge": lambda seed=0: make_hinge_coordmap(seed=seed),
    "hinge_x": lambda seed=0: make_hinge_coordmap(num_frames=10, angle_step=0.1, axis=(1, 0, 0),
                                                  pivot=(0.1, 0.0, 0.05), seed=seed),
    "wrist_trap": lambda seed=0: make_wrist_trap_chain(seed=seed),
    "drift": lambda seed=0: make_drift_coordmap(seed=seed),
}
TRUE_GROUPS = {
    "hinge": [{0, 1, 2}, {3, 4, 5}], "hinge_x": [{0, 1, 2}, {3, 4, 5}],
    "wrist_trap": [{0, 1}, {2, 3}, {4}, {5, 6}], "drift": [{0, 1, 2}, {3, 4, 5}],
}


def coord_map_from_jax(cm) -> tst.CoordMap:
    """The port's CoordMap rebuilt from the fields of a JAX-package one."""
    return tst.CoordMap(np.array(cm.matrices), np.array(cm.coords), list(cm.cluster_points),
                        list(cm.cluster_labels), cm.bbox_diag,
                        raw_clouds=None if cm.raw_clouds is None else list(cm.raw_clouds))


def both(name, seeds=(0,)):
    cms_j = [FIXTURES[name](seed=s) for s in seeds]
    return cms_j, [coord_map_from_jax(c) for c in cms_j]


def _groups_equal(a, b):
    return sorted(map(sorted, a)) == sorted(map(sorted, b))


def _tree_facts(links):
    return sorted((l.id, l.parent_id, l.tree_id, tuple(sorted(l.cluster_idx)),
                   tuple(sorted(l.connected_links))) for l in links)


# ---------------------------------------------------------------------------
# CoordMap and the maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FIXTURES))
def test_coordmap_from_arrays_fields(name):
    (cj,), _ = both(name)
    ct = tst.CoordMap.from_arrays(cj.matrices, cj.cluster_points, cj.cluster_labels,
                                  cj.raw_clouds)
    # xyz exact; the quaternion goes through fp32 matrix_to_quat in both
    np.testing.assert_array_equal(ct.coords[..., :3], cj.coords[..., :3])
    np.testing.assert_allclose(ct.coords[..., 3:], cj.coords[..., 3:], atol=1e-6)
    assert ct.bbox_diag == cj.bbox_diag and ct.num_coords == cj.num_coords
    assert ct.scale == pytest.approx(cj.scale, abs=1e-12)
    np.testing.assert_array_equal(ct.summed_center_distance_matrix(),
                                  cj.summed_center_distance_matrix())


@pytest.mark.parametrize("mode", ["pose", "diff", "legacy", "rigid"])
@pytest.mark.parametrize("name", ["hinge", "wrist_trap"])
def test_dist_map_and_combined_sum_map(name, mode):
    cms_j, cms_t = both(name, seeds=(0, 1))
    sj, mj = cms_j[0].dist_map(mode)
    st_, mt = cms_t[0].dist_map(mode)
    np.testing.assert_allclose(st_, sj, atol=1e-12)       # the same numpy on the same fields
    np.testing.assert_allclose(mt, mj, atol=1e-12)
    np.testing.assert_allclose(tst.combined_sum_map(cms_t, mode), jst.combined_sum_map(cms_j, mode),
                               atol=1e-12)
    with pytest.raises(ValueError):
        cms_t[0].dist_map("nope")


@pytest.mark.parametrize("name", ["hinge", "wrist_trap", "drift"])
def test_carry_stack_matches_jax(name):
    """The carry test: K*K*P carried points against each frame's cloud
    through the nearest-neighbour search (norm 2), all frames of a sequence
    in one batched search here, one per frame in the JAX package.  The
    host draws (subsampling) are the same calls in the same order; the
    fp32 distances agree to 1e-6."""
    cms_j, cms_t = both(name, seeds=(0, 1))
    sj = jst.swap_consistency_stack(cms_j)
    st_ = tst.swap_consistency_stack(cms_t, device="cpu")
    assert st_.shape == sj.shape == (2, cms_j[0].num_coords, cms_j[0].num_coords)
    np.testing.assert_allclose(st_, sj, atol=1e-6)
    # subsampled clouds and clusters: the same draws
    kw = dict(samples_per_cluster=16, target_points=100, seed=3)
    np.testing.assert_allclose(tst.swap_consistency_map(cms_t[0], device="cpu", **kw),
                               jst.swap_consistency_map(cms_j[0], **kw), atol=1e-6)
    no_clouds = coord_map_from_jax(cms_j[0])
    no_clouds.raw_clouds = None
    with pytest.raises(ValueError):
        tst.swap_consistency_map(no_clouds, device="cpu")


def test_carry_stack_ragged_clouds_share_launches_by_size():
    """Frames whose clouds differ in size go to separate searches; the
    result is that of the per-frame loop."""
    (cj,), (ct,) = both("hinge")
    for cm in (cj, ct):
        cm.raw_clouds = [c[: len(c) - 7 * (i % 3)] for i, c in enumerate(cm.raw_clouds)]
    np.testing.assert_allclose(tst.swap_consistency_map(ct, raw=True, device="cpu"),
                               jst.swap_consistency_map(cj, raw=True), atol=1e-6)


@pytest.mark.parametrize("mode", ["swap", "hybrid"])
def test_combined_sum_map_swap_modes(mode):
    cms_j, cms_t = both("hinge", seeds=(0, 1))
    np.testing.assert_allclose(tst.combined_sum_map(cms_t, mode, device="cpu"),
                               jst.combined_sum_map(cms_j, mode), atol=1e-5)


@pytest.mark.parametrize("name", ["hinge", "wrist_trap"])
def test_refine_groups_by_carry(name):
    cms_j, cms_t = both(name, seeds=(0, 1))
    truth = TRUE_GROUPS[name]
    # a boundary cluster put on the wrong link is moved back, in both
    wrong = [set(g) for g in truth]
    moved = max(wrong[0])
    wrong[0].discard(moved)
    wrong[1].add(moved)
    gj = jst.refine_groups_by_carry(cms_j, [set(g) for g in wrong])
    gt = tst.refine_groups_by_carry(cms_t, [set(g) for g in wrong], device="cpu")
    assert _groups_equal(gt, gj)
    stack = tst.swap_consistency_stack(cms_t, device="cpu")
    assert _groups_equal(tst.refine_groups_by_carry(cms_t, [set(g) for g in truth], stack=stack),
                         jst.refine_groups_by_carry(cms_j, [set(g) for g in truth]))


# ---------------------------------------------------------------------------
# clustering and DoF searches
# ---------------------------------------------------------------------------

def test_silhouette_against_sklearn():
    rng = np.random.default_rng(0)
    for trial in range(6):
        k = int(rng.integers(6, 15))
        pts = rng.normal(size=(k, 3)) + rng.integers(0, 3, (k, 1)) * 2.0
        d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
        labels = rng.integers(0, 3, k)
        labels[:3] = [0, 1, 2]
        if trial % 2:
            labels[-1] = 7                      # a singleton group scores 0
        assert tst.silhouette_score(d, labels) == pytest.approx(
            sk_silhouette(d, labels, metric="precomputed"), abs=1e-12)
    with pytest.raises(ValueError):
        tst.silhouette_score(d, np.zeros(k, int))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_dof_searches_match_jax(name):
    cms_j, cms_t = both(name, seeds=(0, 1))
    mj = jst.combined_sum_map(cms_j, "pose")
    mt = tst.combined_sum_map(cms_t, "pose")
    n = len(TRUE_GROUPS[name])
    gj, lj, sj = jst.coord_clustering(mj, n)
    gt, lt, s_t = tst.coord_clustering(mt, n)
    assert _groups_equal(gt, gj) and np.array_equal(lt, lj)
    assert s_t == pytest.approx(sj, abs=1e-9)       # our silhouette against sklearn's
    np.testing.assert_array_equal(tst.single_linkage_components(mt, n),
                                  jst.single_linkage_components(mj, n))
    for search in ("merge_gap_dof_search", "auto_dof_search", "silhouette_dof_search"):
        rj, rt = getattr(jst, search)(mj), getattr(tst, search)(mt)
        assert _groups_equal(rt[0], rj[0]), search
        np.testing.assert_array_equal(rt[1], rj[1])
        np.testing.assert_allclose(np.asarray(rt[2], float), np.asarray(rj[2], float), atol=1e-9)
        np.testing.assert_array_equal(rt[3], rj[3])
    start = [set(range(cms_j[0].num_coords))]
    assert _groups_equal(tst.recursive_gap_split(mt, [set(g) for g in start], min_size=2),
                         jst.recursive_gap_split(mj, [set(g) for g in start], min_size=2))


@pytest.mark.parametrize("name", ["hinge", "wrist_trap", "drift"])
def test_rigidity_guard_matches_jax(name):
    cms_j, cms_t = both(name, seeds=(0, 1))
    mj = jst.combined_sum_map(cms_j, "pose")
    stack_j = jst.swap_consistency_stack(cms_j)
    stack_t = tst.swap_consistency_stack(cms_t, device="cpu")
    ej, fj = jst.carry_excess_matrix(stack_j)
    et, ft = tst.carry_excess_matrix(stack_t)
    np.testing.assert_allclose(et, ej, atol=1e-6)
    assert ft == pytest.approx(fj, abs=1e-6)
    truth = TRUE_GROUPS[name]
    assert tst.partition_rigidity(et, truth) == pytest.approx(
        jst.partition_rigidity(ej, truth), abs=1e-6)
    # an under-split start (everything in one link but one cluster)
    k = cms_j[0].num_coords
    under = [set(range(k - 1)), {k - 1}]
    gj, fired_j = jst.rigidity_guarded_groups(mj, stack_j, [set(g) for g in under])
    gt, fired_t = tst.rigidity_guarded_groups(mj, stack_t, [set(g) for g in under])
    assert fired_t == fired_j and _groups_equal(gt, gj)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def test_kruskal_matches_networkx_on_ties_and_zeros():
    """The port's Kruskal against networkx's on weight matrices with equal
    weights (the stable order decides) and zero entries (a graph built from
    a matrix has no edge there)."""
    rng = np.random.default_rng(1)
    for trial in range(8):
        n = int(rng.integers(4, 10))
        w = rng.integers(0, 4, (n, n)).astype(float)     # many ties, some zeros
        w = np.triu(w, 1)
        w = w + w.T
        edges = [(i, j, w[i, j]) for i in range(n) for j in range(i + 1, n) if w[i, j] != 0]
        ref = nx.minimum_spanning_tree(nx.Graph(w)).edges
        got = minimum_spanning_edges(n, edges)
        assert {frozenset(e) for e in got} == {frozenset(e) for e in ref}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_cluster_mst_and_kinematics_tree(name):
    (cj,), (ct,) = both(name)
    gj, gt = jst.cluster_mst(cj), tst.cluster_mst(ct)
    assert {frozenset(e) for e in gt.edges} == {frozenset(e) for e in gj.edges}
    assert list(gt.nodes) == list(gj.nodes)
    for u in gt.nodes:
        assert sorted(gt.neighbors(u)) == sorted(gj.neighbors(u))
    truth = TRUE_GROUPS[name]
    lj = jst.kinematics_tree(cj, [set(g) for g in truth], gj)
    lt = tst.kinematics_tree(ct, [set(g) for g in truth], gt)
    assert _tree_facts(lt) == _tree_facts(lj)
    np.testing.assert_allclose([l.movement for l in lt], [l.movement for l in lj], atol=1e-12)
    assert [l.tree_id for l in lt] == list(range(len(lt)))      # BFS order


def test_cluster_mst_with_coincident_centres():
    """Two clusters whose summed centres coincide: the zero weight is no
    edge, in networkx's graph from a matrix and in the port's."""
    (cj,), _ = both("hinge")
    cj.coords[:, 1, :3] = cj.coords[:, 0, :3]
    ct = coord_map_from_jax(cj)
    gj, gt = jst.cluster_mst(cj), tst.cluster_mst(ct)
    assert {frozenset(e) for e in gt.edges} == {frozenset(e) for e in gj.edges}
    assert frozenset((0, 1)) not in {frozenset(e) for e in gt.edges}


@pytest.mark.parametrize("name", ["hinge", "wrist_trap"])
def test_motion_tree_and_consistency_matrix(name):
    cms_j, cms_t = both(name, seeds=(0, 1))
    truth = TRUE_GROUPS[name]
    steps = cms_j[0].coords.shape[0]
    dj = jst.revolute_consistency_matrix(cms_j, truth, steps)
    dt = tst.revolute_consistency_matrix(cms_t, truth, steps)
    np.testing.assert_allclose(dt, dj, atol=1e-9)
    lj = jst.motion_tree(cms_j, [set(g) for g in truth], steps)
    lt = tst.motion_tree(cms_t, [set(g) for g in truth], steps)
    assert _tree_facts(lt) == _tree_facts(lj)
    if name == "wrist_trap":
        # the motion tree recovers the chain A-B-C-D that the proximity MST misses
        edges = {frozenset((l.id, l.parent_id)) for l in lt if l.parent_id is not None}
        assert edges == {frozenset(e) for e in ((0, 1), (1, 2), (2, 3))}
        mst = tst.kinematics_tree(cms_t[0], [set(g) for g in truth], tst.cluster_mst(cms_t[0]))
        assert {frozenset((l.id, l.parent_id)) for l in mst if l.parent_id is not None} != edges


# ---------------------------------------------------------------------------
# joints
# ---------------------------------------------------------------------------

def _joint_rows(joints):
    return [(j.parent_link, j.child_link) for j in joints]


@pytest.mark.parametrize("name", ["hinge", "hinge_x", "wrist_trap"])
def test_estimate_joints_from_tree(name):
    """Screw axes from fp32 ``screw_from_transform`` in both packages (the
    JAX one on jnp arrays, the port's on tensors), pooled by float64 numpy:
    axes and origins agree to 1e-5."""
    cms_j, cms_t = both(name, seeds=(0, 1))
    truth = TRUE_GROUPS[name]
    steps = cms_j[0].coords.shape[0]
    lj = jst.motion_tree(cms_j, [set(g) for g in truth], steps)
    lt = tst.motion_tree(cms_t, [set(g) for g in truth], steps)
    jj = jjoints.estimate_joints_from_tree(lj, cms_j, 0, steps, interval=4)
    jt = tjoints.estimate_joints_from_tree(lt, cms_t, 0, steps, interval=4)
    assert _joint_rows(jt) == _joint_rows(jj) and len(jt) == len(truth) - 1
    for a, b in zip(jt, jj):
        for f in ("local_axis", "local_pos", "global_pos", "global_axis"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-5, err_msg=f)
    if name == "hinge":
        assert abs(abs(jt[0].global_axis[2]) - 1.0) < 1e-3


@pytest.mark.parametrize("name", ["hinge", "drift"])
def test_joint_screw_coherence(name):
    cms_j, cms_t = both(name, seeds=(0, 1))
    steps = cms_j[0].coords.shape[0]
    mk = lambda cls: [cls(id=0, cluster_idx={0, 1, 2}, parent_id=None),
                      cls(id=1, cluster_idx={3, 4, 5}, parent_id=0)]
    (sj,) = jjoints.joint_screw_coherence(mk(JLinkNode), cms_j, 0, steps, interval=4)
    (st_,) = tjoints.joint_screw_coherence(mk(LinkNode), cms_t, 0, steps, interval=4)
    assert st_.n_samples == sj.n_samples
    for f in ("concentration", "median_dev_deg", "seq_spread_deg", "total_angle_deg"):
        # fp32 screw samples: statistics in degrees agree to 1e-2
        assert getattr(st_, f) == pytest.approx(getattr(sj, f), abs=1e-2), f
    assert (st_.concentration > 0.97) == (name == "hinge")


def test_screw_helpers_match_jax():
    from autourdf_tpu.joints import screw as js
    from autourdf_tpu_torch.joints import screw as ts

    (cj,), (ct,) = both("hinge_x")
    pp = [js.cluster_pose_mean(cj, [0, 1, 2], t) for t in range(0, 10, 2)]
    pc = [js.cluster_pose_mean(cj, [3, 4, 5], t) for t in range(0, 10, 2)]
    tp = [ts.cluster_pose_mean(ct, [0, 1, 2], t) for t in range(0, 10, 2)]
    for (a, b), (c, d) in zip(pp, tp):
        np.testing.assert_allclose(c, a, atol=1e-12)
        np.testing.assert_allclose(d, b, atol=1e-12)
    aj, gj, pj = js.screw_axes_from_pose_series(pp, pc)
    at, gt, pt = ts.screw_axes_from_pose_series(pp, pc)
    np.testing.assert_allclose(at, aj, atol=1e-6)
    np.testing.assert_allclose(gt, gj, atol=1e-6)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    fa, fp = ts.filter_screws(at, gt, pt)
    ga, gp = js.filter_screws(aj, gj, pj)
    assert len(fa) == len(ga) == 4
    oj = js.optimize_joint_axis(pp, pc, ga, gp)
    ot = ts.optimize_joint_axis(pp, pc, fa, fp)
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    with pytest.raises(ValueError):
        ts.filter_screws([], [], [])


def test_quat_np_helpers_match_jax():
    from scipy.spatial.transform import Rotation as ScipyRot

    from autourdf_tpu.core import quat_np as jq
    from autourdf_tpu_torch.core import quat_np as tq

    rng = np.random.default_rng(5)
    base = ScipyRot.from_rotvec([0.3, -0.2, 0.5])
    near = (base * ScipyRot.from_rotvec(rng.normal(0, 0.05, (6, 3)))).as_quat()[:, [3, 0, 1, 2]]
    near[::2] *= -1                                  # sign flips do not matter
    np.testing.assert_array_equal(tq.average_quaternions_np(near), jq.average_quaternions_np(near))
    mean = tq.average_quaternions_np(near)
    assert abs(abs(mean @ base.as_quat()[[3, 0, 1, 2]]) - 1) < 1e-3
    np.testing.assert_array_equal(tq.quat_to_matrix_np(near[1]), jq.quat_to_matrix_np(near[1]))
    coords = np.c_[rng.normal(size=(6, 3)), near]
    np.testing.assert_array_equal(tq.mean_link_frame_np(coords), jq.mean_link_frame_np(coords))
    T = tq.pose_to_matrix_np(coords[0, :3], near[0])
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-12)
    np.testing.assert_array_equal(T[:3, 3], coords[0, :3])


# ---------------------------------------------------------------------------
# links
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hinge", "wrist_trap"])
def test_consolidate_and_refine_link_clusters(name):
    """Link frames and clouds are float64 numpy in both (1e-12); the
    batched link ICP (50 iterations, fp32, every link of a step as one
    batch) agrees with the JAX package's vmapped one to 1e-4 on the aligned
    points, as for any converged ICP run."""
    (cj,), (ct,) = both(name)
    truth = TRUE_GROUPS[name]
    aj = jst.consolidate_links(cj, truth)
    at = tst.consolidate_links(ct, truth)
    np.testing.assert_allclose(at.matrices, aj.matrices, atol=1e-6)   # eigh quaternion mean
    for t in range(len(aj.clusters)):
        for l in range(len(truth)):
            np.testing.assert_allclose(at.clusters[t][l], aj.clusters[t][l], atol=1e-6)
            np.testing.assert_allclose(at.clusters_wf[t][l], aj.clusters_wf[t][l], atol=1e-12)
    rj = jst.refine_link_clusters(aj, max_iterations=50, backend="xla")
    rt = tst.refine_link_clusters(at, max_iterations=50, device="cpu")
    assert len(rt.refined) == len(rj.refined)
    for t in range(len(rj.refined)):
        for l in range(len(truth)):
            np.testing.assert_allclose(rt.refined[t][l], rj.refined[t][l], atol=1e-4)
    cj_clouds, ct_clouds = jst.canonical_link_clouds(rj), tst.canonical_link_clouds(rt)
    assert [c.shape for c in ct_clouds] == [c.shape for c in cj_clouds]
    # rigid links observed exactly: every step aligns onto step 0
    assert np.abs(rt.refined[-1][0] - at.clusters[0][0]).max() < 1e-3


def test_save_link_artifacts_layout(tmp_path):
    from autourdf_tpu_torch.io.artifacts import load_cluster_npz

    (_,), (ct,) = both("hinge")
    art = tst.refine_link_clusters(tst.consolidate_links(ct, TRUE_GROUPS["hinge"]),
                                   max_iterations=5, device="cpu")
    tst.save_link_artifacts(str(tmp_path / "links"), art)
    for sub in ("matrix", "cluster", "cluster_wf", "cluster_rf"):
        assert len(list((tmp_path / "links" / sub).iterdir())) == len(art.clusters)
    back = load_cluster_npz(str(tmp_path / "links" / "cluster_rf" / "0003.npz"))
    np.testing.assert_allclose(back[1], art.refined[3][1], atol=1e-6)
    np.testing.assert_array_equal(np.load(tmp_path / "links" / "matrix" / "0002.npy"),
                                  art.matrices[2])


# ---------------------------------------------------------------------------
# the jet ramp
# ---------------------------------------------------------------------------

def test_jet_against_matplotlib():
    cmap = matplotlib.colormaps["jet"]
    xs = [i / n for n in (1, 2, 3, 5, 7, 19, 256) for i in range(n)] + [1.0, 0.999999]
    for x in xs:
        np.testing.assert_allclose(jet(x), cmap(x), atol=1e-6, err_msg=str(x))
    assert all(isinstance(v, float) for v in jet(0.3))
