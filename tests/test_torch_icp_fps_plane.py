"""Parity of the port's farthest-point sampling, plane / normal estimation
and ICP (autourdf_tpu_torch.ops.fps / .plane / .icp), and of the
registration options built on them (``mlp_icp``, ``use_normals``,
``seed_mode="fps"``), with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason, stand beside the assertion that uses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from autourdf_tpu.models.regmlp import PoseRegressor as JPoseRegressor
from autourdf_tpu.models.regmlp import init_params as j_init_params
from autourdf_tpu.ops import fps as jfps
from autourdf_tpu.ops import icp as jicp
from autourdf_tpu.ops import plane as jplane
from autourdf_tpu.ops.kmeans import kmeans as j_kmeans
from autourdf_tpu.registration import RegistrationConfig as JConfig
from autourdf_tpu.registration import initial_segments as j_initial_segments
from autourdf_tpu.registration import register_sequences_batched as j_register
from autourdf_tpu_torch.models.regmlp import PoseRegressor, params_from_jax
from autourdf_tpu_torch.ops import fps as tfps
from autourdf_tpu_torch.ops import icp as ticp
from autourdf_tpu_torch.ops import plane as tplane
from autourdf_tpu_torch.ops.kmeans import kmeans as t_kmeans
from autourdf_tpu_torch.ops.knn import PAD_COORD
from autourdf_tpu_torch.registration import (
    RegistrationConfig,
    SegmentInit,
    initial_segments,
    register_sequences_batched,
)

T_ = torch.from_numpy


def _cloud(n=400, seed=0, scale=0.1):
    return np.random.default_rng(seed).normal(scale=scale, size=(n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# farthest-point sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_farthest_point_sample_indices_equal(masked):
    pts = _cloud(300, 1)
    pts[150:170] = pts[:20]                       # duplicated points: equal scores
    mask = None
    if masked:
        mask = np.random.default_rng(2).random(300) > 0.3
        mask[:3] = False                          # the seed is the first VALID point
    got = tfps.farthest_point_sample(T_(pts), 12, None if mask is None else T_(mask))
    ref = jfps.farthest_point_sample(jnp.asarray(pts), 12,
                                     None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0] == (3 if masked and mask[3] else int(np.argmax(mask)) if masked else 0)


def test_farthest_point_sample_repeats_when_few_valid():
    pts = _cloud(50, 3)
    mask = np.zeros(50, bool)
    mask[[4, 9, 30]] = True
    got = tfps.farthest_point_sample(T_(pts), 6, T_(mask)).numpy()
    ref = np.asarray(jfps.farthest_point_sample(jnp.asarray(pts), 6, jnp.asarray(mask)))
    np.testing.assert_array_equal(got, ref)
    assert set(got) <= {4, 9, 30}


@pytest.mark.parametrize("masked", [False, True])
def test_kmeans_fps_seed_mode_matches_jax(masked):
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.normal(c, 0.05, size=(80, 3)) for c in
                          ([0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5])]).astype(np.float32)
    mask = (np.arange(len(pts)) % 7 != 0) if masked else None
    ref = j_kmeans(jax.random.PRNGKey(0), jnp.asarray(pts), 4, iters=16, seed_mode="fps",
                   mask=None if mask is None else jnp.asarray(mask))
    got = t_kmeans(torch.Generator().manual_seed(0), T_(pts), 4, iters=16, seed_mode="fps",
                   mask=None if mask is None else T_(mask))
    # the same seeds (indices equal above), so the same Lloyd run: fp32 sums
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers), atol=1e-6)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))


# ---------------------------------------------------------------------------
# plane segmentation and normals
# ---------------------------------------------------------------------------

def _plane_scene(seed=5):
    rng = np.random.default_rng(seed)
    ground = np.c_[rng.uniform(-1, 1, (300, 2)), rng.normal(0, 2e-4, 300)]
    rot = ScipyRot.from_rotvec([0.3, -0.2, 0.1]).as_matrix()
    ground = ground @ rot.T + [0.1, 0.0, -0.2]
    blob = rng.normal(scale=0.3, size=(150, 3)) + [0, 0, 0.6]
    return np.concatenate([ground, blob]).astype(np.float32)


def test_segment_plane_with_the_jax_draw():
    """The port splits the draw from the scoring: handed the triples that
    ``jax.random.randint`` gives the JAX function for its key, it picks the
    same hypothesis.  Plane to 1e-5 (fp32 cross products and norms), inlier
    mask equal but for points within 1e-6 of the threshold (none here)."""
    pts = _plane_scene()
    key = jax.random.PRNGKey(7)
    plane_j, inl_j = jplane.segment_plane(jnp.asarray(pts), key, 0.001, 200)
    triples = np.array(jax.random.randint(key, (200, 3), 0, len(pts)))
    plane_t, inl_t = tplane.segment_plane_from_triples(T_(pts), T_(triples).long(), 0.001)
    np.testing.assert_allclose(plane_t.numpy(), np.asarray(plane_j), atol=1e-5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert 250 <= int(inl_t.sum()) <= 320


def test_segment_plane_own_draw_finds_the_ground():
    pts = _plane_scene()
    gen = torch.Generator().manual_seed(0)
    triples = tplane.draw_plane_triples(len(pts), 300, gen)
    assert triples.shape == (300, 3) and int(triples.min()) >= 0 and int(triples.max()) < len(pts)
    plane, inliers = tplane.segment_plane(T_(pts), torch.Generator().manual_seed(0), 0.001, 300)
    assert abs(float(torch.linalg.norm(plane[:3])) - 1.0) < 1e-5
    assert int(inliers[:300].sum()) > 250 and int(inliers[300:].sum()) < 10
    # collinear triples never win
    line = torch.tensor([[0, 1, 2]] * 4)
    col = T_(np.c_[np.arange(10.0), np.zeros(10), np.zeros(10)].astype(np.float32))
    _, inl = tplane.segment_plane_from_triples(col, line, 0.001)
    assert inl.shape == (10,)


def test_estimate_normals_matches_jax_up_to_sign():
    """Eigenvector signs and near-equal eigenvalues differ between LAPACK
    and XLA, so compare |n_jax . n_torch| on points whose two smallest
    eigenvalues are separated (gap above 10% of the middle one): there the
    eigenvector is well conditioned and agrees to 1e-3 in fp32."""
    rng = np.random.default_rng(6)
    # a bumpy sheet: a clear normal almost everywhere
    xy = rng.uniform(-1, 1, (1500, 2))
    pts = np.c_[xy, 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.004, 1500)].astype(np.float32)
    n_j = np.asarray(jplane.estimate_normals(jnp.asarray(pts), k=30, backend="xla"))
    n_t = tplane.estimate_normals(T_(pts), k=30).numpy()
    assert n_t.shape == (1500, 3)
    np.testing.assert_allclose(np.linalg.norm(n_t, axis=1), 1.0, atol=1e-5)
    assert np.all(n_t[:, 2] >= 0)
    # eigenvalue gaps from float64 covariances of the same neighbourhoods
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    nb = pts[np.argsort(d, axis=1)[:, :30]].astype(np.float64)
    c = nb - nb.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c))
    sep = (ev[:, 1] - ev[:, 0]) > 0.1 * ev[:, 1]
    assert sep.mean() > 0.9
    dots = np.abs(np.sum(n_j * n_t, axis=1))
    assert np.all(dots[sep] > 1 - 1e-3)
    # chunking does not change the result
    np.testing.assert_array_equal(tplane.estimate_normals(T_(pts), k=30, chunk=256).numpy(), n_t)


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

def _icp_pair(seed=0, n=300):
    src = _cloud(n, seed)
    rot = ScipyRot.from_rotvec([0.05, 0.1, -0.07]).as_matrix().astype(np.float32)
    tgt = src @ rot.T + np.array([0.01, -0.02, 0.03], np.float32)
    return src, tgt


def test_orthonormalize_and_kabsch_match_jax():
    rng = np.random.default_rng(8)
    R = ScipyRot.random(4, random_state=1).as_matrix() + rng.normal(0, 2e-3, (4, 3, 3))
    got = ticp._orthonormalize(T_(R.astype(np.float32)))
    ref = np.stack([np.asarray(jicp._orthonormalize(jnp.asarray(r, jnp.float32))) for r in R])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose((got @ got.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), (4, 3, 3)), atol=1e-6)
    src, tgt = _icp_pair()
    w = (rng.random(len(src)) > 0.2).astype(np.float32)
    Tt = ticp._kabsch(T_(src)[None], T_(tgt)[None], T_(w)[None])[0]
    Tj = jicp._kabsch(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    # 3x3 SVD by LAPACK vs XLA, then the same polar step: fp32 round-off
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_icp_one_iteration_is_tight(masked):
    src, tgt = _icp_pair(1)
    sm = tm = None
    if masked:
        rng = np.random.default_rng(9)
        sm, tm = rng.random(len(src)) > 0.2, rng.random(len(tgt)) > 0.2
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.002, 0.0, -0.001]
    ref = jicp.icp_point_to_point(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init), max_iterations=1, threshold=0.08,
        source_mask=None if sm is None else jnp.asarray(sm),
        target_mask=None if tm is None else jnp.asarray(tm), backend="xla")
    got = ticp.icp_point_to_point(
        T_(src), T_(tgt), T_(init), max_iterations=1, threshold=0.08,
        source_mask=None if sm is None else T_(sm), target_mask=None if tm is None else T_(tm))
    # one step: the same correspondences and weights, one 3x3 SVD apart
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(ref.transform), atol=1e-5)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-5)


def test_icp_converged_run_and_batch():
    """50 iterations on a well-conditioned pair (a rigid copy, every point
    matched): both packages converge to the true motion; 1e-4 on the
    transform, because round-off of 50 composed Kabsch steps accumulates and
    the freeze may trigger one iteration apart."""
    src, tgt = _icp_pair(2)
    ref = jicp.icp_point_to_point(jnp.asarray(src), jnp.asarray(tgt), max_iterations=50,
                                  backend="xla")
    got = ticp.icp_point_to_point(T_(src), T_(tgt), max_iterations=50)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(ref.transform), atol=1e-4)
    moved = src @ got.transform.numpy()[:3, :3].T + got.transform.numpy()[:3, 3]
    assert np.abs(moved - tgt).max() < 1e-4 and float(got.fitness) == 1.0
    # a batch gives each pair its own result
    src2, tgt2 = _icp_pair(3)
    both = ticp.icp_point_to_point(T_(np.stack([src, src2])), T_(np.stack([tgt, tgt2])),
                                   max_iterations=50)
    one = ticp.icp_point_to_point(T_(src2), T_(tgt2), max_iterations=50)
    np.testing.assert_allclose(both.transform[0].numpy(), got.transform.numpy(), atol=1e-6)
    np.testing.assert_allclose(both.transform[1].numpy(), one.transform.numpy(), atol=1e-6)


@pytest.mark.parametrize("case", ["no_inlier", "empty_gate"])
def test_icp_degenerate_cases_keep_the_init(case):
    """No inlier (every match beyond the threshold: w = 0, H = 0, the SVD
    factors arbitrary) and an empty gate (every target at the sentinel):
    both packages leave the transform at its init."""
    src, tgt = _icp_pair(4)
    init = np.eye(4, dtype=np.float32)
    init[:3, :3] = ScipyRot.from_rotvec([0, 0, 0.2]).as_matrix()
    kw = dict(max_iterations=3, threshold=0.5)
    if case == "no_inlier":
        tj, tt, mj, mt = jnp.asarray(tgt + 5), T_(tgt + 5), None, None
    else:
        gate = np.zeros(len(tgt), bool)
        tj, tt, mj, mt = jnp.asarray(tgt), T_(tgt), jnp.asarray(gate), T_(gate)
    ref = jicp.icp_point_to_point(jnp.asarray(src), tj, jnp.asarray(init), target_mask=mj,
                                  backend="xla", **kw)
    got = ticp.icp_point_to_point(T_(src), tt, T_(init), target_mask=mt, **kw)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(ref.transform), atol=1e-6)
    np.testing.assert_allclose(got.transform.numpy(), init, atol=1e-6)
    assert float(got.fitness) == float(ref.fitness) == 0.0
    assert float(got.rmse) == float(ref.rmse) == 0.0


def _cluster_scene(seed=10):
    """3 clusters of a 2-box scene in local frames, the next frame moved."""
    rng = np.random.default_rng(seed)
    centres = np.array([[-0.4, 0, 0], [0.0, 0.1, 0], [0.5, 0, 0.1]], np.float32)
    local = rng.normal(scale=0.05, size=(3, 90, 3)).astype(np.float32)
    labels = np.repeat(np.arange(3), 90).astype(np.int32)
    mats = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    mats[:, :3, 3] = centres
    rot = ScipyRot.from_rotvec([0, 0, 0.08]).as_matrix().astype(np.float32)
    world = local + centres[:, None]
    target = np.concatenate([world[0], world[1], world[2] @ rot.T + [0.0, 0.02, 0.0]])
    perm = rng.permutation(len(target))
    return local.reshape(-1, 3), labels, mats, target[perm].astype(np.float32)


def test_masked_icp_clusters_matches_jax():
    pts, labels, mats, target = _cluster_scene()
    ref = jicp.masked_icp_clusters(jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(mats),
                                   jnp.asarray(target), 3, max_iterations=20, backend="xla")
    got = ticp.masked_icp_clusters(T_(pts), T_(labels).long(), T_(mats), T_(target), 3,
                                   max_iterations=20)
    # 20 composed steps on exact copies: as the converged run above
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert np.abs(got[2].numpy() - mats[2]).max() > 1e-2      # the moved cluster moved


def test_masked_icp_clusters_empty_cluster_and_gate_and_batch():
    """A cluster with no member (no inlier, and its inverted AABB gates
    every target point away) and a cluster whose box holds no target point
    both keep their pose, in both packages; a sequence batch equals the
    per-sequence calls."""
    pts, labels, mats, target = _cluster_scene(11)
    mats4 = np.concatenate([mats, np.eye(4, dtype=np.float32)[None]])
    mats4[3, :3, 3] = [5.0, 5.0, 5.0]                  # cluster 3: no member
    far = target.copy()
    far[:, 0] = np.where(far[:, 0] > 0.25, far[:, 0] + 3.0, far[:, 0])   # cluster 2: empty gate
    ref = jicp.masked_icp_clusters(jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(mats4),
                                   jnp.asarray(far), 4, max_iterations=5, backend="xla")
    got = ticp.masked_icp_clusters(T_(pts), T_(labels).long(), T_(mats4), T_(far), 4,
                                   max_iterations=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), mats4[3])
    np.testing.assert_array_equal(got[2].numpy(), mats4[2])
    two = ticp.masked_icp_clusters(T_(np.stack([pts, pts])), T_(np.stack([labels, labels])).long(),
                                   T_(np.stack([mats4, mats4])), T_(np.stack([far, target])), 4,
                                   max_iterations=5)
    np.testing.assert_allclose(two[0].numpy(), got.numpy(), atol=1e-6)
    one = ticp.masked_icp_clusters(T_(pts), T_(labels).long(), T_(mats4), T_(target), 4,
                                   max_iterations=5)
    np.testing.assert_allclose(two[1].numpy(), one.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the registration options as a whole
# ---------------------------------------------------------------------------

S, T, K, H = 2, 3, 4, 32


def _hinge_frames(angle_step, n_per_link=160, seed=0):
    """Synthetic 2-link robot: a base box and an arm box turning about z."""
    rng = np.random.default_rng(seed)
    base = rng.uniform([-0.6, -0.15, -0.1], [-0.1, 0.15, 0.1], size=(n_per_link, 3))
    arm0 = rng.uniform([0.1, -0.1, -0.08], [0.7, 0.1, 0.08], size=(n_per_link, 3))
    out = []
    for t in range(T):
        a = t * angle_step
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        out.append(np.concatenate([base, arm0 @ rot.T]).astype(np.float32))
    return np.stack(out)


def _register_both(frames, masks, init_j, **options):
    keys = jax.random.split(jax.random.PRNGKey(1), 2 * S)
    mk = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])
    sp, ap = mk(keys[:S]), mk(keys[S:])
    common = dict(num_seg=K, hidden_dim=H, epochs=10, kmeans_iters=8, lr_step=1e-3,
                  lr_anchor=5e-4, icp_iterations=10, **options)
    jm = None if masks is None else jnp.asarray(masks)
    res_j = j_register(JPoseRegressor("q", H), JConfig(chamfer_backend="xla", **common), sp, ap,
                       init_j, jnp.asarray(frames), jm)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    init_t = SegmentInit(*(T_(np.array(v)) for v in init_j[:3]),
                         None if masks is None else T_(masks[0, 0]))
    init_t = init_t._replace(labels=init_t.labels.long())
    res_t = register_sequences_batched(
        PoseRegressor("q", H, num_seqs=S), RegistrationConfig(**common),
        params_from_jax(to_np(sp), "q"), params_from_jax(to_np(ap), "q"), init_t,
        T_(frames), None if masks is None else T_(masks))
    return res_j, res_t


def test_registration_with_mlp_icp_matches_jax():
    """The step phase, then 10 ICP iterations per cluster instead of the
    anchor phase, from the JAX package's segmentation and parameters.  Step
    losses 1e-5 relative (as the plain registration slice); poses 1e-4
    (composed Kabsch steps, LAPACK against XLA SVD); labels equal."""
    frames = np.stack([_hinge_frames(0.10), _hinge_frames(0.16)])
    init_j = j_initial_segments(jax.random.PRNGKey(0), jnp.asarray(frames[0, 0]), K,
                                kmeans_iters=8, n_init=2)
    res_j, res_t = _register_both(frames, None, init_j, mlp_icp=True)
    np.testing.assert_allclose(res_t.step_losses.numpy(), np.asarray(res_j.step_losses),
                               rtol=1e-5)
    # with mlp_icp the reported loss is the step phase's best loss
    np.testing.assert_array_equal(res_t.losses.numpy(), res_t.step_losses.numpy())
    np.testing.assert_array_equal(np.asarray(res_j.losses), np.asarray(res_j.step_losses))
    np.testing.assert_allclose(res_t.matrices.numpy(), np.asarray(res_j.matrices), atol=1e-4)
    np.testing.assert_array_equal(res_t.labels.numpy(), np.asarray(res_j.labels))


def test_registration_with_normals_and_fps_seeds_matches_jax():
    """6-D features (xyz + 0.5 * normals) in the segmentation and in every
    resample, FPS seeds, ragged masked frames.  Each package makes its own
    segmentation here (FPS is deterministic): centres 1e-5, labels equal but
    for points whose normal is ill-conditioned (at most 1%); then the
    registration from the JAX package's segmentation: losses 1e-5 relative,
    poses 1e-5, labels equal on at least 99% of the valid points."""
    counts = [[300, 285, 310], [295, 320, 290]]
    rng = np.random.default_rng(1)
    frames = np.full((S, T, 320, 3), PAD_COORD, np.float32)
    masks = np.zeros((S, T, 320), bool)
    for s, step in enumerate((0.10, 0.16)):
        seq = _hinge_frames(step)
        for t in range(T):
            sel = rng.choice(seq.shape[1], counts[s][t], replace=False)
            frames[s, t, :counts[s][t]] = seq[t][sel]
            masks[s, t, :counts[s][t]] = True
    init_j = j_initial_segments(jax.random.PRNGKey(0), jnp.asarray(frames[0, 0]), K,
                                mask=jnp.asarray(masks[0, 0]), kmeans_iters=8,
                                use_normals=True, seed_mode="fps")
    init_t = initial_segments(torch.Generator().manual_seed(0), T_(frames[0, 0]), K,
                              mask=T_(masks[0, 0]), kmeans_iters=8, use_normals=True,
                              seed_mode="fps")
    assert init_t.matrices.shape == (K, 4, 4) and init_t.points.shape == (320, 3)
    np.testing.assert_allclose(init_t.matrices.numpy(), np.asarray(init_j.matrices), atol=1e-5)
    valid = masks[0, 0]
    same = init_t.labels.numpy()[valid] == np.asarray(init_j.labels)[valid]
    assert same.mean() >= 0.99

    res_j, res_t = _register_both(frames, masks, init_j, use_normals=True)
    np.testing.assert_allclose(res_t.losses.numpy(), np.asarray(res_j.losses), rtol=1e-5)
    np.testing.assert_allclose(res_t.matrices.numpy(), np.asarray(res_j.matrices), atol=1e-5)
    for s in range(S):
        for t in range(1, T):
            v = masks[s, t]
            same = res_t.labels.numpy()[s, t][v] == np.asarray(res_j.labels)[s, t][v]
            assert same.mean() >= 0.99
