"""The algorithms of the port's geometry kernels (``csrc/geom.cu``:
``fps_kernel``, ``kabsch3_kernel``, ``sym_eig3_min_kernel``) on the CPU, and
the programs they make possible.

The kernels run only on the card; here their plain PyTorch models
(``tests/torch_geom_models.py``: the same fixed sweeps, rotations and sums
in the same order) are held against the JAX package, which computes the
same functions with ``jnp.linalg.svd``, ``jnp.linalg.eigh`` and its
``fori_loop``.  Then the ICP through ``utils/programs.py`` against its eager
loop, and the fused registration with ``mlp_icp`` and ``use_normals`` (now
one frame-pair program) against the JAX package's fused driver.

Inputs are made with numpy from a seed and handed to both packages.
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
from autourdf_tpu.registration import RegistrationConfig as JConfig
from autourdf_tpu.registration import initial_segments as j_initial_segments
from autourdf_tpu.registration import register_sequences_fused as j_register_fused
from autourdf_tpu_torch.models.regmlp import PoseRegressor, params_from_jax
from autourdf_tpu_torch.ops import fps as tfps
from autourdf_tpu_torch.ops import icp as ticp
from autourdf_tpu_torch.ops import plane as tplane
from autourdf_tpu_torch.ops.knn import PAD_COORD
from autourdf_tpu_torch.registration import (
    RegistrationConfig,
    SegmentInit,
    register_sequences_batched,
    register_sequences_fused,
)
from autourdf_tpu_torch.utils import programs
from torch_geom_models import fps_model, kabsch3_model, sym_eig3_min_model

T_ = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small tensor operations, and under
    pytest-xdist every worker's full thread pool contends for the same
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cross_cov(sv, seed):
    """``(B, 3, 3)`` float32 matrices with singular values ``sv (B, 3)`` and
    random singular vectors (a reflection where a value is negative)."""
    B = len(sv)
    U = ScipyRot.random(B, random_state=seed).as_matrix()
    V = ScipyRot.random(B, random_state=seed + 1).as_matrix()
    return np.einsum("bij,bj,bkj->bik", U, np.asarray(sv, np.float64), V).astype(np.float32)


def _proper(R: np.ndarray) -> tuple[float, float]:
    """Largest |R R^T - I| entry and largest |det R - 1|."""
    R = R.astype(np.float64)
    orth = np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max()
    return float(orth), float(np.abs(np.linalg.det(R) - 1.0).max())


# ---------------------------------------------------------------------------
# kabsch3_kernel's algorithm
# ---------------------------------------------------------------------------

def _kabsch_inputs(seed, B=24, n=200):
    rng = np.random.default_rng(seed)
    src = rng.normal(scale=[0.12, 0.08, 0.05], size=(B, n, 3)).astype(np.float32)
    rot = ScipyRot.random(B, random_state=seed).as_matrix().astype(np.float32)
    dst = (np.einsum("bij,bnj->bni", rot, src) + rng.normal(0, 0.02, (B, 1, 3))
           + rng.normal(0, 3e-3, src.shape)).astype(np.float32)
    w = (rng.random((B, n)) > 0.15).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kabsch_model_matches_jax(seed, monkeypatch):
    """The port's weighted Kabsch with the kernel's algorithm for its
    rotation, against the JAX package's ``_kabsch`` (``jnp.linalg.svd`` +
    ``det``, then the same Newton-Schulz step) on well-conditioned
    cross-covariances (sigma_2 - sigma_3 > 1e-3 sigma_1): 1e-5, the fp32
    round-off of two 3x3 SVDs."""
    src, dst, w = _kabsch_inputs(seed)
    monkeypatch.setattr(ticp, "kabsch_rotation", kabsch3_model)
    got = ticp._kabsch(T_(src), T_(dst), T_(w)).numpy()
    ref = np.stack([np.asarray(jicp._kabsch(jnp.asarray(s), jnp.asarray(d), jnp.asarray(x)))
                    for s, d, x in zip(src, dst, w)])
    H = np.einsum("bni,bnj->bij", (src - (src * w[..., None]).sum(1, keepdims=True)
                                   / w.sum(1)[:, None, None]) * w[..., None], dst)
    sv = np.linalg.svd(H.astype(np.float64), compute_uv=False)
    assert np.all(sv[:, 1] - sv[:, 2] > 1e-3 * sv[:, 0])
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_kabsch_model_matches_the_plain_rotation_and_reflections():
    """Well-conditioned H with det > 0 and det < 0: the model's rotation
    equals the plain version's V diag(1, 1, det(V U^T)) U^T to 1e-5, and is
    a proper rotation."""
    rng = np.random.default_rng(3)
    sv = np.sort(rng.uniform(0.2, 3.0, (64, 3)), axis=1)[:, ::-1].copy()
    sv[::2, 2] *= -1                                    # reflected H: det(H) < 0
    H = T_(_cross_cov(sv, 5))
    got = kabsch3_model(H)
    np.testing.assert_allclose(got.numpy(), ticp._kabsch_rotation_plain(H).numpy(), atol=1e-5)
    orth, det = _proper(got.numpy())
    assert orth <= 1e-6 and det <= 1e-6


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_kabsch_model_degenerate_cross_covariances(rank):
    """H = 0 (no inlier, an empty gate) gives exactly the identity, as the
    ICP needs to keep an init; rank-1 and rank-2 H give a proper rotation
    (rank 2 is still unique: the plain version's to 1e-5)."""
    if rank == 0:
        H = torch.zeros(5, 3, 3)
        assert torch.equal(kabsch3_model(H), torch.eye(3).repeat(5, 1, 1))
        return
    rng = np.random.default_rng(10 + rank)
    sv = np.zeros((40, 3))
    sv[:, :rank] = np.sort(rng.uniform(0.3, 2.0, (40, rank)), axis=1)[:, ::-1]
    H = T_(_cross_cov(sv, 20 + rank))
    got = kabsch3_model(H)
    orth, det = _proper(got.numpy())
    assert orth <= 1e-6 and det <= 1e-6
    if rank == 2:
        np.testing.assert_allclose(got.numpy(), ticp._kabsch_rotation_plain(H).numpy(),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# sym_eig3_min_kernel's algorithm
# ---------------------------------------------------------------------------

def test_eigen_model_normals_match_jax_up_to_sign(monkeypatch):
    """The port's ``estimate_normals`` with the kernel's Jacobi sweeps for the
    eigenvector against the JAX package's (``jnp.linalg.eigh``), as
    ``test_estimate_normals_matches_jax_up_to_sign``: |n_jax . n| > 1 - 1e-3
    where the two smallest eigenvalues are separated by more than 10%."""
    rng = np.random.default_rng(6)
    xy = rng.uniform(-1, 1, (1500, 2))
    pts = np.c_[xy, 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.004, 1500)].astype(np.float32)
    monkeypatch.setattr(tplane, "smallest_eigenvector", sym_eig3_min_model)
    n_t = tplane.estimate_normals(T_(pts), k=30).numpy()
    n_j = np.asarray(jplane.estimate_normals(jnp.asarray(pts), k=30, backend="xla"))
    np.testing.assert_allclose(np.linalg.norm(n_t, axis=1), 1.0, atol=1e-6)
    assert np.all(n_t[:, 2] >= 0)
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    nb = pts[np.argsort(d, axis=1)[:, :30]].astype(np.float64)
    c = nb - nb.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c))
    sep = (ev[:, 1] - ev[:, 0]) > 0.1 * ev[:, 1]
    assert sep.mean() > 0.9
    assert np.all(np.abs(np.sum(n_j * n_t, axis=1))[sep] > 1 - 1e-3)


def test_eigen_model_on_close_and_degenerate_spectra():
    """Against the plain version (LAPACK's eigh) on covariances of every
    shape: |dot| > 1 - 1e-4 where the gap exceeds 10% (and lies above the
    fp32 round-off of the matrix, 1e-4 of its largest eigenvalue: the two
    zero eigenvalues of a rank-1 matrix part by noise alone), unit norm to
    1e-6 everywhere (isotropic and rank-deficient matrices included), and a
    diagonal matrix's own axis."""
    rng = np.random.default_rng(7)
    ev = rng.uniform(0.01, 1.0, (300, 3))
    ev[:50, 1] = ev[:50, 0] * (1 + rng.uniform(0, 0.05, 50))     # close pairs
    ev[50:60] = 0.5                                                # isotropic
    ev[60:70, 0] = 0.0                                             # rank 2
    ev[70:80, :2] = 0.0                                            # rank 1
    Q = ScipyRot.random(300, random_state=4).as_matrix()
    C = np.einsum("bij,bj,bkj->bik", Q, ev, Q).astype(np.float32)
    C = 0.5 * (C + C.transpose(0, 2, 1))
    got = sym_eig3_min_model(T_(C)).numpy()
    ref = tplane._smallest_eigenvector_plain(T_(C)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    e = np.sort(np.linalg.eigvalsh(C.astype(np.float64)), axis=1)
    gap = e[:, 1] - e[:, 0]
    sep = (gap > 0.1 * e[:, 1]) & (gap > 1e-4 * e[:, 2])
    assert sep.sum() > 150
    assert np.all(np.abs(np.sum(got * ref, axis=1))[sep] > 1 - 1e-4)
    diag = torch.diag_embed(torch.tensor([[3.0, 1.0, 2.0], [0.5, 0.7, 0.2]]))
    assert torch.equal(sym_eig3_min_model(diag), torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]))


# ---------------------------------------------------------------------------
# fps_kernel's algorithm
# ---------------------------------------------------------------------------

def _cpu_dist(points, q):
    """The plain version's distance on the CPU (its own order of the sum)."""
    return torch.sum((points - q) ** 2, dim=1)


@pytest.mark.parametrize("case", ["dense", "masked", "few_valid", "none_valid"])
def test_fps_packed_key_model_matches_the_picks(case):
    """The kernel's compaction and packed-key argmax (distance bits above
    the complement of the compact index) give the plain version's picks and
    the JAX package's, ties to the first index included; fewer valid points
    than k repeat the valid set, none gives all zeros."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.3, 0.3, (700, 3)).astype(np.float32)
    pts[350:420] = pts[:70]                              # duplicated points: equal scores
    mask = {"dense": None, "masked": rng.random(700) > 0.4,
            "few_valid": np.isin(np.arange(700), [5, 17, 400, 401]),
            "none_valid": np.zeros(700, bool)}[case]
    k = 60
    m_t = None if mask is None else T_(mask)
    got = fps_model(T_(pts), k, m_t, dist=_cpu_dist)
    plain = tfps.farthest_point_sample(T_(pts), k, m_t)
    ref = np.asarray(jfps.farthest_point_sample(jnp.asarray(pts), k,
                                                None if mask is None else jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "none_valid":
        assert not got.any()


def test_fps_kernel_sum_order_picks_on_clean_data():
    """With the card's order of the three squared differences ((x + z) + y)
    the model picks what the CPU's order picks where no two candidates are
    within an ulp: on a grid (exact squares and sums) both orders give the
    same numbers."""
    g = np.stack(np.meshgrid(*[np.arange(9, dtype=np.float32) / 8] * 3), -1).reshape(-1, 3)
    p = T_(g)
    np.testing.assert_array_equal(fps_model(p, 40).numpy(), fps_model(p, 40, dist=_cpu_dist))
    np.testing.assert_array_equal(fps_model(p, 40).numpy(), tfps.farthest_point_sample(p, 40))


# ---------------------------------------------------------------------------
# the programs: the ICP and the fused registration with mlp_icp and normals
# ---------------------------------------------------------------------------

def _icp_batch(seed=0, B=3, n=240):
    rng = np.random.default_rng(seed)
    src = rng.normal(scale=0.1, size=(B, n, 3)).astype(np.float32)
    rot = ScipyRot.from_rotvec(rng.normal(0, 0.08, (B, 3))).as_matrix()
    tgt = (np.einsum("bij,bnj->bni", rot, src) + [0.01, -0.02, 0.015]).astype(np.float32)
    sm, tm = rng.random((B, n)) > 0.1, rng.random((B, n)) > 0.1
    tm[-1] = False                                       # an empty gate: keeps its init
    return src, tgt, sm, tm


@pytest.mark.parametrize("masked", [False, True])
def test_icp_program_equals_the_eager_loop(masked):
    """``icp_point_to_point`` runs its iterations as a program
    (``utils/programs.py``; on the CPU the same function on static buffers)
    and gives the eager loop's transforms, fitness and RMSE bit for bit, on
    the first call and on a replay with other inputs."""
    src, tgt, sm, tm = _icp_batch(1)
    kw = dict(max_iterations=12, threshold=0.2)
    if masked:
        kw.update(source_mask=T_(sm), target_mask=T_(tm))
    for shift in (0.0, 0.01):
        a = ticp.icp_point_to_point(T_(src), T_(tgt + shift), **kw)
        b = ticp.icp_point_to_point(T_(src), T_(tgt + shift), eager=True, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    if masked:
        assert torch.equal(a.transform[-1], torch.eye(4))
    one = ticp.icp_point_to_point(T_(src[0]), T_(tgt[0]), max_iterations=12, threshold=0.2)
    ref = ticp.icp_point_to_point(T_(src[0]), T_(tgt[0]), max_iterations=12, threshold=0.2,
                                  eager=True)
    assert one.transform.shape == (4, 4) and torch.equal(one.transform, ref.transform)


def test_icp_program_serves_every_threshold():
    """The threshold and the relative criteria are inputs of the ICP's
    program, not parts of its key: ICPs of one shape at other thresholds
    (the chain fit's polish works one out for each link) share one program,
    and each gives its own eager loop's result bit for bit."""
    src, tgt, sm, tm = _icp_batch(4)
    programs.clear()
    for threshold, rel in ((0.2, 1e-6), (0.05, 1e-6), (0.013, 1e-4)):
        kw = dict(max_iterations=9, threshold=threshold, relative_rmse=rel, relative_fitness=rel,
                  source_mask=T_(sm), target_mask=T_(tm))
        a = ticp.icp_point_to_point(T_(src), T_(tgt), **kw)
        b = ticp.icp_point_to_point(T_(src), T_(tgt), eager=True, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert len(programs._cache) == 1
    assert not torch.equal(a.fitness, ticp.icp_point_to_point(
        T_(src), T_(tgt), max_iterations=9, threshold=0.2, source_mask=T_(sm),
        target_mask=T_(tm)).fitness)


def test_masked_icp_clusters_program_equals_eager():
    """``masked_icp_clusters`` runs its ICP as the plain loop, so it can be
    the body of the registration's ICP-phase program: in a program it gives
    the plain call's poses bit for bit, on the first call and on a replay."""
    rng = np.random.default_rng(12)
    pts = rng.normal(scale=0.05, size=(2, 180, 3)).astype(np.float32)
    labels = np.tile(np.repeat(np.arange(3), 60), (2, 1))
    mats = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    mats[:, :, :3, 3] = [[-0.3, 0, 0], [0, 0.1, 0], [0.3, 0, 0.1]]
    target = (pts + mats[0, labels[0], :3, 3] + rng.normal(0, 0.004, pts.shape)).astype(np.float32)
    programs.clear()
    for shift in (0.0, 0.005):
        args = (T_(pts), T_(labels).long(), T_(mats), T_(target + shift))
        a = programs.run(("masked_icp", 3, 6),
                         lambda *x: ticp.masked_icp_clusters(*x, 3, max_iterations=6), *args)
        b = ticp.masked_icp_clusters(*args, 3, max_iterations=6)
        assert torch.equal(a, b)


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


def _ragged_hinges():
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
    return frames, masks


@pytest.fixture(scope="module")
def icp_normals_runs():
    """``mlp_icp=True, use_normals=True`` on ragged hinge frames from the JAX
    package's segmentation and parameters: the JAX fused driver, and the
    port's fused driver, batched programs and eager loop."""
    frames, masks = _ragged_hinges()
    init_j = j_initial_segments(jax.random.PRNGKey(0), jnp.asarray(frames[0, 0]), K,
                                mask=jnp.asarray(masks[0, 0]), kmeans_iters=8,
                                use_normals=True, seed_mode="fps")
    keys = jax.random.split(jax.random.PRNGKey(1), 2 * S)
    mk = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])
    sp, ap = mk(keys[:S]), mk(keys[S:])
    common = dict(num_seg=K, hidden_dim=H, epochs=10, kmeans_iters=8, lr_step=1e-3,
                  lr_anchor=5e-4, icp_iterations=10, mlp_icp=True, use_normals=True)
    res_j = j_register_fused(JPoseRegressor("q", H), JConfig(chamfer_backend="xla", **common),
                             sp, ap, init_j, jnp.asarray(frames), jnp.asarray(masks))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    init_t = SegmentInit(*(T_(np.array(v)) for v in init_j[:3]), T_(masks[0, 0]))
    init_t = init_t._replace(labels=init_t.labels.long())
    args = (PoseRegressor("q", H, num_seqs=S), RegistrationConfig(**common),
            params_from_jax(to_np(sp), "q"), params_from_jax(to_np(ap), "q"), init_t,
            T_(frames), T_(masks))
    return (res_j, register_sequences_fused(*args), register_sequences_batched(*args),
            register_sequences_batched(*args, eager=True), masks)


def test_fused_registration_with_mlp_icp_and_normals_matches_jax(icp_normals_runs):
    """The port's fused driver (the whole frame-pair body, ICP and normals
    included, as one program) against the JAX package's at the tolerances of
    ``test_registration_with_mlp_icp_matches_jax``: step losses 1e-5
    relative, poses 1e-4, labels equal."""
    res_j, fused, _, _, _ = icp_normals_runs
    np.testing.assert_allclose(fused.step_losses.numpy(), np.asarray(res_j.step_losses),
                               rtol=1e-5)
    np.testing.assert_array_equal(fused.losses.numpy(), fused.step_losses.numpy())
    np.testing.assert_allclose(fused.matrices.numpy(), np.asarray(res_j.matrices), atol=1e-4)
    np.testing.assert_array_equal(fused.labels.numpy(), np.asarray(res_j.labels))


@pytest.mark.parametrize("driver", ["fused", "batched"])
def test_programs_with_mlp_icp_and_normals_equal_the_eager_loop(icp_normals_runs, driver):
    """The fused frame-pair program and the batched driver's phase programs
    (its ICP phase and its normals resample now among them) give the eager
    loop's results bit for bit."""
    _, fused, batched, eager, _ = icp_normals_runs
    got = {"fused": fused, "batched": batched}[driver]
    for f in eager._fields:
        assert torch.equal(getattr(got, f), getattr(eager, f)), f
