"""The algorithms of the port's geometry kernels (``csrc/geom.cu``:
``fps_kernel``, ``icp_kabsch_kernel`` with its 3x3 solve ``kabsch3``,
``pca_normals_kernel`` with ``sym_eig3_min``) on the CPU, and the programs
they make possible.

The kernels run only on the card; here their plain PyTorch models
(``tests/torch_geom_models.py``: the same fixed sweeps, rotations and sums
in the same order, the Kabsch step's cluster partition and reduction tree
included) are held against the JAX package, which computes the same
functions with ``jnp.linalg.svd``, ``jnp.linalg.eigh``, its ``scan`` step
and its ``fori_loop``.  Then the ICP through ``utils/programs.py`` against its eager
loop, and the fused registration with ``mlp_icp`` and ``use_normals`` (now
one frame-pair program) against the JAX package's fused driver.

Inputs are made with numpy from a seed and handed to both packages.
"""

import functools

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
from autourdf_tpu_torch.ops.chamfer import _gather_points
from autourdf_tpu_torch.ops.knn import PAD_COORD, nn_search
from autourdf_tpu_torch.registration import (
    RegistrationConfig,
    SegmentInit,
    register_sequences_batched,
    register_sequences_fused,
)
from autourdf_tpu_torch.utils import programs
from torch_geom_models import (ICP_COLLINEAR, fps_model, icp_cluster_blocks, icp_cluster_sums,
                               icp_kabsch_model, icp_step_inputs, kabsch3_model,
                               pca_normals_model, sym_eig3_min_model)

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
# icp_kabsch_kernel's 3x3 solve (kabsch3)
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
    monkeypatch.setattr(ticp, "_kabsch_rotation_plain", kabsch3_model)
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
# pca_normals_kernel's 3x3 solve (sym_eig3_min)
# ---------------------------------------------------------------------------

def test_eigen_model_normals_match_jax_up_to_sign(monkeypatch):
    """The port's ``estimate_normals`` with the kernel's Jacobi sweeps for the
    eigenvector against the JAX package's (``jnp.linalg.eigh``), as
    ``test_estimate_normals_matches_jax_up_to_sign``: |n_jax . n| > 1 - 1e-3
    where the two smallest eigenvalues are separated by more than 10%."""
    rng = np.random.default_rng(6)
    xy = rng.uniform(-1, 1, (1500, 2))
    pts = np.c_[xy, 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.004, 1500)].astype(np.float32)
    monkeypatch.setattr(tplane, "_smallest_eigenvector_plain", sym_eig3_min_model)
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
# icp_kabsch_kernel: the fused step (partition, sums, 3x3, freeze, moved)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("iterations",))
def _jax_icp(src, tgt, init, sm, tm, threshold, iterations):
    return jax.vmap(lambda s, t, i, a, b: jicp.icp_point_to_point(
        s, t, i, max_iterations=iterations, threshold=threshold, source_mask=a, target_mask=b,
        backend="xla"))(src, tgt, init, sm, tm)


def _model_icp(src, tgt, init, sm, tm, threshold, iterations, blocks):
    """The port's ICP loop with ``icp_kabsch_model`` for its step (the
    kernel's partition into ``blocks`` and its order of every sum)."""
    B = src.shape[0]
    tg = torch.where(tm[..., None], tgt, PAD_COORD)
    w = sm.to(torch.float32)
    total = torch.clamp_min(torch.sum(w, dim=1), 1e-12)
    crit = tuple(torch.tensor(v, dtype=torch.float32) for v in (threshold, 1e-6, 1e-6))
    T, done = init.clone(), torch.zeros(B, dtype=torch.bool)
    fit, rmse = torch.full((B,), -1.0), torch.full((B,), -1.0)
    moved = ticp._transform(src, T)
    for _ in range(iterations):
        d2, idx = nn_search(moved, tg, norm=2)
        moved, T, fit, rmse, done = icp_kabsch_model(src, moved, tg, idx, d2, w, total, crit, T,
                                                     fit, rmse, done, blocks)
    return T, fit, rmse


def _icp_case(case, B=3, n=240):
    """Clouds, a rotated, shifted and noisy copy (an RMSE well above
    round-off), small random inits and the masks
    of ``case``: "dense", "masked" (a tenth of either side off), "no_inlier"
    (the target beyond the threshold) or "empty_gate" (no target point)."""
    rng = np.random.default_rng(21)
    src = rng.normal(scale=[0.12, 0.08, 0.05], size=(B, n, 3)).astype(np.float32)
    rot = ScipyRot.from_rotvec(rng.normal(0, 0.08, (B, 3))).as_matrix()
    tgt = (np.einsum("bij,bnj->bni", rot, src) + [0.01, -0.02, 0.015]
           + rng.normal(0, 3e-3, src.shape)).astype(np.float32)
    init = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    init[:, :3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.02, (B, 3))).as_matrix()
    init[:, :3, 3] = rng.normal(0, 0.005, (B, 3))
    sm, tm = np.ones((B, n), bool), np.ones((B, n), bool)
    if case == "masked":
        sm, tm = rng.random((B, n)) > 0.1, rng.random((B, n)) > 0.1
    elif case == "no_inlier":
        tgt += 5.0
    elif case == "empty_gate":
        tm[:] = False
    return src, tgt, init, sm, tm


@pytest.mark.parametrize("case", ["dense", "masked", "no_inlier", "empty_gate"])
@pytest.mark.parametrize("blocks", [1, 2, 5, 8])
def test_icp_kabsch_model_matches_jax(blocks, case):
    """Eight ICP iterations with the fused step's model, its points split over
    1, 2, 5 or 8 blocks of a cluster and summed in the kernel's order,
    against the JAX package's ``icp_point_to_point`` (``_kabsch`` and its
    ``scan`` step): T to 1e-5 (fp32 round-off of two 3x3 solvers and of the
    sums in two orders), fitness equal (sums of 0/1 weights are exact),
    RMSE to 1e-5 relative.  With no inlier or an empty gate, T stays at its
    init exactly and fitness = RMSE = 0."""
    src, tgt, init, sm, tm = _icp_case(case)
    T, fit, rmse = _model_icp(T_(src), T_(tgt), T_(init), T_(sm), T_(tm), 0.2, 8, blocks)
    ref = _jax_icp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init), jnp.asarray(sm),
                   jnp.asarray(tm), 0.2, 8)
    np.testing.assert_allclose(T.numpy(), np.asarray(ref.transform), atol=1e-5)
    np.testing.assert_array_equal(fit.numpy(), np.asarray(ref.fitness))
    np.testing.assert_allclose(rmse.numpy(), np.asarray(ref.rmse), rtol=1e-5)
    if case in ("no_inlier", "empty_gate"):
        assert torch.equal(T, T_(init))
        assert not fit.any() and not rmse.any()


@pytest.mark.parametrize("B,n", [(1, 10000), (6, 2250), (2, 1024), (100, 4988), (18, 1500)])
def test_icp_kabsch_model_step_matches_the_plain_step(B, n):
    """One step of the model at the partition the kernel takes at the ICP
    sites' shapes (resim, link, polish, ``--mlp_icp`` with 5% of the
    weights, a 14-link build's link ICP) against the port's plain step:
    T to 1e-5 (but where H has rank 1: its rotation about the line is
    free), fitness equal, RMSE to 1e-5 relative, the next moved cloud to
    1e-5; the new rotation proper to 1e-6, also from a reflected H and at
    rank 2 and 1; frozen entries keep T, fitness and RMSE bit for bit, and
    with no inlier or an empty gate T stays as it was and fitness = RMSE =
    0."""
    args, (T, fit, rmse, done), kind = icp_step_inputs(B, n)
    got = icp_kabsch_model(*args, T, fit, rmse, done)
    state = [t.clone() for t in (T, fit, rmse, done)]
    moved = ticp._kabsch_step_plain(*args, *state)
    unique = T_(kind != ICP_COLLINEAR)
    np.testing.assert_allclose(got[1][unique].numpy(), state[0][unique].numpy(), atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), state[1].numpy())
    np.testing.assert_allclose(got[3].numpy(), state[2].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got[4].numpy(), state[3].numpy())
    np.testing.assert_allclose(got[0].numpy(), moved.numpy(), atol=1e-5)
    orth, det = _proper(got[1][:, :3, :3].numpy())
    assert orth <= 1e-6 and det <= 1e-6
    kept = T_(np.isin(kind, (2, 4, 5)))
    assert torch.equal(got[1][kept], T[kept])
    assert torch.equal(got[2][T_(kind == 4)], fit[T_(kind == 4)])
    empty = T_(np.isin(kind, (2, 5)))
    assert not got[2][empty].any() and not got[3][empty].any()
    assert icp_cluster_blocks(n) == ticp.cluster_blocks(n) == {10000: 5, 2250: 2, 1024: 1,
                                                              4988: 3, 1500: 1}[n]


@pytest.mark.parametrize("n", [1, 31, 257, 2049, 16385, 20000])
def test_icp_cluster_sums_cover_every_point_once(n):
    """The kernel's partition (at most 8 blocks, beyond 8 points a thread
    the rest re-read) counts every point once: integer weights sum exactly,
    and random values agree with a float64 sum to fp32 round-off."""
    rng = np.random.default_rng(n)
    ones = torch.ones(2, n, 1)
    v = T_(rng.normal(size=(2, n, 3)).astype(np.float32))
    for blocks in (None, 1, 3, 8):
        assert torch.equal(icp_cluster_sums(ones, blocks), torch.full((2, 1), float(n)))
        np.testing.assert_allclose(icp_cluster_sums(v, blocks).double().numpy(),
                                   v.double().sum(1).numpy(), atol=1e-4)


class _PreviousLoop:
    """``ops/icp.py _icp_loop`` as it was before its step moved into
    ``_kabsch_step_plain``: the reference of the CPU's bits."""

    @staticmethod
    def run(source, target, T, source_mask, target_mask, crit, max_iterations):
        threshold, relative_rmse, relative_fitness = crit
        B, dt = source.shape[0], source.dtype
        tgt = (target if target_mask is None
               else torch.where(target_mask[..., None], target, PAD_COORD))
        src_w = torch.ones(source.shape[:2], dtype=dt) if source_mask is None \
            else source_mask.to(dt)
        src_total = torch.clamp_min(torch.sum(src_w, dim=1), 1e-12)
        fitness, rmse = torch.full((B,), -1.0), torch.full((B,), -1.0)
        done = torch.zeros((B,), dtype=torch.bool)
        for _ in range(max_iterations):
            moved = source @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
            d2, idx = nn_search(moved, tgt, norm=2)
            dist = torch.sqrt(torch.clamp_min(d2, 0.0))
            w = src_w * (dist < threshold)
            T_new = ticp._kabsch(moved, _gather_points(tgt, idx), w) @ T
            w_sum = torch.sum(w, dim=1)
            fit_new = w_sum / src_total
            rmse_new = torch.sqrt(torch.sum(w * d2, dim=1) / torch.clamp_min(w_sum, 1e-12))
            conv = ((torch.abs(fit_new - fitness)
                     < relative_fitness * torch.clamp_min(fit_new, 1e-12))
                    & (torch.abs(rmse_new - rmse)
                       < relative_rmse * torch.clamp_min(rmse_new, 1e-12)))
            T = torch.where(done[:, None, None], T, T_new)
            fitness = torch.where(done, fitness, fit_new)
            rmse = torch.where(done, rmse, rmse_new)
            done = done | conv
        return T, fitness, rmse


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_icp_equals_the_previous_loop_bit_for_bit(masked):
    """On the CPU the ICP with its step in ``_kabsch_step_plain`` (T, fitness,
    RMSE and done updated in place, the next moved cloud returned) gives
    the previous loop's transforms, fitness and RMSE bit for bit, eagerly
    and as a program, with entries that converge and freeze on the way."""
    src, tgt, sm, tm = _icp_batch(7)
    init = torch.eye(4).repeat(3, 1, 1)
    init[:, :3, 3] = torch.tensor([0.004, -0.003, 0.002])
    masks = (T_(sm), T_(tm)) if masked else (None, None)
    crit = tuple(torch.tensor(v) for v in (0.2, 1e-4, 1e-4))
    ref = _PreviousLoop.run(T_(src), T_(tgt), init, *masks, crit, 25)
    for eager in (True, False):
        got = ticp.icp_point_to_point(T_(src), T_(tgt), init, max_iterations=25, threshold=0.2,
                                      source_mask=masks[0], target_mask=masks[1],
                                      relative_rmse=1e-4, relative_fitness=1e-4, eager=eager)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert torch.equal(init[:, :3, 3], torch.tensor([0.004, -0.003, 0.002]).expand(3, 3))


# ---------------------------------------------------------------------------
# pca_normals_kernel: the fused normals (sums, sym_eig3_min, flip)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [30, 8])
def test_pca_normals_model_matches_jax_and_the_plain_version(k):
    """The fused normals' model (each neighbourhood's mean and covariance
    summed in the kernel's order, ``sym_eig3_min_model``, the flip) on the
    port's top-k neighbours, against the JAX package's ``estimate_normals``
    as ``test_estimate_normals_matches_jax_up_to_sign`` holds the port's:
    |n_jax . n| > 1 - 1e-3 where the two smallest eigenvalues are 10% apart;
    against the plain version (gather, mean, einsum, ``eigh``, flip): |dot|
    > 1 - 1e-4 there and the same sign where |n_z| > 1e-3 (the flip); unit
    norm to 1e-6 and n_z >= 0 everywhere."""
    rng = np.random.default_rng(16)
    xy = rng.uniform(-1, 1, (1500, 2))
    pts = np.c_[xy, 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.004, 1500)].astype(np.float32)
    idx = tplane.neighbour_indices(T_(pts), k)
    got = pca_normals_model(T_(pts), idx).numpy()
    plain = tplane._pca_normals_plain(T_(pts), idx).numpy()
    n_j = np.asarray(jplane.estimate_normals(jnp.asarray(pts), k=k, backend="xla"))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert np.all(got[:, 2] >= 0)
    nb = pts[idx.numpy()].astype(np.float64)
    c = nb - nb.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c))
    sep = ((ev[:, 1] - ev[:, 0]) > 0.1 * ev[:, 1]) & ((ev[:, 1] - ev[:, 0]) > 1e-4 * ev[:, 2])
    assert sep.mean() > 0.8
    assert np.all(np.abs(np.sum(n_j * got, axis=1))[sep] > 1 - 1e-3)
    dots = np.sum(plain * got, axis=1)
    assert np.all(np.abs(dots)[sep] > 1 - 1e-4)
    steep = sep & (np.abs(plain[:, 2]) > 1e-3)
    assert np.all(dots[steep] > 0)


# ---------------------------------------------------------------------------
# fps_kernel's algorithm
# ---------------------------------------------------------------------------

def _cpu_dist(points, q):
    """The plain version's distance on the CPU (its own order of the sum)."""
    return torch.sum((points - q) ** 2, dim=1)


def _fps_inputs(case):
    """700 points with a duplicated block (equal scores) and the mask of
    ``case``; "one_block": only the indices [220, 264), the whole range of
    block 5 of 16."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.3, 0.3, (700, 3)).astype(np.float32)
    pts[350:420] = pts[:70]                              # duplicated points: equal scores
    mask = {"dense": None, "masked": rng.random(700) > 0.4,
            "few_valid": np.isin(np.arange(700), [5, 17, 400, 401]),
            "none_valid": np.zeros(700, bool),
            "one_block": (np.arange(700) >= 220) & (np.arange(700) < 264)}[case]
    return pts, mask


def _check_fps_model(case, k=60, **partition):
    pts, mask = _fps_inputs(case)
    m_t = None if mask is None else T_(mask)
    got = fps_model(T_(pts), k, m_t, dist=_cpu_dist, **partition)
    plain = tfps._fps_plain(T_(pts), k, m_t)
    ref = np.asarray(jfps.farthest_point_sample(jnp.asarray(pts), k,
                                                None if mask is None else jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "none_valid":
        assert not got.any()
    return got


@pytest.mark.parametrize("case", ["dense", "masked", "few_valid", "none_valid"])
def test_fps_packed_key_model_matches_the_picks(case):
    """The kernel's compaction and packed-key argmax (distance bits above
    the complement of the index) give the plain version's picks and the JAX
    package's, ties to the first index included; fewer valid points than k
    repeat the valid set, none gives all zeros."""
    _check_fps_model(case)


@pytest.mark.parametrize("case", ["dense", "masked", "few_valid", "none_valid", "one_block"])
@pytest.mark.parametrize("blocks", [1, 2, 16])
def test_fps_cluster_partition_model_matches_the_picks(blocks, case):
    """Whatever the number of blocks the points are split over (each owning
    a range of original indices, compacting its valid points stably and
    keying them on the compact index, its winner on the original one), the
    largest winner is the plain version's and the JAX package's pick, step 0
    included (every minimum at +inf: the first valid point)."""
    got = _check_fps_model(case, blocks=blocks)
    if case == "one_block":
        assert bool(((got >= 220) & (got < 264)).all())


@pytest.mark.parametrize("case", ["dense", "masked", "one_block"])
def test_fps_cluster_overflow_model_matches_the_picks(case):
    """A block's points beyond its shared capacity (streamed from device
    memory each step, keyed on the same compact index) change no pick."""
    _check_fps_model(case, blocks=16, capacity=5)
    _check_fps_model(case, blocks=2, capacity=100)


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
