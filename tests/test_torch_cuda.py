"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.  Marked ``cuda``; they skip where no CUDA device is present.
Run them on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Distances must be bit-identical and indices equal (the kernels keep the
plain version's order of operations and never contract into FMAs).
"""

import numpy as np
import pytest
import torch

from autourdf_tpu_torch.ops import _cuda, knn
from autourdf_tpu_torch.ops.chamfer import chamfer_distance

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU interpret mode")
    return torch.device("cuda")


def _clouds(S, N, M, ties, dev):
    rng = np.random.default_rng(N + M)
    x = rng.uniform(-0.3, 0.3, (S, N, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (S, M, 3)).astype(np.float32)
    if ties:
        y[:, M // 2:M // 2 + 20] = y[:, :20]
        x[:, N // 2:N // 2 + 20] = x[:, :20]
        x[:, -30:] = knn.PAD_COORD
        y[:, -20:] = knn.PAD_COORD
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1, 1, False), (2, 65, 130, True), (3, 700, 333, True),
                                   (5, 4418, 4985, False)])
def test_kernels_match_plain_on_card(cuda, shape, norm):
    S, N, M, ties = shape
    x, y = _clouds(S, N, M, ties, cuda)
    before = dict(_cuda.launch_counts)
    got = knn.nn_search_bidirectional(x, y, norm)
    ref = knn._nn_bidir_plain(x, y, norm)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    gmin = knn.nn_min_bidirectional(x, y, norm)
    rmin = knn._nn_min_bidir_plain(x, y, norm)
    assert torch.equal(gmin[0], rmin[0]) and torch.equal(gmin[1], rmin[1])
    assert _cuda.launch_counts["nn_bidir"] == before["nn_bidir"] + 1
    assert _cuda.launch_counts["nn_min_bidir"] == before["nn_min_bidir"] + 1


def test_chamfer_grad_on_card_matches_cpu(cuda):
    # the same matched neighbours; the card's reductions sum in another order
    x, y = _clouds(2, 700, 333, True, cuda)
    xm = torch.ones(2, 700, device=cuda)
    xm[:, -30:] = 0
    ym = torch.ones(2, 333, device=cuda)
    ym[:, -20:] = 0
    out = []
    for d in (cuda, torch.device("cpu")):
        xr = x.to(d).requires_grad_(True)
        loss = chamfer_distance(xr, y.to(d), xm.to(d), ym.to(d))
        (g,) = torch.autograd.grad(loss.sum(), xr)
        out.append((loss.detach().cpu(), g.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-7)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1, 1, False), (2, 65, 130, True), (3, 700, 333, True),
                                   (100, 500, 480, True), (2, 25600, 2048, False)])
def test_nn_kernel_matches_plain_on_card(cuda, shape, norm):
    S, N, M, ties = shape
    x, y = _clouds(S, N, M, ties, cuda)
    before = _cuda.launch_counts["nn"]
    got = knn.nn_search(x, y, norm)
    ref = knn._nn_plain(x, y, norm)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert _cuda.launch_counts["nn"] == before + 1
    # every target at the sentinel: index 0 at a finite distance
    d, i = knn.nn_search(x, torch.full_like(y, knn.PAD_COORD), norm)
    assert bool(torch.isfinite(d).all()) and int(i.abs().max()) == 0


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1, 1, False), (2, 65, 130, True), (3, 700, 333, True),
                                   (2, 4418, 4985, False)])
def test_accumulator_kernel_matches_plain_and_per_tile_on_card(cuda, shape, norm):
    S, N, M, ties = shape
    x, y = _clouds(S, N, M, ties, cuda)
    before = _cuda.launch_counts["nn_bidir_acc"]
    got = knn._nn_bidir_acc_cuda(x, y, norm)
    assert _cuda.launch_counts["nn_bidir_acc"] == before + 1
    for ref in (knn._nn_bidir_plain(x, y, norm), knn._nn_bidir_cuda(x, y, norm)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("norm", [1, 2])
def test_accumulator_tie_rule_under_many_blocks(cuda, norm):
    """A column whose minimum is reached by rows in many tiles: the packed
    64-bit atomicMin must return the smallest row whatever order the blocks
    ran in.  Every 37th x row is one point (which is also y[5]), and some x
    rows coincide with y points (zero distances: +0.0, never -0.0)."""
    rng = np.random.default_rng(3)
    N, M = 4000, 600
    x = rng.uniform(-0.3, 0.3, (2, N, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (2, M, 3)).astype(np.float32)
    x[:, 11::37] = y[:, 5:6]
    x[:, 100:140] = y[:, 300:340]
    x[0, :, :] = x[0, :1, :]            # sequence 0: every x row is the same point
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    for _ in range(5):
        got = knn._nn_bidir_acc_cuda(x, y, norm)
        ref = knn._nn_bidir_plain(x, y, norm)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(got[3][1, 5]) == 11 and bool((got[3][0] == 0).all())
        assert not bool(torch.signbit(got[2]).any())


def test_dispatch_by_scratch_size_on_card(cuda):
    x, y = _clouds(1, 20000, 20000, False, cuda)
    before = dict(_cuda.launch_counts)
    big = knn.nn_search_bidirectional(x, y, 1)
    assert _cuda.launch_counts["nn_bidir_acc"] == before["nn_bidir_acc"] + 1
    assert _cuda.launch_counts["nn_bidir"] == before["nn_bidir"]
    for a, b in zip(big, knn._nn_bidir_cuda(x, y, 1)):
        assert torch.equal(a, b)
    knn.nn_search_bidirectional(x[:, :5000], y[:, :5000], 1)
    assert _cuda.launch_counts["nn_bidir"] == before["nn_bidir"] + 2


def test_fps_and_icp_on_card_match_cpu(cuda):
    from autourdf_tpu_torch.ops.fps import farthest_point_sample
    from autourdf_tpu_torch.ops.icp import icp_point_to_point

    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32)
    pts[1500:1600] = pts[:100]          # duplicated points: equal scores
    mask = torch.from_numpy(np.arange(3000) >= 7)
    p = torch.from_numpy(pts)
    assert torch.equal(farthest_point_sample(p.to(cuda), 20, mask.to(cuda)).cpu(),
                       farthest_point_sample(p, 20, mask))
    # one ICP step for a batch; entry 2 has no inlier (target out of reach)
    src = torch.from_numpy(rng.normal(scale=0.1, size=(3, 800, 3)).astype(np.float32))
    tgt = src + torch.tensor([0.01, -0.02, 0.015])
    tgt[2] += 5.0
    out = [icp_point_to_point(src.to(d), tgt.to(d), max_iterations=1, threshold=0.5)
           for d in (cuda, torch.device("cpu"))]
    # the same correspondences; the Kabsch kernel's Jacobi SVD against
    # LAPACK's, and the sums, differ in the last bits
    torch.testing.assert_close(out[0].transform.cpu(), out[1].transform, rtol=0, atol=1e-5)
    assert torch.equal(out[0].transform[2].cpu(), torch.eye(4))


# --- the indexed sweep's design: ties across groups, sub-tiles, blocks, chunks ---

def _tie_clouds(S, N, M, dev, values=None):
    """An x row equal to a y point and copied 1, 2, 5, 33, 70, ... rows
    further on (one register group, several groups, sub-tiles, blocks); the y
    point copied 1, 3, 4, 9, 130, ... columns further on (one thread's group,
    several threads, passes, chunks); one y point reached by every 37th row."""
    rng = np.random.default_rng(7 * N + M)
    if values is None:
        x = rng.uniform(-0.3, 0.3, (S, N, 3))
        y = rng.uniform(-0.3, 0.3, (S, M, 3))
    else:
        x, y = rng.choice(values, (S, N, 3)), rng.choice(values, (S, M, 3))
    x, y = x.astype(np.float32), y.astype(np.float32)
    if M > 5:
        x[:, 11::37] = y[:, 5:6]
    for b, j in ((0, 0), (38, 6), (130, 65), (N // 2 + 1, M // 2 + 3), (N - 2, M - 2)):
        if not (0 <= b < N and 0 <= j < M):
            continue
        x[:, b] = y[:, j]
        for off in (1, 2, 5, 33, 70, 131, 259, 1027, 2051):
            if b + off < N:
                x[:, b + off] = x[:, b]
        for off in (1, 3, 4, 9, 130, 515, 1030, 2052, 2499, 2600):
            if j + off < M:
                y[:, j + off] = y[:, j]
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


# forced block shapes: (kernel, rows, cols (None: all of y), threads)
FORCED = [("nn_bidir", 32, None, 128), ("nn_bidir", 64, None, 128), ("nn_bidir", 256, None, 512),
          ("nn_bidir_acc", 32, 256, 128), ("nn_bidir_acc", 96, 1024, 256),
          ("nn_bidir_acc", 160, 2560, 128)]


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(2, 4989, 4987), (3, 130, 67), (1, 300, 257), (100, 300, 257),
                                   (1, 67, 5200)])
def test_indexed_kernels_tie_layouts_and_ragged_shapes_on_card(cuda, shape, norm):
    S, N, M = shape
    x, y = _tie_clouds(S, N, M, cuda)
    ref = knn._nn_bidir_plain(x, y, norm)
    plans = [knn.plan_bidir(S, N, M, _sms(cuda), k) for k in ("nn_bidir", "nn_bidir_acc")]
    plans += [knn.make_plan(S, N, M, _sms(cuda), k, r, c or M, t) for k, r, c, t in FORCED]
    for plan in plans:
        got = knn._launch_sweep(x, y, norm, plan)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), plan
        assert not bool(torch.signbit(got[0]).any() or torch.signbit(got[2]).any())


@pytest.mark.parametrize("norm", [1, 2])
def test_indexed_kernels_with_ties_everywhere_on_card(cuda, norm):
    # coordinates from a three-value set: almost every minimum is tied
    x, y = _tie_clouds(3, 700, 333, cuda, values=np.array([0.0, 0.5, 1.0]))
    ref = knn._nn_bidir_plain(x, y, norm)
    for fn in (knn._nn_bidir_cuda, knn._nn_bidir_acc_cuda):
        for _ in range(3):
            for a, b in zip(fn(x, y, norm), ref):
                assert torch.equal(a, b)


@pytest.mark.parametrize("norm", [1, 2])
def test_indexed_kernels_zero_distances_and_all_sentinel_targets_on_card(cuda, norm):
    x, y = _clouds(2, 700, 333, False, cuda)
    x[:, 100:300] = y[:, 50:250]                # x rows equal to y points
    sentinel = torch.full_like(y, knn.PAD_COORD)
    for fn in (knn._nn_bidir_cuda, knn._nn_bidir_acc_cuda):
        for target in (y, sentinel):
            got, ref = fn(x, target, norm), knn._nn_bidir_plain(x, target, norm)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
    assert int(knn._nn_bidir_cuda(x, sentinel, norm)[1].abs().max()) == 0


def test_per_tile_kernel_limit_goes_to_the_accumulator_by_rule_on_card(cuda):
    sms = _sms(cuda)
    largest = max(m for m in range(28000, 29500) if knn.plan_bidir(1, 100, m, sms, "nn_bidir"))
    for M, kernel in ((largest, "nn_bidir"), (largest + 1, "nn_bidir_acc")):
        x, y = _tie_clouds(1, 100, M, cuda)
        before = dict(_cuda.launch_counts)
        got = knn.nn_search_bidirectional(x, y, 1)
        assert _cuda.launch_counts[kernel] == before[kernel] + 1
        for a, b in zip(got, knn._nn_bidir_plain(x, y, 1)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        knn._nn_bidir_cuda(x, y, 1)             # 8 * M bytes of column state do not fit


# forced block shapes of the one-directional and the min-only kernel:
# (rows, cols (None: all of y; the min-only kernel alone may cut y), threads)
FORCED_LIGHT = [(32, None, 64), (32, None, 512), (512, None, 64), (96, None, 128),
                (256, None, 256), (64, 256, 128), (160, 1024, 64)]


def _light_plans(S, N, M, sms):
    plans = [knn.plan_bidir(S, N, M, sms, k) for k in ("nn", "nn_min_bidir")]
    for rows, cols, threads in FORCED_LIGHT:
        if cols is None:
            plans.append(knn.make_plan(S, N, M, sms, "nn", rows, M, threads))
        plans.append(knn.make_plan(S, N, M, sms, "nn_min_bidir", rows, cols or M, threads))
    return plans


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("shape", [(2, 4989, 4987), (3, 130, 67), (1, 300, 257), (100, 300, 257),
                                   (1, 67, 5200), (1, 20, 3), (2, 25600, 2048)])
def test_light_kernels_tie_layouts_and_ragged_shapes_on_card(cuda, shape, norm):
    S, N, M = shape
    x, y = _tie_clouds(S, N, M, cuda)
    refs = {"nn": knn._nn_plain(x, y, norm), "nn_min_bidir": knn._nn_min_bidir_plain(x, y, norm)}
    for plan in _light_plans(S, N, M, _sms(cuda)):
        before = _cuda.launch_counts[plan.kernel]
        got = knn._launch_sweep(x, y, norm, plan)
        assert _cuda.launch_counts[plan.kernel] == before + 1
        for a, b in zip(got, refs[plan.kernel], strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), plan
        assert not bool(torch.signbit(got[0]).any())


@pytest.mark.parametrize("norm", [1, 2])
def test_light_kernels_ties_everywhere_and_all_sentinel_targets_on_card(cuda, norm):
    # coordinates from a three-value set: almost every minimum is tied
    x, y = _tie_clouds(3, 700, 333, cuda, values=np.array([0.0, 0.5, 1.0]))
    sentinel = torch.full_like(y, knn.PAD_COORD)
    for target in (y, sentinel):
        refs = {"nn": knn._nn_plain(x, target, norm),
                "nn_min_bidir": knn._nn_min_bidir_plain(x, target, norm)}
        for plan in _light_plans(3, 700, 333, _sms(cuda)):
            got = knn._launch_sweep(x, target, norm, plan)
            for a, b in zip(got, refs[plan.kernel], strict=True):
                assert torch.equal(a, b), plan
    d, i = knn.nn_search(x, sentinel, norm)
    assert bool(torch.isfinite(d).all()) and int(i.abs().max()) == 0


def test_planned_shared_memory_matches_the_library_on_card(cuda):
    from autourdf_tpu_torch.ops import _cuda

    lib = _cuda.library("knn")
    for rows, cols, threads in ((32, 4988, 128), (64, 4988, 128), (96, 4988, 256),
                                (160, 20000, 512), (64, 2500, 128), (64, 28672, 256)):
        assert lib.knn_sweep_shared_bytes(rows, cols, threads) == \
            knn.sweep_shared_bytes(rows, cols, threads)


def test_light_sweep_shared_memory_matches_the_library_on_card(cuda):
    from autourdf_tpu_torch.ops import _cuda

    lib = _cuda.library("knn")
    for kernel in ("nn", "nn_min_bidir"):
        for rows, cols, threads in ((32, 4988, 64), (64, 4988, 128), (512, 2048, 64),
                                    (96, 10000, 512), (256, 50000, 256)):
            assert lib.knn_light_shared_bytes(kernel == "nn", rows, cols, threads) == \
                knn.light_shared_bytes(kernel, rows, cols, threads)


def test_planning_constants_match_the_library_on_card(cuda):
    from autourdf_tpu_torch.ops import _cuda

    lib = _cuda.library("knn")
    mirrored = (knn.SWEEP_SUB_ROWS, knn.SWEEP_GROUP_ROWS, knn.SWEEP_GROUP_COLS,
                knn.SWEEP_MAX_THREADS, knn.SHARED_LIMIT)
    assert tuple(lib.knn_sweep_constant(k) for k in range(5)) == mirrored
    assert lib.knn_sweep_constant(5) == -1


# --- the kinematic-chain fit ---

def _hinge_chain_inputs(T=6, step=0.2, seed=0):
    """A 2-link hinge about z (3 clusters a link, 40 points a cluster) as a
    CoordMap, noisy frames, and a joint estimate tilted 25 degrees off the
    axis: the hinge of the CPU parity tests, built without the JAX package."""
    from scipy.spatial.transform import Rotation as ScipyRot

    from autourdf_tpu_torch.joints.screw import JointEstimate
    from autourdf_tpu_torch.structure import CoordMap
    from autourdf_tpu_torch.structure.tree import LinkNode

    rng = np.random.default_rng(seed)
    offs = np.array([[-0.5, 0, 0], [-0.35, 0.1, 0], [-0.2, -0.1, 0.05],
                     [0.2, 0, 0], [0.4, 0.05, 0], [0.6, -0.05, 0.1]])
    local = rng.normal(scale=0.05, size=(6, 40, 3))
    mats = np.tile(np.eye(4), (T, 6, 1, 1))
    points, labels, clouds = [], [], []
    for t in range(T):
        rot = ScipyRot.from_rotvec([0, 0, t * step]).as_matrix()
        for k in range(6):
            mats[t, k, :3, :3] = rot if k >= 3 else np.eye(3)
            mats[t, k, :3, 3] = rot @ offs[k] if k >= 3 else offs[k]
        points.append(local.reshape(-1, 3))
        labels.append(np.repeat(np.arange(6), 40).astype(np.int32))
        clouds.append(np.concatenate([local[k] @ mats[t, k, :3, :3].T + mats[t, k, :3, 3]
                                      for k in range(6)]))
    cm = CoordMap.from_arrays(mats, points, labels, clouds)
    frames = (np.stack(clouds)[None] + rng.normal(scale=2e-3, size=(1, T, 240, 3))
              ).astype(np.float32)
    links = [LinkNode(id=0, cluster_idx={0, 1, 2}, parent_id=None, tree_id=0),
             LinkNode(id=1, cluster_idx={3, 4, 5}, parent_id=0, tree_id=1)]
    bad = ScipyRot.from_rotvec([0.44, 0, 0]).as_matrix() @ np.array([0, 0, 1.0])
    joints = [JointEstimate(parent_link=0, child_link=1, local_axis=bad, local_pos=np.zeros(4),
                            global_pos=np.array([0.02, -0.03, 0.0]), global_axis=bad)]
    return links, joints, [cm], frames


def test_refine_chain_on_card_matches_cpu(cuda):
    """50 steps of the chain fit on the card (accumulator search forward,
    scatter-add backward) against the same fit on the CPU.  The card's
    reductions sum in another order, so the fits are not bit-equal;
    they agree to 1e-4 relative in every step's loss and 1e-4 absolute in
    the axis, origin and angles (the CPU parity tests' geometry tolerance)."""
    from autourdf_tpu_torch.joints.chain import refine_chain

    links, joints, cms, frames = _hinge_chain_inputs()
    before = dict(_cuda.launch_counts)
    out = {d: refine_chain(links, joints, cms, frames, steps=50, points_per_link=256, device=d)[1]
           for d in ("cpu", cuda)}
    assert _cuda.launch_counts["nn_bidir_acc"] + _cuda.launch_counts["nn_bidir"] \
        >= before["nn_bidir_acc"] + before["nn_bidir"] + 50
    assert _cuda.launch_counts["nn_min_bidir"] >= before["nn_min_bidir"] + 2   # the freeze probe
    a, b = out[cuda], out["cpu"]
    np.testing.assert_allclose(a.step_losses, b.step_losses, rtol=1e-4)
    for f in ("axes", "origins", "thetas", "freeze_deltas"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-4, err_msg=f)
    assert a.step_losses[-1] < a.step_losses[0]


def test_refine_chain_on_card_matches_cpu_at_default_length(cuda):
    """The same hinge at the urdf stage's default 1,200 steps, card against
    CPU, as geometry (the CPU port and the JAX package agree there to 1.7e-5
    degrees in the axis, 2.5e-6 in the origin's distance from the axis line
    and 1.5e-6 relative in the loss; ``test_torch_chain_long.py``): the
    card's fit is held to the tolerances of that CPU test."""
    from autourdf_tpu_torch.joints.chain import refine_chain

    links, joints, cms, frames = _hinge_chain_inputs()
    out = {d: refine_chain(links, joints, cms, frames, steps=1200, points_per_link=256,
                           device=d)[1] for d in ("cpu", cuda)}
    a, b = out[cuda], out["cpu"]
    ang = np.degrees(np.arctan2(np.linalg.norm(np.cross(a.axes, b.axes), axis=1),
                                np.abs(np.sum(a.axes * b.axes, axis=1))))
    d = a.origins - b.origins
    line = np.linalg.norm(d - np.sum(d * b.axes, axis=1, keepdims=True) * b.axes, axis=1)
    gaps = dict(axis_deg=float(ang.max()), origin_line=float(line.max()),
                loss_rel=abs(a.loss - b.loss) / b.loss,
                theta=float(np.abs(a.thetas - b.thetas).max()))
    print(f"card against CPU, hinge, 1,200 steps: {gaps}")
    tol = dict(axis_deg=1e-3, origin_line=1e-5, loss_rel=1e-5, theta=1e-4)
    for key, t in tol.items():
        assert gaps[key] <= t, (key, gaps)
    assert a.step_losses.shape == (1200,) and a.loss < a.step_losses[0]


@pytest.mark.parametrize("n", [1, 33, 4988, 5000, 100003, 131072])
def test_batch_invariant_sums_on_card(cuda, n):
    """``ops.reduce.row_sums`` gives each row of a batch of 5 the bits it
    gets alone (the card's plain ``sum(-1)`` groups a row's additions by the
    number of rows), and so does a sequence's Chamfer, with and without its
    gradient."""
    from autourdf_tpu_torch.ops.reduce import row_sums

    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.normal(size=(5, n)).astype(np.float32)).to(cuda)
    got = row_sums(v)
    for i in range(5):
        assert torch.equal(row_sums(v[i:i + 1])[0], got[i]) and torch.equal(row_sums(v[i]), got[i])
    if n < 4988:
        return
    x = torch.from_numpy(rng.normal(scale=0.3, size=(5, n, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(scale=0.3, size=(5, 4096, 3)).astype(np.float32)).to(cuda)
    xm = torch.from_numpy(rng.random((5, n)) < 0.9).to(cuda)
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        fwd = chamfer_distance(x, y, xm)
    loss = chamfer_distance(xg, y, xm)
    loss.sum().backward()
    for i in range(5):
        xi = x[i:i + 1].clone().requires_grad_(True)
        with torch.no_grad():
            assert torch.equal(chamfer_distance(x[i:i + 1], y[i:i + 1], xm[i:i + 1])[0], fwd[i])
        alone = chamfer_distance(xi, y[i:i + 1], xm[i:i + 1])
        alone.sum().backward()
        assert torch.equal(alone[0], loss[i]) and torch.equal(xi.grad[0], xg.grad[i])


def test_registration_is_reproducible_on_card(cuda, tmp_path):
    """Two registrations of the same real scans at the same seed on the card
    give the same matrices, labels and losses, bit for bit."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mat, labels, loss, _ = smoke.register_real_scans_twice(cuda, str(tmp_path))
    print(f"max |matrix a - b| {mat}, labels that differ {labels}, max |loss a - b| {loss}")
    assert (mat, labels, loss) == (0.0, 0, 0.0)


def test_capture_on_card_matches_cpu(cuda):
    """The capture of the tracked wx200 estimate (20 cameras at 800 px) on
    the card against the CPU: the card's batched projection may round a
    camera coordinate differently, so a point on a pixel or depth edge can
    flip; at most 0.1% of the points do.  The farthest-point picks over the
    same visible points are equal (the card's kernel adds the three squares
    in another order than the CPU's loop, which moves no pick here)."""
    import os

    from autourdf_tpu_torch.ops.fps import farthest_point_sample
    from autourdf_tpu_torch.sim import KinematicEnv
    from autourdf_tpu_torch.sim.capture import visible_mask

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    gt = os.path.join(repo, "data_ab5", "urdf", "wx200_5_20_seg", "4_deg_20_cams.urdf")
    env = KinematicEnv.create(gt, dof=5, camera_rng=np.random.default_rng(0), device="cpu")
    env.set_joint_positions(np.array([0.3, -0.2, 0.4, 0.1, -0.3]))
    pts = torch.from_numpy(env.posed_surface_points())
    rig = env.rig
    rig_card = rig._replace(eyes=rig.eyes.to(cuda), targets=rig.targets.to(cuda),
                            ups=rig.ups.to(cuda))
    cpu = visible_mask(pts, rig, 800, 800).any(0)
    card = visible_mask(pts.to(cuda), rig_card, 800, 800).any(0).cpu()
    assert float((cpu != card).float().mean()) <= 1e-3
    sub = pts[cpu]
    assert torch.equal(farthest_point_sample(sub.to(cuda), 5000).cpu(),
                       farthest_point_sample(sub, 5000))


# ---------------------------------------------------------------------------
# the epoch's update (csrc/optim.cu) against the plain chain
# ---------------------------------------------------------------------------

def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, dev) for v in tree))
    return type(tree)(_to(v, dev) for v in tree)


def _update_fields(out):
    carry, masked = out
    return [carry.theta, *carry.opt, *carry.sched, *carry[3:], masked]


@pytest.mark.parametrize("mode,hidden,K", [("q", 512, 20), ("q", 20, 4), ("dq", 21, 7),
                                           ("6d", 64, 5)])
def test_epoch_update_kernel_matches_plain_on_card(cuda, mode, hidden, K):
    """Every field of the carry and the masked loss bit for bit, over three
    epochs of the five bookkeeping cases (improved, plateau cut, stop,
    frozen, below the threshold), at the main path's (5, 425,991) and at
    small odd widths; one launch an update."""
    from test_torch_epoch_update import FACTOR, PATIENCE, STOP_PATIENCE, bookkeeping_cases

    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration import optimizer as opt

    model = PoseRegressor(mode, hidden, num_seqs=5, generator=torch.Generator().manual_seed(2))
    carry, grads, loss, m2 = _to(bookkeeping_cases(model, K=K), cuda)
    assert carry.theta.shape[1] % 2 == 1
    steps = (STOP_PATIENCE, PATIENCE, FACTOR)
    for epoch in range(3):
        before = _cuda.launch_counts["epoch_update"]
        got = opt.epoch_update(carry, grads, loss, m2, *steps)
        assert _cuda.launch_counts["epoch_update"] == before + 1
        flat = torch.cat([g.reshape(5, -1) for g in grads], dim=1)
        ref = opt._epoch_update_plain(carry, flat, loss, m2, *steps)
        for i, (a, b) in enumerate(zip(_update_fields(got), _update_fields(ref))):
            assert a.dtype == b.dtype and torch.equal(a, b), (epoch, i)
        # the flat gradient as one piece takes the same path
        assert all(torch.equal(a, b) for a, b in zip(
            _update_fields(opt.epoch_update(carry, [flat], loss, m2, *steps)),
            _update_fields(got)))
        carry, loss = got[0], loss * torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0], device=cuda)


def test_epoch_update_bias_corrections_at_every_step_on_card(cuda):
    """The kernel's 1 - powf(b, t) against torch.pow's at 4,000 steps, each
    a sequence: theta, mu and nu bit for bit."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration import optimizer as opt

    S, K = 4000, 2
    rng = np.random.default_rng(5)
    model = PoseRegressor("q", 4, num_seqs=S, generator=torch.Generator().manual_seed(3),
                          device=cuda)
    theta = model.flat_params()
    carry = opt.train_init(theta, torch.eye(4, device=cuda).repeat(S, K, 1, 1), 2e-4)
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    carry = carry._replace(opt=opt.AdamState(1e-3 * f(*theta.shape), 1e-6 * f(*theta.shape).abs(),
                                             torch.arange(S, device=cuda, dtype=torch.int32) * 37))
    grads = [1e-2 * f(*p.shape) for p in model.unflatten(theta).values()]
    loss, m2 = f(S).abs(), f(S, K, 4, 4)
    got = opt.epoch_update(carry, grads, loss, m2, 200, 5, 0.7)
    ref = opt._epoch_update_plain(carry, torch.cat([g.reshape(S, -1) for g in grads], 1), loss,
                                  m2, 200, 5, 0.7)
    for a, b in zip(_update_fields(got), _update_fields(ref)):
        assert torch.equal(a, b)


def _training_case(dev):
    """5 sequences at the main path's widths (K=20, hidden 512, P =
    425,991) against random targets of 1,500 points: with an early stop
    after 6 epochs without a new best, sequences freeze along the way."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor

    S, K, N = 5, 20, 1500
    rng = np.random.default_rng(7)
    model = PoseRegressor("q", 512, num_seqs=S, generator=torch.Generator().manual_seed(4),
                          device=dev)
    mats = torch.eye(4, device=dev).repeat(S, K, 1, 1)
    mats[..., :3, 3] = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, K, 3))).float().to(dev)
    pts = torch.from_numpy(rng.normal(scale=0.03, size=(S, N, 3))).float().to(dev)
    labels = torch.from_numpy(rng.integers(0, K, (S, N))).to(dev)
    target = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, N, 3))).float().to(dev)
    return model, (model.flat_params(), mats, target, pts, labels)


def _plain_chain_on_cpu_only(monkeypatch):
    """Fail if a CUDA tensor reaches the plain chain or ``adam_update``."""
    from autourdf_tpu_torch.registration import optimizer as opt

    for name in ("_epoch_update_plain", "adam_update"):
        inner = getattr(opt, name)

        def cpu_only(*a, inner=inner, name=name, **k):
            assert not any(isinstance(t, torch.Tensor) and t.is_cuda for t in a), name
            return inner(*a, **k)

        monkeypatch.setattr(opt, name, cpu_only)


def test_graphed_training_with_epoch_update_equals_eager_on_card(cuda, monkeypatch):
    """300 epochs in chunk programs of 100 (captured, then replayed) against
    the eager loop: every output bit for bit, sequences frozen along the
    way, one update launch an epoch on every path, and no CUDA tensor
    reaches the plain chain or ``adam_update``."""
    from autourdf_tpu_torch.registration import optimizer as opt

    _plain_chain_on_cpu_only(monkeypatch)
    model, args = _training_case(cuda)
    res, launched = {}, {}
    for name in ("eager", "programs", "replayed"):
        before = _cuda.launch_counts["epoch_update"]
        res[name] = opt.train_pose_mlp(model, *args, epochs=300, stop_patience=6,
                                       dispatch_epochs=100, eager=name == "eager")
        torch.cuda.synchronize(cuda)
        launched[name] = _cuda.launch_counts["epoch_update"] - before
    for name in ("programs", "replayed"):
        for f in res[name]._fields:
            assert torch.equal(getattr(res[name], f), getattr(res["eager"], f)), (name, f)
    assert launched == {"eager": 300, "programs": 300, "replayed": 300}
    assert torch.isinf(res["eager"].loss_history[:, -1]).any()


def test_correspondence_rounds_take_the_epoch_update_on_card(cuda, monkeypatch):
    """The rounds family (``corr_every`` 5, ``train_epochs_rounds``) takes
    the kernel once an epoch, eager and as programs, and never the plain
    chain.  Its runs are not compared bit for bit: the gathered Chamfer's
    backward (``torch.gather``) adds with float atomics on the card."""
    from autourdf_tpu_torch.registration import optimizer as opt

    _plain_chain_on_cpu_only(monkeypatch)
    model, args = _training_case(cuda)
    for eager in (True, False):
        before = _cuda.launch_counts["epoch_update"]
        res = opt.train_pose_mlp(model, *args, epochs=300, stop_patience=6, corr_every=5,
                                 dispatch_epochs=100, eager=eager)
        torch.cuda.synchronize(cuda)
        assert _cuda.launch_counts["epoch_update"] - before == 300
        assert torch.isfinite(res.best_loss).all()


# ---------------------------------------------------------------------------
# device programs (utils/programs.py): captured graphs against the eager loops
# ---------------------------------------------------------------------------

def _small_registration(dev, masked: bool):
    """2 sequences x 3 frames of a hinge (about 300 points a frame, ragged
    and sentinel-padded when ``masked``), K=4, hidden 32, with the init and
    weights drawn from seeds."""
    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.registration import initial_segments

    rng = np.random.default_rng(3)
    base = rng.uniform([-0.6, -0.15, -0.1], [-0.1, 0.15, 0.1], size=(160, 3))
    arm = rng.uniform([0.1, -0.1, -0.08], [0.7, 0.1, 0.08], size=(160, 3))
    frames = np.full((2, 3, 320, 3), knn.PAD_COORD, np.float32)
    masks = np.zeros((2, 3, 320), bool)
    for s, step in enumerate((0.10, 0.16)):
        for t in range(3):
            a = t * step
            rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
            cloud = np.concatenate([base, arm @ rot.T])
            n = 320 - (7 * (s + t) if masked else 0)
            frames[s, t, :n] = cloud[rng.permutation(320)[:n]]
            masks[s, t, :n] = True
    ft = torch.from_numpy(frames).to(dev)
    mt = torch.from_numpy(masks).to(dev) if masked else None
    init = initial_segments(torch.Generator(device=dev).manual_seed(0), ft[0, 0], 4,
                            mask=None if mt is None else mt[0, 0], kmeans_iters=8, n_init=2)
    gen = torch.Generator().manual_seed(1)
    model = PoseRegressor("q", 32, num_seqs=2, generator=gen, device=dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    return model, params, init, ft, mt


@pytest.mark.parametrize("masked", [True, False], ids=["ragged", "dense"])
def test_graphed_registration_equals_eager_on_card(cuda, masked):
    """The batched driver's phase programs (chunks of 25 and 5 epochs) and
    the fused frame-pair program, replayed as CUDA graphs, give the eager
    loop's matrices, labels and losses bit for bit, with its launch counts."""
    from autourdf_tpu_torch.registration import (RegistrationConfig, register_sequences_batched,
                                                 register_sequences_fused)

    model, params, init, ft, mt = _small_registration(cuda, masked)
    cfg = RegistrationConfig(num_seg=4, hidden_dim=32, epochs=30, kmeans_iters=8,
                             dispatch_epochs=25)
    out, launched = {}, {}
    for name, run in (("eager", lambda: register_sequences_batched(
                           model, cfg, params, params, init, ft, mt, eager=True)),
                      ("batched", lambda: register_sequences_batched(
                           model, cfg, params, params, init, ft, mt)),
                      ("fused", lambda: register_sequences_fused(
                           model, cfg, params, params, init, ft, mt))):
        for _ in range(2):      # the first graphed call captures, the second only replays
            before = dict(_cuda.launch_counts)
            out[name] = run()
            torch.cuda.synchronize()
            launched[name] = {k: _cuda.launch_counts[k] - before[k] for k in before}
    for name in ("batched", "fused"):
        for f in out["eager"]._fields:
            assert torch.equal(getattr(out[name], f), getattr(out["eager"], f)), (name, f)
        assert launched[name] == launched["eager"], (name, launched)
    assert launched["eager"]["nn_bidir"] + launched["eager"]["nn_bidir_acc"] == 2 * 2 * 30


def test_graphed_chain_fit_equals_eager_on_card(cuda):
    """60 chain-fit steps in chunk programs of 25 (two graphs: 25 and 10
    steps) against the eager step loop: axes, origins, angles, every step's
    loss and the freeze deltas bit for bit, with the same launch counts."""
    from autourdf_tpu_torch.joints.chain import refine_chain

    links, joints, cms, frames = _hinge_chain_inputs()
    res, launched = {}, {}
    for name, kw in (("eager", dict(eager=True)), ("graphed", dict(dispatch_steps=25)),
                     ("replayed", dict(dispatch_steps=25))):
        before = dict(_cuda.launch_counts)
        res[name] = refine_chain(links, joints, cms, frames, steps=60, points_per_link=256,
                                 device=cuda, **kw)[1]
        launched[name] = {k: _cuda.launch_counts[k] - before[k] for k in before}
    for name in ("graphed", "replayed"):
        for f in ("axes", "origins", "thetas", "step_losses", "freeze_deltas"):
            np.testing.assert_array_equal(getattr(res[name], f), getattr(res["eager"], f),
                                          err_msg=f"{name} {f}")
        assert launched[name] == launched["eager"], (name, launched)


def _revolute_case(dev, T=6, P=512, seed=0):
    """A child cloud turning about a tilted axis, ragged observations, an
    axis and origin guess off the truth."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    x = rng.uniform([-0.1, -0.05, -0.05], [0.4, 0.05, 0.05], (P, 3)).astype(np.float32)
    u, o = np.array([0.2, 0.0, 1.0]) / np.hypot(0.2, 1.0), np.array([0.05, 0.02, 0.0])
    parent_T = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    parent_T[:, :3, 3] = [0.1, -0.2, 0.3]
    obs = np.zeros((T, P, 3), np.float32)
    mask = np.zeros((T, P), bool)
    for t in range(T):
        n = P - 37 * t
        Rm = Rotation.from_rotvec(u * 0.12 * t).as_matrix()
        obs[t, :n] = ((x[:n] - o) @ Rm.T + o + parent_T[t, :3, 3]
                      + rng.normal(scale=2e-3, size=(n, 3)))
        mask[t, :n] = True
    u0 = np.array([0.3, 0.1, 0.9], np.float32)
    u0 /= np.linalg.norm(u0)
    arrays = (parent_T, obs, mask, u0, np.zeros(3, np.float32),
              (0.1 * np.arange(T)).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def test_revolute_fit_programs_equal_eager_on_card(cuda):
    """120 steps of the revolute fit in chunk programs of 50 (graphs of 50
    and 20 steps), then replayed, against the eager step loop: axis, origin,
    angles and loss bit for bit, with the same launches."""
    from autourdf_tpu_torch.joints.refine import fit_revolute_joint

    args = _revolute_case(cuda)
    res, launched = {}, {}
    for name in ("eager", "programs", "replayed"):
        before = dict(_cuda.launch_counts)
        res[name] = fit_revolute_joint(*args, steps=120, eager=name == "eager")
        torch.cuda.synchronize(cuda)
        launched[name] = {k: _cuda.launch_counts[k] - before[k] for k in before}
    for name in ("programs", "replayed"):
        for f in res[name]._fields:
            assert torch.equal(getattr(res[name], f), getattr(res["eager"], f)), (name, f)
        assert launched[name] == launched["eager"], (name, launched)
    assert launched["eager"]["nn_bidir"] + launched["eager"]["nn_bidir_acc"] == 120
    assert float(res["programs"].thetas[0]) == 0.0 and torch.isfinite(res["programs"].loss)


def test_dp_sp_train_step_programs_equal_eager_on_card(cuda):
    """``train_step_dp_sp`` with four gloo ranks on the card: the programs
    (captured, then replayed) give the eager loop's best matrices and losses
    on every rank, bit for bit, with the same launches, and those of the
    single-process ``train_init`` + ``train_epochs``."""
    import torch_parallel_ranks as ranks

    from autourdf_tpu_torch.models.regmlp import PoseRegressor
    from autourdf_tpu_torch.parallel import launch
    from autourdf_tpu_torch.registration.optimizer import train_epochs, train_init

    S, N, M, K, H = 4, 300, 256, 3, 64
    rng = np.random.default_rng(13)
    mats = np.tile(np.eye(4, dtype=np.float32), (S, K, 1, 1))
    mats[:, :, :3, 3] = rng.normal(scale=0.2, size=(S, K, 3))
    params = {k: v.detach().numpy() for k, v in PoseRegressor(
        "q", H, num_seqs=S, generator=torch.Generator().manual_seed(1)).named_parameters()}
    step = dict(S=S, H=H, epochs=40, params=params, mats=mats,
                targets=rng.normal(scale=0.3, size=(S, M, 3)).astype(np.float32),
                points=rng.normal(scale=0.1, size=(S, N, 3)).astype(np.float32),
                labels=rng.integers(0, K, size=(S, N)).astype(np.int64))
    results = launch.run(ranks.dp_sp_train_step_both_ways, 4, (step,), device="cuda")

    model = PoseRegressor("q", H, num_seqs=S, device=cuda)
    theta = model.flat_params({k: torch.from_numpy(v) for k, v in params.items()})
    m = torch.from_numpy(mats).to(cuda)
    carry = train_init(theta, m, 2e-4)
    carry, _ = train_epochs(model, carry, m, *(torch.from_numpy(step[k]).to(cuda)
                                               for k in ("targets", "points", "labels")), 40)
    for r in results:
        for name in ("programs", "replayed", "eager"):
            best_m, best_l, counts = r[name]
            assert torch.equal(best_m, carry.best_m.cpu()), name
            assert torch.equal(best_l, carry.best_loss.cpu()), name
            assert counts == r["eager"][2], (name, counts)
        assert r["eager"][2]["nn_bidir"] + r["eager"][2]["nn_bidir_acc"] == 40


def test_program_launch_counts_on_card(cuda):
    """A program that launches the indexed search counts one launch a call:
    the warm-up's and the capture's launches are taken back out."""
    from autourdf_tpu_torch.utils import programs

    x, y = _clouds(2, 700, 333, True, cuda)
    prog = programs.Program(lambda a, b: knn.nn_search_bidirectional(a, b, 1), "search")
    before = dict(_cuda.launch_counts)
    for i in range(7):
        got = prog(x + i, y)
        ref = knn._nn_bidir_plain(x + i, y, 1)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert _cuda.launch_counts["nn_bidir"] - before["nn_bidir"] == 7
    assert prog.stats["launches"] == {"nn_bidir": 1} and prog.stats["capture_s"] > 0


def test_program_that_waits_on_the_host_raises_on_card(cuda):
    """A body that reads a value back to the host cannot be captured: the
    program raises at every call (after its warm-up, an eager run whose
    result is dropped) and never returns an eager result."""
    from autourdf_tpu_torch.utils import programs

    x = torch.arange(8.0, device=cuda)
    prog = programs.Program(lambda a: a * float(a.sum()), "waits")
    for _ in range(2):
        with pytest.raises(RuntimeError):
            prog(x)
        assert prog._graph is None and prog._outputs is None
    torch.cuda.synchronize()
    assert torch.equal(x * 2, torch.arange(0.0, 16.0, 2.0, device=cuda))   # the card still works


@pytest.fixture
def spans_on():
    from autourdf_tpu_torch.utils import telemetry

    telemetry.enable()
    telemetry.collect()
    yield telemetry
    telemetry.enable(False)
    telemetry.collect()


def test_device_span_of_a_replay_on_card(cuda, spans_on):
    """A replay's device interval is > 0 and no longer than its host
    interval plus the time the device took to drain after it; a span waits
    for nothing: its end event is still pending behind a sleeping kernel."""
    import time

    from autourdf_tpu_torch.utils import programs

    a = torch.randn(512, 512).to(cuda)   # the card's generator may be mid-capture after a failed one
    prog = programs.Program(lambda x: ((x @ x).relu() @ x,), "span-replay")
    prog(a)
    torch.cuda.synchronize()
    spans_on.collect()
    with spans_on.span("root", device=True):
        prog(a)
        t_exit = time.perf_counter_ns()
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter_ns() - t_exit) / 1e6
    root, replay = spans_on.collect()
    assert replay["name"] == "program.replay" and replay["parent"] == 0
    dev_ms = replay["device_end_ms"] - replay["device_start_ms"]
    host_ms = (replay["end_ns"] - replay["start_ns"]) / 1e6
    assert 0 < dev_ms <= host_ms + drain_ms
    assert root["device_start_ms"] == 0

    with spans_on.span("root", device=True):
        torch.cuda._sleep(200_000_000)
        with spans_on.span("behind", device=True) as sp:
            pass
        pending = not sp.events[1].query()
    assert pending
    assert [s["name"] for s in spans_on.collect()] == ["root", "behind"]


def test_span_during_a_capture_records_no_event_on_card(cuda, spans_on):
    from autourdf_tpu_torch.utils import programs

    def fn(x):
        with spans_on.span("inside", device=True):
            return (x * 2 + 1,)

    x = torch.arange(8.0, device=cuda)
    with spans_on.span("root", device=True):
        prog = programs.Program(fn, "span-in-capture")
        for i in range(3):
            (out,) = prog(x + i)
            assert torch.equal(out, (x + i) * 2 + 1)
    spans = spans_on.collect()
    names = [s["name"] for s in spans]
    # the warm-up runs fn on a side stream (timed), the capture runs it once
    # (not timed), the replays run no Python
    assert names.count("inside") == 2 and names.count("program.replay") == 3
    warm, captured = [s for s in spans if s["name"] == "inside"]
    assert spans[warm["parent"]]["name"] == "program.warmup" and "device_start_ms" in warm
    assert spans[captured["parent"]]["name"] == "program.capture"
    assert "device_start_ms" not in captured
    assert spans[captured["parent"]]["attrs"]["nodes"] == prog.stats["nodes"]


def test_warm_up_seconds_on_card(cuda):
    """``warm_s`` is the family's first warm-up; a second program of the
    family (another shape) warms up no more."""
    from autourdf_tpu_torch.utils import programs

    made = dict(programs.counters)
    first = programs.Program(lambda x: (x.sin() * 2,), "warm-seconds")
    first(torch.ones(16, device=cuda))
    second = programs.Program(lambda x: (x.sin() * 2,), "warm-seconds")
    second(torch.ones(32, device=cuda))
    assert first.stats["warm_s"] > 0 and second.stats["warm_s"] == 0
    assert first.stats["epochs"] is None
    assert programs.counters["warmups"] - made["warmups"] == 1
    assert programs.counters["captures"] - made["captures"] == 2
    assert programs.counters["replays"] - made["replays"] == 2


# ---------------------------------------------------------------------------
# the geometry kernels (csrc/geom.cu) and the programs they make possible
# ---------------------------------------------------------------------------

# case -> (points, picks): the cloud beyond a block's shared capacity (every
# block streams part of its range), ranges past 16-bit offsets (the winners'
# original indices from device memory), fewer points than blocks, one pick,
# more picks than valid points
_FPS_SIZES = {"overflow": (400003, 2000), "wide": (1100003, 100), "tiny": (11, 20),
              "k1": (3000, 1), "k_above_valid": (3000, 400)}


def _fps_case(case: str, n: int = 3000):
    n, k = _FPS_SIZES.get(case, (n, 400))
    rng = np.random.default_rng(21)
    pts = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    if n >= 200:
        pts[n // 2:n // 2 + 100] = pts[:100]          # duplicated points: equal scores
    idx = np.arange(n)
    mask = {"dense": None, "masked": rng.random(n) > 0.5,
            "first_masked": idx >= 37,
            "few_valid": np.isin(idx, [3, 900, 901, 2500]),
            "none_valid": np.zeros(n, bool),
            "overflow": rng.random(n) > 0.02, "wide": rng.random(n) > 0.3,
            "tiny": idx != 4, "k1": idx >= 5,
            "k_above_valid": idx % 60 == 7,
            "one_block": (idx >= 5 * 188) & (idx < 6 * 188)}[case]   # block 5's range
    return torch.from_numpy(pts), None if mask is None else torch.from_numpy(mask), k


def test_fps_sum_order_on_card(cuda):
    """``torch.sum((p - q) ** 2, dim=1)`` on the card adds the squares as
    (x^2 + z^2) + y^2, the order fps_kernel follows (the CPU adds them
    left to right)."""
    from torch_geom_models import fps_dist_kernel_order

    p, _, _ = _fps_case("dense", 100003)
    p = p.to(cuda)
    for q in (p[0], p[77], p[-1]):
        assert torch.equal(torch.sum((p - q) ** 2, dim=1), fps_dist_kernel_order(p, q))


@pytest.mark.parametrize("case", ["dense", "masked", "first_masked", "few_valid", "none_valid",
                                  "overflow", "wide", "tiny", "k1", "k_above_valid",
                                  "one_block"])
def test_fps_kernel_matches_plain_on_card(cuda, case):
    """One launch of fps_kernel (one cluster of 16 blocks) gives the plain
    loop's picks on the card, bit for bit: ties to the first index, the
    first valid point first, repeats when fewer than k are valid, all zeros
    when none is; with a block's range beyond its shared memory, with empty
    blocks, one pick, and every valid point in one block's range."""
    from autourdf_tpu_torch.ops import fps

    pts, mask, k = _fps_case(case)
    p, m = pts.to(cuda), None if mask is None else mask.to(cuda)
    before = _cuda.launch_counts["fps"]
    got = fps.farthest_point_sample(p, k, m)
    assert _cuda.launch_counts["fps"] == before + 1
    assert got.dtype == torch.int64 and got.is_cuda
    assert torch.equal(got, fps._fps_plain(p, k, m))
    if case == "none_valid":
        assert not got.any()
    if case == "one_block":
        assert bool(((got >= 5 * 188) & (got < 6 * 188)).all())


def test_fps_cluster_setup_on_card(cuda):
    """The card holds fps_kernel's cluster of 16 blocks, the kernel spills
    nothing, a capture's 200,000 surface points fit in the blocks' shared
    memory and 400,003 overflow it."""
    from autourdf_tpu_torch.ops import fps

    setup = fps.cluster_setup(cuda)
    assert setup.max_clusters >= 1 and setup.local_bytes == 0
    assert setup.shared_max > 200 * 1024
    cap, nbytes = fps.shared_plan(cuda, 200000)
    assert cap == 12500 and nbytes <= setup.shared_max
    cap, nbytes = fps.shared_plan(cuda, 400003)
    assert cap < 25001 and nbytes <= setup.shared_max


@pytest.mark.parametrize("B,n", [(1, 10000), (6, 2250), (2, 1024), (100, 4988), (18, 1500),
                                 (2, 20000)])
def test_icp_kabsch_kernel_on_card(cuda, B, n):
    """icp_kabsch_kernel (one launch) against its plain step (svd + det) at
    the ICP sites' shapes, and at 20,000 points (beyond a thread's 8 points
    in registers: the rest read again in the second pass), with masked,
    no-inlier, empty-gate, reflected, frozen, planar (H of rank 2) and, at
    B = 18 and 100, collinear (rank 1) entries: T to 1e-5 where the rotation
    is unique (all but the collinear), fitness equal, RMSE to 1e-5
    relative, the next moved cloud to 1e-5, the rotation proper to 1e-6;
    entries with nothing to fit or frozen keep T; and equal to its model
    (tests/torch_geom_models.py) bit for bit."""
    from autourdf_tpu_torch.ops import icp
    from torch_geom_models import ICP_COLLINEAR, icp_kabsch_model, icp_step_inputs

    args, state, kind = icp_step_inputs(B, n)
    model = icp_kabsch_model(*args, *state)
    on_card = [tuple(c.to(cuda) for c in a) if isinstance(a, tuple) else a.to(cuda) for a in args]
    got = [t.to(cuda).clone() for t in state]
    ref = [t.to(cuda).clone() for t in state]
    before = _cuda.launch_counts["icp_kabsch"]
    moved = icp.kabsch_step(*on_card[:1], on_card[1].clone(), *on_card[2:], *got)
    assert _cuda.launch_counts["icp_kabsch"] == before + 1
    ref_moved = icp._kabsch_step_plain(*on_card, *ref)
    unique = torch.from_numpy(kind != ICP_COLLINEAR).to(cuda)
    assert float((got[0] - ref[0]).abs()[unique].max()) <= 1e-5
    assert torch.equal(got[1], ref[1]) and torch.equal(got[3], ref[3])
    assert float(((got[2] - ref[2]).abs() / ref[2].abs().clamp_min(1e-30)).max()) <= 1e-5
    assert float((moved - ref_moved).abs().max()) <= 1e-5
    R = got[0][:, :3, :3].double()
    assert float((R @ R.transpose(-1, -2) - torch.eye(3, device=cuda, dtype=torch.float64))
                 .abs().max()) <= 1e-6
    assert float((torch.linalg.det(R) - 1).abs().max()) <= 1e-6
    kept = torch.from_numpy(np.isin(kind, (2, 4, 5))).to(cuda)
    assert torch.equal(got[0][kept], state[0].to(cuda)[kept])
    for a, b in zip((moved, *got), model):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n,k", [(33, 30), (33, 7), (129, 30), (4988, 30)])
def test_pca_normals_kernel_on_card(cuda, n, k):
    """pca_normals_kernel (one launch) against its plain version (gather,
    mean, einsum, eigh, flip) on the k-neighbourhoods of a bumpy sheet, a
    ragged last block (33 points) and an odd count of a block's indices (1 x
    7) included: |dot| > 1 - 1e-4 where the two smallest eigenvalues are
    10% apart, unit norm to 1e-6, n_z >= 0; equal to its model bit for
    bit."""
    from autourdf_tpu_torch.ops import plane
    from torch_geom_models import pca_normals_model

    rng = np.random.default_rng(n)
    xy = rng.uniform(-1, 1, (n, 2))
    pts = np.c_[xy, 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.004, n)]
    pts = torch.from_numpy(pts.astype(np.float32))
    idx = plane.neighbour_indices(pts, k)
    before = _cuda.launch_counts["pca_normals"]
    v = plane.pca_normals(pts.to(cuda), idx.to(cuda))
    assert _cuda.launch_counts["pca_normals"] == before + 1
    ref = plane._pca_normals_plain(pts.to(cuda), idx.to(cuda))
    c = pts[idx] - pts[idx].mean(1, keepdim=True)
    e = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", c, c).double())
    gap = e[:, 1] - e[:, 0]
    sep = ((gap > 0.1 * e[:, 1]) & (gap > 1e-4 * e[:, 2])).to(cuda)
    assert bool((((v * ref).sum(1).abs() > 1 - 1e-4) | ~sep).all())
    assert float((v.norm(dim=1) - 1).abs().max()) <= 1e-6
    assert bool((v[:, 2] >= 0).all())
    assert torch.equal(v.cpu(), pca_normals_model(pts, idx))


@pytest.mark.parametrize("masked", [False, True])
def test_graphed_icp_equals_eager_on_card(cuda, masked):
    """icp_point_to_point as a program (captured, then replayed on other
    inputs and at other thresholds) gives its eager loop's transforms,
    fitness and RMSE bit for bit, with the same launches; one capture serves
    every threshold."""
    from autourdf_tpu_torch.ops import icp
    from autourdf_tpu_torch.utils import programs

    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.normal(scale=0.1, size=(6, 700, 3)).astype(np.float32)).to(cuda)
    tgt = src.flip(1) + torch.tensor([0.01, -0.02, 0.015], device=cuda)
    kw = dict(max_iterations=20)
    if masked:
        kw.update(source_mask=torch.from_numpy(rng.random((6, 700)) > 0.1).to(cuda),
                  target_mask=torch.from_numpy(rng.random((6, 700)) > 0.1).to(cuda))
    programs.clear()
    captured = len(programs.captures)
    for shift, threshold in ((0.0, 0.3), (0.005, 0.05), (0.01, 0.3)):
        kw["threshold"] = threshold
        before = dict(_cuda.launch_counts)
        a = icp.icp_point_to_point(src, tgt + shift, **kw)
        mid = dict(_cuda.launch_counts)
        b = icp.icp_point_to_point(src, tgt + shift, eager=True, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert {k: mid[k] - before[k] for k in mid} == \
            {k: _cuda.launch_counts[k] - mid[k] for k in mid}
        assert _cuda.launch_counts["icp_kabsch"] - mid["icp_kabsch"] == 20
    assert len(programs.captures) == captured + 1


def test_graphed_registration_with_mlp_icp_and_normals_equals_eager_on_card(cuda, monkeypatch):
    """--mlp_icp --normal: the batched driver's programs (its ICP phase and
    its normals resample among them) and the fused frame-pair program give
    the eager loop's results bit for bit, with the same launches; no path
    calls PyTorch's svd, det or eigh."""
    from autourdf_tpu_torch.registration import (RegistrationConfig, register_sequences_batched,
                                                 register_sequences_fused)

    model, params, init, ft, mt = _small_registration(cuda, True)

    def forbidden(*a, **k):
        raise AssertionError("a torch.linalg solver was called on the card")

    for fn in ("svd", "det", "eigh"):
        monkeypatch.setattr(torch.linalg, fn, forbidden)
    cfg = RegistrationConfig(num_seg=4, hidden_dim=32, epochs=30, kmeans_iters=8,
                             dispatch_epochs=25, mlp_icp=True, icp_iterations=10,
                             use_normals=True)
    out, launched = {}, {}
    for name, run in (("eager", lambda: register_sequences_batched(
                           model, cfg, params, params, init, ft, mt, eager=True)),
                      ("batched", lambda: register_sequences_batched(
                           model, cfg, params, params, init, ft, mt)),
                      ("fused", lambda: register_sequences_fused(
                           model, cfg, params, params, init, ft, mt))):
        for _ in range(2):
            before = dict(_cuda.launch_counts)
            out[name] = run()
            torch.cuda.synchronize()
            launched[name] = {k: _cuda.launch_counts[k] - before[k] for k in before}
    for name in ("batched", "fused"):
        for f in out["eager"]._fields:
            assert torch.equal(getattr(out[name], f), getattr(out["eager"], f)), (name, f)
        assert launched[name] == launched["eager"], (name, launched)
    assert launched["eager"]["icp_kabsch"] == 2 * 10 and launched["eager"]["pca_normals"] == 2 * 2


def test_capture_reads_nothing_back_on_card(cuda):
    """capture_cloud (projection, splat, visibility, noise, farthest-point
    pick) captures into a CUDA graph, which fails on any read back to the
    host, and the replay gives the eager capture's cloud."""
    import os

    from autourdf_tpu_torch.sim import KinematicEnv
    from autourdf_tpu_torch.sim.capture import capture_cloud
    from autourdf_tpu_torch.utils import programs

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    gt = os.path.join(repo, "data_ab5", "urdf", "wx200_5_20_seg", "4_deg_20_cams.urdf")
    env = KinematicEnv.create(gt, dof=5, camera_rng=np.random.default_rng(0), device=cuda)
    env.set_joint_positions(np.array([0.3, -0.2, 0.4, 0.1, -0.3]))
    pts = torch.from_numpy(env.posed_surface_points()).to(cuda)
    prog = programs.Program(lambda p: capture_cloud(p, env.rig, num_points=2000), "capture")
    got = prog(pts)
    ref = capture_cloud(pts, env.rig, num_points=2000)
    assert prog._graph is not None
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
