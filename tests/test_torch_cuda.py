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


def _cross_covariances(B: int, seed: int):
    """Well-conditioned (sigma_2 - sigma_3 > 1e-2 sigma_1), reflected,
    rank-2, rank-1 and zero 3x3 matrices (a fifth of each), float32."""
    from scipy.spatial.transform import Rotation as ScipyRot

    rng = np.random.default_rng(seed)
    sv = np.sort(rng.uniform(0.2, 3.0, (B, 3)), axis=1)[:, ::-1].copy()
    sv[:, 2] = np.minimum(sv[:, 2], sv[:, 1] - 0.01 * sv[:, 0])
    kind = np.arange(B) % 5
    sv[kind == 1, 2] *= -1
    sv[kind == 2, 2] = 0.0
    sv[kind == 3, 1:] = 0.0
    sv[kind == 4] = 0.0
    U = ScipyRot.random(B, random_state=seed).as_matrix()
    V = ScipyRot.random(B, random_state=seed + 1).as_matrix()
    H = np.einsum("bij,bj,bkj->bik", U, sv, V).astype(np.float32)
    return torch.from_numpy(H), kind, sv


@pytest.mark.parametrize("B", [1, 7, 18, 100, 1000])
def test_kabsch3_kernel_on_card(cuda, B):
    """kabsch3_kernel against its plain version (svd + det) on well-conditioned
    H (1e-5), exactly I at H = 0, a proper rotation for reflections and at
    rank 1 and 2 (|R R^T - I| and |det R - 1| at most 1e-6), and equal to
    its model (tests/torch_geom_models.py) bit for bit."""
    from autourdf_tpu_torch.ops import icp
    from torch_geom_models import kabsch3_model

    H, kind, _ = _cross_covariances(B, 30 + B)
    before = _cuda.launch_counts["kabsch3"]
    R = icp.kabsch_rotation(H.to(cuda))
    assert _cuda.launch_counts["kabsch3"] == before + 1
    ref = icp._kabsch_rotation_plain(H.to(cuda))
    good = torch.from_numpy(kind == 0).to(cuda)
    assert float((R - ref).abs()[good].max()) <= 1e-5
    zero = torch.from_numpy(kind == 4).to(cuda)
    assert torch.equal(R[zero], torch.eye(3, device=cuda).expand(int(zero.sum()), 3, 3))
    Rd = R.double()
    assert float((Rd @ Rd.transpose(-1, -2) - torch.eye(3, device=cuda, dtype=torch.float64))
                 .abs().max()) <= 1e-6
    assert float((torch.linalg.det(Rd) - 1).abs().max()) <= 1e-6
    assert torch.equal(R.cpu(), kabsch3_model(H))


@pytest.mark.parametrize("n", [1, 129, 4988])
def test_sym_eig3_min_kernel_on_card(cuda, n):
    """sym_eig3_min_kernel against its plain version (eigh) on neighbourhood
    covariances of a bumpy sheet: |dot| > 1 - 1e-4 where the two smallest
    eigenvalues are 10% apart, unit norm to 1e-6, equal to its model bit for
    bit."""
    from autourdf_tpu_torch.ops import plane
    from torch_geom_models import sym_eig3_min_model

    rng = np.random.default_rng(n)
    xy = rng.uniform(-1, 1, (max(n, 40), 2))
    pts = np.c_[xy, 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.004, len(xy))]
    pts = torch.from_numpy(pts.astype(np.float32))
    d = torch.cdist(pts, pts)
    nb = pts[torch.topk(d, 30, largest=False).indices][:n]
    c = nb - nb.mean(1, keepdim=True)
    C = torch.einsum("nki,nkj->nij", c, c)
    before = _cuda.launch_counts["sym_eig3_min"]
    v = plane.smallest_eigenvector(C.to(cuda))
    assert _cuda.launch_counts["sym_eig3_min"] == before + 1
    ref = plane._smallest_eigenvector_plain(C.to(cuda))
    e = torch.linalg.eigvalsh(C.double())
    sep = ((e[:, 1] - e[:, 0]) > 0.1 * e[:, 1]).to(cuda)
    dots = (v * ref).sum(1).abs()
    assert bool((dots[sep] > 1 - 1e-4).all())
    assert float((v.norm(dim=1) - 1).abs().max()) <= 1e-6
    assert torch.equal(v.cpu(), sym_eig3_min_model(C))


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
        assert _cuda.launch_counts["kabsch3"] - mid["kabsch3"] == 20
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
    assert launched["eager"]["kabsch3"] == 2 * 10 and launched["eager"]["sym_eig3_min"] == 2 * 2


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
