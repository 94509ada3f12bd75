"""The epoch's update on the CPU: the segment table ``epoch_update_kernel``
walks (``registration/optimizer.py update_segments``), the gradient one
piece a parameter against the flat gradient, and a model of the kernel's
logic (``csrc/optim.cu``) against the plain chain, bit for bit.

The model walks the table as the kernel does (a column's segment is the
last whose offset is at or below it; its gradient sits at ``s n + j -
offset`` of the piece), takes every sequence's decisions from the old
carry, copies a frozen sequence's row, and does Adam's arithmetic in the
kernel's order with the float32 constants the wrapper passes.  The card
tests (``tests/test_torch_cuda.py``) hold the kernel to the plain chain on
the card.
"""

import numpy as np
import pytest
import torch

from autourdf_tpu_torch.models.regmlp import MODES, PoseRegressor, layer_shapes
from autourdf_tpu_torch.ops.chamfer import chamfer_distance
from autourdf_tpu_torch.registration import optimizer as opt

STOP_PATIENCE, PATIENCE, FACTOR = 200, 5, 0.7


@pytest.mark.parametrize("hidden", [64, 512])
@pytest.mark.parametrize("mode", MODES)
def test_segment_table_tiles_theta(mode, hidden):
    S = 2
    model = PoseRegressor(mode, hidden, num_seqs=S, generator=torch.Generator().manual_seed(0))
    theta = model.flat_params()
    P = theta.shape[1]
    table = opt.update_segments(list(model.unflatten(theta).values()), S, P)
    sizes = [n for _, fan_in, fan_out in layer_shapes(mode, hidden)
             for n in (fan_in * fan_out, fan_out)]
    assert [g.shape[1] for g, _ in table] == sizes
    assert [o for _, o in table] == [sum(sizes[:i]) for i in range(len(sizes))]
    assert sum(sizes) == P and len(table) <= opt.UPDATE_MAX_SEGMENTS
    # each piece is the view of theta's columns that its offset names
    for (g, off) in table:
        assert torch.equal(g, theta[:, off:off + g.shape[1]])
    with pytest.raises(ValueError):
        opt.update_segments([g for g, _ in table[:-1]], S, P)


def _regression(mode, S=3, K=5, N=40, hidden=32, seed=0):
    rng = np.random.default_rng(seed)
    model = PoseRegressor(mode, hidden, num_seqs=S, generator=torch.Generator().manual_seed(seed))
    mats = torch.eye(4).repeat(S, K, 1, 1)
    mats[..., :3, 3] = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, K, 3))).float()
    pts = torch.from_numpy(rng.normal(scale=0.05, size=(S, N, 3))).float()
    labels = torch.from_numpy(rng.integers(0, K, (S, N)))
    target = torch.from_numpy(rng.uniform(-0.2, 0.2, (S, N + 7, 3))).float()

    def loss_and_m(theta):
        m2, pred = opt.predict_points(model, theta, mats, pts, labels)
        return chamfer_distance(pred, target, norm=1), m2

    return model, loss_and_m


@pytest.mark.parametrize("mode", MODES)
def test_per_parameter_gradients_equal_the_flat_gradient(mode):
    model, loss_and_m = _regression(mode)
    theta = model.flat_params()
    flat = opt.loss_and_grads(theta, loss_and_m, model, per_parameter=False)
    pieces = opt.loss_and_grads(theta, loss_and_m, model, per_parameter=True)
    assert len(flat[2]) == 1 and len(pieces[2]) == len(dict(model.named_parameters()))
    assert torch.equal(flat[0], pieces[0]) and torch.equal(flat[1], pieces[1])
    cat = torch.cat([g.reshape(g.shape[0], -1) for g in pieces[2]], dim=1)
    assert torch.equal(cat, flat[2][0])
    assert cat.abs().sum() > 0


def _kernel_model(c, grads, loss, m2, stop_patience, patience, factor):
    """``epoch_update_kernel``'s logic on the CPU (see the module's
    docstring)."""
    S, P = c.theta.shape
    table = opt.update_segments(grads, S, P)
    offsets = np.array([o for _, o in table] + [P])
    pieces = [g.reshape(-1) for g, _ in table]
    # the gradient a column reads: its segment's piece at s n + j - offset
    cols = np.arange(P)
    seg = np.searchsorted(offsets, cols, side="right") - 1
    g = torch.empty(S, P)
    for i, piece in enumerate(pieces):
        at = cols[seg == i]
        n = offsets[i + 1] - offsets[i]
        for s in range(S):
            g[s, at] = piece[s * n + at - offsets[i]]
    b1, b2, eps = opt.ADAM_B1, opt.ADAM_B2, opt.ADAM_EPS
    # the bias corrections of step + 1, as torch.pow makes them
    t = (c.opt.step + 1).to(torch.float32)[:, None]
    bc1, bc2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    mu = b1 * c.opt.mu + (1 - b1) * g
    nu = b2 * c.opt.nu + ((1 - b2) * g) * g
    theta = c.theta - (c.sched.lr[:, None] * (mu / bc1)) / (torch.sqrt(nu / bc2) + eps)

    f32 = np.float32
    out = {k: v.clone() for k, v in dict(
        theta=c.theta, mu=c.opt.mu, nu=c.opt.nu, step=c.opt.step, sched_best=c.sched.best,
        lr=c.sched.lr, num_bad=c.sched.num_bad, best_loss=c.best_loss, best_m=c.best_m,
        bad_count=c.bad_count, stopped=c.stopped).items()}
    masked = torch.empty(S)
    for s in range(S):
        frozen = bool(c.stopped[s])
        loss_s = f32(loss[s])
        masked[s] = float("inf") if frozen else float(loss_s)
        improved = loss_s < f32(c.best_loss[s])
        bad = 0 if improved else int(c.bad_count[s]) + 1
        out["stopped"][s] = frozen or bad > stop_patience
        if frozen:
            continue                    # every other field passes through
        out["theta"][s], out["mu"][s], out["nu"][s] = theta[s], mu[s], nu[s]
        out["step"][s] = c.opt.step[s] + 1
        if improved:
            out["best_loss"][s], out["best_m"][s] = float(loss_s), m2[s]
        out["bad_count"][s] = bad
        better = loss_s < f32(c.sched.best[s]) * f32(1.0 - opt.PLATEAU_THRESHOLD)
        num_bad = 0 if better else int(c.sched.num_bad[s]) + 1
        if better:
            out["sched_best"][s] = float(loss_s)
        if num_bad > patience:
            out["lr"][s] = float(f32(c.sched.lr[s]) * f32(factor))
            num_bad = 0
        out["num_bad"][s] = num_bad
    carry = opt.TrainCarry(out["theta"], opt.AdamState(out["mu"], out["nu"], out["step"]),
                           opt.PlateauState(out["sched_best"], out["num_bad"], out["lr"]),
                           out["best_loss"], out["best_m"], out["bad_count"], out["stopped"])
    return carry, masked


def bookkeeping_cases(model, S=5, K=4, seed=3):
    """A carry, a loss, poses and per-parameter gradients where, across the
    five sequences: the loss improves on the best and on the plateau's
    best (0); improves on neither, with the plateau's patience run out this
    epoch (1); improves on neither, with the early stop this epoch (2);
    improves, but the sequence is frozen already (3); improves on the best
    but not by the plateau's threshold, at a late step (4).  Also used on
    the card."""
    rng = np.random.default_rng(seed)
    theta = model.flat_params()
    P = theta.shape[1]
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    loss = torch.tensor([0.5, 0.9, 0.9, 0.1, 0.49999], dtype=torch.float32)
    carry = opt.TrainCarry(
        theta=theta,
        opt=opt.AdamState(1e-3 * f(S, P), 1e-6 * f(S, P).abs(),
                          torch.tensor([0, 6, 149, 40, 298], dtype=torch.int32)),
        sched=opt.PlateauState(torch.tensor([0.6, 0.8, 0.8, 0.2, 0.5], dtype=torch.float32),
                               torch.tensor([2, PATIENCE, 1, 3, 0], dtype=torch.int32),
                               torch.tensor([2e-4, 2e-4, 1.4e-4, 2e-4, 9.8e-5],
                                            dtype=torch.float32)),
        best_loss=torch.tensor([0.6, 0.8, 0.8, 0.2, 0.5], dtype=torch.float32),
        best_m=f(S, K, 4, 4),
        bad_count=torch.tensor([4, 10, STOP_PATIENCE, 7, 0], dtype=torch.int32),
        stopped=torch.tensor([False, False, False, True, False]),
    )
    grads = [1e-2 * f(*p.shape) for p in model.unflatten(theta).values()]
    grads[1][0] = 0.0                   # a zero gradient
    return carry, grads, loss, f(S, K, 4, 4)


def _assert_same(a, b):
    (ca, la), (cb, lb) = a, b
    for name, x, y in zip(("theta", "mu", "nu", "step", "sched_best", "num_bad", "lr",
                           "best_loss", "best_m", "bad_count", "stopped"),
                          (ca.theta, *ca.opt, *ca.sched, *ca[3:]),
                          (cb.theta, *cb.opt, *cb.sched, *cb[3:])):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert torch.equal(la, lb)


@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_model_equals_the_plain_chain(mode, hidden):
    model = PoseRegressor(mode, hidden, num_seqs=5, generator=torch.Generator().manual_seed(1))
    carry, grads, loss, m2 = bookkeeping_cases(model)
    flat = torch.cat([g.reshape(5, -1) for g in grads], dim=1)
    steps = (STOP_PATIENCE, PATIENCE, FACTOR)
    plain = opt._epoch_update_plain(carry, flat, loss, m2, *steps)
    _assert_same(_kernel_model(carry, grads, loss, m2, *steps), plain)
    # the CPU wrapper takes the pieces as well as the flat gradient
    _assert_same(opt.epoch_update(carry, grads, loss, m2, *steps), plain)
    _assert_same(opt.epoch_update(carry, [flat], loss, m2, *steps), plain)
    # every case happened: improved, cut, stopped, frozen, below the threshold
    out, masked = plain
    assert out.best_loss.tolist()[:1] == [0.5] and out.sched.lr[1] < carry.sched.lr[1]
    assert out.stopped.tolist() == [False, False, True, True, False]
    assert torch.isinf(masked[3]) and torch.equal(out.theta[3], carry.theta[3])
    assert out.best_loss[4] == loss[4] and out.sched.best[4] == carry.sched.best[4]
