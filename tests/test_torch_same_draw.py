"""The port's registration against the JAX package's from one initial draw,
at the registration's default depth.

The port's initial MLP weights (``workflow._draw_weights``) cross to the
JAX package through ``params_to_jax``; on the hinge batch the port's
frame-0 segmentation crosses too, on the real scans the record's (the JAX
package's own).  At 300 Adam epochs a phase the registration's long-horizon
logic acts: the plateau schedule cuts the learning rate, best-pose tracking
spans the whole phase, the early-stop freeze holds the carry, and the Lloyd
resample starts from a full fit.

- The tier-1 test runs the ragged hinge batch of
  ``test_torch_registration.py`` (about 300 points a frame, 2 sequences x 3
  frames) at K=20, hidden 512 and 300 epochs a phase.
- The slow test (``-m slow``) runs one sequence x 3 frames of the real
  scans at full width and depth and measures where the two packages part;
  its tolerance is the one ``chip_smoke.py`` [14] holds the card to.
- The record ``tests/data/same_draw_wx200_real_5_seed0.npz`` is the JAX
  package's registration of all the real scans from the port's draw at seed
  0, written by ``scripts/torch_same_draw.py record``; these tests read its
  init and check its weight checksum against the port's draw.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autourdf_tpu.models.regmlp import PoseRegressor as JPoseRegressor
from autourdf_tpu.models.regmlp import init_params as j_init_params
from autourdf_tpu.registration import RegistrationConfig as JConfig
from autourdf_tpu.registration import SegmentInit as JSegmentInit
from autourdf_tpu.registration import optimizer as j_opt
from autourdf_tpu.registration import register_sequences_batched as j_register
from autourdf_tpu_torch.models.regmlp import PoseRegressor, params_from_jax, params_to_jax
from autourdf_tpu_torch.registration import RegistrationConfig, SegmentInit, initial_segments
from autourdf_tpu_torch.registration import optimizer as t_opt
from autourdf_tpu_torch.registration import register_sequences_batched
from autourdf_tpu_torch.workflow import _draw_weights, load_raw_sequences_padded
from test_torch_registration import S, T, ragged_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "tests", "data", "same_draw_wx200_real_5_seed0.npz")
K, H, EPOCHS = 20, 512, 300


def to_jax(params: dict):
    return jax.tree.map(jnp.asarray, params_to_jax(params, "q"))


def init_to_torch(init) -> SegmentInit:
    return SegmentInit(*(torch.from_numpy(np.array(v)) for v in init))


def _chip_smoke():
    """``chip_smoke.py`` as a module: its record checks and tolerances."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode,hidden", [("q", 32), ("q", 512), ("dq", 16), ("rpy", 16),
                                         ("6d", 16)])
def test_params_to_jax_round_trips_bit_for_bit(mode, hidden):
    model = PoseRegressor(mode, hidden, num_seqs=3, generator=torch.Generator().manual_seed(5))
    sd = {k: v.detach() for k, v in model.named_parameters()}
    tree = params_to_jax(sd, mode)
    leaves = jax.tree.leaves(tree)
    assert all(type(x) is np.ndarray and x.dtype == np.float32 for x in leaves)
    back = params_from_jax(tree, mode)
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == sd[k].dtype and back[k].shape == sd[k].shape
        assert torch.equal(back[k], sd[k]), k
    # the flax tree has the structure the JAX package's own init gives
    _, jp = j_init_params(jax.random.PRNGKey(0), mode, 4, hidden)
    assert (jax.tree.structure(jax.tree.map(lambda x: 0, dict(jp)))
            == jax.tree.structure(jax.tree.map(lambda x: 0, tree)))
    for a, b in zip(jax.tree.leaves(jp), leaves):
        assert a.shape == b.shape[1:]


@pytest.mark.parametrize("mode", ["q", "dq", "rpy", "6d"])
def test_params_to_jax_feeds_the_jax_regressor(mode):
    """The JAX ``PoseRegressor`` given the converted weights computes the
    port's forward, sequence by sequence, to 1e-6."""
    model = PoseRegressor(mode, H, num_seqs=2, generator=torch.Generator().manual_seed(7))
    tree = params_to_jax({k: v.detach() for k, v in model.named_parameters()}, mode)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, K, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                    2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                   -1).reshape(2, K, 3, 3)
    m = np.tile(np.eye(4), (2, K, 1, 1))
    m[..., :3, :3] = rot
    m[..., :3, 3] = rng.uniform(-0.5, 0.5, size=(2, K, 3))
    m = m.astype(np.float32)
    with torch.no_grad():
        out_t = model.forward_flat(model.flat_params(), torch.from_numpy(m)).numpy()
    jm = JPoseRegressor(mode=mode, hidden_dim=H)
    for s in range(2):
        tree_s = jax.tree.map(lambda v: v[s], tree)
        out_j = np.asarray(jm.apply(tree_s, jnp.asarray(m[s])))
        np.testing.assert_allclose(out_t[s], out_j, atol=1e-6, rtol=0)


def test_draw_weights_is_run_registrations_draw():
    """``_draw_weights`` gives the bits ``run_registration`` always drew:
    a CPU generator seeded ``seed + 1``, the step MLPs first."""
    model, sp, ap = _draw_weights(2, 3, "cpu", "q", 32)
    gen = torch.Generator().manual_seed(4)
    first = PoseRegressor("q", 32, num_seqs=2, generator=gen)
    second = PoseRegressor("q", 32, num_seqs=2, generator=gen)
    for k, v in first.named_parameters():
        assert torch.equal(sp[k], v.detach()) and torch.equal(getattr(model, k).detach(), sp[k])
    for k, v in second.named_parameters():
        assert torch.equal(ap[k], v.detach())


def test_record_matches_the_ports_draw():
    """The record's weight checksum is the port's CPU draw at seed 0 (the
    generator seeded 1) and its init is a valid segmentation of the real
    scans' first frame."""
    rec = np.load(RECORD)
    assert os.path.getsize(RECORD) < 1 << 20
    assert int(rec["seed"]) == 0 and int(rec["epochs"]) == EPOCHS
    _, sp, ap = _draw_weights(5, 0, "cpu")
    smoke = _chip_smoke()
    smoke.check_record_weights(rec, (sp, ap))
    with pytest.raises(SystemExit, match="not the port's draw"):
        smoke.check_record_weights(rec, _draw_weights(5, 1, "cpu")[1:])
    _, frames, masks = load_raw_sequences_padded(
        os.path.join(REPO, "data_real", "raw", "wx200_real_5"), 5)
    assert rec["matrices"].shape == (5, 10, K, 4, 4) and rec["labels"].shape == frames.shape[:3]
    np.testing.assert_array_equal(rec["init_mask"], masks[0, 0])
    assert set(np.unique(rec["init_labels"][masks[0, 0]])) == set(range(K))
    assert np.isfinite(rec["losses"]).all() and np.isfinite(rec["history_step"]).all()
    # the record's frame 0 is the init in every sequence
    for s in range(5):
        np.testing.assert_array_equal(rec["matrices"][s, 0], rec["init_matrices"])


# stop_patience for the hinge batch: at the default 200, and at 25, no
# sequence of it stops within 300 epochs (each phase keeps finding new bests
# by a few ulps at the cut learning rates); at 10 the step phases of pair
# 0->1 stop in both packages, after the same epochs (49 and 66)
STOP_PATIENCE = 10


@pytest.fixture(scope="module")
def hinge_default_depth():
    """Both packages' batched drivers on the hinge batch, 2 frame pairs at
    K=20, hidden 512, 300 epochs a phase, from one draw; the port's phase
    carries are caught as its driver finalises them.  Two intra-op threads:
    the port's epochs are passes over 852k weights, and under pytest-xdist
    every worker's full thread pool contends for the same cores (this
    fixture took 915 s in a parallel run with the default pool, 21 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _hinge_drivers()
    finally:
        torch.set_num_threads(threads)


def _hinge_drivers():
    frames, masks = ragged_batch()
    init_t = initial_segments(torch.Generator().manual_seed(0), torch.from_numpy(frames[0, 0]),
                              K, mask=torch.from_numpy(masks[0, 0]), kmeans_iters=8, n_init=2)
    init_j = JSegmentInit(jnp.asarray(init_t.matrices.numpy()), jnp.asarray(init_t.points.numpy()),
                          jnp.asarray(init_t.labels.numpy().astype(np.int32)),
                          jnp.asarray(masks[0, 0]))
    model, sp, ap = _draw_weights(S, 0, "cpu")
    res_j = j_register(JPoseRegressor("q", H),
                       JConfig(num_seg=K, chamfer_backend="xla", stop_patience=STOP_PATIENCE),
                       to_jax(sp), to_jax(ap), init_j, jnp.asarray(frames), jnp.asarray(masks))
    carries_t = []
    finalize = t_opt.train_finalize

    def catch(carry, losses):
        carries_t.append((carry, losses))
        return finalize(carry, losses)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_opt, "train_finalize", catch)
    try:
        res_t = register_sequences_batched(
            model, RegistrationConfig(num_seg=K, stop_patience=STOP_PATIENCE), sp, ap, init_t,
            torch.from_numpy(frames), torch.from_numpy(masks))
    finally:
        mp.undo()
    return frames, masks, init_j, sp, jax.tree.map(np.asarray, res_j), res_t, carries_t


def test_default_depth_reaches_schedule_and_freeze(hinge_default_depth):
    """At 300 epochs the plateau schedule cuts every phase's learning rate
    and the step phases reach the early-stop freeze: read from the carries
    the port's driver finalises (the JAX package's, along its trajectory,
    in the operation test below, which holds the port's bookkeeping to
    them)."""
    frames, masks, init_j, sp, res_j, res_t, carries_t = hinge_default_depth
    assert len(carries_t) == 2 * (T - 1)
    for i, (c, losses) in enumerate(carries_t):
        assert (c.sched.lr < (2e-4, 1e-4)[i % 2]).all()
        # the freeze shows in the history as inf from the epoch after the stop
        assert (torch.isinf(losses).any(1) <= c.stopped).all()
    ct, _ = carries_t[0]
    assert ct.stopped.all()
    np.testing.assert_array_equal(ct.best_loss.numpy(), res_t.step_losses[:, 0].numpy())


# both packages' drivers from one draw at the default depth, 2 frame pairs,
# measured on this input: the step phases agree to 1.6e-6 in the best
# losses; the anchor phase of pair 1->2 parts, 0.261 (first sequence) and
# 4.2e-4 (second) in its best loss, 0.0114 and 2.8e-5 in the poses, as the
# real scans' V0003 does (PERF.md); the labels are equal
LOSS_RTOL, POSE_ATOL, LABELS_DIFFER = 0.5, 0.03, 0


def test_default_depth_matches_jax(hinge_default_depth):
    """Two frame pairs at K=20, hidden 512, 300 epochs a phase from one
    draw: best losses, best poses and labels of both packages."""
    frames, masks, init_j, sp, res_j, res_t, _ = hinge_default_depth
    gaps = {
        "step": np.abs(res_t.step_losses.numpy() - res_j.step_losses) / res_j.step_losses,
        "anchor": np.abs(res_t.losses.numpy() - res_j.losses) / res_j.losses,
        "pose": np.abs(res_t.matrices.numpy() - res_j.matrices).max(axis=(-1, -2, -3)),
    }
    lab_t = res_t.labels.numpy()
    differ = np.zeros((S, T), int)
    for s in range(S):
        for t in range(T):
            valid = masks[0, 0] if t == 0 else masks[s, t]
            differ[s, t] = int((lab_t[s, t][valid] != res_j.labels[s, t][valid]).sum())
    print({k: v.tolist() for k, v in gaps.items()}, differ.tolist())
    assert gaps["step"].max() <= LOSS_RTOL and gaps["anchor"].max() <= LOSS_RTOL
    assert gaps["pose"].max() <= POSE_ATOL
    assert differ.max() <= LABELS_DIFFER


# one epoch's operations of both packages on the same inputs, the JAX
# trajectory's state (11 checks to epoch 66, where both sequences have
# stopped), measured on this input: the forward 1.5e-7 (poses and valid
# points), the MLP's gradient for one cotangent 1.1e-7 relative, the Chamfer
# 1.5e-7 relative and its gradient 3.7e-9 absolute at the same points, Adam
# 7 ulps (up to 2,340 of 851,982 weights not bit-equal: XLA fuses the
# update, and its float32 ``b**t`` differs from torch's by an ulp at 3 of
# 300 steps)
FWD_ATOL, MLP_GRAD_RTOL, CHAMFER_RTOL, CHAMFER_GRAD_ATOL, ADAM_ULPS = 5e-7, 1e-6, 1e-6, 1e-8, 16
CHECK_EVERY = 10


def _flat(model, tree) -> torch.Tensor:
    return model.flat_params(params_from_jax(jax.tree.map(np.asarray, tree), "q"))


def test_each_epoch_operation_matches_along_the_jax_trajectory(hinge_default_depth):
    """The JAX step phase of pair 0->1 one epoch at a time until every
    sequence has stopped; every ``CHECK_EVERY`` epochs, and at each plateau
    cut and stop, the port's operations get the JAX state: the MLP forward
    at hidden 512, its gradient for the same cotangent, the one-hot pose
    selection and the Chamfer (value, per-sequence sums, gradient) at the
    same points, Adam's update with its bias corrections on the same
    gradient, and a whole epoch's plateau and stop bookkeeping on the same
    loss.  The whole gradient at the same parameters is printed, not held:
    the L1 Chamfer's subgradient turns round-off in the points into a sign
    or a neighbour that differs.  Then both packages' warm-started Lloyd and
    ``local_points_from_labels`` on the JAX driver's poses after the full
    fit."""
    from autourdf_tpu.ops.chamfer import chamfer_distance as j_chamfer
    from autourdf_tpu.ops.kmeans import lloyd as j_lloyd
    from autourdf_tpu.registration import local_points_from_labels as j_local
    from autourdf_tpu_torch.ops.chamfer import chamfer_distance
    from autourdf_tpu_torch.ops.kmeans import lloyd
    from autourdf_tpu_torch.registration import local_points_from_labels

    frames, masks, init_j, sp, res_j, *_ = hinge_default_depth
    tile = lambda x: jnp.broadcast_to(x[None], (S,) + x.shape)
    model_j, model = JPoseRegressor("q", H), PoseRegressor("q", H, num_seqs=S)
    xs = (tile(init_j.matrices), jnp.asarray(frames[:, 1]), tile(init_j.points),
          tile(init_j.labels), jnp.asarray(masks[:, 1]), tile(init_j.mask))

    def j_loss(p, m, t, x, lb, tm, pm):
        pred = j_opt.transform_by_labels(model_j.apply(p, m), x, lb)
        return j_chamfer(pred, t, pm, tm, norm=1, backend="xla")

    def j_parts(p, m, t, x, lb, tm, pm):
        m2, mlp_vjp = jax.vjp(lambda q: model_j.apply(q, m), p)
        pred = j_opt.transform_by_labels(m2, x, lb)
        loss, ch_grad = jax.value_and_grad(
            lambda y: j_chamfer(y, t, pm, tm, norm=1, backend="xla"))(pred)
        return m2, pred, loss, ch_grad, mlp_vjp(jnp.ones_like(m2))[0], jax.grad(j_loss)(
            p, m, t, x, lb, tm, pm)

    j_parts = jax.jit(jax.vmap(j_parts))
    j_epoch = jax.jit(jax.vmap(lambda c, m, t, x, lb, tm, pm: j_opt.train_epochs(
        model_j, c, m, t, x, lb, 1, target_mask=tm, points_mask=pm, chamfer_backend="xla",
        stop_patience=STOP_PATIENCE)[0]))
    j_adam = jax.jit(jax.vmap(j_opt.adam_update))
    carry = jax.vmap(lambda p, m: j_opt.train_init(p, m, 2e-4))(to_jax(sp), xs[0])

    it = init_to_torch(init_j)
    tl = lambda x: x[None].expand((S,) + x.shape)
    m0, pts, lab, pmask = tl(it.matrices), tl(it.points), tl(it.labels), tl(it.mask)
    target, tmask = torch.from_numpy(frames[:, 1]), torch.from_numpy(masks[:, 1])
    T_ = lambda x: torch.from_numpy(np.array(x))
    worst = dict.fromkeys(("fwd", "mlp_grad", "chamfer", "chamfer_grad", "adam_ulps", "grad"),
                          0.0)
    rel = lambda a, b: float(((a - b).norm(dim=1) / b.norm(dim=1)).max())
    cut_seen = stop_seen = False
    checked = adam_differ = 0
    for epoch in range(EPOCHS):
        nxt = j_epoch(carry, *xs)
        event = (np.any(np.asarray(nxt.stopped) != np.asarray(carry.stopped))
                 or np.any(np.asarray(nxt.sched.lr) != np.asarray(carry.sched.lr)))
        if epoch % CHECK_EVERY == 0 or event:
            checked += 1
            m2_j, pred_j, loss_j, chg_j, mlpg_j, grad_j = j_parts(carry.params, *xs)
            theta = _flat(model, carry.params).requires_grad_(True)
            with torch.enable_grad():
                m2 = model.forward_flat(theta, m0)
                (mlpg_t,) = torch.autograd.grad(m2, theta, torch.ones_like(m2), retain_graph=True)
                y = T_(pred_j).requires_grad_(True)
                loss_y = chamfer_distance(y, target, pmask, tmask, norm=1)
                (chg_t,) = torch.autograd.grad(loss_y.sum(), y)
                loss_t = chamfer_distance(t_opt.transform_by_labels(m2, pts, lab), target,
                                          pmask, tmask, norm=1)
                (grad_t,) = torch.autograd.grad(loss_t.sum(), theta)
            loss_j = np.asarray(loss_j)
            pred_t = t_opt.transform_by_labels(T_(m2_j), pts, lab)
            worst["fwd"] = max(worst["fwd"], float((m2.detach() - T_(m2_j)).abs().max()),
                               float((pred_t - T_(pred_j))[pmask].abs().max()))
            worst["mlp_grad"] = max(worst["mlp_grad"], rel(mlpg_t, _flat(model, mlpg_j)))
            worst["chamfer"] = max(worst["chamfer"], float(np.max(
                np.abs(loss_y.detach().numpy() - loss_j) / loss_j)))
            worst["chamfer_grad"] = max(worst["chamfer_grad"],
                                        float((chg_t - T_(chg_j)).abs().max()))
            worst["grad"] = max(worst["grad"], rel(grad_t, _flat(model, grad_j)))
            # Adam on the same gradient and state
            opt = t_opt.AdamState(_flat(model, carry.opt.mu), _flat(model, carry.opt.nu),
                                  T_(carry.opt.step))
            gj = _flat(model, grad_j)
            new_t, _ = t_opt.adam_update(gj, opt, _flat(model, carry.params), T_(carry.sched.lr))
            new_j, _ = j_adam(grad_j, carry.opt, carry.params, carry.sched.lr)
            new_j, old = _flat(model, new_j).numpy(), _flat(model, carry.params).numpy()
            ulp = np.spacing(np.maximum(np.abs(old), np.abs(new_j))).astype(np.float64)
            worst["adam_ulps"] = max(worst["adam_ulps"], float(np.max(
                np.abs(new_t.numpy().astype(np.float64) - new_j) / ulp)))
            adam_differ = max(adam_differ, int((new_t.numpy() != new_j).sum()))
            # a whole epoch's bookkeeping from the same carry on the same loss
            ct = t_opt.TrainCarry(
                _flat(model, carry.params), opt,
                t_opt.PlateauState(T_(carry.sched.best), T_(carry.sched.num_bad),
                                   T_(carry.sched.lr)),
                T_(carry.best_loss), T_(carry.best_m), T_(carry.bad_count), T_(carry.stopped))
            out, _ = t_opt._epoch_step(ct, lambda th: (T_(loss_j) + 0 * th.sum(), T_(m2_j)),
                                       model, STOP_PATIENCE, 5, 0.7)
            for a, b in ((out.sched.lr, nxt.sched.lr), (out.sched.num_bad, nxt.sched.num_bad),
                         (out.sched.best, nxt.sched.best), (out.best_loss, nxt.best_loss),
                         (out.best_m, nxt.best_m), (out.bad_count, nxt.bad_count),
                         (out.stopped, nxt.stopped)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            cut_seen |= bool(np.any(np.asarray(nxt.sched.lr) < 2e-4))
            stop_seen |= bool(np.any(np.asarray(nxt.stopped)))
        carry = nxt
        if np.all(np.asarray(carry.stopped)):
            break
    print(f"{checked} checks to epoch {epoch + 1}, at most {adam_differ} weights of "
          f"{S * model.flat_params().shape[1]} not bit-equal after Adam: {worst}")
    assert cut_seen and stop_seen
    assert worst["fwd"] <= FWD_ATOL and worst["mlp_grad"] <= MLP_GRAD_RTOL
    assert worst["chamfer"] <= CHAMFER_RTOL and worst["chamfer_grad"] <= CHAMFER_GRAD_ATOL
    assert worst["adam_ulps"] <= ADAM_ULPS

    # the resample after a full fit: the JAX driver's poses at frame 1
    m1 = res_j.matrices[:, 1]
    km_t = lloyd(target, torch.from_numpy(m1[..., :3, 3]), iters=32, mask=tmask)
    km_j = jax.jit(jax.vmap(lambda t, c, tm: j_lloyd(t, c, iters=32, mask=tm)))(
        jnp.asarray(frames[:, 1]), jnp.asarray(m1[..., :3, 3]), jnp.asarray(masks[:, 1]))
    lp_j = np.asarray(jax.jit(jax.vmap(j_local))(jnp.asarray(m1), jnp.asarray(frames[:, 1]),
                                                 km_j.labels))
    lp_t = local_points_from_labels(torch.from_numpy(m1), target, km_t.labels).numpy()
    valid = masks[:, 1]
    np.testing.assert_array_equal(km_t.labels.numpy()[valid], np.asarray(km_j.labels)[valid])
    np.testing.assert_allclose(lp_t[valid], lp_j[valid], atol=1e-6, rtol=0)


def _rec_init(rec):
    """The record's frame-0 segmentation for both packages."""
    arrays = (rec["init_matrices"], rec["init_points"], rec["init_labels"].astype(np.int32),
              rec["init_mask"])
    init_t = SegmentInit(torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1]),
                         torch.from_numpy(rec["init_labels"].astype(np.int64)),
                         torch.from_numpy(arrays[3]))
    return JSegmentInit(*(jnp.asarray(v) for v in arrays)), init_t


def _parting(hist_t: np.ndarray, hist_j: np.ndarray, smoke):
    """``(first epoch, 1-based, at which a sequence's loss leaves the
    reference's by more than chip_smoke's HISTORY_RTOL, {epoch: largest
    gap})``."""
    h = smoke._rel(hist_t, hist_j)
    over = np.nonzero((h > smoke.HISTORY_RTOL).any(0))[0]
    return (int(over[0]) + 1 if len(over) else None,
            {e: float(h[:, e - 1].max()) for e in (1, 10, 100, 300)})


@pytest.mark.slow
def test_real_scans_same_draw_on_the_cpu():
    """The real scans at full width and depth (K=20, hidden 512, 300 epochs a
    phase) on the CPU from the record's init and the port's weights.

    1. Frame pair 0->1 of all 5 sequences, step then anchor phase, in the
       port against the record's JAX histories and best losses: the first
       epoch at which the losses part by more than 1e-6 relative, the gaps
       at epochs 1, 10, 100 and 300, and the largest relative gap of a best
       loss (``chip_smoke.py``'s ``SAME_DRAW_CPU_GAP`` is the largest over
       the runs made), held to the tolerance [14] holds the card to.
    2. One sequence x 3 frames through both packages' batched drivers: the
       gaps at the end of each pair.
    """

    smoke = _chip_smoke()
    rec = np.load(RECORD)
    _, frames, masks = load_raw_sequences_padded(
        os.path.join(REPO, "data_real", "raw", "wx200_real_5"), 5)
    init_j, init_t = _rec_init(rec)
    model, sp, ap = _draw_weights(5, 0, "cpu")
    smoke.check_record_weights(rec, (sp, ap))
    S5 = frames.shape[0]

    # 1. pair 0->1 of every sequence, port on the CPU against the record
    t0 = time.time()
    tl = lambda x: x[None].expand((S5,) + x.shape)
    target, tmask = torch.from_numpy(frames[:, 1]), torch.from_numpy(masks[:, 1])
    step = t_opt.train_pose_mlp(model, model.flat_params(sp), tl(init_t.matrices), target,
                                tl(init_t.points), tl(init_t.labels), tmask, tl(init_t.mask))
    anchor = t_opt.train_pose_mlp(model, model.flat_params(ap), step.best_matrices, target,
                                  tl(init_t.points), tl(init_t.labels), tmask, tl(init_t.mask),
                                  learning_rate=1e-4)
    seconds_pair = time.time() - t0
    best = {"step": smoke._rel(step.best_loss.numpy(), rec["step_losses"][:, 0]),
            "anchor": smoke._rel(anchor.best_loss.numpy(), rec["losses"][:, 0])}
    parts = {ph: _parting(r.loss_history.numpy(), rec[f"history_{ph}"], smoke)
             for ph, r in (("step", step), ("anchor", anchor))}
    pair0 = max(float(best["step"].max()), float(best["anchor"].max()))

    # 2. one sequence x 3 frames, both packages' drivers
    f1, m1 = frames[:1, :3], masks[:1, :3]
    sp1, ap1 = ({k: v[:1] for k, v in p.items()} for p in (sp, ap))
    t0 = time.time()
    res_j = jax.tree.map(np.asarray, j_register(
        JPoseRegressor("q", H), JConfig(num_seg=K), to_jax(sp1), to_jax(ap1), init_j,
        jnp.asarray(f1), jnp.asarray(m1)))
    seconds_j = time.time() - t0
    t0 = time.time()
    res_t = register_sequences_batched(PoseRegressor("q", H, num_seqs=1),
                                       RegistrationConfig(num_seg=K), sp1, ap1, init_t,
                                       torch.from_numpy(f1), torch.from_numpy(m1))
    seconds_t = time.time() - t0
    ends = {"step": smoke._rel(res_t.step_losses.numpy(), res_j.step_losses)[0].tolist(),
            "anchor": smoke._rel(res_t.losses.numpy(), res_j.losses)[0].tolist(),
            "pose": np.abs(res_t.matrices.numpy() - res_j.matrices).max(
                axis=(-1, -2, -3))[0, 1:].tolist(),
            "labels": [int(((res_t.labels.numpy()[0, t] != res_j.labels[0, t]) & m1[0, t]).sum())
                       for t in (1, 2)],
            "jax_vs_record": [float(np.abs(res_j.step_losses[0] - rec["step_losses"][0, :2]).max()),
                              float(np.abs(res_j.losses[0] - rec["losses"][0, :2]).max())]}
    print(f"\npair 0->1, 5 sequences, port on the CPU against the record ({seconds_pair:.1f} s): "
          f"best-loss gaps {({k: v.tolist() for k, v in best.items()})}; first epoch past "
          f"{smoke.HISTORY_RTOL} and the largest gaps at epochs 1/10/100/300: {parts}; largest "
          f"{pair0:.4g}\none sequence x 3 frames (JAX {seconds_j:.1f} s, port {seconds_t:.1f} s): "
          f"gaps at the end of each pair {ends}")
    assert np.isfinite(res_t.losses.numpy()).all()
    assert pair0 <= smoke.SAME_DRAW_CPU_GAP * smoke.SAME_DRAW_FACTOR
