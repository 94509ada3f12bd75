"""The port's device programs (``autourdf_tpu_torch/utils/programs.py``) on
the CPU, where a program runs its function on its static buffers without
capture: the chunked training phase, the three registration drivers and the
chunked chain fit against the plain loops, bit for bit, and against the JAX
package's drivers and fits at the tolerances of the parity tests they extend.

- ``train_pose_mlp`` in chunk programs equals one eager call exactly (the
  same epochs in the same order); against JAX's ``train_pose_mlp`` the
  tolerances of ``test_torch_model_optim.py`` (1e-4 relative in losses,
  1e-4 absolute in poses over 20 epochs).
- The batched, fused and single-sequence drivers equal each other and the
  plain loop exactly; against JAX's ``register_sequences_fused`` and
  ``register_sequences_batched`` (at ``dispatch_epochs`` 25 and 100) at
  ``test_torch_registration.py``'s tolerances (1e-5 relative in losses,
  1e-5 absolute in poses, equal labels) on its batch and at its 12 epochs
  (the port's programs of 5, 5 and 2 epochs, and of 12).
- The chain fit in chunks of 25 equals the step-by-step loop exactly, and
  JAX's ``refine_chain`` at ``test_torch_chain.py``'s tolerances.
- The revolute-joint fit in chunk programs (one chunk of 30 steps, chunks of
  50 and 30, of 50, 50 and 20, and none) equals its step-by-step loop exactly, and JAX's
  ``fit_revolute_joint`` and ``refine_joints`` at ``test_torch_chain.py``'s
  tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot
from test_structure_joints_mesh import make_hinge_coordmap
from test_torch_chain import GEOM_ATOL
from test_torch_chain import LOSS_RTOL as FIT_LOSS_RTOL
from test_torch_chain import (assert_chain_results_match, hinge_problem, jittered, port_joints,
                              port_links, run_jax_chain)
from test_torch_registration import H, K, S, T, hinge_frames, ragged_batch
from test_torch_structure import coord_map_from_jax

import autourdf_tpu.joints.refine as jrefine
from autourdf_tpu.models.regmlp import PoseRegressor as JPoseRegressor
from autourdf_tpu.models.regmlp import init_params as j_init_params
from autourdf_tpu.registration import RegistrationConfig as JConfig
from autourdf_tpu.registration import initial_segments as j_initial_segments
from autourdf_tpu.registration import optimizer as jopt
from autourdf_tpu.registration import register_sequences_batched as j_batched
from autourdf_tpu.registration import register_sequences_fused as j_fused
from autourdf_tpu_torch.joints import chain as tchain
from autourdf_tpu_torch.joints import refine as trefine
from autourdf_tpu_torch.models.regmlp import PoseRegressor, params_from_jax
from autourdf_tpu_torch.registration import (
    RegistrationConfig,
    SegmentInit,
    register_sequence,
    register_sequences_batched,
    register_sequences_fused,
)
from autourdf_tpu_torch.registration import optimizer as topt
from autourdf_tpu_torch.utils import programs

# the drivers against JAX: test_torch_registration.py's tolerances.  The gaps
# here reach 6.3e-7 relative in a loss (against JAX's batched driver, ragged)
# and 6.0e-7 absolute in a pose (dense frames): sums in another order,
# compounded over 12 Adam epochs, two phases and two frame pairs.
LOSS_RTOL, POSE_ATOL = 1e-5, 1e-5
TRAIN_RTOL = TRAIN_ATOL = 1e-4      # 20 epochs against JAX (test_torch_model_optim.py)
# The drivers' epochs: as test_torch_registration.py, where the two packages'
# fits agree to the tolerances above (longer fits part on round-off, which the
# L1 Chamfer's subgradient and Adam's first steps amplify; PERF.md §6).
EPOCHS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor operations, and
    under pytest-xdist every worker's full thread pool contends for the same
    cores (this file took ten times as long in a parallel run as alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same(a, b):
    """Two tensor trees equal bit for bit."""
    la, lb = [], []
    programs._flatten(a, la)
    programs._flatten(b, lb)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y), float((x.float() - y.float()).abs().max())


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_program_static_buffers_on_cpu():
    """Inputs are copied into static buffers, the outputs are the static
    output buffers (overwritten by the next call), an output that is an
    input comes back as a buffer of its own, None leaves pass through."""
    calls = []

    def fn(x, pair):
        calls.append(1)
        a, b = pair
        return {"twice": 2 * x, "same": x, "none": b, "sum": (a + x).sum(-1)}

    prog = programs.Program(fn, "toy")
    x1, a1 = torch.arange(6.0).view(2, 3), torch.ones(2, 3)
    out1 = prog(x1, (a1, None))
    assert out1["none"] is None and torch.equal(out1["twice"], 2 * x1)
    assert out1["same"].data_ptr() != x1.data_ptr() and torch.equal(out1["same"], x1)
    kept = programs.clone(out1)
    out2 = prog(x1 + 1, (a1, None))
    # the same buffers, new values; the clone keeps the first call's
    assert out2["twice"] is out1["twice"] and torch.equal(out1["twice"], 2 * (x1 + 1))
    assert torch.equal(kept["twice"], 2 * x1) and torch.equal(kept["sum"], (a1 + x1).sum(-1))
    assert len(calls) == 2
    x1.add_(100)                                  # the program holds its own copy
    assert torch.equal(prog._inputs[0], torch.arange(6.0).view(2, 3) + 1)
    with pytest.raises(ValueError):
        prog(x1, (None, None))                    # an input went away
    with pytest.raises(TypeError):
        prog(x1, (a1, 1.5))                       # a number would be frozen in


def test_program_cache_keys_on_shape_dtype_and_none():
    programs.clear()
    made = []

    def run(x, m):
        return programs.run(("cache-test",), lambda x, m: made.append(1) or (x + 1,), x, m)

    run(torch.zeros(3), None)
    run(torch.ones(3), None)                      # cached
    run(torch.zeros(4), None)                     # another shape
    run(torch.zeros(3, dtype=torch.float64), None)
    run(torch.zeros(3), torch.zeros(3, dtype=torch.bool))   # a mask is another program
    assert len(made) == 4 + 1                     # the cached call ran its program again
    assert len(programs._cache) == 4
    for i in range(programs.CACHE_SIZE + 3):
        programs.run(("cache-test", i), lambda x: (x,), torch.zeros(1))
    assert len(programs._cache) == programs.CACHE_SIZE
    programs.clear()


@pytest.mark.parametrize("epochs,dispatch,corr,chunks", [
    (300, 100, 1, [100, 100, 100]),
    (300, 25, 1, [25] * 12),
    (120, 100, 1, [100, 20]),
    (120, 25, 3, [24] * 5),
    (90, 25, 3, [24, 24, 24, 18]),
    (12, 2, 4, [4, 4, 4]),
])
def test_epoch_chunks_follow_the_jax_driver(epochs, dispatch, corr, chunks):
    assert topt.epoch_chunks(epochs, dispatch, corr) == chunks


def test_chain_dispatch_chunk_follows_the_jax_clamp():
    assert tchain.dispatch_chunk(50, 6, 1024, 5000) == 50
    assert tchain.dispatch_chunk(50, 6, 1024, 10000) == 25
    assert tchain.dispatch_chunk(50, 19, 1024, 20000) == 2    # doubled past 16,384 points
    assert tchain.dispatch_chunk(50, 2, 256, 300) == 50
    assert tchain.dispatch_chunk(25, 2, 256, 300) == 25
    # the short fits' chunks: a quarter of the fit, under the same clamp
    assert [tchain.short_fit_dispatch(n) for n in (60, 100, 3)] == [15, 25, 1]
    assert tchain.dispatch_chunk(tchain.short_fit_dispatch(60), 6, 1024, 5000) == 15


# ---------------------------------------------------------------------------
# the training phase in chunk programs
# ---------------------------------------------------------------------------

def _train_inputs(seed=5, K=3, N=120, H=32):
    """Two sequences: sequence 0 chases a shifted target, sequence 1's
    target is where it starts, so it stops improving and freezes
    (stop_patience 1) inside a chunk; the last rows of the points are
    masked out."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=0.3, size=(K, 3)).astype(np.float32)
    m0 = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    m0[:, :3, 3] = centers
    labels = rng.integers(0, K, N)
    pts = rng.normal(scale=0.05, size=(N, 3)).astype(np.float32)
    world = pts + centers[labels]
    targets = np.stack([world + np.float32(0.03), world])
    mask = np.ones(N, bool)
    mask[-7:] = False
    model_j, _ = j_init_params(jax.random.PRNGKey(0), "q", K, H)
    stack = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])(
        jax.random.split(jax.random.PRNGKey(1), 2))
    return dict(m0=m0, pts=pts, labels=labels, targets=targets, mask=mask, model_j=model_j,
                stack=stack, H=H)


def _port_train(inp, **kw):
    model = PoseRegressor("q", inp["H"], num_seqs=2)
    theta = model.flat_params(params_from_jax(_np_tree(inp["stack"]), "q"))
    tile = lambda a: torch.from_numpy(np.stack([a, a]))
    return topt.train_pose_mlp(model, theta, tile(inp["m0"]), torch.from_numpy(inp["targets"]),
                               tile(inp["pts"]), tile(inp["labels"]),
                               target_mask=tile(inp["mask"]), points_mask=tile(inp["mask"]),
                               learning_rate=2e-3, **kw)


@pytest.mark.parametrize("epochs,dispatch,corr", [
    (200, 100, 1), (100, 25, 1), (120, 100, 1), (120, 25, 3), (90, 25, 3)])
def test_train_pose_mlp_chunks_equal_one_eager_call(epochs, dispatch, corr):
    inp = _train_inputs()
    kw = dict(epochs=epochs, stop_patience=3, corr_every=corr)
    chunked = _port_train(inp, dispatch_epochs=dispatch, **kw)
    eager = _port_train(inp, eager=True, **kw)
    _assert_same(chunked, eager)
    assert chunked.loss_history.shape == (2, epochs)
    hist = chunked.loss_history.numpy()
    assert np.isinf(hist[1, -1]) and np.isfinite(hist[0, 0])   # sequence 1 froze


@pytest.mark.parametrize("corr", [1, 4])
def test_train_pose_mlp_chunks_match_jax(corr):
    inp = _train_inputs()
    kw = dict(epochs=20, stop_patience=1, corr_every=corr)
    res_t = _port_train(inp, dispatch_epochs=8, **kw)          # chunks of 8, 8 and 4
    tile = lambda a: jnp.asarray(np.stack([a, a]))
    res_j = jax.vmap(lambda p, t, pm: jopt.train_pose_mlp(
        inp["model_j"], p, jnp.asarray(inp["m0"]), t, jnp.asarray(inp["pts"]),
        jnp.asarray(inp["labels"], jnp.int32), target_mask=pm, points_mask=pm,
        learning_rate=2e-3, chamfer_backend="xla", **kw))(
            inp["stack"], jnp.asarray(inp["targets"]), tile(inp["mask"]))
    hist_j, hist_t = np.asarray(res_j.loss_history), res_t.loss_history.numpy()
    np.testing.assert_array_equal(np.isinf(hist_t), np.isinf(hist_j))
    fin = np.isfinite(hist_j)
    np.testing.assert_allclose(hist_t[fin], hist_j[fin], rtol=TRAIN_RTOL)
    np.testing.assert_allclose(res_t.best_loss.numpy(), np.asarray(res_j.best_loss),
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose(res_t.best_matrices.numpy(), np.asarray(res_j.best_matrices),
                               atol=TRAIN_ATOL)


# ---------------------------------------------------------------------------
# the three registration drivers
# ---------------------------------------------------------------------------

def _driver_inputs(masked: bool):
    """The batch of ``test_torch_registration.py`` (ragged, masked) or its
    hinge frames unpadded, the JAX package's init and weights."""
    if masked:
        frames, masks = ragged_batch()
    else:
        frames = np.stack([hinge_frames(T, step, seed=s)
                           for s, step in enumerate((0.10, 0.16))])
        masks = None
    jm = None if masks is None else jnp.asarray(masks[0, 0])
    init_j = j_initial_segments(jax.random.PRNGKey(0), jnp.asarray(frames[0, 0]), K,
                                mask=jm, kmeans_iters=8, n_init=2)
    keys = jax.random.split(jax.random.PRNGKey(1), 2 * S)
    mk = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])
    return frames, masks, init_j, mk(keys[:S]), mk(keys[S:])


def _config(cls, **kw):
    return cls(num_seg=K, hidden_dim=H, epochs=EPOCHS, kmeans_iters=8, lr_step=1e-3,
               lr_anchor=5e-4, **kw)


@pytest.fixture(scope="module", params=[True, False], ids=["ragged", "dense"])
def drivers(request):
    masked = request.param
    frames, masks, init_j, sp, ap = _driver_inputs(masked)
    fj = jnp.asarray(frames)
    mj = None if masks is None else jnp.asarray(masks)
    jax_res = {"fused": j_fused(JPoseRegressor("q", H), _config(JConfig, chamfer_backend="xla"),
                                sp, ap, init_j, fj, mj)}
    for d in (25, 100):
        jax_res[f"batched{d}"] = j_batched(
            JPoseRegressor("q", H), _config(JConfig, chamfer_backend="xla", dispatch_epochs=d),
            sp, ap, init_j, fj, mj)

    init_t = SegmentInit(*(torch.from_numpy(np.array(v)) for v in init_j[:3]),
                         None if masks is None else torch.from_numpy(masks[0, 0]))
    model = PoseRegressor("q", H, num_seqs=S)
    spt, apt = params_from_jax(_np_tree(sp), "q"), params_from_jax(_np_tree(ap), "q")
    ft = torch.from_numpy(frames)
    mt = None if masks is None else torch.from_numpy(masks)
    cfg = _config(RegistrationConfig, dispatch_epochs=5)       # programs of 5, 5 and 2
    port = {
        "eager": register_sequences_batched(model, cfg, spt, apt, init_t, ft, mt, eager=True),
        "batched": register_sequences_batched(model, cfg, spt, apt, init_t, ft, mt),
        "batched100": register_sequences_batched(model, cfg._replace(dispatch_epochs=100), spt,
                                                 apt, init_t, ft, mt),
        "fused": register_sequences_fused(model, cfg, spt, apt, init_t, ft, mt),
    }
    one = PoseRegressor("q", H, num_seqs=1)
    rows = [register_sequence(one, cfg, {k: v[s] for k, v in spt.items()},
                              {k: v[s] for k, v in apt.items()}, init_t, ft[s],
                              None if mt is None else mt[s]) for s in range(S)]
    port["sequence"] = type(rows[0])(*(torch.stack(f) for f in zip(*rows)))
    return dict(masks=masks, jax=jax_res, port=port)


@pytest.mark.parametrize("name", ["batched", "batched100", "fused", "sequence"])
def test_drivers_equal_the_eager_loop(drivers, name):
    _assert_same(drivers["port"][name], drivers["port"]["eager"])


@pytest.mark.parametrize("name", ["fused", "batched25", "batched100"])
def test_drivers_match_jax(drivers, name):
    res_j, res_t = drivers["jax"][name], drivers["port"]["fused"]
    masks = drivers["masks"]
    np.testing.assert_allclose(res_t.step_losses.numpy(), np.asarray(res_j.step_losses),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_t.losses.numpy(), np.asarray(res_j.losses), rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_t.matrices.numpy(), np.asarray(res_j.matrices),
                               atol=POSE_ATOL)
    lab_t, lab_j = res_t.labels.numpy(), np.asarray(res_j.labels)
    for s in range(S):
        for t in range(T):
            valid = (slice(None) if masks is None
                     else masks[0, 0] if t == 0 else masks[s, t])
            np.testing.assert_array_equal(lab_t[s, t][valid], lab_j[s, t][valid])


def test_fused_driver_cuts_at_host_waiting_phases():
    """With ``mlp_icp`` (SVD) or ``use_normals`` (eigh) the fused driver runs
    its programs around the eager phase and equals the batched driver."""
    frames, masks, init_j, sp, ap = _driver_inputs(True)
    init_t = SegmentInit(*(torch.from_numpy(np.array(v)) for v in init_j[:3]),
                         torch.from_numpy(masks[0, 0]))
    model = PoseRegressor("q", H, num_seqs=S)
    spt, apt = params_from_jax(_np_tree(sp), "q"), params_from_jax(_np_tree(ap), "q")
    ft, mt = torch.from_numpy(frames), torch.from_numpy(masks)
    for opt in (dict(mlp_icp=True), dict(use_normals=True)):
        cfg = _config(RegistrationConfig, **opt)._replace(epochs=8)
        _assert_same(register_sequences_fused(model, cfg, spt, apt, init_t, ft, mt),
                     register_sequences_batched(model, cfg, spt, apt, init_t, ft, mt,
                                                eager=True))


# ---------------------------------------------------------------------------
# the chain fit in chunk programs
# ---------------------------------------------------------------------------

def test_chain_fit_chunks_equal_the_step_loop_and_match_jax():
    cms_j, jlinks, jjoints, frames = hinge_problem()
    kw = dict(steps=60, points_per_link=256)
    cms_t = [coord_map_from_jax(c) for c in cms_j]
    fits = {mode: tchain.refine_chain(port_links(jlinks), port_joints(jjoints), cms_t, frames,
                                      device="cpu", **kw, **extra)
            for mode, extra in (("chunked", dict(dispatch_steps=25)),
                                ("eager", dict(eager=True)))}
    (tref_c, tres_c), (tref_e, tres_e) = fits["chunked"], fits["eager"]
    for f in ("axes", "origins", "thetas", "step_losses", "freeze_deltas", "subtree_share"):
        np.testing.assert_array_equal(getattr(tres_c, f), getattr(tres_e, f), err_msg=f)
    assert tres_c.loss == tres_e.loss and tres_c.step_losses.shape == (60,)
    jrefined, jres, jlosses = run_jax_chain(jlinks, jjoints, cms_j, frames, **kw)
    assert_chain_results_match(tres_c, jres, jlosses, tref_c, jrefined)


def test_chain_fit_prints_at_chunk_boundaries(capsys):
    cms_j, jlinks, jjoints, frames = hinge_problem()
    tchain.refine_chain(port_links(jlinks), port_joints(jjoints),
                        [coord_map_from_jax(c) for c in cms_j], frames, steps=60,
                        points_per_link=64, dispatch_steps=25, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert [ln.split()[1] for ln in out.splitlines() if " loss " in ln] == [
        "25/60", "50/60", "60/60"]
    assert out.count("axis net deg") == 1            # the window closes at the end


# ---------------------------------------------------------------------------
# the revolute-joint fit in chunk programs
# ---------------------------------------------------------------------------

def _revolute_inputs():
    """test_torch_chain.py's single-joint fit: a child cloud turning about z
    through an origin off the parent's, an axis guess 25 degrees off."""
    rng = np.random.default_rng(0)
    T, P = 5, 256
    x = rng.uniform([-0.1, -0.05, -0.05], [0.4, 0.05, 0.05], (200, 3)).astype(np.float32)
    u_true, o_true = np.array([0.0, 0.0, 1.0]), np.array([0.05, 0.02, 0.0])
    parent_T = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    obs = np.zeros((T, P, 3), np.float32)
    mask = np.zeros((T, P), bool)
    for t in range(T):
        Rm = ScipyRot.from_rotvec(u_true * 0.15 * t).as_matrix()
        obs[t, :200] = (x - o_true) @ Rm.T + o_true + rng.normal(scale=2e-3, size=(200, 3))
        mask[t, :200] = True
    u0 = np.array([0.3, 0.2, 0.9], np.float32)
    u0 /= np.linalg.norm(u0)
    return parent_T, obs, mask, u0, np.zeros(3, np.float32), (0.1 * np.arange(T)).astype(
        np.float32)


@pytest.mark.parametrize("steps", [30, 80, 120, 0])
def test_revolute_fit_programs_equal_the_step_loop(steps):
    assert trefine.DISPATCH_STEPS == 50
    args = [torch.from_numpy(a) for a in _revolute_inputs()]
    programmed = trefine.fit_revolute_joint(*args, steps=steps)
    eager = trefine.fit_revolute_joint(*args, steps=steps, eager=True)
    _assert_same(programmed, eager)
    assert float(programmed.thetas[0]) == 0.0
    assert np.isinf(float(programmed.loss)) == (steps == 0)


def test_revolute_fit_programs_match_jax():
    args = _revolute_inputs()
    jres = jrefine.fit_revolute_joint(*(jnp.asarray(a) for a in args), steps=80)
    tres = trefine.fit_revolute_joint(*(torch.from_numpy(a) for a in args), steps=80)
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=FIT_LOSS_RTOL)
    for f in ("axis", "origin", "thetas"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   atol=GEOM_ATOL, err_msg=f)


def test_refine_joints_programs_equal_eager_and_match_jax():
    """As ``test_torch_chain.py test_refine_joints_matches_jax`` (5 steps,
    inside the window where the two packages agree), through the programs
    and through the step loop."""
    _, jlinks, jjoints, _ = hinge_problem()
    cm_j = jittered(make_hinge_coordmap(num_frames=6, angle_step=0.2))
    want = jrefine.refine_joints(jjoints, jlinks, cm_j, steps=5, point_cap=256)
    got = {eager: trefine.refine_joints(port_joints(jjoints), port_links(jlinks),
                                        coord_map_from_jax(cm_j), steps=5, point_cap=256,
                                        device="cpu", eager=eager)
           for eager in (False, True)}
    for a, e, b in zip(got[False], got[True], want, strict=True):
        assert (a.parent_link, a.child_link) == (b.parent_link, b.child_link)
        for f in ("global_axis", "global_pos", "local_axis", "local_pos"):
            np.testing.assert_array_equal(getattr(a, f), getattr(e, f), err_msg=f)
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=GEOM_ATOL, err_msg=f)
