"""Parity of the port's pose MLP, optimizer and k-means with the JAX
package on the CPU.

The port receives the JAX package's initial parameters (through
``params_from_jax``) and the same seeded numpy inputs.  Tolerances:
- one MLP forward: 1e-5 absolute (fp32, matmul sums in another order);
- one Adam / plateau step: 1e-7 absolute, the same elementwise formula;
- 20 training epochs: losses 1e-4 relative, poses 1e-4 absolute (Adam
  amplifies last-bit gradient differences a little each epoch);
- Lloyd: centres 1e-5 absolute, labels equal (no point sits on a boundary
  at these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autourdf_tpu.models.regmlp import init_params as j_init_params
from autourdf_tpu.ops.kmeans import assign as j_assign, lloyd as j_lloyd
from autourdf_tpu.registration import optimizer as jopt
from autourdf_tpu_torch.models.regmlp import MODES, PoseRegressor, params_from_jax, sin_encoding
from autourdf_tpu_torch.ops.kmeans import assign, kmeans, kmeans_plusplus_init, lloyd
from autourdf_tpu_torch.registration import optimizer as topt


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _poses(K, seed=0):
    rng = np.random.default_rng(seed)
    from scipy.spatial.transform import Rotation

    m = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    m[:, :3, :3] = Rotation.random(K, random_state=seed).as_matrix()
    m[:, :3, 3] = rng.normal(scale=0.3, size=(K, 3))
    return m


@pytest.mark.parametrize("mode", MODES)
def test_pose_regressor_parity_from_jax_params(mode):
    K, H = 5, 32
    model_j, params = j_init_params(jax.random.PRNGKey(3), mode, K, H)
    m = _poses(K)
    out_j = np.asarray(model_j.apply(params, jnp.asarray(m)))
    model_t = PoseRegressor(mode, H, num_seqs=1)
    model_t.load_state_dict(params_from_jax(_np_tree(params), mode))
    with torch.no_grad():
        out_t = model_t(torch.from_numpy(m)[None])[0].numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)


def test_params_from_jax_sequence_stack():
    # a per-sequence stack from jax.vmap(init): leading S axis kept
    K, H, S = 4, 32, 3
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    stack = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])(keys)
    model_j = j_init_params(keys[0], "q", K, H)[0]
    m = np.stack([_poses(K, s) for s in range(S)])
    out_j = np.asarray(jax.vmap(model_j.apply)(stack, jnp.asarray(m)))
    model_t = PoseRegressor("q", H, num_seqs=S)
    model_t.load_state_dict(params_from_jax(_np_tree(stack), "q"))
    with torch.no_grad():
        out_t = model_t(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    # the flat (S, P) view round-trips
    theta = model_t.flat_params()
    assert theta.shape == (S, sum(p[0].numel() for p in model_t.parameters()))
    np.testing.assert_array_equal(model_t.forward_flat(theta, torch.from_numpy(m)).detach().numpy(),
                                  out_t)
    with pytest.raises(ValueError):
        params_from_jax(_np_tree(stack), "dq")


def test_sin_encoding_parity():
    from autourdf_tpu.models.regmlp import sin_encoding as j_sin

    x = np.random.default_rng(1).normal(size=(6, 7)).astype(np.float32)
    np.testing.assert_allclose(sin_encoding(torch.from_numpy(x)).numpy(),
                               np.asarray(j_sin(jnp.asarray(x))), atol=1e-6)


def test_apply_pose_rows_gather_equals_one_hot():
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(2, 6, 3, 4)).astype(np.float32)
    pts = rng.normal(size=(2, 50, 3)).astype(np.float32)
    labels = rng.integers(0, 6, size=(2, 50))
    got = topt.apply_pose_rows(torch.from_numpy(rows), torch.from_numpy(pts),
                               torch.from_numpy(labels)).numpy()
    for s in range(2):
        ref = np.asarray(jopt.apply_pose_rows(jnp.asarray(rows[s]), jnp.asarray(pts[s]),
                                              jnp.asarray(labels[s], jnp.int32)))
        np.testing.assert_allclose(got[s], ref, atol=1e-6)


def test_adam_and_plateau_step_parity():
    rng = np.random.default_rng(4)
    S, P = 2, 37
    theta, g1, g2 = (rng.normal(size=(S, P)).astype(np.float32) for _ in range(3))
    lrs = np.array([2e-4, 1e-2], np.float32)
    t_theta, t_state = torch.from_numpy(theta), topt.adam_init(torch.from_numpy(theta))
    for g in (g1, g2):
        t_theta, t_state = topt.adam_update(torch.from_numpy(g), t_state, t_theta,
                                            torch.from_numpy(lrs))
    for s in range(S):
        j_theta, j_state = jnp.asarray(theta[s]), jopt.adam_init(jnp.asarray(theta[s]))
        for g in (g1, g2):
            j_theta, j_state = jopt.adam_update(jnp.asarray(g[s]), j_state, j_theta, lrs[s])
        np.testing.assert_allclose(t_theta[s].numpy(), np.asarray(j_theta), atol=1e-7)
        np.testing.assert_allclose(t_state.mu[s].numpy(), np.asarray(j_state.mu), atol=1e-7)
        np.testing.assert_allclose(t_state.nu[s].numpy(), np.asarray(j_state.nu), atol=1e-7)

    # plateau: two sequences with different loss streams, step by step
    streams = np.array([[1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.89999],
                        [1.0, 0.5, 0.4, 0.4, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]], np.float32)
    ts = topt.plateau_init(1.0, 2, "cpu")
    js = [jopt.plateau_init(1.0) for _ in range(2)]
    for e in range(streams.shape[1]):
        ts = topt.plateau_update(ts, torch.from_numpy(streams[:, e]), factor=0.5, patience=2)
        for s in range(2):
            js[s] = jopt.plateau_update(js[s], jnp.asarray(streams[s, e]), factor=0.5, patience=2)
            assert float(ts.lr[s]) == float(js[s].lr)
            assert int(ts.num_bad[s]) == int(js[s].num_bad)
            assert float(ts.best[s]) == float(js[s].best)


def _train_problem(seed, K=3, N=120):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=0.3, size=(K, 3)).astype(np.float32)
    m0 = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    m0[:, :3, 3] = centers
    labels = rng.integers(0, K, N)
    pts = rng.normal(scale=0.05, size=(N, 3)).astype(np.float32)
    return m0, pts, labels, pts + centers[labels]


@pytest.mark.parametrize("corr_every", [1, 4])
def test_train_pose_mlp_parity_with_freeze(corr_every):
    """Two sequences in one batch, 20 epochs: sequence 0 chases a shifted
    target and (with fresh correspondences every epoch) keeps improving;
    sequence 1's target is where it starts, so it stops improving and
    freezes (stop_patience=1)."""
    K, H, epochs = 3, 32, 20
    m0, pts, labels, world = _train_problem(5, K)
    targets = np.stack([world + np.float32(0.03), world])
    model_j, _ = j_init_params(jax.random.PRNGKey(0), "q", K, H)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    stack = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])(keys)
    kw = dict(epochs=epochs, learning_rate=2e-3, stop_patience=1, corr_every=corr_every)

    model_t = PoseRegressor("q", H, num_seqs=2)
    theta = model_t.flat_params(params_from_jax(_np_tree(stack), "q"))
    tile = lambda a: torch.from_numpy(np.stack([a, a]))
    res_t = topt.train_pose_mlp(model_t, theta, tile(m0), torch.from_numpy(targets),
                                tile(pts), tile(labels), **kw)
    res_j = jax.vmap(lambda p, t: jopt.train_pose_mlp(
        model_j, p, jnp.asarray(m0), t, jnp.asarray(pts), jnp.asarray(labels, jnp.int32),
        chamfer_backend="xla", **kw))(stack, jnp.asarray(targets))
    hist_j, hist_t = np.asarray(res_j.loss_history), res_t.loss_history.numpy()
    np.testing.assert_array_equal(np.isinf(hist_t), np.isinf(hist_j))
    fin = np.isfinite(hist_j)
    np.testing.assert_allclose(hist_t[fin], hist_j[fin], rtol=1e-4)
    np.testing.assert_allclose(res_t.best_loss.numpy(), np.asarray(res_j.best_loss), rtol=1e-4)
    np.testing.assert_allclose(res_t.best_matrices.numpy(), np.asarray(res_j.best_matrices),
                               atol=1e-4)
    assert np.isinf(hist_j[1, -1])
    if corr_every == 1:
        assert np.isfinite(hist_j[0, -1])


def test_lloyd_parity_from_shared_centres():
    rng = np.random.default_rng(6)
    pts = np.concatenate([rng.normal(loc=c, scale=0.1, size=(60, 3))
                          for c in ([0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1])]
                         ).astype(np.float32)
    mask = rng.random(len(pts)) > 0.1
    init = pts[rng.choice(len(pts), 4, replace=False)] + np.float32(0.05)
    for m in (None, mask):
        res_j = j_lloyd(jnp.asarray(pts), jnp.asarray(init), iters=10,
                          mask=None if m is None else jnp.asarray(m))
        res_t = lloyd(torch.from_numpy(pts), torch.from_numpy(init), iters=10,
                          mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(res_t.centers.numpy(), np.asarray(res_j.centers), atol=1e-5)
        np.testing.assert_array_equal(res_t.labels.numpy(), np.asarray(res_j.labels))
        np.testing.assert_allclose(float(res_t.inertia), float(res_j.inertia), rtol=1e-5)
    # batched over sequences, and assign
    res_b = lloyd(torch.from_numpy(np.stack([pts, pts[::-1].copy()])),
                      torch.from_numpy(np.stack([init, init])), iters=10)
    res_j = j_lloyd(jnp.asarray(pts[::-1].copy()), jnp.asarray(init), iters=10)
    np.testing.assert_allclose(res_b.centers[1].numpy(), np.asarray(res_j.centers), atol=1e-5)
    np.testing.assert_array_equal(
        assign(torch.from_numpy(pts), torch.from_numpy(init)).numpy(),
        np.asarray(j_assign(jnp.asarray(pts), jnp.asarray(init))))


def test_kmeans_plusplus_seeds_and_fps_not_ported():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    mask = np.arange(200) < 150
    gen = torch.Generator().manual_seed(0)
    c = kmeans_plusplus_init(gen, torch.from_numpy(pts), 6, torch.from_numpy(mask))
    # every seed is a distinct valid point of the cloud
    d = np.abs(pts[None, :150] - c.numpy()[:, None]).sum(-1)
    assert np.all(d.min(1) == 0) and len(np.unique(d.argmin(1))) == 6
    res = kmeans(gen, torch.from_numpy(pts), 6, iters=8, mask=torch.from_numpy(mask))
    assert res.centers.shape == (6, 3) and torch.isfinite(res.inertia)
    # farthest-point seeding is ported: deterministic, whatever the generator
    fps = [kmeans(torch.Generator().manual_seed(s), torch.from_numpy(pts), 6, iters=8,
                  mask=torch.from_numpy(mask), seed_mode="fps") for s in (0, 1)]
    assert torch.equal(fps[0].labels, fps[1].labels) and torch.isfinite(fps[0].inertia)
    with pytest.raises(ValueError, match="seed_mode"):
        kmeans(gen, torch.from_numpy(pts), 6, seed_mode="grid")
