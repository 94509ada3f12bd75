"""The port's parallel layer (``autourdf_tpu_torch.parallel``) against the JAX
package's (``autourdf_tpu.parallel``) on the CPU.

JAX runs in this process on its 8-device virtual CPU mesh
(``tests/conftest.py``); the port runs in 4 gloo ranks started by
``parallel.launch.run`` (the rank functions are in
``tests/torch_parallel_ranks.py``, which imports no JAX).  The ranks start
in background threads when the module's first test asks for them, so that
JAX computes its side meanwhile.  Inputs are seeded numpy arrays; the MLP
parameters are JAX's, converted with ``params_from_jax``.

Tolerances: against JAX, the sharded Chamfer's loss 1e-6 relative and its
gradients 1e-6 absolute (sums in another order); against the port's own
single-process path, exact (every rank rebuilds the loss from the
assembled matches as ``chamfer_distance`` does); the (dp, sp) training
step's best losses 1e-5 relative and 1e-6 absolute and its best matrices
1e-5 absolute, and the dp registration's losses 1e-5 absolute, against JAX
(the JAX package's own tolerances for its sharded paths, whose Adam epochs
compound last-bit differences), and exact against the port's own
single-process ``train_epochs`` and ``register_sequences_batched``.  The
training step's programs equal its eager loop exactly.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from autourdf_tpu.models import PoseRegressor as JPoseRegressor
from autourdf_tpu.models import init_params as j_init_params
from autourdf_tpu.parallel import make_mesh as j_make_mesh
from autourdf_tpu.parallel import mesh_scope as j_mesh_scope
from autourdf_tpu.parallel import register_sequences_sharded as j_register_sharded
from autourdf_tpu.parallel import sharded_chamfer as j_sharded_chamfer
from autourdf_tpu.parallel import train_step_dp_sp as j_train_step_dp_sp
from autourdf_tpu.registration import RegistrationConfig as JConfig
from autourdf_tpu.registration import SegmentInit as JSegmentInit
from autourdf_tpu_torch.models.regmlp import PoseRegressor, params_from_jax
from autourdf_tpu_torch.ops.chamfer import chamfer_distance
from autourdf_tpu_torch.ops.knn import nn_search_bidirectional
from autourdf_tpu_torch.parallel import launch
from autourdf_tpu_torch.registration import (
    RegistrationConfig,
    SegmentInit,
    register_sequences_batched,
)
from autourdf_tpu_torch.registration.optimizer import train_epochs, train_init

WORLD = 4
to_np = lambda tree: jax.tree.map(np.asarray, tree)


def chamfer_inputs():
    rng = np.random.default_rng(11)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    cases = {
        "128x256": dict(x=f32(128, 3), y=f32(256, 3), xm=None, ym=None, grad=False),
        "101x203": dict(x=f32(101, 3), y=f32(203, 3), xm=None, ym=None, grad=False),
    }
    cases["101x203 masked"] = dict(x=cases["101x203"]["x"], y=cases["101x203"]["y"],
                                   xm=rng.random(101) < 0.8, ym=rng.random(203) < 0.7, grad=False)
    cases["64x160 grad"] = dict(x=f32(64, 3), y=f32(160, 3), xm=None, ym=None, grad=True)
    # port only: a sequence batch with float masks, gradients on both sides
    cases["batched float masks"] = dict(
        x=f32(2, 60, 3), y=f32(2, 90, 3), xm=(rng.random((2, 60)) < 0.9).astype(np.float32),
        ym=(rng.random((2, 90)) < 0.8).astype(np.float32), grad=True)
    return cases


def auto_inputs():
    rng = np.random.default_rng(12)
    return dict(x=rng.normal(size=(96, 3)).astype(np.float32),
                y=rng.normal(size=(256, 3)).astype(np.float32), threshold=128)


def step_inputs():
    """The (dp, sp) training step of test_parallel_native_viz.py."""
    S, N, M, K, H = 4, 96, 128, 3, 32
    rng = np.random.default_rng(13)
    params = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])(
        jax.random.split(jax.random.PRNGKey(3), S))
    mats = np.tile(np.eye(4, dtype=np.float32), (S, K, 1, 1))
    mats[:, :, :3, 3] = rng.normal(scale=0.2, size=(S, K, 3))
    return dict(S=S, K=K, H=H, epochs=4, params_j=params, mats=mats,
                targets=rng.normal(scale=0.3, size=(S, M, 3)).astype(np.float32),
                points=rng.normal(scale=0.1, size=(S, N, 3)).astype(np.float32),
                labels=rng.integers(0, K, size=(S, N)).astype(np.int64))


def registration_inputs():
    """The dp registration of test_parallel_native_viz.py."""
    S, T, N, K, H = 4, 3, 128, 4, 32
    rng = np.random.default_rng(14)
    frames = (rng.normal(size=(S, T, N, 3)) * 0.3).astype(np.float32)
    centers = (rng.normal(size=(K, 3)) * 0.3).astype(np.float32)
    m0 = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    m0[:, :3, 3] = centers
    labels = rng.integers(0, K, N).astype(np.int64)
    init = (m0, frames[0, 0] - centers[labels], labels)
    keys = jax.random.split(jax.random.PRNGKey(0), 2 * S)
    mk = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])
    return dict(S=S, K=K, H=H, epochs=5, kmeans_iters=4, frames=frames, init=init,
                sp_j=mk(keys[:S]), ap_j=mk(keys[S:]))


@pytest.fixture(scope="module")
def inputs():
    return dict(cham=chamfer_inputs(), auto=auto_inputs(), step=step_inputs(),
                reg=registration_inputs())


@pytest.fixture(scope="module")
def port(inputs):
    """The port's ranks, started in background threads: futures of the
    per-rank result lists."""
    step, reg = inputs["step"], inputs["reg"]
    step_args = {k: v for k, v in step.items() if k != "params_j"}
    step_args["params"] = {k: v.numpy() for k, v in
                           params_from_jax(to_np(step["params_j"]), "q").items()}
    reg_args = {k: v for k, v in reg.items() if k not in ("sp_j", "ap_j")}
    reg_args["sp"] = {k: v.numpy() for k, v in params_from_jax(to_np(reg["sp_j"]), "q").items()}
    reg_args["ap"] = {k: v.numpy() for k, v in params_from_jax(to_np(reg["ap_j"]), "q").items()}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = dict(
        sp=pool.submit(launch.run, ranks.sp_cases, WORLD,
                       (list(inputs["cham"].values()), inputs["auto"]), "cpu"),
        dp=pool.submit(launch.run, ranks.dp_sp_and_registration, WORLD,
                       (step_args, reg_args), "cpu"))
    yield futures
    pool.shutdown(wait=True)


def _same_on_every_rank(results, get):
    first = get(results[0])
    for r in results[1:]:
        torch.testing.assert_close(get(r), first, rtol=0, atol=0)
    return first


@pytest.mark.parametrize("name", ["128x256", "101x203", "101x203 masked", "64x160 grad"])
def test_sharded_chamfer_matches_jax(inputs, port, name):
    c = inputs["cham"][name]
    i = list(inputs["cham"]).index(name)
    res = port["sp"].result()
    loss = _same_on_every_rank(res, lambda r: r["cases"][i]["loss"])
    mesh = j_make_mesh((WORLD,), ("sp",))
    args = [jnp.asarray(c[k]) if c[k] is not None else None for k in ("x", "y", "xm", "ym")]
    np.testing.assert_allclose(float(loss), float(j_sharded_chamfer(mesh, *args)), rtol=1e-6)
    if c["grad"]:
        gx_j, gy_j = jax.grad(lambda x, y: j_sharded_chamfer(mesh, x, y), argnums=(0, 1))(
            *args[:2])
        gx = _same_on_every_rank(res, lambda r: r["cases"][i]["gx"])
        gy = _same_on_every_rank(res, lambda r: r["cases"][i]["gy"])
        np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), atol=1e-6)
        np.testing.assert_allclose(gy.numpy(), np.asarray(gy_j), atol=1e-6)


@pytest.mark.parametrize("name", list(chamfer_inputs()))
def test_sharded_chamfer_equals_single_process(inputs, port, name):
    """Every rank's loss and gradients equal the port's own unsharded
    ``chamfer_distance`` bit for bit, and the assembled search equals the
    single-process search, index for index."""
    c = inputs["cham"][name]
    i = list(inputs["cham"]).index(name)
    res = port["sp"].result()
    x = torch.tensor(c["x"], requires_grad=c["grad"])
    y = torch.tensor(c["y"], requires_grad=c["grad"])
    masks = [None if c[k] is None else torch.tensor(c[k]) for k in ("xm", "ym")]
    loss = chamfer_distance(x, y, *masks)
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(_same_on_every_rank(res, lambda r: r["cases"][i]["loss"]),
                               loss.detach(), **exact)
    if c["grad"]:
        loss.sum().backward()
        for g, ref in (("gx", x.grad), ("gy", y.grad)):
            torch.testing.assert_close(_same_on_every_rank(res, lambda r: r["cases"][i][g]), ref,
                                       **exact)
    xs, ys = x.detach(), y.detach()
    ref = nn_search_bidirectional(xs if xs.dim() == 3 else xs[None],
                                  ys if ys.dim() == 3 else ys[None])
    got = _same_on_every_rank(res, lambda r: r["cases"][i]["search"])
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **exact)


@pytest.mark.parametrize("name", list(chamfer_inputs()))
def test_search_split_equals_sharded_search(port, name):
    """``search_local`` -> ``search_reduce`` -> ``search_unpack``, the cut
    the training step's programs make, gives ``sharded_search``'s result,
    index for index, on every rank."""
    i = list(chamfer_inputs()).index(name)
    for r in port["sp"].result():
        for a, b in zip(r["cases"][i]["split"], r["cases"][i]["search"], strict=True):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["128x256", "64x160 grad"])
def test_chamfer_collective_equals_sharded_chamfer(port, name):
    """The per-shard form, each rank passing its quarter of the target,
    gives ``sharded_chamfer``'s loss, the whole gradient of ``x`` and the
    rank's rows of the gradient of ``y``, bit for bit."""
    i = list(chamfer_inputs()).index(name)
    for r in port["sp"].result():
        whole, col = r["cases"][i], r["cases"][i]["collective"]
        torch.testing.assert_close(col["loss"], whole["loss"], rtol=0, atol=0)
        if "gx" in whole:
            torch.testing.assert_close(col["gx"], whole["gx"], rtol=0, atol=0)
            torch.testing.assert_close(col["gy"], whole["gy"][col["cut"]], rtol=0, atol=0)


def test_mesh_scope_nesting_and_active_mesh(port):
    for r in port["sp"].result():
        bad = [label for label, ok in r["scopes"] if not ok]
        assert not bad, bad


def test_chamfer_auto_shards_in_mesh_scope(port):
    for r in port["sp"].result():
        a = r["auto"]
        assert a["calls_in_scope"] == 1, "mesh-scoped large chamfer did not shard"
        assert a["calls_below_threshold"] == 1, "a target below the threshold sharded"
        assert a["calls_dp_only"] == 1, "a mesh without an sp axis sharded"
        assert a["calls_after"] == 1, "the single-device path sharded outside the scope"
        torch.testing.assert_close(a["auto"], a["baseline"], rtol=1e-6, atol=0)
        torch.testing.assert_close(a["after"], a["baseline"], rtol=0, atol=0)


def test_dp_sp_train_step_matches_jax(inputs, port):
    st = inputs["step"]
    mesh = j_make_mesh((2, 2), ("dp", "sp"))
    model = JPoseRegressor(mode="q", hidden_dim=st["H"])
    m_j, l_j = j_train_step_dp_sp(mesh, model, st["params_j"], jnp.asarray(st["mats"]),
                                  jnp.asarray(st["targets"]), jnp.asarray(st["points"]),
                                  jnp.asarray(st["labels"], jnp.int32), num_epochs=st["epochs"])
    res = port["dp"].result()
    best_m = _same_on_every_rank(res, lambda r: r["best_m"])
    best_l = _same_on_every_rank(res, lambda r: r["best_l"])
    np.testing.assert_allclose(best_l.numpy(), np.asarray(l_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(best_m.numpy(), np.asarray(m_j), atol=1e-5)

    # and the port's own single-process train_init + train_epochs
    model_t = PoseRegressor("q", st["H"], num_seqs=st["S"])
    theta = model_t.flat_params(params_from_jax(to_np(st["params_j"]), "q"))
    mats = torch.from_numpy(st["mats"])
    carry = train_init(theta, mats, 2e-4)
    carry, _ = train_epochs(model_t, carry, mats, torch.from_numpy(st["targets"]),
                            torch.from_numpy(st["points"]), torch.from_numpy(st["labels"]),
                            st["epochs"])
    torch.testing.assert_close(best_l, carry.best_loss, rtol=0, atol=0)
    torch.testing.assert_close(best_m, carry.best_m, rtol=0, atol=0)


def test_dp_sp_train_step_programs_equal_eager(port):
    """The default training step (programs A and B around the all-reduces)
    gives the eager loop's best matrices and losses, bit for bit, on every
    rank."""
    for r in port["dp"].result():
        eager_m, eager_l = r["eager"]
        torch.testing.assert_close(r["best_m"], eager_m, rtol=0, atol=0)
        torch.testing.assert_close(r["best_l"], eager_l, rtol=0, atol=0)


def test_dp_registration_matches_jax(inputs, port):
    rg = inputs["reg"]
    model = JPoseRegressor(mode="q", hidden_dim=rg["H"])
    cfg = JConfig(num_seg=rg["K"], hidden_dim=rg["H"], epochs=rg["epochs"],
                  kmeans_iters=rg["kmeans_iters"], chamfer_backend="xla")
    m0, pts, lab = rg["init"]
    init = JSegmentInit(jnp.asarray(m0), jnp.asarray(pts), jnp.asarray(lab, jnp.int32))
    mesh = j_make_mesh((WORLD,), ("dp",))
    with j_mesh_scope(mesh):
        res_j = j_register_sharded(mesh, model, cfg, rg["sp_j"], rg["ap_j"], init,
                                   jnp.asarray(rg["frames"]))
    res = port["dp"].result()
    reg = _same_on_every_rank(res, lambda r: r["reg"].losses)
    np.testing.assert_allclose(reg.numpy(), np.asarray(res_j.losses), atol=1e-5)
    for field in ("matrices", "labels", "step_losses", "local_points"):
        _same_on_every_rank(res, lambda r: getattr(r["reg"], field))

    # and the port's own single-process register_sequences_batched
    model_t = PoseRegressor("q", rg["H"], num_seqs=rg["S"])
    cfg_t = RegistrationConfig(num_seg=rg["K"], hidden_dim=rg["H"], epochs=rg["epochs"],
                               kmeans_iters=rg["kmeans_iters"])
    res_t = register_sequences_batched(
        model_t, cfg_t, params_from_jax(to_np(rg["sp_j"]), "q"),
        params_from_jax(to_np(rg["ap_j"]), "q"), SegmentInit(*(torch.from_numpy(a)
                                                               for a in rg["init"])),
        torch.from_numpy(rg["frames"]))
    for field in res_t._fields:
        torch.testing.assert_close(getattr(res[0]["reg"], field), getattr(res_t, field), rtol=0,
                                   atol=0)


def test_chamfer_fn_requires_corr_every_one():
    model = PoseRegressor("q", 16, num_seqs=1, generator=torch.Generator().manual_seed(0))
    mats = torch.eye(4).expand(1, 2, 4, 4).clone()
    pts = torch.zeros(1, 8, 3)
    carry = train_init(model.flat_params(), mats, 1e-3)
    with pytest.raises(ValueError, match="corr_every"):
        train_epochs(model, carry, mats, pts, pts, torch.zeros(1, 8, dtype=torch.int64), 4,
                     corr_every=2, chamfer_fn=lambda *a: None)


def test_train_step_dp_sp_refuses_uneven_splits():
    """S % dp and M % sp are checked before any collective (a mesh of one
    rank each way is enough to reach the check)."""
    from autourdf_tpu_torch.parallel import sharding

    mesh = object.__new__(sharding.Mesh)
    mesh.shape, mesh.coords = {"dp": 2, "sp": 2}, {"dp": 0, "sp": 0}
    with pytest.raises(ValueError, match="S % dp"):
        sharding.train_step_dp_sp(mesh, None, {}, torch.zeros(3, 1, 4, 4), torch.zeros(3, 8, 3),
                                  torch.zeros(3, 4, 3), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="M % sp"):
        sharding.train_step_dp_sp(mesh, None, {}, torch.zeros(2, 1, 4, 4), torch.zeros(2, 7, 3),
                                  torch.zeros(2, 4, 3), torch.zeros(2, 4))


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="fails on purpose"):
        launch.run(ranks.fails_on_rank, 2, (1,), "cpu", timeout_s=60)
