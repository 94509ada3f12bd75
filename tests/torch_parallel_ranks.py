"""Rank functions of tests/test_torch_parallel.py: each runs in every rank
that ``autourdf_tpu_torch.parallel.launch.run`` starts (4 gloo ranks on the
CPU) and imports torch and the port only, never JAX.  Inputs arrive as
numpy arrays; each rank returns what it saw, and the test compares."""

import numpy as np
import torch

from autourdf_tpu_torch.models.regmlp import PoseRegressor
from autourdf_tpu_torch.parallel import (
    active_mesh,
    chamfer_collective,
    make_mesh,
    mesh_scope,
    register_sequences_sharded,
    sharded_chamfer,
    train_step_dp_sp,
)
from autourdf_tpu_torch.parallel.sharding import (search_local, search_reduce, search_unpack,
                                                  sharded_search)


def _t(a, **kw):
    return None if a is None else torch.tensor(a, **kw)


def sp_cases(cases, auto):
    """Mesh (4,) "sp": every Chamfer case (loss, gradients when asked, the
    assembled bidirectional search), the scope nesting, and the auto-shard dispatch
    of ``ops.chamfer.chamfer_distance`` with its threshold lowered."""
    import autourdf_tpu_torch.ops.chamfer as cham_mod
    import autourdf_tpu_torch.parallel.sharding as sh_mod

    mesh = make_mesh((4,), ("sp",), device="cpu")
    out = {"cases": []}
    for c in cases:
        x = _t(c["x"], requires_grad=c["grad"])
        y = _t(c["y"], requires_grad=c["grad"])
        loss = sharded_chamfer(mesh, x, y, _t(c["xm"]), _t(c["ym"]))
        r = {"loss": loss.detach()}
        if c["grad"]:
            loss.sum().backward()
            r["gx"], r["gy"] = x.grad, y.grad
        xs, ys = x.detach(), y.detach()
        xs, ys = (xs if xs.dim() == 3 else xs[None]), (ys if ys.dim() == 3 else ys[None])
        r["search"] = sharded_search(mesh, xs, ys)
        # the split as train_step_dp_sp runs it: local, then the collectives
        # in place on the local result, then the unpack
        key, yside = search_local(mesh, xs, ys)
        r["split"] = search_unpack(*search_reduce(mesh, key, yside))
        if ys.shape[-2] % 4 == 0:
            r["collective"] = _collective(mesh, c)
        out["cases"].append(r)

    scopes = [("none at start", active_mesh() is None)]
    dp = make_mesh((4,), ("dp",), device="cpu")
    with mesh_scope(mesh) as m:
        scopes += [("enter returns the mesh", m is mesh), ("active", active_mesh() is mesh)]
        with mesh_scope(dp):
            scopes.append(("innermost wins", active_mesh() is dp))
        scopes.append(("outer restored", active_mesh() is mesh))
    scopes.append(("none at end", active_mesh() is None))
    out["scopes"] = scopes

    calls = []
    orig = sh_mod.sharded_chamfer

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    cham_mod.AUTO_SHARD_MIN_M = auto["threshold"]
    sh_mod.sharded_chamfer = spy
    try:
        x, y = _t(auto["x"]), _t(auto["y"])
        small = _t(auto["y"][: auto["threshold"] - 1])
        res = {"baseline": cham_mod.chamfer_distance(x, y)}
        with mesh_scope(mesh):
            res["auto"] = cham_mod.chamfer_distance(x, y)
            res["calls_in_scope"] = len(calls)
            cham_mod.chamfer_distance(x, small)
            res["calls_below_threshold"] = len(calls)
        with mesh_scope(dp):
            cham_mod.chamfer_distance(x, y)
            res["calls_dp_only"] = len(calls)
        res["after"] = cham_mod.chamfer_distance(x, y)
        res["calls_after"] = len(calls)
    finally:
        sh_mod.sharded_chamfer = orig
    out["auto"] = res
    return out


def _collective(mesh, c):
    """``chamfer_collective`` with this rank's quarter of ``y`` and of its
    weights: the loss, and the gradients of the whole ``x`` and of the
    rank's rows when the case asks for them."""
    m = c["y"].shape[-2] // 4
    cut = slice(mesh.index("sp") * m, (mesh.index("sp") + 1) * m)
    x = _t(c["x"], requires_grad=c["grad"])
    y = _t(c["y"][..., cut, :], requires_grad=c["grad"])
    xw = torch.ones(c["x"].shape[:-1]) if c["xm"] is None else _t(c["xm"]).float()
    yw = torch.ones(c["y"].shape[:-1]) if c["ym"] is None else _t(c["ym"]).float()
    loss = chamfer_collective(x, y, xw, yw[..., cut], mesh)
    r = {"loss": loss.detach(), "cut": cut}
    if c["grad"]:
        loss.sum().backward()
        r["gx"], r["gy"] = x.grad, y.grad
    return r


def dp_sp_and_registration(step, reg):
    """Mesh (2, 2) ("dp", "sp"): ``train_step_dp_sp`` as programs and
    eagerly; then mesh (4,) "dp": ``register_sequences_sharded`` inside its
    scope."""
    from autourdf_tpu_torch.registration import RegistrationConfig, SegmentInit

    mesh = make_mesh((2, 2), ("dp", "sp"), device="cpu")
    model = PoseRegressor("q", step["H"], num_seqs=step["S"])
    params = {k: torch.from_numpy(v) for k, v in step["params"].items()}
    args = (mesh, model, params, _t(step["mats"]), _t(step["targets"]), _t(step["points"]),
            _t(step["labels"]))
    best_m, best_l = train_step_dp_sp(*args, num_epochs=step["epochs"])
    eager = train_step_dp_sp(*args, num_epochs=step["epochs"], eager=True)

    dp = make_mesh((4,), ("dp",), device="cpu")
    model = PoseRegressor("q", reg["H"], num_seqs=reg["S"])
    cfg = RegistrationConfig(num_seg=reg["K"], hidden_dim=reg["H"], epochs=reg["epochs"],
                             kmeans_iters=reg["kmeans_iters"])
    init = SegmentInit(*(torch.from_numpy(a) for a in reg["init"]))
    to_t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}
    with mesh_scope(dp):
        res = register_sequences_sharded(dp, model, cfg, to_t(reg["sp"]), to_t(reg["ap"]), init,
                                         _t(reg["frames"]))
    return {"best_m": best_m, "best_l": best_l, "eager": eager, "reg": res}


def dp_sp_train_step_both_ways(step, device=None):
    """Mesh (2, 2) ("dp", "sp") on ``device`` (None: the card ``make_mesh``
    picks): ``train_step_dp_sp`` as programs, twice (captured on the card,
    then replayed), and eagerly, with the launch counts of each run."""
    from autourdf_tpu_torch.ops import _cuda

    mesh = make_mesh((2, 2), ("dp", "sp"), device=device)
    dev = mesh.device
    model = PoseRegressor("q", step["H"], num_seqs=step["S"], device=dev)
    params = {k: torch.from_numpy(v).to(dev) for k, v in step["params"].items()}
    args = [_t(step[k]).to(dev) for k in ("mats", "targets", "points", "labels")]
    out = {}
    for name in ("programs", "replayed", "eager"):
        before = dict(_cuda.launch_counts)
        best = train_step_dp_sp(mesh, model, params, *args, num_epochs=step["epochs"],
                                eager=name == "eager")
        out[name] = best + ({k: _cuda.launch_counts[k] - before[k] for k in before},)
    return out


def fails_on_rank(rank):
    """Raises on one rank (the others wait in a collective)."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    t = torch.zeros(1)
    dist.all_reduce(t)
    return t
