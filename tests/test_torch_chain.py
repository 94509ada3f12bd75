"""The port's kinematic-chain fit, revolute-joint fit, DoF probe ladder and
pairwise path against the JAX package on the CPU.

Both packages get the same inputs: the JAX package's synthetic fixtures (a
2-link hinge, the 4-link wrist trap), whose fields the port's ``CoordMap``
takes over (``coord_map_from_jax``), the same frames and masks, and the
same links and joint estimates (the JAX ones, copied field by field).  The
JAX fits run as the JAX package's own tests run them, on the CPU, where its
Chamfer takes the plain XLA search; the port's searches take their plain
PyTorch versions.  Per-step losses are read from the JAX fit by running it
one step a chunk (``dispatch_steps=1``, which does not change the result)
and recording each chunk's loss.

Tolerances (both fits are fp32 Adam on the same subgradients; sums are
ordered differently): losses 1e-5 relative, axes, origins, thetas and
freeze deltas 1e-4 absolute, subtree shares, link sets, ladder picks and
the probe's k exact.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot
from test_structure_joints_mesh import make_hinge_coordmap, make_wrist_trap_chain
from test_torch_structure import coord_map_from_jax

import jax
import jax.numpy as jnp

import autourdf_tpu.joints.chain as jchain
import autourdf_tpu.joints.refine as jrefine
import autourdf_tpu.structure.model_select as jselect
import autourdf_tpu.structure.pairwise as jpairwise
from autourdf_tpu import structure as jst
from autourdf_tpu.joints.screw import JointEstimate as JJointEstimate
from autourdf_tpu.structure.tree import LinkNode as JLinkNode
from autourdf_tpu_torch.core import rotations as tR
from autourdf_tpu_torch.joints import chain as tchain
from autourdf_tpu_torch.joints import refine as trefine
from autourdf_tpu_torch.joints.screw import JointEstimate
from autourdf_tpu_torch.ops import chamfer as tchamfer
from autourdf_tpu_torch.structure import model_select as tselect
from autourdf_tpu_torch.structure import pairwise as tpairwise
from autourdf_tpu_torch.structure.tree import LinkNode

LOSS_RTOL = 1e-5
GEOM_ATOL = 1e-4
CPU = "cpu"


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

def port_links(jlinks):
    return [LinkNode(id=l.id, cluster_idx=set(l.cluster_idx),
                     connected_links=set(l.connected_links), parent_id=l.parent_id,
                     tree_id=l.tree_id, movement=l.movement) for l in jlinks]


def port_joints(jjoints):
    return [JointEstimate(**{f: getattr(j, f) for f in (
        "parent_link", "child_link", "local_axis", "local_pos", "global_pos", "global_axis")})
        for j in jjoints]


def link_facts(links):
    return sorted((l.id, l.parent_id, tuple(sorted(l.cluster_idx))) for l in links)


def world_frames(cm):
    """(T, N, 3) world clouds rebuilt from a CoordMap's registered poses."""
    out = []
    for t in range(cm.coords.shape[0]):
        pts = np.asarray(cm.cluster_points[t])
        labels = np.asarray(cm.cluster_labels[t])
        world = np.zeros_like(pts)
        for k in range(cm.num_coords):
            sel = labels == k
            M = cm.matrices[t, k]
            world[sel] = pts[sel] @ M[:3, :3].T + M[:3, 3]
        out.append(world.astype(np.float32))
    return np.stack(out)


def noisy(frames, seed=0, scale=2e-3):
    """Frames with scanner noise.  Noise-free frames coincide with the
    posed model to round-off, where the sign of each coordinate difference
    (the L1 subgradient) is the round-off's: the two packages' gradients
    would part on it, not on anything they compute."""
    return (frames + np.random.default_rng(seed).normal(scale=scale, size=frames.shape)
            ).astype(np.float32)


def hinge_problem():
    """The JAX chain tests' hinge (6 frames, 0.2 rad a step, with noise)
    and a joint estimate tilted 25 degrees off the true z axis."""
    cm = make_hinge_coordmap(num_frames=6, angle_step=0.2)
    groups, _, _ = jst.coord_clustering(jst.combined_sum_map([cm], "pose"), 2)
    jlinks = jst.kinematics_tree(cm, groups, jst.cluster_mst(cm))
    bad = ScipyRot.from_rotvec([0.44, 0, 0]).as_matrix() @ np.array([0, 0, 1.0])
    jjoints = [JJointEstimate(parent_link=jlinks[0].id, child_link=jlinks[1].id,
                              local_axis=bad, local_pos=np.zeros(4),
                              global_pos=np.array([0.02, -0.03, 0.0]), global_axis=bad)]
    return [cm], jlinks, jjoints, noisy(world_frames(cm)[None])


def jittered(cm, seed=0, rot=0.01, trans=1e-3):
    """The CoordMap with registration error: every cluster pose moved by a
    small random rigid motion.  The analytic fixtures are exact, so their
    screw estimates give the true axes, which are coordinate axes of the
    link frames, and their registered clouds coincide with the frames:
    there the two packages' gradients part on round-off (a component that
    is exactly zero in one and 3e-9 in the other, which Adam's first steps,
    |g| against eps = 1e-8, turn into steps of a quarter of the learning
    rate; the sign of a coordinate difference of 1e-9), not on anything
    they compute."""
    from autourdf_tpu.structure import CoordMap as JCoordMap

    rng = np.random.default_rng(100 + seed)
    T, K = cm.matrices.shape[:2]
    d = np.tile(np.eye(4), (T, K, 1, 1))
    d[..., :3, :3] = ScipyRot.from_rotvec(rng.normal(scale=rot, size=(T * K, 3))).as_matrix(
    ).reshape(T, K, 3, 3)
    d[..., :3, 3] = rng.normal(scale=trans, size=(T, K, 3))
    return JCoordMap.from_arrays(cm.matrices @ d, cm.cluster_points, cm.cluster_labels,
                                 cm.raw_clouds)


def trap_problem():
    """The wrist trap (4 links, 3 joints) in two sequences with registration
    error, the motion tree and the screw estimates of the JAX package;
    noisy, ragged frames (the last 10 points of every second frame masked
    out)."""
    cms = [jittered(make_wrist_trap_chain(seed=s), seed=s) for s in (0, 1)]
    groups = [{0, 1}, {2, 3}, {4}, {5, 6}]
    jlinks = jst.motion_tree(cms, groups, 8)
    from autourdf_tpu.joints import estimate_joints_from_tree

    jjoints = estimate_joints_from_tree(jlinks, cms, 0, 8, interval=4)
    frames = noisy(np.stack([np.stack(cm.raw_clouds) for cm in cms]), seed=1)
    masks = np.ones(frames.shape[:3], bool)
    masks[:, 1::2, -10:] = False
    return cms, jlinks, jjoints, frames, masks


def run_jax_chain(jlinks, jjoints, cms, frames, **kw):
    """JAX refine_chain one step a chunk, recording every step's loss."""
    losses = []
    inner = jchain._chain_fit_chunk

    def recording(*a, **k):
        carry, loss = inner(*a, **k)
        losses.append(float(loss))
        return carry, loss

    jchain._chain_fit_chunk = recording
    try:
        refined, res = jchain.refine_chain(jlinks, jjoints, cms, frames, dispatch_steps=1, **kw)
    finally:
        jchain._chain_fit_chunk = inner
    return refined, res, np.asarray(losses)


def chain_geometry_gaps(tres, jres) -> dict:
    """The port's fit against the JAX package's, as geometry: the largest
    angle between the axes (degrees, sign-free), the largest distance of the
    port's origin from the JAX axis line (the origin's slide along its axis
    changes nothing), and the largest gaps of the final loss (relative),
    the angles and the freeze deltas."""
    ta, ja = tres.axes, np.asarray(jres.axes, np.float64)
    ang = np.degrees(np.arctan2(np.linalg.norm(np.cross(ta, ja), axis=1),
                                np.abs(np.sum(ta * ja, axis=1))))
    d = tres.origins - np.asarray(jres.origins, np.float64)
    line = np.linalg.norm(d - np.sum(d * ja, axis=1, keepdims=True) * ja, axis=1)
    out = dict(axis_deg=float(ang.max()), origin_line=float(line.max()),
               origin_abs=float(np.abs(d).max()),
               loss_rel=abs(tres.loss - float(jres.loss)) / float(jres.loss),
               theta=float(np.abs(tres.thetas - np.asarray(jres.thetas)).max()))
    if jres.freeze_deltas is not None:
        out["freeze"] = float(np.abs(tres.freeze_deltas - jres.freeze_deltas).max())
    return out


def assert_chain_results_match(tres, jres, jlosses, trefined, jrefined):
    np.testing.assert_allclose(tres.step_losses, jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tres.loss, float(jres.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tres.axes, np.asarray(jres.axes), atol=GEOM_ATOL)
    np.testing.assert_allclose(tres.origins, np.asarray(jres.origins), atol=GEOM_ATOL)
    np.testing.assert_allclose(tres.thetas, np.asarray(jres.thetas), atol=GEOM_ATOL)
    if jres.freeze_deltas is None:
        assert tres.freeze_deltas is None and tres.subtree_share is None
    else:
        np.testing.assert_allclose(tres.freeze_deltas, jres.freeze_deltas, atol=GEOM_ATOL)
        np.testing.assert_array_equal(tres.subtree_share, jres.subtree_share)
    for a, b in zip(trefined, jrefined, strict=True):
        assert (a.parent_link, a.child_link) == (b.parent_link, b.child_link)
        for f in ("global_axis", "global_pos", "local_axis", "local_pos"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=GEOM_ATOL, err_msg=f)


# ---------------------------------------------------------------------------
# chain kinematics and losses
# ---------------------------------------------------------------------------

def _random_chain(seed=0, J=3, T=4):
    rng = np.random.default_rng(seed)
    spec = jchain.ChainSpec(parent_index=(0, 1, 1), child_index=(1, 2, 3), root_index=0)
    frames0 = np.tile(np.eye(4, dtype=np.float32), (J + 1, 1, 1))
    frames0[:, :3, :3] = ScipyRot.from_rotvec(rng.normal(size=(J + 1, 3))).as_matrix()
    frames0[:, :3, 3] = rng.normal(scale=0.3, size=(J + 1, 3))
    u = rng.normal(size=(J, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = rng.normal(scale=0.1, size=(J, 3)).astype(np.float32)
    theta = rng.uniform(-1, 1, (T, J)).astype(np.float32)
    theta[0] = 0.0
    return spec, frames0, u, o, theta


def test_chain_world_transforms_match_jax():
    spec, frames0, u, o, theta = _random_chain()
    got = tchain.chain_world_transforms(
        tchain.ChainSpec(*spec), torch.from_numpy(frames0), torch.from_numpy(u),
        torch.from_numpy(o), torch.from_numpy(theta)).numpy()
    for t in range(theta.shape[0]):
        want = np.asarray(jchain.chain_world_transforms(
            spec, jnp.asarray(frames0), jnp.asarray(u), jnp.asarray(o), jnp.asarray(theta[t])))
        np.testing.assert_allclose(got[t], want, atol=1e-5)
    # step 0 (all angles zero) reproduces the rest frames
    np.testing.assert_allclose(got[0], frames0, atol=1e-5)


def _loss_inputs(seed=1, S=2, T=4, P=48, N=150):
    spec, frames0, u, o, _ = _random_chain(seed, T=T)
    rng = np.random.default_rng(seed)
    L, J = frames0.shape[0], u.shape[0]
    link_pts = rng.normal(scale=0.08, size=(L, P, 3)).astype(np.float32)
    link_masks = np.ones((L, P), bool)
    link_masks[1, -7:] = False
    theta = rng.uniform(-0.6, 0.6, (S, T, J)).astype(np.float32)
    frames = rng.normal(scale=0.4, size=(S, T, N, 3)).astype(np.float32)
    fmasks = np.ones((S, T, N), bool)
    fmasks[:, 1, -11:] = False
    return spec, frames0, link_pts, link_masks, u, o, theta, frames, fmasks


@pytest.mark.parametrize("trunc", [0.0, 2.0])
@pytest.mark.parametrize("anchor_step", [0, 2])
def test_chain_loss_values_and_gradients_match_jax(trunc, anchor_step):
    spec, frames0, link_pts, link_masks, u, o, theta, frames, fmasks = _loss_inputs()
    tspec = tchain.ChainSpec(*spec)
    # _theta_loss at explicit parameters
    jl = float(jchain._theta_loss(spec, jnp.asarray(frames0), jnp.asarray(link_pts),
                                  jnp.asarray(link_masks), jnp.asarray(u), jnp.asarray(o),
                                  jnp.asarray(theta), jnp.asarray(frames), jnp.asarray(fmasks),
                                  trunc=trunc))
    t = [torch.from_numpy(a) for a in (frames0, link_pts, link_masks, u, o, theta, frames,
                                      fmasks)]
    tl = float(tchain._theta_loss(tspec, *t, trunc=trunc))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)

    # _chain_loss (unit axes, pinned angles) and its gradients
    params = {"u": u * 1.3, "o": o, "theta": theta}
    jval, jgrad = jax.value_and_grad(
        lambda p: jchain._chain_loss(spec, jnp.asarray(frames0), jnp.asarray(link_pts),
                                     jnp.asarray(link_masks), p, jnp.asarray(frames),
                                     jnp.asarray(fmasks), anchor_step=anchor_step, trunc=trunc)
    )({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tval = tchain._chain_loss(tspec, torch.from_numpy(frames0), torch.from_numpy(link_pts),
                              torch.from_numpy(link_masks), tp, torch.from_numpy(frames),
                              torch.from_numpy(fmasks), anchor_step=anchor_step, trunc=trunc)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=LOSS_RTOL)
    for k in params:
        g_t, g_j = tp[k].grad.numpy(), np.asarray(jgrad[k])
        scale = float(np.abs(g_j).max())
        np.testing.assert_allclose(g_t, g_j, atol=1e-5 * scale, err_msg=k)
    # the pinned angles get no gradient
    pinned = tp["theta"].grad.numpy()
    assert np.all(pinned[:, 0] == 0) if anchor_step == 0 else np.all(pinned[0, anchor_step] == 0)


def test_zero_angle_gradients_are_finite():
    """The pinned angles are exactly 0, so rotvec_to_matrix(u * 0) sits on
    the zero-angle branch in every step: its gradient must stay finite (no
    sin(0)/0 in an unselected torch.where branch)."""
    th = torch.zeros((), requires_grad=True)
    (g,) = torch.autograd.grad(tR.rotvec_to_matrix(torch.ones(3) * th).sum(), th)
    assert torch.isfinite(g)
    u = torch.tensor([[0.3, -0.2, 0.9]], requires_grad=True)
    o = torch.tensor([[0.05, 0.0, 0.01]], requires_grad=True)
    theta = torch.zeros((1, 1), requires_grad=True)
    T = trefine._rot_about_axis(u, o, theta)
    grads = torch.autograd.grad(T.sum(), (u, o, theta))
    assert all(torch.isfinite(gr).all() for gr in grads)
    spec, frames0, link_pts, link_masks, u0, o0, theta0, frames, fmasks = _loss_inputs()
    theta0[:] = 0.0                                   # every angle on the zero branch
    tp = {"u": torch.tensor(u0, requires_grad=True), "o": torch.tensor(o0, requires_grad=True),
          "theta": torch.tensor(theta0, requires_grad=True)}
    loss = tchain._chain_loss(tchain.ChainSpec(*spec), *(torch.from_numpy(a) for a in (
        frames0, link_pts, link_masks)), tp, torch.from_numpy(frames), torch.from_numpy(fmasks))
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in tp.values())
    assert float(tp["theta"].grad.abs().sum()) > 0   # the unpinned zeros do move


# ---------------------------------------------------------------------------
# refine_chain and its options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(),
    dict(balance=True),
    dict(canonical_frames=3),
    dict(anchor_step=2),
    dict(trunc=2.0),
], ids=["plain", "balance", "canonical3", "anchor2", "trunc2"])
def test_refine_chain_matches_jax_hinge(opts):
    """50 steps, every step's loss compared.  With every option the two
    packages agree at each step of fits of 30, 40, 45, 50, 55 and 60 steps;
    some longer fits cross a nearest-neighbour tie on either side and part
    (ROADMAP.md Queue 3, ``tests/torch_chain_parity_sweep.py --window``);
    ``test_torch_chain_long.py`` holds the longer fits' geometry."""
    cms_j, jlinks, jjoints, frames = hinge_problem()
    kw = dict(steps=50, points_per_link=256, **opts)
    jrefined, jres, jlosses = run_jax_chain(jlinks, jjoints, cms_j, frames, **kw)
    trefined, tres = tchain.refine_chain(port_links(jlinks), port_joints(jjoints),
                                         [coord_map_from_jax(c) for c in cms_j], frames,
                                         device=CPU, **kw)
    assert len(jlosses) == 50 and tres.step_losses.shape == (50,)
    assert_chain_results_match(tres, jres, jlosses, trefined, jrefined)
    # the fit moves the loss down
    assert tres.step_losses[-1] < tres.step_losses[0]


def test_refine_chain_matches_jax_trap_ragged():
    """Three joints, two sequences, ragged frames: J + 1 forward-only
    evaluations for the freeze probe and a subtree share per joint.  8
    steps: on this input (210-point frames, 64 model points a link) the two
    fits part from step 10 on (2.5e-5 relative, 2e-4 by step 17) although
    their gradients at the same parameters agree to 3e-8 absolute; ROADMAP.md
    Queue 3."""
    cms_j, jlinks, jjoints, frames, masks = trap_problem()
    kw = dict(steps=8, points_per_link=64, frame_masks=masks)
    jrefined, jres, jlosses = run_jax_chain(jlinks, jjoints, cms_j, frames, **kw)
    trefined, tres = tchain.refine_chain(port_links(jlinks), port_joints(jjoints),
                                         [coord_map_from_jax(c) for c in cms_j], frames,
                                         device=CPU, **kw)
    assert_chain_results_match(tres, jres, jlosses, trefined, jrefined)
    assert tres.freeze_deltas.shape == (3,) and tres.subtree_share.shape == (3,)


def test_refine_chain_multi_anchor_matches_jax():
    cms_j, jlinks, jjoints, frames = hinge_problem()
    kw = dict(anchors=2, steps=30, points_per_link=128)
    jrefined, jres = jchain.refine_chain_multi_anchor(jlinks, jjoints, cms_j, frames, **kw)
    trefined, tres = tchain.refine_chain_multi_anchor(
        port_links(jlinks), port_joints(jjoints), [coord_map_from_jax(c) for c in cms_j],
        frames, device=CPU, **kw)
    np.testing.assert_allclose(tres.loss, float(jres.loss), rtol=LOSS_RTOL)
    for f in ("axes", "origins", "thetas"):
        np.testing.assert_allclose(getattr(tres, f), np.asarray(getattr(jres, f)),
                                   atol=GEOM_ATOL, err_msg=f)
    np.testing.assert_allclose(tres.freeze_deltas, jres.freeze_deltas, atol=GEOM_ATOL)
    for a, b in zip(trefined, jrefined, strict=True):
        for f in ("global_axis", "global_pos", "local_axis", "local_pos"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=GEOM_ATOL, err_msg=f)


def test_polish_canonical_union_matches_jax():
    rng = np.random.default_rng(5)
    base = rng.uniform(-0.1, 0.1, (1500, 3)).astype(np.float32)
    base[:, 0] *= 3.0
    err = ScipyRot.from_rotvec([0.0, 0.01, 0.02]).as_matrix().astype(np.float32)
    later = [base[rng.permutation(1500)[:1300]] @ err.T + [0.004, -0.003, 0.002],
             np.concatenate([base, rng.uniform(0.3, 0.4, (90, 3))]) @ err.T]
    locals_t = [base] + [c.astype(np.float64) for c in later]
    got = tchain._polish_canonical_union(locals_t, np.random.default_rng(0), device=CPU)
    want = jchain._polish_canonical_union(locals_t, np.random.default_rng(0))
    assert got[0] is base
    for g, w in zip(got[1:], want[1:], strict=True):
        np.testing.assert_allclose(g, w, atol=1e-5)


# ---------------------------------------------------------------------------
# the single-joint fit
# ---------------------------------------------------------------------------

def test_fit_revolute_joint_matches_jax():
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
    # a rough initial guess of the angles: at all-zero angles the origin has
    # exactly no gradient, which the JAX fit reads as round-off (see jittered)
    theta0 = (0.1 * np.arange(T)).astype(np.float32)
    args = (parent_T, obs, mask, u0, np.zeros(3, np.float32), theta0)
    jres = jrefine.fit_revolute_joint(*(jnp.asarray(a) for a in args), steps=80)
    tres = trefine.fit_revolute_joint(*(torch.from_numpy(a) for a in args), steps=80)
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=LOSS_RTOL)
    for f in ("axis", "origin", "thetas"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                   atol=GEOM_ATOL, err_msg=f)
    assert float(tres.thetas[0]) == 0.0


def test_refine_joints_matches_jax():
    """5 steps: from step 10 on the two fits part on this input (origin 2.2e-4
    at step 10, axis 4.2e-4 at step 40; ROADMAP.md Queue 3)."""
    _, jlinks, jjoints, _ = hinge_problem()
    cms_j = [jittered(make_hinge_coordmap(num_frames=6, angle_step=0.2))]
    want = jrefine.refine_joints(jjoints, jlinks, cms_j[0], steps=5, point_cap=256)
    got = trefine.refine_joints(port_joints(jjoints), port_links(jlinks),
                                coord_map_from_jax(cms_j[0]), steps=5, point_cap=256,
                                device=CPU)
    for a, b in zip(got, want, strict=True):
        assert (a.parent_link, a.child_link) == (b.parent_link, b.child_link)
        for f in ("global_axis", "global_pos", "local_axis", "local_pos"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=GEOM_ATOL, err_msg=f)


# ---------------------------------------------------------------------------
# prune and merge (host numpy): the JAX tests' cases
# ---------------------------------------------------------------------------

def _prune_case(name):
    mk = lambda cls: [cls(id=0, cluster_idx={0, 1}, parent_id=None),
                      cls(id=1, cluster_idx={2}, parent_id=0),
                      cls(id=2, cluster_idx={3, 4}, parent_id=1)]
    th = np.zeros((2, 5, 2), np.float32)
    extra = None
    if name == "static leaf":
        th[:, :, 0] = np.linspace(0, 0.5, 5)
        th[0, :, 1] = 0.01 * np.arange(5) / 5
    elif name == "static middle":
        th = np.zeros((1, 5, 2), np.float32)
        th[:, :, 1] = np.linspace(0, 0.5, 5)
    elif name == "all moving":
        th = np.tile(np.linspace(0, 0.5, 5)[None, :, None], (1, 1, 2)).astype(np.float32)
    elif name == "extra static":
        th = np.tile(np.linspace(0, 0.5, 5)[None, :, None], (1, 1, 2)).astype(np.float32)
        extra = [0]
    return mk, th, extra


@pytest.mark.parametrize("name", ["static leaf", "static middle", "all moving", "extra static"])
def test_prune_static_joints_matches_jax(name):
    mk, th, extra = _prune_case(name)
    joint = dict(local_axis=np.array([0, 0, 1.0]), local_pos=np.array([0, 0, 0, 1.0]),
                 global_pos=np.zeros(3), global_axis=np.array([0, 0, 1.0]))
    jout, jp = jchain.prune_static_joints(
        mk(JLinkNode), [JJointEstimate(0, 1, **joint), JJointEstimate(1, 2, **joint)], th,
        extra_static=extra)
    tout, tp = tchain.prune_static_joints(
        mk(LinkNode), [JointEstimate(0, 1, **joint), JointEstimate(1, 2, **joint)], th,
        extra_static=extra)
    assert tp == jp and link_facts(tout) == link_facts(jout)


def _swing(S=2, T=10, seed=0):
    return np.cumsum(np.random.default_rng(seed).uniform(-0.2, 0.2, size=(S, T)), axis=1)


@pytest.mark.parametrize("case", ["split door", "two doors", "independent", "weak joint"])
def test_merge_coarticulated_siblings_matches_jax(case):
    pos = {"split door": ([0.5, 0, 0], [0.5, 0.02, 0]), "two doors": ([-0.5, 0, 0], [0.5, 0, 0]),
           "independent": ([0.5, 0, 0], [0.5, 0.02, 0]),
           "weak joint": ([0.5, 0, 0], [0.5, 0.02, 0])}[case]
    if case == "split door":
        thetas = np.stack([_swing(), _swing() + 0.01 * _swing(seed=9)], axis=-1)
    elif case == "weak joint":
        thetas = np.stack([_swing(), 0.02 * _swing()], axis=-1)
    else:
        thetas = np.stack([_swing(seed=1), _swing(seed=2)], axis=-1)
    outs = []
    for Node, Joint, mod in ((JLinkNode, JJointEstimate, jchain),
                             (LinkNode, JointEstimate, tchain)):
        links = [Node(id=0, cluster_idx={0, 1}, parent_id=None),
                 Node(id=1, cluster_idx={2}, parent_id=0), Node(id=2, cluster_idx={3}, parent_id=0)]
        joints = [Joint(parent_link=0, child_link=c, local_axis=np.array([0, 0, 1.0]),
                        local_pos=np.array([0, 0, 0, 1.0]), global_pos=np.asarray(p, float),
                        global_axis=np.array([0, 0, 1.0])) for c, p in ((1, pos[0]), (2, pos[1]))]
        out, merged = mod.merge_coarticulated_siblings(links, joints, thetas, scale=1.0)
        outs.append((merged, link_facts(out)))
    assert outs[0] == outs[1]
    assert outs[1][0] == (case == "split door")


# ---------------------------------------------------------------------------
# the DoF probe ladder
# ---------------------------------------------------------------------------

LADDER_CURVES = {
    "wx200 flat before drop": ({3: 0.0531, 4: 0.0296, 5: 0.0295, 6: 0.0187, 7: 0.0182,
                                8: 0.0177, 9: 0.0174}, 4, {}),
    "correct pick": ({5: 0.0295, 6: 0.0187, 7: 0.0182, 8: 0.0177, 9: 0.0174, 10: 0.0172}, 6, {}),
    "over-split pick": ({5: 0.0295, 6: 0.0187, 7: 0.0182, 8: 0.0177, 9: 0.0174, 10: 0.0172,
                         11: 0.0171, 12: 0.0170}, 9, {}),
    "two drops": ({3: 0.09, 4: 0.085, 5: 0.05, 6: 0.048, 7: 0.030, 8: 0.029, 9: 0.0285,
                   10: 0.028}, 4, {}),
    "1-DoF flat": ({2: 0.040, 3: 0.0398, 4: 0.0395, 5: 0.0393}, 2, dict(k_min=2)),
    "laptop drift": ({2: 0.08849, 3: 0.08076, 4: 0.07344, 5: 0.06798, 6: 0.0634, 7: 0.0593},
                     2, dict(k_min=2)),
    "real drop over drift": ({4: 0.050, 5: 0.048, 6: 0.0384, 7: 0.0369, 8: 0.0355,
                              9: 0.0341}, 4, {}),
    "pxs raw": ({15: 0.02448, 16: 0.02165, 17: 0.02095, 18: 0.02036, 19: 0.01903, 20: 0.01903,
                 21: 0.01900, 22: 0.01898}, 19, {}),
    "pxs share-norm": ({15: 0.02448, 16: 0.02165, 17: 0.02095, 18: 0.02036, 19: 0.01903,
                        20: 0.01903, 21: 0.01900, 22: 0.01898}, 19, dict(share=lambda k: 0.08)),
    "laptop share-norm": ({2: 0.08849, 3: 0.08076, 4: 0.07344, 5: 0.06798, 6: 0.0634,
                           7: 0.0593}, 2, dict(k_min=2, share=lambda k: 0.5)),
    "inf candidate": ({3: np.inf, 4: 0.03, 5: 0.029, 6: 0.0185, 7: 0.018, 8: 0.0178,
                       9: 0.0177}, 4, {}),
    "all inf": ({4: np.inf}, 4, {}),
}


@pytest.mark.parametrize("name", list(LADDER_CURVES))
def test_ladder_select_picks_match_jax(name):
    curve, k0, kw = LADDER_CURVES[name]
    picks, calls = [], []
    for mod in (jselect, tselect):
        seen = []

        def loss(k):
            seen.append(k)
            return curve.get(k, curve[max(curve)])

        picks.append(mod.ladder_select(loss, k0, **kw))
        calls.append(seen)
    assert picks[0] == picks[1] and calls[0] == calls[1]


def test_probe_k_selection_matches_jax():
    cms_j, _, _, frames, masks = trap_problem()
    cms_t = [coord_map_from_jax(c) for c in cms_j]
    d_map = jst.combined_sum_map(cms_j, "pose")
    stack = np.asarray(jst.swap_consistency_stack(cms_j))
    kw = dict(k0=3, frame_masks=masks, carry_stack=stack, probe_steps=6, points_per_link=32,
              share_normalize=True)
    jgroups, jloss = jselect.probe_k_selection(d_map, cms_j, frames, **kw)
    tgroups, tloss = tselect.probe_k_selection(d_map, cms_t, frames, device=CPU, **kw)
    assert sorted(map(sorted, tgroups)) == sorted(map(sorted, jgroups))
    assert sorted(tloss) == sorted(jloss) and len(tloss) >= 3
    for k in jloss:
        if np.isfinite(jloss[k]):
            np.testing.assert_allclose(tloss[k], jloss[k], rtol=LOSS_RTOL, err_msg=str(k))
        else:
            assert not np.isfinite(tloss[k])


def test_probe_k_selection_lets_a_search_failure_propagate(monkeypatch):
    """A RuntimeError from the search (what a failed CUDA launch raises) is
    not a degenerate candidate: it leaves the ladder, it is not scored inf."""
    cms_j, _, _, frames, masks = trap_problem()

    def failing(*a, **k):
        raise RuntimeError("knn launch of nn_bidir_acc: an illegal memory access")

    monkeypatch.setattr(tchamfer, "nn_search_bidirectional", failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tselect.probe_k_selection(jst.combined_sum_map(cms_j, "pose"),
                                  [coord_map_from_jax(c) for c in cms_j], frames, k0=3,
                                  frame_masks=masks, probe_steps=2, points_per_link=16,
                                  device=CPU)


def test_candidate_counts_and_chain_fit_dof_search_match_jax():
    cms_j, _, _, frames, _ = trap_problem()
    cms_t = [coord_map_from_jax(c) for c in cms_j]
    d_map = jst.combined_sum_map(cms_j, "pose")
    assert tselect.candidate_link_counts(d_map) == jselect.candidate_link_counts(d_map)
    kw = dict(link_range=(2, 5), fit_steps=8, points_per_link=32)
    jg, jl, js, jc = jselect.chain_fit_dof_search(d_map, cms_j, frames, **kw)
    tg, tl, ts, tc = tselect.chain_fit_dof_search(d_map, cms_t, frames, device=CPU, **kw)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tl, jl)
    assert sorted(map(sorted, tg)) == sorted(map(sorted, jg))
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the pairwise path (host numpy)
# ---------------------------------------------------------------------------

def test_pairwise_path_matches_jax():
    cm_j = make_hinge_coordmap()
    cm_t = coord_map_from_jax(cm_j)
    groups = [{0, 1}, {2}, {3, 4, 5}]
    jj = jpairwise.estimate_pairwise_joints([cm_j], groups, 0, 8, interval=2)
    tj = tpairwise.estimate_pairwise_joints([cm_t], groups, 0, 8, interval=2)
    assert len(tj) == len(jj) == 3
    for a, b in zip(tj, jj):
        assert a.clusters == b.clusters
        for f in ("local_axis", "local_pos", "global_pos", "global_axis"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-5, err_msg=f)
        np.testing.assert_allclose(a.deviation, b.deviation, rtol=1e-5, atol=1e-9)
    base = tpairwise.identify_base_group([cm_t], groups, 0, 8)
    assert base == jpairwise.identify_base_group([cm_j], groups, 0, 8) == 0
    for thr in (0.04, 10.0):
        tt = tpairwise.greedy_tree(tj, base, thr)
        jt = jpairwise.greedy_tree(jj, base, thr)
        assert {n: [c["child"] for c in cs] for n, cs in tt.items()} == \
            {n: [c["child"] for c in cs] for n, cs in jt.items()}
    # the hinge: link B turns about z
    hinge = next(j for j in tj if j.clusters == (0, 2))
    assert abs(abs(hinge.global_axis[2]) - 1.0) < 1e-3
