"""Global kinematic-chain refinement (port of autourdf_tpu.joints.chain).

Once the tree and initial joints are known, the strongest supervision
available is the raw frames themselves: pose the *whole* robot model --
canonical per-link point clouds forward-kinematically chained through
explicit revolute joints -- and fit every joint axis/origin plus all
per-frame joint angles jointly against the full frame clouds with the
masked Chamfer loss.  Segmentation-boundary noise and per-link visibility
changes, which bias per-link screw estimates, average out when the whole
robot competes for the whole cloud.

Model (links in tree order, root static):

    W_root(t)  = F_root(0)
    W_c(t)     = W_p(t) @ Rot(u_j, o_j, theta_{t,j}) @ [F_p(0)^-1 F_c(0)]

with (u_j, o_j) the joint axis/origin in the parent link frame and
theta_{0, j} = 0, so step 0 reproduces the registered configuration
exactly.  Parameters: all (u_j, o_j) and theta (per sequence, per step, per
joint), fitted by Adam.

Layout of a step: the S sequences x T steps are one batch, so the posed
model ``(S*T, L*P, 3)`` meets the frames ``(S*T, N, 3)`` in one Chamfer call
(the indexed bidirectional search forward, its scatter-add rebuild
backward); the rest poses ``[F_p(0)^-1 F_c(0)]`` do not depend on the
parameters and are computed once per fit.  The loss stays on the device and
is read only where the JAX host loop reads it: after each chunk of
steps when ``verbose``, and at the end.

The steps run as the JAX ``_chain_fit_chunk`` runs them: chunks of
``dispatch_steps`` steps (50, fewer for large clouds), each chunk a device
program (``utils/programs.py``: a CUDA graph captured once per shape and
replayed on the card, the same function run without capture on the CPU).
The step's schedule (Adam's bias corrections, the cosine decay, the EMA
weight) is a table computed on the host in float32 and copied in a chunk at
a time, so a replay meets each step's own values; ``eager=True`` runs the
same steps one by one, the reference the programs are held against.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import numpy as np
import torch

from ..core import se3
from ..core.quat_np import mean_link_frame_np
from ..ops.chamfer import chamfer_distance, chamfer_distance_trunc
from ..ops.icp import icp_point_to_point
from .refine import _rot_about_axis as _rot_about
from .refine import adam_bias_corrections
from .screw import JointEstimate
from ..utils import programs


def _link_frame_np(cm, members, t) -> np.ndarray:
    return mean_link_frame_np(cm.coords[t, members, :])


class ChainSpec(NamedTuple):
    """Static structure of the chain."""
    parent_index: tuple       # per joint: index of parent LINK in link order
    child_index: tuple        # per joint: index of child LINK in link order
    root_index: int


class ChainResult(NamedTuple):
    axes: np.ndarray     # (J, 3) unit axes, parent-link frames
    origins: np.ndarray  # (J, 3) origins, parent-link frames
    thetas: np.ndarray   # (S, T, J)
    # the loss of the last Adam step, evaluated BEFORE its update (the JAX
    # result's ``losses[-1]`` of the last scan chunk); the probe ladder and
    # the tree arbitration compare these across candidates
    loss: float
    # per-joint loss sensitivity: (loss with theta_j frozen to the anchor
    # configuration) / (fitted loss) - 1.  Real articulation costs real
    # chamfer when frozen; a joint whose fitted motion is a symmetry-flat
    # or drift direction costs ~nothing (see joint freeze-delta probe).
    freeze_deltas: np.ndarray | None = None
    # fraction of all model points that can move when joint j moves (its
    # child link's subtree) -- the natural scale of freeze_deltas[j]
    subtree_share: np.ndarray | None = None
    # every step's loss (step_losses[-1] == loss); not in the JAX result
    step_losses: np.ndarray | None = None


_POLISH_PAD = 1024  # ICP subsample size for canonical-union polishing
_KEYS = ("u", "o", "theta")


def _polish_canonical_union(locals_t: list[np.ndarray], rng,
                            device: str | torch.device = "cuda") -> list[np.ndarray]:
    """Rigidly re-align later-step local clouds onto the step-0 cloud.

    The multi-frame canonical union maps each step's observation into the
    link frame through the REGISTERED per-cluster poses, so every added
    step carries that step's registration error (~mm) into the canonical
    cloud.  A small-threshold ICP of each step's cloud onto the step-0
    cloud (one batched ICP on ``device``) removes the rigid component of
    that error while keeping the newly visible surface, which has no
    correspondences and is carried along by the fitted rigid transform.
    Draws its subsamples from ``rng`` in the JAX function's order.
    """
    base = locals_t[0]
    if len(base) < 16:
        return locals_t
    diag = float(np.linalg.norm(base.max(0) - base.min(0)))
    threshold = max(0.1 * diag, 1e-3)

    def pad(cloud: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        n = min(len(cloud), _POLISH_PAD)
        idx = (
            rng.choice(len(cloud), n, replace=False)
            if len(cloud) > _POLISH_PAD
            else np.arange(len(cloud))
        )
        out = np.zeros((_POLISH_PAD, 3), np.float32)
        mask = np.zeros(_POLISH_PAD, bool)
        out[:n] = cloud[idx]
        mask[:n] = True
        return out, mask

    tgt, tgt_mask = pad(base)
    srcs, src_masks = zip(*(pad(c) for c in locals_t[1:]))
    dev = torch.device(device)
    B = len(srcs)
    res = icp_point_to_point(
        torch.from_numpy(np.stack(srcs)).to(dev),
        torch.from_numpy(tgt).to(dev).expand(B, -1, -1),
        max_iterations=30, threshold=threshold,
        source_mask=torch.from_numpy(np.stack(src_masks)).to(dev),
        target_mask=torch.from_numpy(tgt_mask).to(dev).expand(B, -1),
    )
    transforms = res.transform.cpu().numpy()
    out = [base]
    for k, cloud in enumerate(locals_t[1:]):
        T = transforms[k]
        out.append(cloud @ T[:3, :3].T + T[:3, 3])
    return out


def _rest_offsets(spec: ChainSpec, frames0: torch.Tensor) -> torch.Tensor:
    """(J, 4, 4) rest pose of each joint's child in its parent's frame,
    ``inverse(F_p) @ F_c``."""
    return se3.compose(se3.inverse(frames0[list(spec.parent_index)]),
                       frames0[list(spec.child_index)])


def _chain_transforms(spec: ChainSpec, root: torch.Tensor, rel0: torch.Tensor,
                      axes: torch.Tensor, origins: torch.Tensor,
                      theta: torch.Tensor) -> torch.Tensor:
    """(..., L, 4, 4) link world transforms for joint angles ``theta (..., J)``;
    ``root`` is the root link's frame, ``rel0`` from :func:`_rest_offsets`."""
    joint = _rot_about(axes, origins, theta)                 # (..., J, 4, 4)
    L = len(spec.child_index) + 1
    world = [None] * L
    world[spec.root_index] = root.expand(theta.shape[:-1] + (4, 4))
    # joints are listed parent-before-child (tree order), one pass suffices
    for j, (pi, ci) in enumerate(zip(spec.parent_index, spec.child_index)):
        world[ci] = se3.compose(se3.compose(world[pi], joint[..., j, :, :]), rel0[j])
    return torch.stack(world, dim=-3)


def chain_world_transforms(spec: ChainSpec, frames0: torch.Tensor,
                           axes: torch.Tensor, origins: torch.Tensor,
                           theta: torch.Tensor) -> torch.Tensor:
    """(..., L, 4, 4) link world transforms for joint angles ``theta (..., J)``
    (one step's ``(J,)`` gives ``(L, 4, 4)``)."""
    return _chain_transforms(spec, frames0[spec.root_index], _rest_offsets(spec, frames0),
                             axes, origins, theta)


def _posed_loss(spec: ChainSpec, root, rel0, link_pts, flat_mask, u, o, theta,
                frames, frame_masks, trunc: float = 0.0) -> torch.Tensor:
    """Mean Chamfer over all sequences and steps: ``theta (S, T, J)``, the
    frames flattened to ``(S*T, N, 3)`` and ``(S*T, N)``, ``flat_mask (L*P,)``
    the model points' mask (or weights)."""
    S, T, J = theta.shape
    L, P = link_pts.shape[:2]
    world = _chain_transforms(spec, root, rel0, u, o, theta.reshape(S * T, J))
    posed = se3.transform_points(world, link_pts).reshape(S * T, L * P, 3)
    x_mask = flat_mask.expand(S * T, L * P)
    if trunc > 0:
        losses = chamfer_distance_trunc(posed, frames, x_mask, frame_masks, norm=1, mult=trunc)
    else:
        losses = chamfer_distance(posed, frames, x_mask, frame_masks, norm=1)
    return torch.mean(torch.mean(losses.view(S, T), dim=1))


def _flat_frames(frames: torch.Tensor, frame_masks: torch.Tensor):
    S, T, N = frames.shape[:3]
    return frames.reshape(S * T, N, 3), frame_masks.reshape(S * T, N)


def _theta_loss(spec: ChainSpec, frames0, link_pts, link_masks,
                u, o, theta, frames, frame_masks, trunc: float = 0.0) -> torch.Tensor:
    """Mean chamfer over all sequences/steps for explicit (u, o, theta).

    Core of :func:`_chain_loss` without the unit-normalisation and anchor
    pinning; also drives the post-fit freeze-delta probe (which always
    evaluates UNtruncated: the probe measures explanatory power, and its
    0.25 veto threshold was calibrated on plain chamfer).

    ``trunc`` > 0 switches the per-step loss to the truncated robust
    Chamfer (ops.chamfer.chamfer_distance_trunc with tau = trunc x the
    median matched distance).
    """
    L, P = link_pts.shape[:2]
    return _posed_loss(spec, frames0[spec.root_index], _rest_offsets(spec, frames0), link_pts,
                       link_masks.reshape(L * P), u, o, theta,
                       *_flat_frames(frames, frame_masks), trunc=trunc)


def _pinned(params: dict, anchor_step: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit axes and pinned angles: every sequence's step 0 is held at zero,
    or, with ``anchor_step > 0``, only sequence 0 at the anchor step."""
    u = params["u"]
    u = u / torch.sqrt(torch.clamp_min(torch.sum(u * u, -1, keepdim=True), 1e-18))
    theta = params["theta"]
    S, T = theta.shape[:2]
    if anchor_step == 0:
        # every sequence starts from the shared home configuration, so the
        # zero-angle pin applies to all of them
        pin = (torch.arange(T, device=theta.device) == 0)[None, :, None]
    else:
        # anchored fit: only sequence 0 at the anchor step is pinned to the
        # registered canonical configuration (frames0 is taken there)
        pin = ((torch.arange(S, device=theta.device) == 0)[:, None, None]
               & (torch.arange(T, device=theta.device) == anchor_step)[None, :, None])
    return u, params["o"], torch.where(pin, 0.0, theta)


def _chain_loss(spec: ChainSpec, frames0, link_pts, link_masks,
                params, frames, frame_masks, anchor_step: int = 0,
                trunc: float = 0.0) -> torch.Tensor:
    """Mean chamfer over all sequences and steps."""
    u, o, theta = _pinned(params, anchor_step)
    return _theta_loss(spec, frames0, link_pts, link_masks, u, o, theta, frames, frame_masks,
                       trunc=trunc)


def dispatch_chunk(dispatch_steps: int, links: int, points_per_link: int,
                   frame_points: int) -> int:
    """Steps a chunk program runs: ``dispatch_steps`` scaled down by the
    Chamfer's work against the wx200's (6 links x 1,024 points x 5,000-point
    frames), at least 2, as the JAX ``refine_chain`` sizes its chunks (there
    to keep one TPU execution short; here a chunk is one graph)."""
    work = links * points_per_link * float(frame_points)
    if frame_points > 16384:
        work *= 2.0
    base = 6 * 1024 * 5000.0
    return int(np.clip(dispatch_steps * base / max(work, 1.0), 2, dispatch_steps))


def short_fit_dispatch(steps: int) -> int:
    """``dispatch_steps`` for the short fits that compare candidates (the
    probe ladder's, the tree arbitration's, the chain-fit model selection's):
    a quarter of their steps.  Capturing a chunk costs about twice the host
    time of running its steps eagerly, and each such fit has a structure of
    its own, so a chunk of all its steps would be captured for one use; a
    quarter is captured once and replayed four times.  The chunking does not
    change the fit's result."""
    return max(1, steps // 4)


def _schedule(steps: int, lr: float) -> np.ndarray:
    """``(steps, 6)`` float32 rows of each step's scalars: Adam's two bias
    corrections, the decayed learning rates of u, o and theta, and the tail
    EMA's weight.  Computed from the float32 step count as JAX computes them
    (the cosine in float64, rounded)."""
    # geometry parameters move much slower than angles: the angles carry
    # the per-frame fit while axes/origins follow only persistent residuals
    group_lr = (0.2 * lr, 0.1 * lr, lr)
    # Weakly-constrained axes random-walk under Adam noise at zero loss cost
    # once the chamfer plateaus, while slow real convergence continues in
    # the same flat-loss regime.  Two measures, both aimed at the walk:
    #   - cosine lr decay (floor 5%) once 30% of the steps are done;
    #   - a tail EMA of the geometry (half-life ~total/6) that tracks the
    #     live parameters until half of the steps are done and averages
    #     whatever wander remains after.
    beta = np.float32(2.0 / (max(steps, 6) / 6.0 + 1.0))
    warmup = steps // 2
    rows = np.zeros((steps, 6), np.float32)
    for done in range(1, steps + 1):
        t = np.float32(done)
        frac = np.clip((t / np.float32(steps) - np.float32(0.3)) / np.float32(0.7),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(np.cos(np.float64(np.float32(np.pi) * frac)))
        decay = np.float32(0.05) + np.float32(0.95 * 0.5) * (np.float32(1.0) + cos)
        rows[done - 1] = (*adam_bias_corrections(done),
                          *(decay * np.float32(g) for g in group_lr),
                          beta if done > warmup else 1.0)
    return rows


def _chain_step(spec: ChainSpec, anchor_step: int, trunc: float, consts, state, row):
    """One Adam step of the chain fit: ``state`` is (params, mu, nu, ema,
    path), ``row`` the step's :func:`_schedule` row on the device.  Returns
    the new state and the loss, evaluated before the update."""
    params, mu, nu, ema, path = state
    p = {k: params[k].detach().requires_grad_(True) for k in _KEYS}
    with torch.enable_grad():
        u, o, theta = _pinned(p, anchor_step)
        loss = _posed_loss(spec, *consts[:4], u, o, theta, *consts[4:], trunc)
        grads = dict(zip(_KEYS, torch.autograd.grad(loss, [p[k] for k in _KEYS])))
    bc1, bc2, b = row[0], row[1], row[5]
    with torch.no_grad():
        mu = {k: 0.9 * mu[k] + 0.1 * grads[k] for k in _KEYS}
        nu = {k: 0.999 * nu[k] + 0.001 * grads[k] * grads[k] for k in _KEYS}
        p_new = {k: params[k] - row[2 + i] * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + 1e-8)
                 for i, k in enumerate(_KEYS)}
        # per-joint axis path length: with the per-window net
        # displacement (host side) a directed-vs-diffusive diagnostic
        path = path + torch.linalg.norm(p_new["u"] - params["u"], dim=1)
        ema = {k: ema[k] + b * (p_new[k] - ema[k]) for k in ("u", "o")}
    return (p_new, mu, nu, ema, path), loss.detach()


def _chain_chunk(spec: ChainSpec, anchor_step: int, trunc: float, num_steps: int,
                 state, sched, consts):
    """``num_steps`` steps from the rows of ``sched``: the body of the chunk
    program (the JAX ``_chain_fit_chunk``).  Returns the state and the
    steps' losses."""
    losses = []
    for j in range(num_steps):
        state, loss = _chain_step(spec, anchor_step, trunc, consts, state, sched[j])
        losses.append(loss)
    return state, torch.stack(losses)


def refine_chain(
    links,
    joints: list[JointEstimate],
    cms,
    frames: np.ndarray,          # (S, T, N, 3) raw frame clouds
    steps: int = 300,
    lr: float = 2e-2,
    points_per_link: int = 768,
    frame_masks: np.ndarray | None = None,  # (S, T, N) for ragged frames
    balance: bool = False,
    canonical_frames: int = 1,
    anchor_step: int = 0,
    freeze_probe: bool = True,
    trunc: float = 0.0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
    dispatch_steps: int = 50,
    eager: bool = False,
) -> tuple[list[JointEstimate], ChainResult]:
    """Jointly refine every joint against the raw frames of all sequences,
    on ``device``, in chunk programs of :func:`dispatch_chunk` steps
    (``eager=True``: step by step, the plain loop).

    ``links`` must be in tree order (root first) as kinematics_tree
    returns; joints[j] connects links by id.  Returns updated
    JointEstimates (global axis/pos at the step-0 configuration, the
    frames the URDF writer consumes).

    ``anchor_step`` selects which step of sequence 0 supplies the
    canonical link clouds, the link frames, and the zero-angle pin.  With
    ``anchor_step`` > 0 the returned JointEstimates are expressed at the
    ANCHOR configuration, not step 0; consume ``ChainResult.axes/origins``
    (parent-link-frame coordinates, configuration-invariant) instead.

    ``balance=True`` reweights the forward (model -> frame) Chamfer term so
    every link contributes equally regardless of its point count (the mask
    doubles as per-point weights, ``1 / n_link``).
    """
    dev = torch.device(device)
    id_to_pos = {l.id: i for i, l in enumerate(links)}
    spec = ChainSpec(
        parent_index=tuple(id_to_pos[j.parent_link] for j in joints),
        child_index=tuple(id_to_pos[j.child_link] for j in joints),
        root_index=next(i for i, l in enumerate(links) if l.parent_id is None),
    )

    cm = cms[0]
    # canonical per-link clouds in link frames (subsampled, padded).
    # ``canonical_frames`` > 1 unions observations from that many evenly
    # spaced steps of sequence 0, each mapped into the link frame via the
    # REGISTERED per-cluster pose at its own step.  The numpy draws follow
    # the JAX function's order, so both packages build the same clouds.
    rng = np.random.default_rng(0)
    L = len(links)
    T_cm = cm.matrices.shape[0]
    anchor_step = int(np.clip(anchor_step, 0, T_cm - 1))
    if canonical_frames <= 1:
        steps_used = [anchor_step]
    else:
        rest = sorted(
            {int(t) for t in np.linspace(0, T_cm - 1, canonical_frames)}
            - {anchor_step}
        )
        # anchor first: _polish_canonical_union aligns onto locals_t[0]
        steps_used = [anchor_step] + rest
    link_pts = np.zeros((L, points_per_link, 3), np.float32)
    link_masks = np.zeros((L, points_per_link), bool)
    frames0_np = np.zeros((L, 4, 4), np.float32)
    for i, link in enumerate(links):
        members = sorted(link.cluster_idx)
        frames0_np[i] = _link_frame_np(cm, members, anchor_step)
        locals_t = []
        for t in steps_used:
            pts_t = np.asarray(cm.cluster_points[t])
            labels_t = np.asarray(cm.cluster_labels[t])
            F = _link_frame_np(cm, members, t)
            inv = np.linalg.inv(F)
            parts = []
            for m in members:
                sel = labels_t == m
                M = cm.matrices[t, m]
                parts.append(pts_t[sel] @ M[:3, :3].T + M[:3, 3])
            world = np.concatenate(parts, axis=0)
            locals_t.append(world @ inv[:3, :3].T + inv[:3, 3])
        if len(locals_t) > 1:
            locals_t = _polish_canonical_union(locals_t, rng, device=dev)
        local = np.concatenate(locals_t, axis=0)
        if len(local) > points_per_link:
            idx = rng.choice(len(local), points_per_link, replace=False)
            local = local[idx]
        link_pts[i, : len(local)] = local
        link_masks[i, : len(local)] = True

    # init params from the screw estimates, in parent-link frames.  The
    # screw estimate's global_axis/global_pos are expressed at the STEP-0
    # configuration, so the conversion uses the STEP-0 parent frame; the
    # local (u, o) are configuration-invariant, so valid for any anchor.
    J = len(joints)
    u0 = np.zeros((J, 3), np.float32)
    o0 = np.zeros((J, 3), np.float32)
    for j, joint in enumerate(joints):
        parent_members = sorted(
            next(l for l in links if l.id == joint.parent_link).cluster_idx)
        p0 = (_link_frame_np(cm, parent_members, 0).astype(np.float64)
              if anchor_step != 0
              else frames0_np[id_to_pos[joint.parent_link]].astype(np.float64))
        inv = np.linalg.inv(p0)
        ax = joint.global_axis / max(np.linalg.norm(joint.global_axis), 1e-12)
        u0[j] = inv[:3, :3] @ ax
        o0[j] = inv[:3, :3] @ joint.global_pos[:3] + inv[:3, 3]

    # initial angles: relative child rotation (vs step 0) projected onto the
    # initial axis, per sequence -- the fit starts from the registered motion
    from scipy.spatial.transform import Rotation as ScipyRot

    S, T = frames.shape[:2]
    theta0 = np.zeros((S, T, J), np.float32)
    rel_anchor: dict[int, np.ndarray] = {}  # joint -> reference relative pose
    for s, cm_s in enumerate(cms[:S]):
        for j, joint in enumerate(joints):
            pm = sorted(next(l for l in links if l.id == joint.parent_link).cluster_idx)
            cmem = sorted(next(l for l in links if l.id == joint.child_link).cluster_idx)
            Tp = [_link_frame_np(cm_s, pm, t) for t in range(T)]
            Tc = [_link_frame_np(cm_s, cmem, t) for t in range(T)]
            if anchor_step == 0:
                # every sequence shares the home configuration; its own
                # step-0 relative pose is the zero reference
                rel0 = np.linalg.inv(Tp[0]) @ Tc[0]
            else:
                # anchored fit: the zero reference is sequence 0 at the
                # anchor step (where frames0 is taken), for all sequences
                if s == 0:
                    rel_anchor[j] = (np.linalg.inv(Tp[anchor_step])
                                     @ Tc[anchor_step])
                rel0 = rel_anchor[j]
            for t in range(T):
                if t == 0 and anchor_step == 0:
                    continue  # pinned to zero
                rel_t = np.linalg.inv(Tp[t]) @ Tc[t]
                d_rel = rel_t @ np.linalg.inv(rel0)
                rv = ScipyRot.from_matrix(d_rel[:3, :3]).as_rotvec()
                theta0[s, t, j] = float(rv @ u0[j])

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    params = {"u": tensor(u0), "o": tensor(o0), "theta": tensor(theta0)}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    state = (params, zeros, zeros, {"u": params["u"], "o": params["o"]},
             torch.zeros((J,), dtype=torch.float32, device=dev))

    frames_t = tensor(frames)
    fmasks = (tensor(frame_masks, torch.bool) if frame_masks is not None
              else torch.ones(frames.shape[:3], dtype=torch.bool, device=dev))
    flat_frames = _flat_frames(frames_t, fmasks)
    f0 = tensor(frames0_np)
    rest_pose = (f0[spec.root_index], _rest_offsets(spec, f0))
    lp = tensor(link_pts)
    if balance:
        counts = np.maximum(link_masks.sum(axis=1, keepdims=True), 1)
        lm = tensor(link_masks / counts)
    else:
        lm = tensor(link_masks, torch.bool)
    flat_lm = lm.reshape(-1)
    consts = (*rest_pose, lp, flat_lm, *flat_frames)

    if verbose and balance:
        print("[chain] balanced per-link forward weighting", flush=True)
    table = tensor(_schedule(steps, lr))
    chunk = dispatch_chunk(dispatch_steps, L, points_per_link, frames.shape[2])
    losses = []  # each step's loss, evaluated before its update, on the device
    win_u, win_path, win_step = u0, 0.0, 0
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        if eager:
            chunk_losses = []
            for i in range(done, done + n):
                state, loss = _chain_step(spec, anchor_step, trunc, consts, state, table[i])
                chunk_losses.append(loss)
            losses.append(torch.stack(chunk_losses))
        else:
            state, chunk_losses = programs.run(
                ("chain_chunk_trunc" if trunc > 0 else "chain_chunk", spec, anchor_step, trunc,
                 n), functools.partial(_chain_chunk, spec, anchor_step, trunc, n),
                state, table[done:done + n], consts,
                warm=functools.partial(_chain_chunk, spec, anchor_step, trunc, 1))
            losses.append(chunk_losses.clone())
        done += n
        if verbose:
            print(f"[chain] {done}/{steps} loss {float(losses[-1][-1]):.5f}", flush=True)
            if done - win_step >= 200 or done == steps:
                # directed-vs-diffusive axis motion over the window:
                # r ~ 1 = the axis is still converging somewhere,
                # r ~ 0 = pure Adam random walk (wasted steps + drift)
                u_now = state[0]["u"].cpu().numpy()
                p_now = state[4].cpu().numpy()
                net = np.linalg.norm(u_now - win_u, axis=1)
                dpath = np.maximum(p_now - win_path, 1e-12)
                ratio = net / dpath
                print(f"[chain]   axis net deg "
                      f"{np.round(np.degrees(net), 2).tolist()} "
                      f"dir-ratio {np.round(ratio, 2).tolist()}",
                      flush=True)
                win_u, win_path, win_step = u_now, p_now, done
    params, ema = state[0], state[3]

    # geometry from the tail average; angles from the live params (they
    # track each frame exactly)
    u = ema["u"].cpu().numpy().astype(np.float64)
    u = u / np.linalg.norm(u, axis=1, keepdims=True)
    o = ema["o"].cpu().numpy().astype(np.float64)
    theta = params["theta"].cpu().numpy()
    step_losses = torch.cat(losses).cpu().numpy() if losses else np.zeros(0, np.float32)

    refined = []
    for j, joint in enumerate(joints):
        p0 = frames0_np[id_to_pos[joint.parent_link]].astype(np.float64)
        global_axis = p0[:3, :3] @ u[j]
        global_pos = p0[:3, :3] @ o[j] + p0[:3, 3]
        refined.append(
            JointEstimate(
                parent_link=joint.parent_link,
                child_link=joint.child_link,
                local_axis=u[j],
                local_pos=np.concatenate([o[j], [1.0]]),
                global_pos=global_pos,
                global_axis=global_axis,
            )
        )
    # freeze-delta probe: how much chamfer does each joint's fitted motion
    # actually buy?  Zero theta_j (= freeze the child to the anchor
    # configuration) with everything else fitted and re-evaluate: one
    # forward-only evaluation (the min-only search) per joint.  Real
    # articulation leaves observed surface unexplained (large delta); a
    # joint whose motion is a symmetry-flat direction or registration-drift
    # absorption costs ~nothing.  Skipped for the ladder's short probe fits
    # (freeze_probe=False).
    freeze = share = None
    if freeze_probe:
        u_dev, o_dev, th_dev = tensor(u), tensor(o), tensor(theta)
        with torch.no_grad():
            base_loss = float(_posed_loss(spec, *rest_pose, lp, flat_lm, u_dev, o_dev, th_dev,
                                          *flat_frames))
            freeze = np.zeros(J, np.float64)
            eye = np.eye(J, dtype=np.float32)
            for j in range(J):
                mask = tensor(1.0 - eye[j])
                fl = float(_posed_loss(spec, *rest_pose, lp, flat_lm, u_dev, o_dev, th_dev * mask,
                                       *flat_frames))
                freeze[j] = fl / max(base_loss, 1e-12) - 1.0
        # natural scale of each delta: the point share of the child's
        # subtree (only those points move when theta_j is frozen)
        counts = link_masks.sum(axis=1).astype(np.float64)  # pre-balance
        children: dict[int, list[int]] = {}
        for pi, ci in zip(spec.parent_index, spec.child_index):
            children.setdefault(pi, []).append(ci)
        share = np.zeros(J, np.float64)
        for j, cj in enumerate(spec.child_index):
            stack, tot = [cj], 0.0
            while stack:
                n = stack.pop()
                tot += counts[n]
                stack.extend(children.get(n, []))
            share[j] = tot / max(counts.sum(), 1.0)
    result = ChainResult(u, o, theta,
                         float(step_losses[-1]) if steps > 0 else float("inf"),
                         freeze_deltas=freeze, subtree_share=share,
                         step_losses=step_losses)
    return refined, result


def refine_chain_multi_anchor(
    links,
    joints: list[JointEstimate],
    cms,
    frames: np.ndarray,
    anchors: int = 1,
    verbose: bool = False,
    **kw,
) -> tuple[list[JointEstimate], ChainResult]:
    """Average the chain fit over several canonical anchor steps (ours).

    The single-anchor chain fit carries a DIRECTED axis bias: the
    canonical link clouds are occlusion-incomplete in a step-0-specific
    way, so surface that appears in the raw frames with nothing in the
    model to explain it pulls weakly-constrained axes persistently
    (dir-ratio ~1 in the fit diagnostics; RESULTS.md round-3 findings).
    Filling the clouds via multi-frame unions was measured NEGATIVE — the
    union smears the canonical geometry by the per-step registration
    error and the smear is non-rigid (``--canonical-frames`` A/B).

    This attacks the bias rather than the occlusion: run ``anchors``
    independent fits, each anchored at a different step of sequence 0
    (different pose => different occlusion pattern => different bias
    direction), and average the fitted axes/origins in the PARENT-LINK
    frame, where they are configuration-invariant.  Geometry averaging
    cannot smear the model clouds because each fit uses a single-step
    (un-smeared) canonical cloud.

    Returns JointEstimates at the step-0 configuration (writer
    convention) and a ChainResult whose thetas/loss come from the
    anchor-0 fit with the axes/origins replaced by the averages.
    """
    anchors = max(1, int(anchors))
    if anchors == 1:
        return refine_chain(links, joints, cms, frames, verbose=verbose, **kw)

    T_cm = cms[0].matrices.shape[0]
    anchor_steps = sorted({int(t) for t in np.linspace(0, T_cm - 1, anchors)})
    fits = []
    res0 = None
    for a in anchor_steps:
        if verbose:
            print(f"[chain] multi-anchor fit at step {a} "
                  f"({len(fits) + 1}/{len(anchor_steps)})", flush=True)
        # freeze-delta diagnostics only from the anchor-0 fit (whose
        # thetas/loss the combined ChainResult reports)
        kw_a = dict(kw)
        kw_a["freeze_probe"] = kw.get("freeze_probe", True) and a == 0
        _, res = refine_chain(links, joints, cms, frames, anchor_step=a,
                              verbose=verbose, **kw_a)
        if a == 0:
            res0 = res
        fits.append(res)
    assert res0 is not None  # linspace always includes 0

    # sign-align each anchor's axes to the anchor-0 fit before averaging
    # (the axis sign is a gauge choice; a flip would cancel instead of
    # average).  Origins are points on the axis LINE with gauge freedom
    # along it — per-anchor fits settle at arbitrary arc-length positions,
    # so each origin is first re-gauged to the point on its own axis
    # closest to the anchor-0 origin before the mean (a raw point mean of
    # different gauges can sit off every fitted line).
    u0 = np.asarray(res0.axes, np.float64)
    o_ref = np.asarray(res0.origins, np.float64)
    us, origs = [], []
    for res in fits:
        u = np.asarray(res.axes, np.float64)
        sign = np.sign(np.sum(u * u0, axis=1, keepdims=True))
        sign[sign == 0] = 1.0
        u = u * sign
        o = np.asarray(res.origins, np.float64)
        o = o + np.sum((o_ref - o) * u, axis=1, keepdims=True) * u
        us.append(u)
        origs.append(o)
    u_avg = np.mean(us, axis=0)
    u_avg = u_avg / np.linalg.norm(u_avg, axis=1, keepdims=True)
    o_avg = np.mean(origs, axis=0)

    if verbose:
        # per-joint spread across anchors: a direct read of the
        # occlusion-bias magnitude the average is cancelling
        spreads = [
            float(np.degrees(np.arccos(np.clip(
                min(float(u[j] @ u_avg[j]) for u in us), -1.0, 1.0))))
            for j in range(u_avg.shape[0])
        ]
        print(f"[chain] multi-anchor axis spread (deg, max vs mean) "
              f"{np.round(spreads, 2).tolist()}", flush=True)

    # express at the step-0 configuration for the URDF writer
    refined = []
    for j, joint in enumerate(joints):
        members = sorted(
            next(l for l in links if l.id == joint.parent_link).cluster_idx)
        p0 = _link_frame_np(cms[0], members, 0).astype(np.float64)
        refined.append(
            JointEstimate(
                parent_link=joint.parent_link,
                child_link=joint.child_link,
                local_axis=u_avg[j],
                local_pos=np.concatenate([o_avg[j], [1.0]]),
                global_pos=p0[:3, :3] @ o_avg[j] + p0[:3, 3],
                global_axis=p0[:3, :3] @ u_avg[j],
            )
        )
    result = ChainResult(u_avg, o_avg, res0.thetas, res0.loss,
                         freeze_deltas=res0.freeze_deltas,
                         subtree_share=res0.subtree_share,
                         step_losses=res0.step_losses)
    return refined, result


def merge_coarticulated_siblings(
    links,
    joints: list[JointEstimate],
    thetas: np.ndarray,
    scale: float,
    axis_deg: float = 10.0,
    line_frac: float = 0.12,
    corr_min: float = 0.92,
    min_range_deg: float = 5.0,
    verbose: bool = False,
) -> tuple[list, bool]:
    """Merge sibling links that articulate as ONE body on ONE hinge (ours).

    The failure this targets (storage cabinet, gt 3 links / 2 door
    hinges): the dendrogram splits one door into two links, the tree
    wires BOTH halves to the cabinet, and the chain fit gives each half
    the same ~35-50 deg swing about the same physical hinge line.  Every
    per-joint veto then reads "real articulation" — freezing either half
    leaves half a door unexplained (freeze-delta ~200% normalized), the
    excitation range is tens of degrees, and the screw axes are coherent
    — because the motion IS real; only the structure is wrong.  The
    discriminating signal is *pairwise*: two fitted joints tracking the
    same physical hinge have (a) near-parallel axes, (b) axis LINES that
    nearly coincide (the hinge line), and (c) per-frame theta
    trajectories correlated ~1.  Under this dataset's excitation
    (independent per-joint random walks, the reference simulator's
    trajectory contract) two DISTINCT gt joints decorrelate: over S*T ~ 50 samples
    chance |corr| > 0.9 is vanishing, and physically parallel sibling
    hinges (storage's two real doors) sit on opposite cabinet edges, so
    the line-coincidence gate blocks them even before correlation.

    Candidates are sibling joint pairs (same parent link) whose fitted
    ranges BOTH exceed ``min_range_deg`` (weaker joints belong to the
    static/drift/freeze vetoes, which run first).  ``scale`` is the
    workload's cloud diagonal — the natural unit for the line-coincidence
    gate.  Merging absorbs the second child into the first (union of
    cluster memberships, grandchildren re-parented); the caller must
    re-estimate joints and refit, exactly as after prune_static_joints.
    """
    J = len(joints)
    if J < 2:
        return links, False
    ranges = np.degrees(
        (thetas.max(axis=1) - thetas.min(axis=1)).max(axis=0))
    flat = thetas.reshape(-1, J).astype(np.float64)  # (S*T, J)
    by_parent: dict[int, list[int]] = {}
    for j, joint in enumerate(joints):
        by_parent.setdefault(joint.parent_link, []).append(j)

    def pair_stats(j1: int, j2: int):
        u1 = np.asarray(joints[j1].global_axis, np.float64)
        u2 = np.asarray(joints[j2].global_axis, np.float64)
        u1 = u1 / max(np.linalg.norm(u1), 1e-12)
        u2 = u2 / max(np.linalg.norm(u2), 1e-12)
        s = float(np.sign(u1 @ u2)) or 1.0
        ang = float(np.degrees(np.arccos(np.clip(abs(u1 @ u2), -1.0, 1.0))))
        # distance between the two (near-parallel) axis lines: component
        # of the origin offset perpendicular to the common direction
        d = (np.asarray(joints[j2].global_pos[:3], np.float64)
             - np.asarray(joints[j1].global_pos[:3], np.float64))
        line_d = float(np.linalg.norm(d - (d @ u1) * u1))
        a = flat[:, j1] - flat[:, j1].mean()
        b = s * (flat[:, j2] - flat[:, j2].mean())
        denom = float(np.linalg.norm(a) * np.linalg.norm(b))
        corr = float(a @ b) / denom if denom > 1e-12 else 0.0
        return ang, line_d, corr

    merge: tuple[int, int] | None = None
    for sibs in by_parent.values():
        for i1 in range(len(sibs)):
            for i2 in range(i1 + 1, len(sibs)):
                j1, j2 = sibs[i1], sibs[i2]
                if ranges[j1] < min_range_deg or ranges[j2] < min_range_deg:
                    continue
                ang, line_d, corr = pair_stats(j1, j2)
                fired = (ang < axis_deg and line_d < line_frac * scale
                         and corr > corr_min)
                if verbose:
                    print(f"[coart] sibling joints "
                          f"{joints[j1].parent_link}->"
                          f"{joints[j1].child_link} / "
                          f"->{joints[j2].child_link}: axis {ang:.1f}deg "
                          f"line {line_d / max(scale, 1e-9) * 100:.0f}% "
                          f"corr {corr:.2f} "
                          f"ranges {ranges[j1]:.0f}/{ranges[j2]:.0f}deg"
                          f"{'  -> MERGE' if fired else ''}", flush=True)
                if fired and merge is None:
                    merge = (j1, j2)  # one merge per pass; loop refits

    if merge is None:
        return links, False
    j1, j2 = merge
    keep_id, victim_id = joints[j1].child_link, joints[j2].child_link
    by_id = {l.id: l for l in links}
    by_id[keep_id].cluster_idx |= by_id[victim_id].cluster_idx
    survivors = []
    for l in links:
        if l.id == victim_id:
            continue
        if l.parent_id == victim_id:
            l.parent_id = keep_id
        survivors.append(l)
    renum = {l.id: i for i, l in enumerate(sorted(survivors,
                                                  key=lambda l: l.id))}
    for l in survivors:
        l.id = renum[l.id]
        if l.parent_id is not None:
            l.parent_id = renum[l.parent_id]
    return survivors, True


def prune_static_joints(
    links,
    joints: list[JointEstimate],
    thetas: np.ndarray,
    threshold: float = 0.035,
    extra_static: list[int] | None = None,
) -> tuple[list, bool]:
    """Merge child links whose fitted joint never moves (ours).

    After the chain fit, ``thetas`` (S, T, J) carries each joint's
    per-frame angles.  A real joint in this data moves tens of degrees in
    its best sequence (the trajectory generator excites every gt joint
    40-70 deg); a SPURIOUS joint — the probe ladder or the dendrogram
    splitting one rigid link in two (franka seed-2026 k=8, op3's 13th
    link) — fits only registration noise and its angle range stays within
    a degree or two.  Joints whose best-sequence range is below
    ``threshold`` (rad; default 2 deg) are removed and their child link's
    clusters merged into the parent.

    Returns (surviving LinkNodes in tree order, pruned?).  When pruned,
    the caller must re-estimate joints and re-run the chain fit on the
    merged structure (link mean frames change with membership).
    """
    ranges = (thetas.max(axis=1) - thetas.min(axis=1)).max(axis=0)
    static = [j for j, r in enumerate(ranges) if float(r) < threshold]
    # ``extra_static``: joint indices vetoed by an additional signal (the
    # drift veto in workflow.run_build_urdf combines a low fitted range
    # with incoherent registration screw axes)
    for j in extra_static or []:
        if j not in static:
            static.append(j)
    if not static:
        return links, False

    absorb = {joints[j].child_link: joints[j].parent_link for j in static}

    def resolve(lid):
        while lid in absorb:
            lid = absorb[lid]
        return lid

    by_id = {l.id: l for l in links}
    for victim, target in absorb.items():
        by_id[resolve(victim)].cluster_idx |= by_id[victim].cluster_idx
    survivors = []
    for l in links:  # original order preserves parent-before-child
        if l.id in absorb:
            continue
        if l.parent_id is not None:
            l.parent_id = resolve(l.parent_id)
        survivors.append(l)
    # renumber ids contiguously: downstream consumers (mesh {id:04}.stl
    # naming, the URDF writer's color table) index by link id
    renum = {l.id: i for i, l in enumerate(sorted(survivors,
                                                  key=lambda l: l.id))}
    for l in survivors:
        l.id = renum[l.id]
        if l.parent_id is not None:
            l.parent_id = renum[l.parent_id]
    return survivors, True
