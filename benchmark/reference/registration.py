"""Plain reference of the registration stage (mode ``q``): the pose MLP,
the per-cluster transform, the L1 Chamfer loss, the Adam update, Lloyd's
resample and the local frames, written out in plain PyTorch from the
method's description (AutoURDF's ``scripts/registration.sh``: a residual
MLP on ``[xyz, quat]`` poses with a 4-octave sin/cos encoding, trained by
Adam on the bidirectional L1 Chamfer between the posed clusters and the
next frame).

Searches are exhaustive (every pair's distance, in row blocks), transforms gather
each point's cluster pose, and every sequence is computed on its own valid
points.  The layout of a flat parameter row (the layers in order, each
weight ``(in, out)`` then bias) is what the reference reads from the
program's recorded state.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 2048


# --- rotations -------------------------------------------------------------

def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), eps)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = quat_normalize(q).unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion ``[w, x, y, z]`` with ``w >= 0``,
    from the largest of the four squared magnitudes."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    sq = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    mag = torch.sqrt(torch.clamp_min(sq, 0.0))
    cands = torch.stack([
        torch.stack([sq[..., 0], m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, sq[..., 1], m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, sq[..., 2], m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, sq[..., 3]], dim=-1)], dim=-2)
    cands = cands / (2.0 * torch.clamp_min(mag, 0.1))[..., None]
    best = torch.argmax(sq, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


# --- the pose MLP ----------------------------------------------------------

def layers(hidden: int) -> list[tuple[str, int, int]]:
    """Mode ``q``'s dense layers ``(name, in, out)`` in their flat order."""
    return [("encoder", 56, hidden), ("head0_l0", hidden, hidden // 2),
            ("head0_l1", hidden // 2, 3), ("head1_l0", hidden, hidden),
            ("head1_l1", hidden, 4)]


def unflatten(theta: torch.Tensor, hidden: int) -> dict[str, torch.Tensor]:
    out, off = {}, 0
    S = theta.shape[0]
    for name, i, o in layers(hidden):
        out[name + "_w"] = theta[:, off:off + i * o].reshape(S, i, o)
        off += i * o
        out[name + "_b"] = theta[:, off:off + o]
        off += o
    if off != theta.shape[1]:
        raise ValueError(f"a flat row of {theta.shape[1]} values is not mode q at "
                         f"hidden {hidden} ({off})")
    return out


def encode(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([g(f * x) for f in (1.0, 2.0, 4.0, 8.0) for g in (torch.sin, torch.cos)],
                     dim=-1)


def pose_mlp(p: dict[str, torch.Tensor], m: torch.Tensor) -> torch.Tensor:
    """Refined poses ``(S, K, 4, 4)`` from poses ``m``."""
    def dense(name, x):
        return torch.bmm(x, p[name + "_w"]) + p[name + "_b"][:, None, :]

    act = lambda x: torch.nn.functional.leaky_relu(x, 0.01)  # noqa: E731
    t = m[..., :3, 3]
    q = matrix_to_quat(m[..., :3, :3])
    feat = act(dense("encoder", encode(torch.cat([t, q], dim=-1))))
    d_xyz = dense("head0_l1", act(dense("head0_l0", feat)))
    d_rot = dense("head1_l1", act(dense("head1_l0", feat)))
    rot = quat_to_matrix(quat_normalize(q + d_rot))
    top = torch.cat([rot, (t + d_xyz)[..., None]], dim=-1)
    return torch.cat([top, m.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        top.shape[:-2] + (1, 4))], dim=-2)


# --- geometry and the loss -------------------------------------------------

def transform(m: torch.Tensor, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """World points ``R[label] p + t[label]`` of one sequence."""
    T = m[labels]
    return torch.einsum("nij,nj->ni", T[:, :3, :3], points) + T[:, :3, 3]


def local_points(m: torch.Tensor, world: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Points ``R[label]^T (p - t[label])`` in their cluster's frame."""
    T = m[labels]
    return torch.einsum("nji,nj->ni", T[:, :3, :3], world - T[:, :3, 3])


@torch.no_grad()
def nearest_l1(x: torch.Tensor, y: torch.Tensor):
    """Exhaustive L1 nearest neighbours both ways: ``(dx, ix, dy, iy)``."""
    dx, ix = [], []
    dy = torch.full((len(y),), float("inf"), dtype=x.dtype, device=x.device)
    iy = torch.zeros(len(y), dtype=torch.long, device=x.device)
    for a in range(0, len(x), BLOCK_ROWS):
        d = (x[a:a + BLOCK_ROWS, None, :] - y[None, :, :]).abs().sum(-1)
        v, i = d.min(dim=1)
        dx.append(v)
        ix.append(i)
        cv, ci = d.min(dim=0)
        better = cv < dy
        dy = torch.where(better, cv, dy)
        iy = torch.where(better, ci + a, iy)
    return torch.cat(dx), torch.cat(ix), dy, iy


def chamfer_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean L1 distance of each point to the other cloud's nearest, both
    ways; differentiable in ``x`` through the nearest points."""
    _, ix, _, iy = nearest_l1(x.detach(), y)
    return (torch.abs(x - y[ix]).sum(-1).mean() + torch.abs(y - x[iy]).sum(-1).mean())


# --- a training phase's bookkeeping and epochs ------------------------------

STATE_KEYS = ("best_loss", "bad_count", "stopped", "plateau_best", "num_bad", "lr", "step")


def fresh_state(num_seqs: int, lr: float) -> dict:
    """The bookkeeping of a training phase before its first epoch."""
    return {"best_loss": np.full(num_seqs, np.inf, np.float32),
            "bad_count": np.zeros(num_seqs, np.int64), "stopped": np.zeros(num_seqs, bool),
            "plateau_best": np.full(num_seqs, np.inf, np.float32),
            "num_bad": np.zeros(num_seqs, np.int64), "lr": np.full(num_seqs, lr, np.float32),
            "step": np.zeros(num_seqs, np.int64)}


def advance(st: dict, loss, stop_patience: int, patience: int, factor: float,
            threshold: float) -> None:
    """One epoch of a training phase's bookkeeping, in place, as the method
    states it, in float32, on the sequences that have not stopped: Adam's
    step count; the best loss and the epochs since it improved, and the
    stop once more than ``stop_patience`` epochs pass without a new best
    (every later epoch is skipped); ReduceLROnPlateau (mode min, relative
    ``threshold``; ``factor`` once more than ``patience`` epochs pass
    without improving on its own best, taking effect the next epoch)."""
    f32 = np.float32
    for s in range(len(loss)):
        if st["stopped"][s]:
            continue
        st["step"][s] += 1
        if loss[s] < st["best_loss"][s]:
            st["best_loss"][s], st["bad_count"][s] = loss[s], 0
        else:
            st["bad_count"][s] += 1
        if loss[s] < f32(st["plateau_best"][s] * f32(1.0 - threshold)):
            st["plateau_best"][s], st["num_bad"][s] = loss[s], 0
        else:
            st["num_bad"][s] += 1
        if st["num_bad"][s] > patience:
            st["lr"][s], st["num_bad"][s] = f32(st["lr"][s] * f32(factor)), 0
        st["stopped"][s] = st["bad_count"][s] > stop_patience


def schedule(losses, lr: float, stop_patience: int, patience: int, factor: float,
             threshold: float) -> tuple[dict, np.ndarray]:
    """The bookkeeping replayed over a phase's per-epoch losses ``(S, E)``
    (``inf`` where an epoch did not run): the state after the ``E`` epochs
    (``STATE_KEYS``, each ``(S,)``) and the epochs that ran ``(S, E)``."""
    losses = np.asarray(losses, np.float32)
    st = fresh_state(losses.shape[0], lr)
    ran = np.zeros(losses.shape, bool)
    for e in range(losses.shape[1]):
        ran[:, e] = ~st["stopped"]
        advance(st, losses[:, e], stop_patience, patience, factor, threshold)
    return st, ran


def follow(theta: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, state: dict,
           matrices: torch.Tensor, points: list[torch.Tensor], labels: list[torch.Tensor],
           targets: list[torch.Tensor], hidden: int, epochs: int, stop_patience: int,
           patience: int, factor: float, threshold: float):
    """A training phase followed for ``epochs`` epochs from flat MLP rows
    ``theta (S, P)``, Adam's moments ``mu``, ``nu`` and the bookkeeping
    ``state`` (``STATE_KEYS``, as :func:`schedule` gives it), fed the incoming
    poses ``matrices (S, K, 4, 4)`` every epoch, each sequence's valid
    source points and labels and its target frame: each epoch's loss taken
    before Adam's update (0.9, 0.999, 1e-8) at the epoch's learning rate,
    then the bookkeeping (:func:`advance`); a stopped sequence
    is left as it is.  Returns the losses ``(S, epochs)`` (``inf`` where a
    sequence had stopped), the rows after the last epoch and the gradient
    of the first."""
    dev = theta.device
    th = theta.detach().clone()
    mu, nu = mu.detach().clone(), nu.detach().clone()
    st = {k: np.array(v, copy=True) for k, v in state.items()}
    out, first_grad = [], None
    for _ in range(epochs):
        th.requires_grad_(True)
        m2 = pose_mlp(unflatten(th, hidden), matrices)
        loss = torch.stack([chamfer_l1(transform(m2[s], points[s], labels[s]), targets[s])
                            for s in range(len(points))])
        (g,) = torch.autograd.grad(loss.sum(), th)
        if first_grad is None:
            first_grad = g.detach()
        live = torch.from_numpy(~st["stopped"]).to(dev)
        loss_np = loss.detach().cpu().numpy().astype(np.float32)
        out.append(np.where(st["stopped"], np.float32(np.inf), loss_np))
        with torch.no_grad():
            step = torch.from_numpy(st["step"] + 1).to(dev, torch.float64)[:, None]
            bc1, bc2 = (1 - 0.9 ** step).float(), (1 - 0.999 ** step).float()
            lr = torch.from_numpy(st["lr"]).to(dev)[:, None]
            mu_n = 0.9 * mu + 0.1 * g
            nu_n = 0.999 * nu + 0.001 * g * g
            th_n = th.detach() - lr * (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + 1e-8)
            keep = live[:, None]
            th = torch.where(keep, th_n, th.detach())
            mu, nu = torch.where(keep, mu_n, mu), torch.where(keep, nu_n, nu)
        advance(st, loss_np, stop_patience, patience, factor, threshold)
    return np.stack(out, axis=1), th.detach(), first_grad


def leaf_slices(hidden: int) -> list[tuple[int, int]]:
    """The ``(start, end)`` of each weight and bias in a flat row."""
    out, off = [], 0
    for _, i, o in layers(hidden):
        out += [(off, off + i * o), (off + i * o, off + i * o + o)]
        off += i * o + o
    return out


def change_gaps(start: torch.Tensor, program_end: torch.Tensor,
                reference_end: torch.Tensor, first_grad: torch.Tensor,
                hidden: int) -> tuple[float, float]:
    """The parameters' change over a followed stretch, by leaf (one
    sequence's weight or bias of one layer): the gap between the program's
    norm of its change and the reference's, over the larger of the
    reference's norm and the median leaf's.  Leaves whose reference
    gradient at the start is under a thousandth of the median leaf's move
    by round-off alone and are left out.  Returns the worst leaf's gap and
    the gap between the two sides' median leaf changes."""
    d_p = program_end.double() - start.double()
    d_r = reference_end.double() - start.double()
    g = first_grad.double()
    cuts = leaf_slices(hidden)
    P, R, G = (np.array([[float(t[s, a:b].norm()) for a, b in cuts] for s in range(len(t))])
               .reshape(-1) for t in (d_p, d_r, g))
    keep = G >= 1e-3 * np.median(G)
    P, R = P[keep], R[keep]
    floor = max(float(np.median(R)), 1e-30)
    worst = float(np.max(np.abs(P - R) / np.maximum(R, floor)))
    return worst, float(abs(np.median(P) - floor) / floor)


@torch.no_grad()
def chamfer_at(m: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
               target: torch.Tensor) -> float:
    """The loss of one sequence's poses ``m (K, 4, 4)``."""
    return float(chamfer_l1(transform(m, points, labels), target))


# --- the resample -----------------------------------------------------------

@torch.no_grad()
def lloyd(points: torch.Tensor, centres: torch.Tensor, iters: int = 32,
          tol: float = 1e-4) -> torch.Tensor:
    """Lloyd's k-means from ``centres``, ``iters`` rounds at most, held once
    a round moves the centres by at most ``tol`` times the data's variance
    (summed squared shift); empty clusters keep their centre.  Labels of the
    final centres."""
    p = points.double()
    var = ((p - p.mean(0)) ** 2).mean()
    c = centres.double()
    K = len(c)
    for _ in range(iters):
        lab = torch.cdist(p, c).argmin(dim=1)
        counts = torch.bincount(lab, minlength=K).double()
        sums = torch.zeros_like(c).index_add_(0, lab, p)
        new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1)[:, None], c)
        shift = ((new - c) ** 2).sum()
        c = new
        if shift <= tol * var:
            break
    return torch.cdist(p, c).argmin(dim=1)
