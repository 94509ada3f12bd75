"""Chain-fit model selection for DoF discovery (port of
autourdf_tpu.structure.model_select).

Silhouette and merge-gap scores judge the motion-dissimilarity *map*;
the criteria here judge candidate structures by what actually matters:
how well a fitted kinematic chain with that many links explains the raw
frames.

``probe_k_selection`` (the default arbiter of the ``urdf`` stage's unknown
DoF) walks a contiguous ladder of link counts around the statistical pick,
probes each with a short chain fit, and selects by the LAST SIGNIFICANT
MARGINAL DROP:

  - under-split -> correct split is a 35-80% relative loss drop;
  - over-split gains are ~2-3% per extra link (noise absorption), so a
    GLOBAL penalized minimum still drifts upward (the negative result
    kept in chain_fit_dof_search below);
  - the marginal-drop sequence can contain flats BEFORE the true k, so the
    ladder needs lookahead, not stop-at-first-flat.

``chain_fit_dof_search`` -- global penalized minimum over a shortlist;
documented failure mode above.

A candidate structure that the tree or joint estimation cannot take (a
degenerate partition) scores ``inf``; only the errors of that host code are
caught, so a failure of the search kernels propagates.
"""

from __future__ import annotations

import numpy as np
import torch

from .clustering import coord_clustering, merge_gap_dof_search, silhouette_dof_search
from .coord_map import CoordMap
from .tree import cluster_mst, kinematics_tree

# What a degenerate candidate partition raises in the tree, joint and
# chain-fit set-up code (no root, a missing link id, an empty group, a
# singular frame); a CUDA failure of a search kernel is a RuntimeError and
# is not among them.
_DEGENERATE = (ValueError, KeyError, IndexError, StopIteration, np.linalg.LinAlgError)


def probe_k_selection(
    d_map: np.ndarray,
    cms: list[CoordMap],
    frames: np.ndarray,
    k0: int,
    frame_masks: np.ndarray | None = None,
    eps: float = 0.10,
    lookahead: int = 3,
    k_min: int = 2,
    k_max: int | None = None,
    probe_steps: int = 60,
    points_per_link: int = 256,
    carry_stack: np.ndarray | None = None,
    share_normalize: bool = False,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[list[set[int]], dict[int, float]]:
    """Ladder probe around the statistical pick ``k0``; returns the
    selected partition and the probed ``{k: loss}`` map.

    Algorithm (calibrated on the 3-seed x 4-robot sweep, see module doc):

    1. probe ``k0``; extend DOWN while the step k-1 -> k is flat (the
       pick may be over-split) and stop at the first significant increase
       (that increase IS the drop evidence for the boundary it crosses);
    2. extend UP until ``lookahead`` consecutive insignificant marginal
       drops (flats before the true k require looking past them);
    3. select the largest k whose marginal drop loss(k-1)/loss(k)
       >= 1+eps; if the window contains no significant drop, the
       smallest k within (1+eps) of the window minimum.

    A drop is "significant" at 10% relative — an order of magnitude above
    the ~2-3%/step over-split drift and several times below the >=35%
    under-split signal, so the margin is wide on both sides.

    Partitions are cut from the pose dendrogram and carry-refined exactly
    as the main path does, so the selected groups drop into the pipeline
    unchanged.  Cost: ~(lookahead + spread + 2) probes, each a
    ``probe_steps``-step chain fit at ``points_per_link`` points, on
    ``device``.
    """
    from ..joints.chain import refine_chain, short_fit_dispatch
    from ..joints.screw import estimate_joints_from_tree
    from .coord_map import refine_groups_by_carry

    K = d_map.shape[0]
    k_max = k_max or min(25, K)
    k0 = int(np.clip(k0, k_min, k_max))
    T = frames.shape[1]

    part_cache: dict[int, list[set[int]]] = {}
    loss_cache: dict[int, float] = {}

    def partition(k: int) -> list[set[int]]:
        if k not in part_cache:
            groups, _, _ = coord_clustering(d_map, k)
            groups = refine_groups_by_carry(cms, groups, stack=carry_stack, device=device)
            part_cache[k] = groups
        return part_cache[k]

    def loss(k: int) -> float:
        if k not in loss_cache:
            groups = partition(k)
            # probe BOTH tree hypotheses and keep the better fit: judging
            # every k through one topology biases the ladder (ur5: the
            # proximity MST's composite wrist inflates the true k=6 to
            # 0.060 while the motion tree fits it at 0.029 — under
            # MST-only scoring the ladder over-split to k=7 to compensate)
            candidates = []
            try:
                candidates.append(
                    kinematics_tree(cms[0], groups, cluster_mst(cms[0])))
            except _DEGENERATE:
                pass
            try:
                from .tree import motion_tree

                candidates.append(motion_tree(cms, groups, T))
            except _DEGENERATE:
                pass
            val = np.inf
            for links in candidates:
                try:
                    joints = estimate_joints_from_tree(links, cms, 0, T,
                                                       interval=4)
                    if not joints:
                        continue
                    _, result = refine_chain(
                        links, joints, cms, frames, steps=probe_steps,
                        points_per_link=points_per_link,
                        frame_masks=frame_masks, freeze_probe=False,
                        device=device, dispatch_steps=short_fit_dispatch(probe_steps),
                    )
                    val = min(val, float(result.loss))
                except _DEGENERATE as e:  # degenerate candidate
                    if verbose:
                        print(f"[kprobe] k={k}: candidate failed "
                              f"({type(e).__name__})")
            loss_cache[k] = val
            if verbose and np.isfinite(val):
                print(f"[kprobe] k={k} (eff {len(groups)}): "
                      f"probe loss {val:.5f}")
        return loss_cache[k]

    share = None
    if share_normalize:
        # point share of the region that CHANGES between partition(k-1)
        # and partition(k) — the denominator that makes a small distal
        # link's split drop comparable to a large link's (a correct split
        # of an 18-DoF hexapod's last leg segment buys only 3-7% global
        # chamfer, below any fixed bar; pxs s2025 under-split to k=16).
        # Robust to carry reassignment: "changed" = groups of partition(k)
        # that are not groups of partition(k-1) verbatim.
        labels0 = np.asarray(cms[0].cluster_labels[0])
        counts = np.bincount(labels0, minlength=K).astype(np.float64)

        def share(k: int) -> float:
            if k - 1 < k_min:
                return 1.0
            prev = {frozenset(g) for g in partition(k - 1)}
            changed = [g for g in partition(k) if frozenset(g) not in prev]
            if not changed:
                return 1.0
            pts = sum(float(counts[i]) for g in changed for i in g)
            return float(np.clip(pts / max(counts.sum(), 1.0), 0.02, 1.0))

    best_k = ladder_select(loss, k0, k_min=k_min, k_max=k_max, eps=eps,
                           lookahead=lookahead, share=share)
    if best_k is None:
        best_k = k0
    if verbose:
        ks = sorted(loss_cache)
        tag = ", share-norm" if share_normalize else ""
        print(f"[kprobe] selected k={best_k} "
              f"(window {ks[0]}..{ks[-1]}, eps {eps:.2f}{tag})")
    return partition(best_k), loss_cache


def ladder_select(
    loss,
    k0: int,
    k_min: int = 2,
    k_max: int = 25,
    eps: float = 0.10,
    lookahead: int = 3,
    drift_factor: float = 2.5,
    share=None,
) -> int | None:
    """Pure ladder walk + drift-normalized last-significant-drop selection.

    ``loss`` is a memoizing callable k -> probe loss (may return inf).
    Returns the selected k, or None if every probed loss is non-finite.
    Separated from probe_k_selection so the walk/selection policy is unit
    testable against synthetic loss curves (the measured curve shapes in
    the module docstring are the test fixtures).

    Significance is judged against the LOCAL over-split drift, not a
    fixed threshold alone: large objects' probe curves decline 8-10% per
    spurious extra link (capture noise on big surfaces; measured on
    laptop — 0.0885/0.0808/0.0734/0.0680 for k=2..5) while an arm's
    drift is 2-4%, so a fixed 10% cut over-splits the former.  A drop at
    k counts only if it is >= max(eps, drift_factor * median of the raw
    drops above k); real joints measure 6-13x their local drift, spurious
    ones 1.0-1.3x.  With no significant drop anywhere the walk found no
    articulation evidence against the statistical pick — return ``k0``
    (never the window minimum, which just rewards the drift).

    ``share`` (optional callable k -> point share of the region that the
    k-1 -> k split changes, clipped away from 0) normalizes each drop
    before significance is judged: a correct split of a small distal
    link can only buy a small GLOBAL chamfer drop, so the raw criterion
    systematically under-splits many-small-link robots while the
    share-normalized one judges the drop against what that region could
    possibly contribute.  The walk itself stays raw — only the final
    selection normalizes.
    """
    probed: dict[int, float] = {}

    def ev(k: int) -> float:
        if k not in probed:
            probed[k] = float(loss(k))
        return probed[k]

    ev(k0)
    # downward: keep descending while the coarser partition fits equally
    # well (over-split pick); a significant increase marks a needed link
    lo = k0
    while lo > k_min:
        if not np.isfinite(ev(lo)):
            lo -= 1
            continue
        if ev(lo - 1) >= (1.0 + eps) * ev(lo):
            break
        lo -= 1
    # upward: look past flats until `lookahead` consecutive insignificant
    # marginal drops.  The walk judges raw eps, and — when share
    # normalization is on — ALSO counts a step as progress when its
    # share-normalized drop reaches the >=35% under-split band: a true
    # split of a small distal link reads 3-7% raw (invisible to the raw
    # criterion, so the window would stop `lookahead` short of it — the
    # exact under-split regime the flag targets) but 60-140% normalized.
    # The 0.35 floor (not eps) keeps the walk bounded: over-split drift
    # normalizes to 16-30% on small shares, below the band, so drift
    # cannot keep the walk alive to k_max.
    hi, flats = k0, 0
    while hi < k_max and flats < lookahead:
        nxt = ev(hi + 1)
        cur = ev(hi)
        progress = (np.isfinite(cur) and np.isfinite(nxt)
                    and cur >= (1.0 + eps) * nxt)
        if (not progress and share is not None and np.isfinite(cur)
                and np.isfinite(nxt) and nxt > 0):
            progress = (cur / nxt - 1.0) / share(hi + 1) >= 0.35
        if progress:
            flats = 0
        else:
            flats += 1
        hi += 1

    ks = sorted(k for k in probed if np.isfinite(probed[k]))
    if not ks:
        return None

    def drop(k: int) -> float:
        if k - 1 in probed and np.isfinite(probed[k - 1]) and \
                np.isfinite(probed[k]) and probed[k] > 0:
            raw = probed[k - 1] / probed[k] - 1.0
            if share is not None:
                return raw / share(k)
            return raw
        return 0.0

    best_k = None
    for k in ks:
        above = [drop(k2) for k2 in ks if k2 > k and k2 - 1 in probed]
        drift = float(np.median(above)) if above else 0.0
        floor = eps
        if share is not None and not above:
            # window edge: no successors to estimate the local drift, and
            # normalization can lift pure drift past the raw eps floor
            # (laptop at share 0.5).  Demand the >=35% under-split-band
            # signal instead.
            floor = max(eps, 0.35)
        if drop(k) >= max(floor, drift_factor * drift):
            best_k = k
    return best_k if best_k is not None else int(np.clip(k0, ks[0], ks[-1]))


def candidate_link_counts(
    d_map: np.ndarray, link_range: tuple[int, int] | None = None, top: int = 3
) -> list[int]:
    """Shortlist: top candidates by silhouette plus top by merge gap."""
    _, _, s_scores, nls = silhouette_dof_search(d_map, link_range)
    _, _, g_scores, _ = merge_gap_dof_search(d_map, link_range)
    order_s = [int(nls[i]) for i in np.argsort(s_scores)[::-1][:top]]
    order_g = [int(nls[i]) for i in np.argsort(g_scores)[::-1][:top]]
    seen, out = set(), []
    for n in order_s + order_g:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out


def chain_fit_dof_search(
    d_map: np.ndarray,
    cms: list[CoordMap],
    frames: np.ndarray,
    link_range: tuple[int, int] | None = None,
    fit_steps: int = 120,
    points_per_link: int = 512,
    joint_penalty: float = 0.02,
    num_sequences: int = 2,
    verbose: bool = False,
    device: str | torch.device = "cuda",
):
    """Returns (groups, labels, scores, candidates) like the other searches.

    ``scores`` are the penalized chain-fit losses (lower is better) for the
    shortlisted candidates.
    """
    from ..joints.chain import refine_chain, short_fit_dispatch
    from ..joints.screw import estimate_joints_from_tree

    cands = candidate_link_counts(d_map, link_range)
    sub_cms = cms[:num_sequences]
    sub_frames = frames[:num_sequences]
    T = sub_frames.shape[1]

    results = []
    for nl in cands:
        groups, labels, _ = coord_clustering(d_map, nl)
        g0 = cluster_mst(sub_cms[0])
        links = kinematics_tree(sub_cms[0], groups, g0)
        try:
            joints = estimate_joints_from_tree(links, sub_cms, 0, T, interval=4)
            _, chain = refine_chain(
                links, joints, sub_cms, sub_frames, steps=fit_steps,
                points_per_link=points_per_link, freeze_probe=False,
                device=device, dispatch_steps=short_fit_dispatch(fit_steps),
            )
            loss = float(chain.loss)
        except _DEGENERATE as e:  # degenerate candidate
            if verbose:
                print(f"[chainfit] links={nl}: failed ({type(e).__name__})")
            results.append((nl, np.inf, groups, labels))
            continue
        score = loss * (1.0 + joint_penalty * len(joints))
        if verbose:
            print(f"[chainfit] links={nl}: chamfer {loss:.5f} "
                  f"score {score:.5f}")
        results.append((nl, score, groups, labels))

    results.sort(key=lambda r: r[1])
    best_nl, _, groups, labels = results[0]
    scores = [s for _, s, _, _ in sorted(results, key=lambda r: cands.index(r[0]))]
    return groups, labels, scores, np.asarray(cands)
