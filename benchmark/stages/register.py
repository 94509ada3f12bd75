"""The registration stage, ``workflow.run_registration`` (``cli register``):
a unit registers every sequence of the configuration in one batch from a
k-means++ segmentation and MLP weights drawn from the unit's seed, reads
its frames from disk and writes its artifacts, as a ``cli register``
process does, on an empty program cache.

Every training phase's start and result are recorded (references, no
copies), and so is the carry that the epoch programs hand on at one later
chunk start drawn from the seed, with the carry at that chunk's end
(copies).  After the window: a sample of phases drawn from the seed is
followed by the reference for its first epochs; the sampled chunk is
followed whole, its first loss and its parameters' change compared; every
phase's bookkeeping (best loss, early stop, plateau learning rate, Adam's
step) is replayed from its losses; and the last unit's outputs (poses,
losses, resampled labels, local points, the frame-0 segmentation and the
files it wrote) are held against the reference.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import frames as frame_sources
from ..harness import BenchmarkError, merge_max, unit_seed
from ..plyio import read_sequences
from ..reference import full_fp32
from ..reference import registration as ref
from ..trace import DeviceSlice


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "not read"


class Stage:
    def __init__(self, run):
        self.run = run
        self.dev = run.device
        self.records: list[list] = []
        self.results: list = []
        self._restore = None
        self._slice_at = None
        self._chunk_at = None      # (unit, phase, draw) of the followed chunk
        self._chunk = None         # the chunk being recorded, then its record

    # --- set-up ------------------------------------------------------------
    def setup(self) -> dict:
        from autourdf_tpu_torch.config import PipelineConfig
        from autourdf_tpu_torch.registration import pipeline

        run, cfg = self.run, self.run.cell.config
        t0 = time.perf_counter()
        self.data_root = os.path.join(run.tmp, "data")
        self.seq_dirs = frame_sources.make(run, self.data_root)
        fr = cfg["frames"]
        self.cfg = PipelineConfig(
            robot=cfg["robot"], data_root=self.data_root, num_videos=len(self.seq_dirs),
            epochs=run.setting("epochs"), rot=cfg["rot"], num_seg=run.setting("num_seg"),
            step_size_deg=fr.get("step_deg", 4), num_cameras=fr.get("cameras", 20))
        from autourdf_tpu_torch.registration import optimizer
        from autourdf_tpu_torch.utils import programs

        inner, inner_run = pipeline.train_pose_mlp, programs.run

        def recording(*a, **k):
            where = (len(self.records) - 1, len(self.records[-1]))
            sl = None
            if self._slice_at == where:
                sl = DeviceSlice(self.dev, "training phase")
                sl.start()
            if self._chunk_at is not None and self._chunk_at[:2] == where:
                chunks = optimizer.epoch_chunks(k["epochs"], k["dispatch_epochs"],
                                                k["corr_every"])
                if len(chunks) > 1:
                    c = 1 + int(self._chunk_at[2] * (len(chunks) - 1))
                    self._chunk = {"phase": where, "index": c, "calls": 0,
                                   "first_epoch": sum(chunks[:c]), "epochs": chunks[c]}
            res = inner(*a, **k)
            if sl is not None:
                self.run.data["slice"] = sl.stop()
                self.run.data["register"] = self._slice_counts(a, k)
                print(f"slice: {len(sl.result['kernels'])} device operations, user "
                      f"annotations on the device {sl.result['annotations_s']!r} s",
                      file=sys.stderr, flush=True)
            self.records[-1].append((a, k, res))
            return res

        def chunk_recording(key, fn, *args, warm=None):
            ch = self._chunk
            if ch is None or "end" in ch or key[0] != "train_epochs":
                return inner_run(key, fn, *args, warm=warm)
            ch["calls"] += 1
            if ch["calls"] - 1 != ch["index"]:
                return inner_run(key, fn, *args, warm=warm)
            ch["start"] = programs.clone(args[0])
            out = inner_run(key, fn, *args, warm=warm)
            ch["end"] = programs.clone(out[0])
            return out

        pipeline.train_pose_mlp = recording
        programs.run = chunk_recording
        self._restore = (pipeline, inner, programs, inner_run)
        if self.dev == "cuda":
            self.power = power_limit()
            print(f"card: {self.power}", flush=True)
        t1 = time.perf_counter()
        self.unit(-1)                       # the warm unit: every shape of the cell
        rng = np.random.default_rng([abs(run.seed) % (1 << 63), 2])
        self._chunk_at = (0, int(rng.integers(len(self.records[0]))), float(rng.random()))
        self.records.clear()
        self.results.clear()
        if run.trace:
            tr = run.setting("trace")
            self._slice_at = (tr["unit"], tr["phase"])
        return {"inputs": t1 - t0, "warm unit": time.perf_counter() - t1}

    # --- the window ----------------------------------------------------------
    def unit(self, i: int) -> dict:
        from autourdf_tpu_torch import workflow
        from autourdf_tpu_torch.utils import programs

        tel = os.path.join(self.data_root, "telemetry.json")
        if os.path.exists(tel):
            os.remove(tel)
        programs.clear()
        n_caps = len(programs.captures)
        self.records.append([])
        t0 = time.perf_counter()
        out = workflow.run_registration(self.cfg, seed=unit_seed(self.run.seed, i),
                                        verbose=False, device=self.dev)
        seconds = time.perf_counter() - t0
        res = out["result"]
        self.results.append(res)
        S, T = res.matrices.shape[:2]
        return {"frames": S * (T - 1), "seconds": seconds,
                "captures": list(programs.captures[n_caps:])}

    def end_to_end(self, units: list[dict], window_s: float) -> dict:
        return {"register_frames_per_s": sum(u["frames"] for u in units) / window_s}

    def release(self) -> None:
        from autourdf_tpu_torch.utils import programs

        mod, inner, prog_mod, inner_run = self._restore
        mod.train_pose_mlp = inner
        prog_mod.run = inner_run
        programs.clear()
        if self.dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _slice_counts(self, a, k) -> dict:
        """The traced phase's work from its start: the epochs, the valid
        pairs and points of one epoch's search, its operations."""
        from ..counts import epoch_flops

        _, theta, matrices, target, points, labels, target_mask, points_mask = a[:8]
        S, N, M = points.shape[0], points.shape[1], target.shape[1]
        n = (points_mask.sum(1) if points_mask is not None
             else torch.full((S,), N)).double().cpu().numpy()
        m = (target_mask.sum(1) if target_mask is not None
             else torch.full((S,), M)).double().cpu().numpy()
        cfg = self.run.cell.config
        epochs = int(k["epochs"])
        pairs = float(np.sum(n * m))
        return {
            "epochs": epochs, "pairs": pairs, "points": float(np.sum(n + m)),
            "flops": epochs * epoch_flops(pairs, float(np.sum(n)), S,
                                          matrices.shape[1], cfg["rot"], cfg["hidden_dim"])}

    # --- the check -----------------------------------------------------------
    def check(self) -> tuple[dict, dict]:
        full_fp32()
        run = self.run
        dev = self.dev
        raw = read_sequences(self.seq_dirs)
        frames = [[torch.from_numpy(f).to(dev) for f in seq] for seq in raw]
        hidden = run.cell.config["hidden_dim"]
        rng = np.random.default_rng([abs(run.seed) % (1 << 63), 1])

        # a sample of training phases, the first of the window's first
        # unit always among them: followed for their first epochs, and
        # their best pose held against its loss
        phases = [(u, j) for u, recs in enumerate(self.records) for j in range(len(recs))]
        pick = 1 + rng.choice(len(phases) - 1, size=min(run.setting("check_phases") - 1,
                                                        len(phases) - 1), replace=False)
        consts = self._bookkeeping()
        per_unit: dict[int, dict] = {}
        for u, j in [phases[0]] + [phases[p] for p in sorted(pick)]:
            a, k, res = self.records[u][j]
            _, theta, matrices, target, points, labels, target_mask, points_mask = a[:8]
            pair = j // 2
            pts, labs = self._valid(points, labels, points_mask)
            tgts = [frames[s][pair + 1] for s in range(len(pts))]
            zero = torch.zeros_like(theta, dtype=torch.float32)
            follow, _, _ = ref.follow(theta.float(), zero, zero,
                                      ref.fresh_state(len(pts), self._lr(j)), matrices, pts,
                                      labs, tgts, hidden, 3, *consts)
            gaps = _loss_gaps(res.loss_history[:, :3], follow).max(0).tolist()
            bl = torch.tensor([ref.chamfer_at(res.best_matrices[s], pts[s], labs[s], tgts[s])
                               for s in range(len(pts))], device=dev)
            r = _rel(res.best_loss.float(), bl)
            merge_max(per_unit.setdefault(u, {}), first_loss_gap=gaps[0], step_loss_gap=gaps[1],
                   third_loss_gap=gaps[2], loss_residual=r)

        # every phase's bookkeeping, replayed from its losses: the epochs that
        # ran, the best loss
        for u, recs in enumerate(self.records):
            bad = 0
            for j, (_, _, res) in enumerate(recs):
                hist = res.loss_history.float().cpu().numpy()
                st, ran = ref.schedule(hist, self._lr(j), *consts)
                bad += int(np.sum(np.isfinite(hist) != ran))
                bad += int(np.sum(res.best_loss.float().cpu().numpy() != st["best_loss"]))
            per_unit.setdefault(u, {})["schedule_mismatch"] = bad

        # the sampled later chunk: the carry handed to it and the one it
        # handed on against the bookkeeping replayed from the losses before
        # them; followed whole from its start: its first loss, its first
        # three, and its parameters' change
        ch = self._chunk
        if ch is None or "end" not in ch:
            raise BenchmarkError("the window recorded no later chunk of a training phase")
        u, j = ch["phase"]
        a, k, res = self.records[u][j]
        _, theta, matrices, target, points, labels, target_mask, points_mask = a[:8]
        pts, labs = self._valid(points, labels, points_mask)
        tgts = [frames[s][j // 2 + 1] for s in range(len(pts))]
        e0, n = ch["first_epoch"], ch["epochs"]
        hist = res.loss_history.float().cpu().numpy()
        before, _ = ref.schedule(hist[:, :e0], self._lr(j), *consts)
        after, _ = ref.schedule(hist[:, :e0 + n], self._lr(j), *consts)
        start, end = ch["start"], ch["end"]
        bad = _carry_mismatch(start, before) + _carry_mismatch(end, after)
        follow, theta_ref, grad = ref.follow(start.theta.float(), start.opt.mu.float(),
                                             start.opt.nu.float(), before, matrices, pts, labs,
                                             tgts, hidden, n, *consts)
        worst, median = ref.change_gaps(start.theta, end.theta, theta_ref, grad, hidden)
        gaps = _loss_gaps(res.loss_history[:, e0:e0 + 3], follow[:, :3])
        unit0 = per_unit.setdefault(u, {})
        unit0["schedule_mismatch"] += bad
        merge_max(unit0, chunk_first_loss_gap=float(gaps[:, 0].max()),
                  chunk_loss_gap=float(gaps.max()), chunk_change_gap=worst,
                  chunk_median_change_gap=median)

        # the last unit's outputs, every frame pair
        last = len(self.results) - 1
        out = self.results[last]
        S, T = out.matrices.shape[:2]
        n0 = len(raw[0][0])
        mismatch = total = 0
        lp_gap = residual = 0.0
        for s in range(S):
            for t in range(1, T):
                tgt = frames[s][t]
                n_t = len(tgt)
                m = out.matrices[s, t]
                lab = out.labels[s, t, :n_t]
                lab_ref = ref.lloyd(tgt, m[:, :3, 3], run.setting("kmeans_iters"))
                mismatch += int((lab != lab_ref).sum())
                total += n_t
                lp = ref.local_points(m, tgt, lab)
                lp_gap = max(lp_gap, float((out.local_points[s, t, :n_t] - lp).abs().max()))
                loss_ref = ref.chamfer_at(m, out.local_points[s, 0, :n0],
                                          out.labels[s, 0, :n0], tgt)
                residual = max(residual, abs(float(out.losses[s, t - 1]) - loss_ref) / loss_ref)

        # every unit's frame-0 segmentation: each point in its nearest
        # centre's cluster
        init_bad = init_total = 0
        for res in self.results:
            c = res.matrices[0, 0, :, :3, 3]
            lab0 = res.labels[0, 0, :n0]
            world = res.local_points[0, 0, :n0] + c[lab0]
            init_bad += int((torch.cdist(world.double(), c.double()).argmin(1) != lab0).sum())
            init_total += n0
        init_share = init_bad / init_total

        merge_max(per_unit.setdefault(last, {}), loss_residual=residual,
               label_mismatch=mismatch / max(total, 1), local_point_gap=lp_gap,
               written_mismatch=self._written_mismatch(out, raw))
        readings = merge_max({}, *per_unit.values())
        readings["init_label_mismatch"] = init_share
        return readings, per_unit

    def _lr(self, phase: int) -> float:
        """The learning rate a phase starts at: a pair's step phase, then its
        anchor phase."""
        return float(self.run.cell.config["lr_anchor" if phase % 2 else "lr_step"])

    def _bookkeeping(self) -> tuple:
        """The configuration's early stop and plateau schedule, in the order
        the reference takes them."""
        cfg = self.run.cell.config
        return (cfg["stop_patience"], cfg["plateau_patience"], cfg["plateau_factor"],
                cfg["plateau_threshold"])

    @staticmethod
    def _valid(points, labels, mask):
        S = points.shape[0]
        if mask is None:
            return [points[s] for s in range(S)], [labels[s] for s in range(S)]
        return ([points[s][mask[s]] for s in range(S)], [labels[s][mask[s]] for s in range(S)])

    def _written_mismatch(self, out, raw) -> int:
        """Entries of the last unit's files (poses, clusters, losses) that
        differ from its in-memory outputs."""
        bad = 0
        part = self.cfg.part_dir()
        names = sorted(os.listdir(part))
        M = out.matrices.cpu().numpy()
        P = out.local_points.cpu().numpy()
        L = out.labels.cpu().numpy()
        losses = out.losses.cpu().numpy()
        K = M.shape[2]
        for s, name in enumerate(names):
            d = os.path.join(part, name)
            for t in range(M.shape[1]):
                n_t = len(raw[0][0]) if t == 0 else len(raw[s][t])
                bad += int(np.sum(np.load(os.path.join(d, "matrix", f"{t:04}.npy")) != M[s, t]))
                with np.load(os.path.join(d, "cluster", f"{t:04}.npz")) as z:
                    for c in range(K):
                        want = P[s, t, :n_t][L[s, t, :n_t] == c]
                        got = z[str(c)]
                        bad += (int(np.sum(got != want)) if got.shape == want.shape
                                else max(len(got), len(want)))
            got = np.loadtxt(os.path.join(d, "loss.txt")).astype(np.float32).reshape(-1)
            bad += int(np.sum(got != losses[s]))
        return bad


def _loss_gaps(program: torch.Tensor, reference: np.ndarray) -> np.ndarray:
    """``|program - reference| / reference`` by entry; 0 where both are
    ``inf`` (a stopped sequence), ``inf`` where only one is."""
    p = program.float().cpu().numpy().astype(np.float64)
    r = reference.astype(np.float64)
    both = np.isinf(p) & np.isinf(r)
    with np.errstate(invalid="ignore"):
        gap = np.abs(p - r) / np.abs(r)
    return np.where(both, 0.0, np.nan_to_num(gap, nan=np.inf))


def _carry_mismatch(carry, st: dict) -> int:
    """Entries of the program's bookkeeping in ``carry`` (a ``TrainCarry``)
    that differ from the reference's replay ``st``."""
    pairs = [(carry.best_loss, "best_loss"), (carry.bad_count, "bad_count"),
             (carry.stopped, "stopped"), (carry.sched.best, "plateau_best"),
             (carry.sched.num_bad, "num_bad"), (carry.sched.lr, "lr"), (carry.opt.step, "step")]
    return sum(int(np.sum(t.cpu().numpy() != st[key])) for t, key in pairs)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest ``|a - b| / |b|``."""
    return float(((a - b).abs() / b.abs()).max())
