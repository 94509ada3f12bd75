"""The check fails the lower-precision control and each planted fault; the
reference's bookkeeping and leaf gaps equal hand counts; the reference
imports nothing of the port; no module of a run is JAX's or the JAX
package's; the work counts equal hand counts."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, run_tiny

from benchmark import control

FAULTS = ["lower_precision", "state_unchanged", "half_batch", "answer_altered"]


@pytest.mark.parametrize("cell", ["register.wx200_real"])
@pytest.mark.parametrize("kind", FAULTS)
def test_control_and_faults_are_not_correct(cell, kind):
    r = run_tiny(cell, seed=555, context=control.KINDS[kind]("cpu"))
    assert r["correct"] is False, r["checks"]


def _plateau_never_cuts(device):
    """A planted fault of the program's bookkeeping: the plateau schedule
    never lowers the learning rate."""
    from autourdf_tpu_torch.registration import optimizer

    update = optimizer.plateau_update

    def never(state, loss, factor=0.7, patience=5, threshold=1e-4):
        return update(state, loss, 1.0, patience, threshold)

    return control._patched([(optimizer, "plateau_update", never)])


def _optimizer_state_not_handed_on(device):
    """A planted fault of the epoch programs: each chunk hands the next a
    fresh optimizer state (Adam's moments and step) instead of its own."""
    from autourdf_tpu_torch.registration import optimizer

    epochs = optimizer.train_epochs

    def forgetful(model, carry, *a, **k):
        out, losses = epochs(model, carry, *a, **k)
        return out._replace(opt=optimizer.adam_init(out.theta)), losses

    return control._patched([(optimizer, "train_epochs", forgetful)])


@pytest.mark.parametrize("fault", [_plateau_never_cuts, _optimizer_state_not_handed_on])
def test_bookkeeping_faults_are_not_correct(fault):
    r = run_tiny("register.wx200_real", seed=556, context=fault("cpu"))
    assert r["readings"]["schedule_mismatch"] > 0
    assert r["correct"] is False, r["checks"]


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_a_run_imports_nothing_of_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness, control, counts, trace, plyio\n"
            "from benchmark.stages import register\n"
            "from benchmark.frames import real_scans\n"
            "import autourdf_tpu_torch.workflow, autourdf_tpu_torch.registration\n"
            "for name in __import__('os').listdir('benchmark/metrics'):\n"
            "    if name.endswith('.py'):\n"
            "        harness.load_metric('.', name[:-3])\n")
    top = {m.split(".")[0] for m in _modules_after(code)}
    assert not top & {"jax", "jaxlib", "flax", "autourdf_tpu"}
    assert "autourdf_tpu_torch" in top


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.registration\n")
    top = {m.split(".")[0] for m in _modules_after(code)}
    assert not top & {"jax", "jaxlib", "flax", "autourdf_tpu", "autourdf_tpu_torch"}


def test_nothing_reads_the_jax_package_benchmark():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath:
                text = open(os.path.join(dirpath, f)).read()
                for word in ("bench.py", "bench_reference_shape", "BENCH_r0"):
                    assert word not in text, (f, word)


@pytest.mark.parametrize("S,n,m", [(1, 20000, 20000), (5, 4988, 4418)])
def test_search_counts_match_hand_counts(S, n, m):
    from benchmark import counts

    pairs = S * n * m
    assert counts.search_ops(pairs) == 9 * pairs
    assert counts.search_bytes(S * (n + m)) == S * (n + m) * (12 + 4 + 8)
    t = counts.bound_seconds(counts.search_ops(pairs), counts.search_bytes(S * (n + m)))
    assert t == pytest.approx(max(9 * pairs / 67e12, S * (n + m) * 24 / 3.35e12))


@pytest.mark.parametrize("hidden,K,S", [(512, 20, 5), (64, 4, 2)])
def test_epoch_flops_match_hand_counts(hidden, K, S):
    from benchmark import counts

    layers = [(56, hidden), (hidden, hidden // 2), (hidden // 2, 3), (hidden, hidden),
              (hidden, 4)]
    fwd = K * sum(2 * i * o + o for i, o in layers)
    pairs, pts = 1000 * 900, 1000
    want = 9 * pairs + 3 * fwd * S + 3 * 18 * pts
    assert counts.epoch_flops(pairs, pts, S, K, "q", hidden) == want


def test_schedule_replay_matches_hand_counts():
    from benchmark.reference import registration as ref

    inf = np.float32(np.inf)
    # improves twice, then 7 epochs without: a cut after the 6th
    st, ran = ref.schedule(np.array([[5, 4] + [4] * 7], np.float32), 0.5, 200, 5, 0.5, 1e-4)
    assert ran.all() and st["step"].tolist() == [9] and not st["stopped"][0]
    assert st["best_loss"].tolist() == [4] and st["bad_count"].tolist() == [7]
    assert st["lr"].tolist() == [0.25] and st["num_bad"].tolist() == [1]
    # stops once 3 epochs pass without a new best; later epochs do not run
    st, ran = ref.schedule(np.array([[3, 3, 3, 3, inf, inf]], np.float32), 0.5, 2, 5, 0.5, 1e-4)
    assert ran[0].tolist() == [True] * 4 + [False] * 2
    assert st["step"].tolist() == [4] and st["stopped"][0] and st["bad_count"].tolist() == [3]
    assert st["lr"].tolist() == [0.5] and st["num_bad"].tolist() == [3]


def test_change_gaps_match_hand_counts():
    import torch

    from benchmark.reference import registration as ref

    hidden = 8
    P = ref.leaf_slices(hidden)[-1][1]
    start = torch.zeros(1, P, dtype=torch.float64)
    grad = torch.ones(1, P, dtype=torch.float64)
    ref_end = torch.full((1, P), 0.01, dtype=torch.float64)
    prog_end = ref_end.clone()
    a, b = ref.leaf_slices(hidden)[2]
    prog_end[0, a:b] *= 1.5                 # one leaf moved half again as far
    worst, median = ref.change_gaps(start, prog_end, ref_end, grad, hidden)
    assert worst == pytest.approx(0.5) and median == pytest.approx(0.0, abs=1e-12)
    grad[0, a:b] = 1e-6                     # its gradient is round-off: left out
    worst, _ = ref.change_gaps(start, prog_end, ref_end, grad, hidden)
    assert worst == pytest.approx(0.0, abs=1e-12)
