"""The port's registration slice against the JAX package, end to end on the
CPU: the same frame-0 segmentation and initial MLP parameters (the JAX
package's, converted) go through ``register_sequences_batched`` of both
packages on ragged, sentinel-padded frames.

Tolerances: per-pair best losses 1e-5 relative, poses 1e-5 absolute and
labels equal.  Each phase is 12 Adam epochs whose last-bit gradient
differences (sums in another order) compound over two frame pairs and two
phases per pair; measured on this input they stay below 6e-7 relative and
4e-7 absolute, and no point sits close enough to a cluster boundary for
the k-means resample to flip its label.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autourdf_tpu.models.regmlp import PoseRegressor as JPoseRegressor
from autourdf_tpu.models.regmlp import init_params as j_init_params
from autourdf_tpu.registration import RegistrationConfig as JConfig
from autourdf_tpu.registration import initial_segments as j_initial_segments
from autourdf_tpu.registration import register_sequences_batched as j_register
from autourdf_tpu_torch import resolve_device
from autourdf_tpu_torch.config import PipelineConfig
from autourdf_tpu_torch.io.artifacts import load_registration
from autourdf_tpu_torch.io.ply import write_ply
from autourdf_tpu_torch.models.regmlp import PoseRegressor, params_from_jax
from autourdf_tpu_torch.ops.chamfer import chamfer_distance
from autourdf_tpu_torch.ops.knn import PAD_COORD
from autourdf_tpu_torch.registration import (
    RegistrationConfig,
    SegmentInit,
    initial_segments,
    predicted_world_points,
    register_sequence,
    register_sequences_batched,
    transform_by_labels,
)

S, T, K, H = 2, 3, 4, 32


def hinge_frames(num_frames, angle_step, n_per_link=160, seed=0):
    """Synthetic 2-link robot: a base box and an arm box turning about z."""
    rng = np.random.default_rng(seed)
    base = rng.uniform([-0.6, -0.15, -0.1], [-0.1, 0.15, 0.1], size=(n_per_link, 3))
    arm0 = rng.uniform([0.1, -0.1, -0.08], [0.7, 0.1, 0.08], size=(n_per_link, 3))
    out = []
    for t in range(num_frames):
        a = t * angle_step
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        out.append(np.concatenate([base, arm0 @ rot.T]).astype(np.float32))
    return np.stack(out)


def ragged_batch():
    """(S, T, N, 3) sentinel-padded frames and (S, T, N) masks, about 300
    valid points per frame."""
    counts = [[300, 285, 310], [295, 320, 290]]
    n_max = max(max(c) for c in counts)
    rng = np.random.default_rng(1)
    frames = np.full((S, T, n_max, 3), PAD_COORD, np.float32)
    masks = np.zeros((S, T, n_max), bool)
    for s, step in enumerate((0.10, 0.16)):
        seq = hinge_frames(T, step)
        for t in range(T):
            sel = rng.choice(seq.shape[1], counts[s][t], replace=False)
            frames[s, t, :counts[s][t]] = seq[t][sel]
            masks[s, t, :counts[s][t]] = True
    return frames, masks


@pytest.fixture(scope="module")
def both_results():
    frames, masks = ragged_batch()
    init_j = j_initial_segments(jax.random.PRNGKey(0), jnp.asarray(frames[0, 0]), K,
                                mask=jnp.asarray(masks[0, 0]), kmeans_iters=8, n_init=2)
    keys = jax.random.split(jax.random.PRNGKey(1), 2 * S)
    mk = jax.vmap(lambda k: j_init_params(k, "q", K, H)[1])
    sp, ap = mk(keys[:S]), mk(keys[S:])
    cfg_j = JConfig(num_seg=K, hidden_dim=H, epochs=12, kmeans_iters=8, chamfer_backend="xla",
                    lr_step=1e-3, lr_anchor=5e-4)
    res_j = j_register(JPoseRegressor("q", H), cfg_j, sp, ap, init_j,
                       jnp.asarray(frames), jnp.asarray(masks))

    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    init_t = SegmentInit(*(torch.from_numpy(np.array(v)) for v in init_j[:3]),
                         torch.from_numpy(masks[0, 0]))
    cfg_t = RegistrationConfig(num_seg=K, hidden_dim=H, epochs=12, kmeans_iters=8,
                               lr_step=1e-3, lr_anchor=5e-4)
    model = PoseRegressor("q", H, num_seqs=S)
    res_t = register_sequences_batched(model, cfg_t, params_from_jax(to_np(sp), "q"),
                                       params_from_jax(to_np(ap), "q"), init_t,
                                       torch.from_numpy(frames), torch.from_numpy(masks))
    return frames, masks, res_j, res_t


def test_registration_slice_losses_and_poses_match_jax(both_results):
    frames, masks, res_j, res_t = both_results
    assert res_t.matrices.shape == (S, T, K, 4, 4)
    assert res_t.losses.shape == res_t.step_losses.shape == (S, T - 1)
    np.testing.assert_allclose(res_t.step_losses.numpy(), np.asarray(res_j.step_losses),
                               rtol=1e-5)
    np.testing.assert_allclose(res_t.losses.numpy(), np.asarray(res_j.losses), rtol=1e-5)
    np.testing.assert_allclose(res_t.matrices.numpy(), np.asarray(res_j.matrices), atol=1e-5)


def test_registration_slice_labels_and_points_match_jax(both_results):
    frames, masks, res_j, res_t = both_results
    lab_t, lab_j = res_t.labels.numpy(), np.asarray(res_j.labels)
    for s in range(S):
        for t in range(T):
            valid = masks[0, 0] if t == 0 else masks[s, t]
            np.testing.assert_array_equal(lab_t[s, t][valid], lab_j[s, t][valid])
    # registered world points reproduce each target frame (valid rows)
    for t in range(1, T):
        pred = predicted_world_points(res_t, t)
        np.testing.assert_allclose(pred.numpy()[masks[:, t]], frames[:, t][masks[:, t]],
                                   atol=1e-5)


def test_register_sequence_alias_equals_batched_row(both_results):
    frames, masks, res_j, res_t = both_results
    cfg = RegistrationConfig(num_seg=K, hidden_dim=H, epochs=12, kmeans_iters=8,
                             lr_step=1e-3, lr_anchor=5e-4)
    model = PoseRegressor("q", H, num_seqs=1, generator=torch.Generator().manual_seed(0))
    sp = {k: v.detach() for k, v in model.named_parameters()}
    frames_t, masks_t = torch.from_numpy(frames), torch.from_numpy(masks)
    init = initial_segments(torch.Generator().manual_seed(0), frames_t[0, 0], K,
                            mask=masks_t[0, 0], kmeans_iters=8, n_init=2)
    one = register_sequence(model, cfg, sp, sp, init, frames_t[1], masks_t[1])
    two = register_sequences_batched(model, cfg, sp, sp, init, frames_t[1:], masks_t[1:])
    assert one.matrices.shape == (T, K, 4, 4)
    np.testing.assert_array_equal(one.matrices.numpy(), two.matrices[0].numpy())
    # the MLP+ICP variant is ported: the step phase is the same, so its loss
    # is the batched run's step loss, and the ICP-refined poses are rigid
    icp = register_sequences_batched(model, cfg._replace(mlp_icp=True), sp, sp, init,
                                     frames_t[1:], masks_t[1:])
    np.testing.assert_array_equal(icp.losses[:, 0].numpy(), two.step_losses[:, 0].numpy())
    rot = icp.matrices[..., :3, :3]
    np.testing.assert_allclose((rot @ rot.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3, dtype=np.float32), rot.shape), atol=1e-5)


def test_run_registration_on_cpu_writes_artifacts(tmp_path):
    """workflow.run_registration end to end on the CPU: ragged frames in
    the real-scan layout, artifacts with only the valid rows."""
    from autourdf_tpu_torch import workflow

    frames = hinge_frames(3, 0.15)
    counts = [[300, 280, 310], [320, 290, 300]]
    rng = np.random.default_rng(2)
    root = tmp_path / "data"
    for s in range(2):
        for t in range(3):
            sel = rng.choice(frames.shape[1], counts[s][t], replace=False)
            write_ply(str(root / "raw" / "wx200_real_5" / f"V{s:04}" / f"{t:04}" / "robot.ply"),
                      frames[t][sel])
    cfg = PipelineConfig(robot="wx200_real_5", data_root=str(root), num_videos=2, num_seg=K,
                         epochs=8)
    stats = workflow.run_registration(cfg, verbose=False, device="cpu")
    assert np.isfinite(stats["mean_loss"]) and stats["device"] == "cpu"
    res = stats["result"]
    for s, name in enumerate(stats["names"]):
        art = load_registration(os.path.join(cfg.part_dir(), name))
        assert art.matrices.shape == (3, K, 4, 4)
        assert len(art.cluster_points[0]) == counts[0][0]      # the shared init
        assert [len(p) for p in art.cluster_points[1:]] == counts[s][1:]
        world = transform_by_labels(torch.from_numpy(art.matrices[2]).float(),
                                    torch.from_numpy(art.cluster_points[2]),
                                    torch.from_numpy(art.cluster_labels[2]).long())
        with torch.no_grad():
            assert float(chamfer_distance(world, res.local_points.new_tensor(
                frames[2]))) < 0.05
    with pytest.raises(ValueError):
        workflow.run_registration(cfg.replace(epochs=9), corr_every=2, verbose=False,
                                  device="cpu")


def test_cli_register_and_unported_options(tmp_path, capsys):
    from autourdf_tpu_torch import cli

    # every register option is ported: with no data the stage fails on the
    # missing input, not on the option
    with pytest.raises(FileNotFoundError):
        cli.main(["register", "--mlp_icp", "--normal", "--seed-mode", "fps", "--device", "cpu",
                  "--data-root", str(tmp_path / "none")])
    # what the urdf stage does not carry yet names its ROADMAP item
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        cli.main(["urdf", "--device", "cpu"])                      # default --refine chain
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        cli.main(["urdf", "--refine", "none", "--unknown-dof", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_segments_local_points_and_world_points_parity(both_results):
    from autourdf_tpu.registration.segments import local_points_from_labels as j_local
    from autourdf_tpu.registration.segments import world_points as j_world
    from autourdf_tpu_torch.registration.segments import local_points_from_labels, world_points

    frames, masks, res_j, res_t = both_results
    m = np.array(res_j.matrices[0, 1])
    lab = np.array(res_j.labels[0, 1])
    pts = frames[0, 1][masks[0, 1]]
    lab = lab[masks[0, 1]]
    loc_j = np.asarray(j_local(jnp.asarray(m), jnp.asarray(pts), jnp.asarray(lab)))
    loc_t = local_points_from_labels(torch.from_numpy(m), torch.from_numpy(pts),
                                     torch.from_numpy(lab).long())
    np.testing.assert_allclose(loc_t.numpy(), loc_j, atol=1e-6)
    np.testing.assert_allclose(
        world_points(torch.from_numpy(m), loc_t, torch.from_numpy(lab).long()).numpy(),
        np.asarray(j_world(jnp.asarray(m), jnp.asarray(loc_j), jnp.asarray(lab))), atol=1e-6)


def test_load_raw_sequences_uniform_and_ragged(tmp_path):
    from autourdf_tpu.workflow import load_raw_sequences_padded as j_load_padded
    from autourdf_tpu_torch.workflow import load_raw_sequences, load_raw_sequences_padded

    frames = hinge_frames(2, 0.1)
    raw = tmp_path / "raw" / "toy" / "4_deg_20_cams"
    for s in range(2):
        for t in range(2):
            write_ply(str(raw / f"V{s:04}" / f"{t:04}" / "robot.ply"), frames[t])
    names, fr = load_raw_sequences(str(raw), 5)
    assert names == ["V0000", "V0001"] and fr.shape == (2, 2, frames.shape[1], 3)
    assert load_raw_sequences_padded(str(raw), 5)[2] is None
    write_ply(str(raw / "V0001" / "0001" / "robot.ply"), frames[1][:250])
    got, ref = load_raw_sequences_padded(str(raw), 5), j_load_padded(str(raw), 5)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
