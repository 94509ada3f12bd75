"""The port's evaluation stage and CLI against the JAX package on the CPU,
and the port's closed loop: dataset -> register -> urdf -> evaluate on the
toy hinge of tests/test_end_to_end.py, at its sizes and thresholds.

Evaluation stage: ``run_evaluation`` of both packages scores one predicted
URDF against one ground truth over one raw directory.  The joint errors are
float64 numpy in both packages (1e-9); the re-simulation captures agree
point for point where the visibility masks and the farthest-point picks
agree (tests/test_torch_sim.py), and ICP and Chamfer run in float32 on each
side, so the resim values agree to 1e-4 and the floor (identical clouds) to
1e-5.  In the fast tier the captures are cut from 10,000 to 2,000 points in
both packages (the evaluation's ICP on 10,000 points takes minutes on the
CPU); the loop's own evaluation runs at 10,000.

The whole loop takes several minutes on the CPU (minutes more when other
test processes share the cores), so its tests are marked slow, as
tests/test_end_to_end.py is.
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch
from test_end_to_end import TWO_LINK_URDF

from autourdf_tpu import config as jconfig
from autourdf_tpu import eval as j_eval
from autourdf_tpu import workflow as jworkflow
from autourdf_tpu_torch import cli
from autourdf_tpu_torch import config as tconfig
from autourdf_tpu_torch import eval as t_eval
from autourdf_tpu_torch import workflow as tworkflow
from autourdf_tpu_torch.io import read_ply
from autourdf_tpu_torch.io.artifacts import list_sequence_dirs, load_registration
from autourdf_tpu_torch.ops.chamfer import chamfer_distance
from autourdf_tpu_torch.urdf import link_points_world, load_urdf, sample_link_surfaces

SIZES = dict(robot="toy_hinge", num_step=5, num_videos=2, num_points=1200, pix=240, epochs=60,
             end_steps=5, step_size_deg=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor operations, and
    under pytest-xdist every worker's full thread pool contends for the same
    cores (the loop fixture ran eleven times slower in a parallel run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _register_toy(root, *packages):
    urdf = os.path.join(root, "toy.urdf")
    with open(urdf, "w") as f:
        f.write(TWO_LINK_URDF)
    for c in packages:
        c.ROBOTS["toy_hinge"] = c.RobotConfig(name="toy_hinge", num_seg=6, dof=1, gt_urdf=urdf,
                                              voxel_size=0.02, cam_dist=2.0)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("closed_loop"))
    _register_toy(root, tconfig, jconfig)
    cfg = tconfig.PipelineConfig(data_root=os.path.join(root, "data"), **SIZES)
    seq_dirs = tworkflow.run_dataset(cfg, epochs=2, device="cpu")
    reg = tworkflow.run_registration(cfg, verbose=False, device="cpu")
    reg.pop("result")
    urdf = tworkflow.run_build_urdf(cfg, unknown_dof=True, end_video=2, dof_probe_steps=20,
                                    dof_probe_points=128, refine_steps=300, verbose=False,
                                    device="cpu")
    ev = tworkflow.run_evaluation(cfg, verbose=False, num_configs=1, device="cpu")
    return dict(root=root, cfg=cfg, seq_dirs=seq_dirs, reg=reg, urdf=urdf, ev=ev)


@pytest.mark.slow
def test_dataset_artifacts(loop):
    assert len(loop["seq_dirs"]) == 2
    for d in loop["seq_dirs"]:
        for t in range(SIZES["num_step"]):
            assert read_ply(os.path.join(d, f"{t:04}", "robot.ply")).shape == (1200, 3)
            assert os.path.exists(os.path.join(d, f"{t:04}", "joint_cfg.txt"))


@pytest.mark.slow
def test_registration_quality(loop):
    # chamfer-L1 on a ~1m robot should register to a few mm
    assert loop["reg"]["mean_loss"] < 0.05


@pytest.mark.slow
def test_urdf_structure(loop):
    out = loop["urdf"]
    assert out["num_links"] >= 2
    assert os.path.exists(out["urdf_path"])
    for m in out["mesh_paths"]:
        assert os.path.exists(m)


@pytest.mark.slow
def test_joint_recovery(loop):
    # axis within 15 degrees and origin within 10 cm on the toy
    assert loop["ev"]["dir_mean"] < 15.0, loop["ev"]
    assert loop["ev"]["pos_mean"] < 0.10, loop["ev"]


@pytest.mark.slow
def test_resim_chamfer(loop):
    ev = loop["ev"]
    assert ev["chamfer_mean"] < 0.25, ev
    assert np.isfinite(ev["chamfer_floor"]) and 0 <= ev["chamfer_floor"] < ev["chamfer_mean"]


@pytest.mark.slow
def test_urdf_assembles_at_zero_config(loop):
    # the recovered URDF posed at q=0 must reproduce frame 0's geometry
    model = load_urdf(loop["urdf"]["urdf_path"])
    samples = sample_link_surfaces(model, total_points=4000)
    pts = link_points_world(model, samples, {})
    raw0 = read_ply(os.path.join(loop["seq_dirs"][0], "0000", "robot.ply"))
    d = float(chamfer_distance(torch.from_numpy(pts.astype(np.float32)), torch.from_numpy(raw0)))
    assert d < 0.15, f"assembled chamfer {d}"


@pytest.mark.slow
def test_artifacts_roundtrip(loop):
    cfg = loop["cfg"]
    art = load_registration(list_sequence_dirs(cfg.part_dir())[0])
    assert art.matrices.shape[0] == cfg.num_step
    assert art.num_clusters == 6
    rots = art.matrices[..., :3, :3]
    rtr = np.einsum("tkij,tkil->tkjl", rots, rots)
    np.testing.assert_allclose(rtr, np.broadcast_to(np.eye(3), rtr.shape), atol=1e-4)


@pytest.mark.slow
def test_eval_artifacts_and_telemetry(loop):
    eval_dir = loop["cfg"].eval_dir()
    for name in ("pos_mean_std.txt", "dir_mean_std.txt", "coverage.txt", "per_joint.txt",
                 "floor.txt", "loss.txt", "loss_mean_std.txt", "command_rad.txt",
                 "command_deg.txt", os.path.join("pred", "0000", "robot.ply"),
                 os.path.join("gt", "0000", "robot.ply")):
        assert os.path.exists(os.path.join(eval_dir, name)), name
    with open(os.path.join(eval_dir, "coverage.txt")) as f:
        assert f.readline().strip() == "matched 1 / 1"
    np.testing.assert_allclose(np.loadtxt(os.path.join(eval_dir, "floor.txt")),
                               loop["ev"]["chamfer_floor"])
    with open(os.path.join(loop["cfg"].data_root, "telemetry.json")) as f:
        records = json.load(f)
    assert [r["stage"] for r in records] == ["dataset", "register", "build_urdf", "evaluate"]
    reg, build, ev = records[1], records[2], records[3]
    assert reg["frames"] == 2 * 4 and reg["seconds_compute"] > 0
    assert build["links"] == loop["urdf"]["num_links"] and build["seconds_total"] > 0
    assert ev["chamfer_mean"] == round(loop["ev"]["chamfer_mean"], 4)


@pytest.mark.slow
def test_loop_evaluation_matches_jax(loop, tmp_path):
    """The JAX package's run_evaluation on a copy of the loop's data root."""
    root = str(tmp_path / "data")
    shutil.copytree(loop["cfg"].data_root, root)
    cfg = jconfig.PipelineConfig(data_root=root, **SIZES)
    ej = jworkflow.run_evaluation(cfg, verbose=False, num_configs=1)
    et = loop["ev"]
    for k in ("pos_errors", "dir_errors"):
        np.testing.assert_allclose(et[k], ej[k], atol=1e-9, rtol=0, err_msg=k)
    for k in ("matched", "total"):
        assert et[k] == ej[k]
    for k in ("dir_mean_complete", "pos_mean_complete"):
        np.testing.assert_allclose(et[k], ej[k], atol=1e-9, rtol=0, err_msg=k)
    np.testing.assert_allclose(et["chamfer_losses"], ej["chamfer_losses"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(et["chamfer_floor"], ej["chamfer_floor"], atol=1e-5, rtol=0)
    for name in ("per_joint.txt", "coverage.txt"):
        with open(os.path.join(loop["cfg"].eval_dir(), name)) as a, \
                open(os.path.join(cfg.eval_dir(), name)) as b:
            assert a.read() == b.read()


@pytest.mark.slow
def test_loop_build_matches_jax(loop, tmp_path):
    """The JAX package's unknown-DoF build on a copy of the loop's data root
    (the port's own registration): the same links and dof."""
    root = str(tmp_path / "data")
    shutil.copytree(loop["cfg"].data_root, root)
    cfg = jconfig.PipelineConfig(data_root=root, **SIZES)
    uj = jworkflow.run_build_urdf(cfg, unknown_dof=True, end_video=2, dof_probe_steps=20,
                                  dof_probe_points=128, refine_steps=300, verbose=False)
    ut = loop["urdf"]
    print(f"toy hinge loop: JAX {uj['num_links']} links, port {ut['num_links']} links")
    assert (ut["num_links"], ut["dof"]) == (uj["num_links"], uj["dof"])


# ---------------------------------------------------------------------------
# the evaluation stage against the JAX package (fast tier)
# ---------------------------------------------------------------------------

def _eval_setup(root):
    """A raw directory with one sequence's start angles, the toy hinge as the
    ground truth and, as the prediction, the toy hinge with a tilted axis
    and a moved joint origin."""
    _register_toy(root, tconfig, jconfig)
    cfg = tconfig.PipelineConfig(data_root=os.path.join(root, "data"), **SIZES)
    seq = os.path.join(cfg.raw_dir(), "V0000", "0000")
    os.makedirs(seq)
    with open(os.path.join(seq, "joint_cfg.txt"), "w") as f:
        f.write("hinge:0.150000\n")
    os.makedirs(os.path.dirname(cfg.urdf_path()))
    with open(cfg.urdf_path(), "w") as f:
        f.write(TWO_LINK_URDF.replace('<axis xyz="0 0 1"/>', '<axis xyz="0.08 0 0.997"/>')
                .replace('<origin xyz="0.05 0 0.1" rpy="0 0 0"/>',
                         '<origin xyz="0.06 0.01 0.1" rpy="0 0 0"/>'))
    return cfg


def test_evaluation_stage_matches_jax(tmp_path, monkeypatch):
    cfg = _eval_setup(str(tmp_path))
    for mod in (t_eval, j_eval):
        monkeypatch.setattr(mod, "resim_chamfer",
                            functools.partial(mod.resim_chamfer, num_points=2000))
    et = tworkflow.run_evaluation(cfg, verbose=False, num_configs=2, device="cpu")
    jdir = str(tmp_path / "j")
    shutil.copytree(cfg.data_root, jdir, ignore=shutil.ignore_patterns("evaluation"))
    jcfg = jconfig.PipelineConfig(data_root=jdir, **SIZES)
    ej = jworkflow.run_evaluation(jcfg, verbose=False, num_configs=2)
    for k in ("pos_errors", "dir_errors"):
        np.testing.assert_allclose(et[k], ej[k], atol=1e-9, rtol=0, err_msg=k)
    assert et["dir_errors"][0] > 1.0 and et["pos_errors"][0] > 1e-3   # a real error
    for k in ("matched", "total"):
        assert et[k] == ej[k]
    for k in ("dir_mean_complete", "pos_mean_complete"):
        np.testing.assert_allclose(et[k], ej[k], atol=1e-9, rtol=0, err_msg=k)
    np.testing.assert_allclose(et["chamfer_losses"], ej["chamfer_losses"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(et["chamfer_floor"], ej["chamfer_floor"], atol=1e-5, rtol=0)
    eval_t, eval_j = cfg.eval_dir(), jcfg.eval_dir()
    for name in ("per_joint.txt", "coverage.txt"):
        with open(os.path.join(eval_t, name)) as a, open(os.path.join(eval_j, name)) as b:
            assert a.read() == b.read()
    for name in ("pos_mean_std.txt", "dir_mean_std.txt", "command_rad.txt"):
        np.testing.assert_allclose(np.loadtxt(os.path.join(eval_t, name)),
                                   np.loadtxt(os.path.join(eval_j, name)), atol=1e-9, rtol=0)
    for name in ("floor.txt", "loss.txt", "loss_mean_std.txt"):
        np.testing.assert_allclose(np.loadtxt(os.path.join(eval_t, name)),
                                   np.loadtxt(os.path.join(eval_j, name)), atol=1e-4, rtol=0)
    for tag in ("pred", "gt"):
        for c in ("0000", "0001"):
            assert read_ply(os.path.join(eval_t, tag, c, "robot.ply")).shape == (2000, 3)
    with open(os.path.join(cfg.data_root, "telemetry.json")) as f:
        records = json.load(f)
    assert [r["stage"] for r in records] == ["evaluate"]
    assert records[0]["chamfer_mean"] == round(et["chamfer_mean"], 4)


# ---------------------------------------------------------------------------
# the CLI: every subcommand's flags reach the stages, with the JAX CLI's seeds
# ---------------------------------------------------------------------------

def _record_stages(monkeypatch):
    calls = []

    def stage(name, ret):
        def fn(cfg, **kw):
            calls.append((name, cfg, kw))
            return ret
        monkeypatch.setattr(tworkflow, name, fn)

    stage("run_dataset", ["V0000"])
    stage("run_registration", {"result": None})
    stage("run_build_urdf", {"urdf_path": "u", "num_links": 2, "dof": 1})
    stage("run_evaluation", {"dir_mean": 1.0, "pos_mean": 0.1, "matched": 1, "total": 1,
                             "dir_mean_complete": 1.0, "chamfer_mean": 0.1,
                             "chamfer_floor": 0.01})
    return calls


def test_cli_all_seeds_and_stage_arguments(monkeypatch, capsys):
    calls = _record_stages(monkeypatch)
    assert cli.main(["all", "--robot", "toy", "--data-root", "d", "--epoch", "3", "--pix", "320",
                     "--no_noise", "--refine-steps", "50", "--device", "cpu"]) == 0
    assert [c[0] for c in calls] == ["run_dataset", "run_registration", "run_build_urdf",
                                     "run_evaluation"]
    (_, ds_cfg, ds_kw), (_, reg_cfg, reg_kw), (_, _, urdf_kw), (_, ev_cfg, ev_kw) = calls
    assert ds_cfg.seed == ev_cfg.seed == 2024          # the dataset and the evaluation
    assert reg_kw["seed"] == 0                          # registration at its own default
    assert urdf_kw["unknown_dof"] is True and urdf_kw["refine_steps"] == 50
    assert urdf_kw["end_video"] == 5
    assert ds_kw["epochs"] == 3 and ds_cfg.pix == 320 and ds_cfg.noise is False
    assert all(c[2]["device"] == "cpu" for c in calls)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["chamfer_floor"] == 0.01 and out["links"] == 2


def test_cli_dataset_and_evaluate_arguments(monkeypatch, tmp_path):
    calls = _record_stages(monkeypatch)
    cli.main(["dataset", "--robot", "toy", "--seed", "2025", "--ground", "--epoch", "4"])
    jm = tmp_path / "map.txt"
    np.savetxt(jm, [1, 0], fmt="%d")
    cli.main(["evaluate", "--robot", "toy", "--joint-map", str(jm), "--num-configs", "2",
              "--pred-ori", "0,0,1.5", "--device", "cpu"])
    (_, ds_cfg, ds_kw), (_, ev_cfg, ev_kw) = calls
    assert ds_cfg.seed == 2025 and ds_kw["ground"] and ds_kw["epochs"] == 4
    assert ds_cfg.noise is True and ds_kw["device"] == "cuda"     # the default device
    assert ev_cfg.seed == 2024 and ev_kw["num_configs"] == 2
    assert ev_kw["pred_ori"] == (0.0, 0.0, 1.5) and list(ev_kw["joint_map"]) == [1, 0]


# ---------------------------------------------------------------------------
# the structure a card registration's artifacts give in both packages
# ---------------------------------------------------------------------------

CARD_ARTIFACTS = os.environ.get("AUTOURDF_CARD_ARTIFACTS", "")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _structure_counts(workflow, structure, cfg, end_video=None, probe=False, **device):
    """The unknown-DoF build's link partition before its chain fits: the
    DoF search, the carry-test reassignment and the rigidity guard on the
    ``pose`` map, and with ``probe`` the probe ladder (60-step fits at 256
    points a link).  Returns the link count after each, the partition and
    the ladder's probed losses."""
    cms, _ = workflow.build_coord_maps(cfg, end_video, cfg.start_steps, cfg.end_steps)
    sum_map = structure.combined_sum_map(cms, "pose", **device)
    groups, _, _, _ = structure.auto_dof_search(sum_map)
    counts = [len(groups)]
    stack = structure.swap_consistency_stack(cms, **device)
    groups = structure.refine_groups_by_carry(cms, groups, verbose=False, stack=stack)
    counts.append(len(groups))
    groups, _ = structure.rigidity_guarded_groups(sum_map, stack, groups, verbose=False)
    counts.append(len(groups))
    losses = {}
    if probe:
        frames, masks = workflow._load_refine_frames(cfg, end_video)
        groups, losses = structure.probe_k_selection(
            sum_map, cms, frames, k0=len(groups), frame_masks=masks, carry_stack=stack,
            share_normalize=True, **device)
        counts.append(len(groups))
    return counts, sorted(sorted(int(c) for c in g) for g in groups), losses


@pytest.mark.parametrize("which,end_video,probe", [("real", None, False), ("loop", None, False),
                                                   ("real", 1, True)])
def test_card_artifacts_structure_matches_jax(which, end_video, probe, tmp_path, monkeypatch):
    """Both packages' unknown-DoF structure (DoF search, carry reassignment,
    rigidity guard) on the artifacts of one registration on the card, at
    full size: the same link counts and the same partition.  With the probe
    ladder, on the real scans' first sequence only (ten frames of 5,000
    points; the ladder over five sequences, or over the 16 links the guard
    leaves in [11], takes tens of minutes on the CPU): the same pick and
    partition, and probed losses to 1e-3 relative (float32 fits of 60 Adam
    steps in each package part at that level: ROADMAP Queue 3, entry 2).  Set
    ``AUTOURDF_CARD_ARTIFACTS`` to a directory holding ``real/part`` (the
    registration of data_real/raw/wx200_real_5) and ``loop/{raw,part,
    parameters.json}`` (the data root of ``cli all`` on the tracked wx200
    estimate): copies of the data roots of chip_smoke.py's phases [4] and
    [11].  The build's chain fit is not run."""
    from autourdf_tpu import structure as j_structure
    from autourdf_tpu_torch import structure as t_structure

    src = os.path.abspath(os.path.join(CARD_ARTIFACTS, which))
    if not (CARD_ARTIFACTS and os.path.isdir(os.path.join(src, "part"))):
        pytest.skip("needs a card registration's artifacts (AUTOURDF_CARD_ARTIFACTS)")
    if which == "real":
        robot, root = "wx200_real_5", str(tmp_path)
        os.symlink(os.path.join(REPO, "data_real", "raw"), os.path.join(root, "raw"))
        os.symlink(os.path.join(src, "part"), os.path.join(root, "part"))
    else:
        with open(os.path.join(src, "parameters.json")) as f:
            (robot, p), = json.load(f).items()
        for c in (jconfig, tconfig):
            monkeypatch.setitem(c.ROBOTS, robot, c.RobotConfig(
                name=robot, num_seg=p["num_seg"], dof=p["dof"], gt_urdf=p["gt"]))
        root = src
    cj = jconfig.PipelineConfig(robot=robot, data_root=root)
    ct = tconfig.PipelineConfig(robot=robot, data_root=root)
    counts_j, groups_j, losses_j = _structure_counts(jworkflow, j_structure, cj, end_video, probe)
    counts_t, groups_t, losses_t = _structure_counts(tworkflow, t_structure, ct, end_video, probe,
                                                     device="cpu")
    print(f"{which}, {end_video or 'all'} sequences: links after the DoF search, the carry "
          f"reassignment, the guard{' and the ladder' if probe else ''}: JAX {counts_j}, port "
          f"{counts_t}; partition {groups_t}; probed losses JAX {losses_j}, port {losses_t}")
    assert counts_t == counts_j and groups_t == groups_j
    assert losses_t.keys() == losses_j.keys()
    for k in losses_j:
        np.testing.assert_allclose(losses_t[k], losses_j[k], rtol=1e-3, err_msg=str(k))
