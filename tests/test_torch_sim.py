"""The simulator of the port (trajectories, collision, capture, the
kinematic env, the dataset stage) and the re-simulation Chamfer, against the
JAX package on the CPU.

Trajectories, collision checks and the env's posed surfaces are numpy on
the same seeds in both packages: equal (collision distances to 1e-6).  The
capture is float32 on both sides.  Its one intended numeric difference is
the focal length: the port rounds 1 / tan(fov / 2) once to float32 on the
host, while XLA's float32 tangent makes the JAX module's one ulp smaller at
60 degrees.  A point whose projection or depth test sits within such an ulp
of an edge can therefore flip between visible and hidden.  The tests allow
flips in at most 0.1% of the points, and each flip must be explained: the
port's own visibility of that point changes when the focal length moves by
one or two ulps.  Where the masks agree, the farthest-point picks and the
clouds must be equal (1e-6), or the farthest-point picks part on a near
tie: XLA on the CPU contracts the squared distance into fused multiply-adds
while the port (on the CPU and on the card) rounds each product, so two
candidates within two ulps can swap, and every later pick follows.  With the
noise on, the two packages draw from different generators; the tests check
the noise's presence and scale.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_end_to_end import TWO_LINK_URDF
from test_sim_io_urdf import TEST_URDF

from autourdf_tpu import config as jconfig
from autourdf_tpu import workflow as jworkflow
from autourdf_tpu.eval import resim as j_resim
from autourdf_tpu.ops import fps as j_fps
from autourdf_tpu.sim import capture as j_capture
from autourdf_tpu.sim import collision as j_collision
from autourdf_tpu.sim import env as j_env
from autourdf_tpu.sim import trajectory as j_traj
from autourdf_tpu.urdf import fk as j_fk
from autourdf_tpu.urdf import parser as j_parser
from autourdf_tpu_torch import config as tconfig
from autourdf_tpu_torch import workflow as tworkflow
from autourdf_tpu_torch.eval import resim_chamfer
from autourdf_tpu_torch.io.ply import read_ply
from autourdf_tpu_torch.ops.fps import farthest_point_sample
from autourdf_tpu_torch.sim import (
    CollisionChecker,
    KinematicEnv,
    angle_trajectory,
    capture_cloud,
    sphere_camera_rig,
)
from autourdf_tpu_torch.sim import capture as t_capture
from autourdf_tpu_torch.sim.capture import focal_length, visible_mask
from autourdf_tpu_torch.urdf import forward_kinematics, load_urdf, sample_link_surfaces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WX200 = os.path.join(REPO, "data_ab5", "urdf", "wx200_5_20_seg", "4_deg_20_cams.urdf")
MAX_FLIP_SHARE = 1e-3
CLOUD_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor operations, and
    under pytest-xdist every worker's full thread pool contends for the same
    cores (the loop fixture ran eleven times slower in a parallel run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def two_link(tmp_path):
    p = tmp_path / "two_link.urdf"
    p.write_text(TEST_URDF)
    return str(p)


# ---------------------------------------------------------------------------
# trajectories and collision (numpy in both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 1000, 2024])
@pytest.mark.parametrize("limits,scale", [([[-1.0, 1.0], [-0.5, 2.0]], 0.9),
                                          ([[1.2, -1.2], [-3.14159, 3.14159]], [0.9, 0.5])])
def test_angle_trajectory_matches_jax(seed, limits, scale):
    a = angle_trajectory(10, 4.0, 2, np.asarray(limits), scale=scale, seed=seed)
    b = j_traj.angle_trajectory(10, 4.0, 2, np.asarray(limits), scale=scale, seed=seed)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("urdf", ["two_link", "wx200"])
def test_collision_checker_matches_jax(urdf, two_link):
    path = two_link if urdf == "two_link" else WX200
    ma, mb = load_urdf(path), j_parser.load_urdf(path)
    sa = sample_link_surfaces(ma, total_points=20000)
    sb = j_fk.sample_link_surfaces(mb, total_points=20000)
    ca = CollisionChecker(ma, sa)
    cb = j_collision.CollisionChecker(mb, sb)
    assert ca.pairs == cb.pairs
    rng = np.random.default_rng(0)
    n = len(ma.movable_joints)
    home = forward_kinematics(ma, np.zeros(n))
    ca.calibrate(home)
    cb.calibrate(j_fk.forward_kinematics(mb, np.zeros(n)))
    assert ca.baseline.keys() == cb.baseline.keys()
    for k in ca.baseline:
        np.testing.assert_allclose(ca.baseline[k], cb.baseline[k], atol=1e-6, rtol=0)
    outcomes = []
    for _ in range(12):
        q = rng.uniform(-2.5, 2.5, n)
        wa, wb = forward_kinematics(ma, q), j_fk.forward_kinematics(mb, q)
        da, db = ca._pair_distances(wa, 0.05), cb._pair_distances(wb, 0.05)
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_allclose(da[k], db[k], atol=1e-6, rtol=0)
        for thr in (0.0015, 0.02):
            hit = ca.self_collision(wa, thr)
            assert hit == cb.self_collision(wb, thr)
            outcomes.append(hit)
    if urdf == "wx200":
        assert any(outcomes) and not all(outcomes)   # both outcomes exercised


# ---------------------------------------------------------------------------
# the capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cams", [4, 8, 20, 25])
def test_sphere_camera_rig_matches_jax(cams):
    a = sphere_camera_rig(1.5, cams, np.random.default_rng(5), device="cpu")
    b = j_capture.sphere_camera_rig(1.5, cams, np.random.default_rng(5))
    for f in ("eyes", "targets", "ups"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
    assert (a.fov_deg, a.near, a.far) == (b.fov_deg, b.near, b.far)


def _flips_explained(points, rig, pix, visible_port, visible_jax):
    """The flipped points, and whether each is one whose port visibility
    changes when the focal length moves by one or two float32 ulps."""
    flips = visible_port != visible_jax
    if not flips.any():
        return flips, True
    f0 = np.float32(focal_length(rig.fov_deg))
    sensitive = np.zeros_like(visible_port)
    for k in (-2, -1, 1, 2):
        fk = f0
        for _ in range(abs(k)):
            fk = np.nextafter(fk, np.float32(np.inf if k > 0 else -np.inf))
        with pytest.MonkeyPatch.context() as m:
            m.setattr(t_capture, "focal_length", lambda fov, fk=fk: float(fk))
            moved = visible_mask(points, rig, pix, pix).any(0).numpy()
        sensitive |= moved != visible_port
    return flips, bool((flips <= sensitive).all())


def _plain_fps_scores(points: np.ndarray, picks: np.ndarray) -> np.ndarray:
    """The farthest-point scores after ``picks``, every product and sum
    rounded to float32 on its own (the port's arithmetic)."""
    def dist(c):
        d = points - c
        return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]

    mind = dist(points[picks[0]])
    for j in picks[1:]:
        mind = np.minimum(mind, dist(points[j]))
    return mind


def _fps_agrees_or_parts_on_a_tie(points: np.ndarray, k: int) -> bool:
    """The port's and the JAX farthest-point picks on the same points are
    equal, or equal up to a step where the two candidates' scores are within
    two float32 ulps: XLA on the CPU contracts the squared distance into
    fused multiply-adds, the port rounds each product, so a near tie can go
    either way (and every later pick follows it)."""
    a = farthest_point_sample(torch.from_numpy(points), k).numpy()
    b = np.asarray(j_fps.farthest_point_sample(jnp.asarray(points), k))
    if np.array_equal(a, b):
        return True
    i = int(np.argmax(a != b))
    mind = _plain_fps_scores(points, a[:i])
    return abs(float(mind[a[i]]) - float(mind[b[i]])) <= 2 * float(np.spacing(mind[a[i]]))


def _hold_capture(points_np, rig_t, pix, num_points, vis_t, cloud_t, vis_j, cloud_j):
    """Noise-off captures of both packages on the same points: the masks
    agree up to explained flips; where they agree, the clouds are equal or
    the farthest-point picks part on a near tie."""
    flips, explained = _flips_explained(torch.from_numpy(points_np), rig_t, pix, vis_t, vis_j)
    assert flips.mean() <= MAX_FLIP_SHARE, f"{flips.sum()} of {len(flips)} points flipped"
    assert explained, "a flipped point is not on a one-ulp pixel or depth edge"
    if not flips.any() and np.abs(cloud_t - cloud_j).max() > CLOUD_ATOL:
        assert _fps_agrees_or_parts_on_a_tie(points_np[vis_t], num_points)
    return int(flips.sum())


def _check_capture(points_np, rig_t, rig_j, pix, num_points):
    """Noise-off capture of both packages on the same points and rig."""
    cloud_t, vis_t = capture_cloud(torch.from_numpy(points_np), rig_t, None, width=pix,
                                   height=pix, num_points=num_points)
    cloud_j, vis_j = j_capture.capture_cloud(jnp.asarray(points_np), rig_j,
                                             jax.random.PRNGKey(0), width=pix, height=pix,
                                             num_points=num_points)
    vis_t, cloud_t = vis_t.numpy(), cloud_t.numpy()
    flips = _hold_capture(points_np, rig_t, pix, num_points, vis_t, cloud_t,
                          np.asarray(vis_j), np.asarray(cloud_j))
    return vis_t, cloud_t, flips


def _cube_with_interior():
    """TestCapture's solid cube surface plus an interior point grid."""
    rng = np.random.default_rng(0)
    n = 4000
    face = rng.random((n, 2)) - 0.5
    cube = []
    for axis in range(3):
        for s in (-0.5, 0.5):
            pts = np.zeros((n, 3))
            other = [a for a in range(3) if a != axis]
            pts[:, other[0]] = face[:, 0]
            pts[:, other[1]] = face[:, 1]
            pts[:, axis] = s
            cube.append(pts)
    surface = np.concatenate(cube).astype(np.float32) * 0.4
    interior = (rng.random((2000, 3)) - 0.5).astype(np.float32) * 0.2
    return np.concatenate([surface, interior]), len(surface)


def test_capture_cube_occlusion_matches_jax():
    pts, n_surface = _cube_with_interior()
    rig_t = sphere_camera_rig(1.5, 8, np.random.default_rng(1), device="cpu")
    rig_j = j_capture.sphere_camera_rig(1.5, 8, np.random.default_rng(1))
    vis, cloud, _ = _check_capture(pts, rig_t, rig_j, 200, 500)
    assert vis[n_surface:].sum() == 0                 # the interior stays hidden
    assert vis[:n_surface].mean() > 0.3
    assert cloud.shape == (500, 3)


@pytest.mark.parametrize("pix,cams", [(240, 20), (240, 8), (400, 25)])
@pytest.mark.parametrize("q", [0.0, 0.7, -1.1, 0.3])
def test_capture_two_link_matches_jax(two_link, pix, cams, q):
    env_t = KinematicEnv.create(two_link, dof=1, num_cameras=cams,
                                camera_rng=np.random.default_rng(3), device="cpu")
    env_j = j_env.KinematicEnv.create(two_link, dof=1, num_cameras=cams,
                                      camera_rng=np.random.default_rng(3))
    env_t.set_joint_positions([q])
    env_j.set_joint_positions([q])
    pts = env_t.posed_surface_points()
    np.testing.assert_array_equal(pts, env_j.posed_surface_points())
    _check_capture(pts, env_t.rig, env_j.rig, pix, 2000)


def test_fps_native_and_loop_make_the_same_picks():
    from autourdf_tpu_torch.io import native

    pts = torch.from_numpy(np.random.default_rng(4).random((20000, 3)).astype(np.float32))
    pts[5000:5100] = pts[:100]                         # equal scores
    assert native.available()
    got = native.fps_native(pts.numpy(), 700)
    assert torch.equal(torch.from_numpy(got.astype(np.int64)), farthest_point_sample(pts, 700))


def test_capture_noise_presence_and_scale():
    pts_np, _ = _cube_with_interior()
    pts = torch.from_numpy(pts_np)
    rig = sphere_camera_rig(1.5, 8, np.random.default_rng(1), device="cpu")
    clean, vis = capture_cloud(pts, rig, None, width=200, height=200, num_points=400)
    with pytest.raises(ValueError):
        capture_cloud(pts, rig, None, width=200, height=200, num_points=400, pose_noise=0.01)
    # pose noise: one rigid shift, the generator's first draw
    gen = torch.Generator().manual_seed(7)
    shifted, vis2 = capture_cloud(pts, rig, gen, width=200, height=200, num_points=400,
                                  pose_noise=0.01)
    shift = torch.randn(3, generator=torch.Generator().manual_seed(7)) * 0.01
    assert torch.equal(vis, vis2)                     # visibility is the clean points'
    assert float((shifted - clean).abs().max()) > 1e-4
    np.testing.assert_allclose(torch.median(shifted - clean, dim=0).values, shift, atol=1e-6)
    # point noise: every captured point within reach of a clean visible point,
    # at the mean distance of a 3-d normal of sigma 0.0005 (1.596 sigma)
    sigma = 0.0005
    noisy, _ = capture_cloud(pts, rig, torch.Generator().manual_seed(8), width=200,
                             height=200, num_points=400, point_noise=sigma)
    d = torch.cdist(noisy, pts[vis]).min(dim=1).values
    assert 0.8 * 1.596 * sigma < float(d.mean()) < 1.2 * 1.596 * sigma
    again, _ = capture_cloud(pts, rig, torch.Generator().manual_seed(8), width=200,
                             height=200, num_points=400, point_noise=sigma)
    assert torch.equal(noisy, again)                   # the generator decides the draws


# ---------------------------------------------------------------------------
# the env, the dataset stage and the re-simulation Chamfer
# ---------------------------------------------------------------------------

def test_kinematic_env_matches_jax():
    kw = dict(dof=5, radius=1.5, num_cameras=20, base_orientation=(0.1, 0.0, -0.3),
              surface_points=30000)
    env_t = KinematicEnv.create(WX200, camera_rng=np.random.default_rng(9), device="cpu", **kw)
    env_j = j_env.KinematicEnv.create(WX200, camera_rng=np.random.default_rng(9), **kw)
    np.testing.assert_array_equal(env_t.joint_limits, env_j.joint_limits)
    np.testing.assert_array_equal(env_t.rig.eyes.numpy(), np.asarray(env_j.rig.eyes))
    rng = np.random.default_rng(2)
    for _ in range(6):
        cmd = rng.uniform(-4, 4, 5)
        assert env_t.set_joint_positions(cmd) == env_j.set_joint_positions(cmd)
        np.testing.assert_array_equal(env_t.posed_surface_points(), env_j.posed_surface_points())
        assert env_t.check_collision() == env_j.check_collision()


def _toy_robot(root, *packages):
    urdf = os.path.join(root, "toy.urdf")
    with open(urdf, "w") as f:
        f.write(TWO_LINK_URDF)
    for c in packages:
        c.ROBOTS["toy_hinge"] = c.RobotConfig(name="toy_hinge", num_seg=6, dof=1, gt_urdf=urdf,
                                              voxel_size=0.02, cam_dist=2.0)
    return urdf


def _recording(calls, capture, to_numpy):
    """``capture`` that also appends each call's (points, rig, mask, cloud)."""
    def wrapped(points, rig, *args, **kwargs):
        cloud, vis = capture(points, rig, *args, **kwargs)
        calls.append((to_numpy(points), rig, to_numpy(vis), to_numpy(cloud)))
        return cloud, vis
    return wrapped


def test_dataset_stage_matches_jax(tmp_path, monkeypatch):
    """run_dataset of both packages on the toy hinge, noise off: the same
    sequence directories and identical joint_cfg.txt; every capture of the
    stage on the same posed points, with masks that agree up to explained
    flips and clouds held as the capture tests hold them; the files are
    those captures."""
    _toy_robot(str(tmp_path), jconfig, tconfig)
    calls_t, calls_j = [], []
    monkeypatch.setattr("autourdf_tpu_torch.sim.env.capture_cloud",
                        _recording(calls_t, capture_cloud, lambda x: x.cpu().numpy()))
    monkeypatch.setattr(j_env, "capture_cloud",
                        _recording(calls_j, j_capture.capture_cloud, np.asarray))
    kw = dict(robot="toy_hinge", num_step=3, num_videos=2, num_points=600, pix=240,
              step_size_deg=8, noise=False)
    dj = jworkflow.run_dataset(jconfig.PipelineConfig(data_root=str(tmp_path / "j"), **kw),
                               epochs=2)
    dt = tworkflow.run_dataset(tconfig.PipelineConfig(data_root=str(tmp_path / "t"), **kw),
                               epochs=2, device="cpu")
    assert [os.path.basename(d) for d in dt] == [os.path.basename(d) for d in dj]
    assert len(calls_t) == len(calls_j) == 6           # 2 sequences x 3 frames, none collided
    for (pts, rig_t, vis_t, cloud_t), (pts_j, _, vis_j, cloud_j) in zip(calls_t, calls_j):
        np.testing.assert_array_equal(pts, pts_j)
        _hold_capture(pts, rig_t, 240, 600, vis_t, cloud_t, vis_j, cloud_j)
    clouds_t = iter(c[3] for c in calls_t)
    clouds_j = iter(c[3] for c in calls_j)
    for a, b in zip(dj, dt):
        frames = sorted(os.listdir(a))
        assert frames == sorted(os.listdir(b)) and len(frames) == 3
        for fr in frames:
            with open(os.path.join(a, fr, "joint_cfg.txt")) as fa, \
                    open(os.path.join(b, fr, "joint_cfg.txt")) as fb:
                assert fa.read() == fb.read()
            ca, cb = (read_ply(os.path.join(d, fr, "robot.ply")) for d in (a, b))
            assert ca.shape == cb.shape == (600, 3)
            np.testing.assert_array_equal(ca, next(clouds_j))
            np.testing.assert_array_equal(cb, next(clouds_t))
    with open(tmp_path / "t" / "telemetry.json") as f:
        assert [r["stage"] for r in json.load(f)] == ["dataset"]


def test_resim_chamfer_matches_jax(tmp_path, two_link):
    """resim_chamfer of both packages on a predicted URDF with a tilted axis
    and a moved origin against the gt: the same commands, rigs and clouds
    (noise off, 3,000 points a capture), ICP and Chamfer in float32 on each
    side: losses to 1e-5."""
    pred = tmp_path / "pred.urdf"
    pred.write_text(TEST_URDF.replace('<axis xyz="0 0 1"/>', '<axis xyz="0.1 0 0.995"/>')
                    .replace('<origin xyz="0 0 0.2" rpy="0 0 0"/>',
                             '<origin xyz="0.01 0 0.19" rpy="0 0 0"/>'))
    kw = dict(pred_urdf_path=str(pred), gt_urdf_path=two_link, dof=1,
              offset=np.array([0.2]), joint_map=np.array([0]), direction_map=[1],
              num_configs=2, num_cameras=20, seed=3, radius=1.5, num_points=3000)
    lt, mt, st = resim_chamfer(save_path=str(tmp_path / "t"), device="cpu", **kw)
    lj, mj, sj = j_resim.resim_chamfer(save_path=str(tmp_path / "j"), **kw)
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
    assert 0 < mt < 0.05
    for name in ("loss.txt", "command_rad.txt"):
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / name),
                                   np.loadtxt(tmp_path / "j" / name), atol=1e-5, rtol=0)
