"""The port's views against the JAX package's, on the CPU.

``viz_interactive`` is a copy: the scene JSON that ``export_interactive_html``
embeds and ``_decimate``'s output must equal the JAX module's exactly.
``viz`` is a numpy rasteriser in place of matplotlib and PIL, so its images
cannot equal the JAX ones; instead every one of its eleven functions must
write a file that decodes back, exactly, to the array the rasteriser drew
(decoded by ``chip_smoke.py``'s own PNG and GIF readers, and by PIL where it
is installed), and the geometry is checked: a lone point lands on the
pixel that matplotlib's default camera (elevation 30 degrees, azimuth -60
degrees, orthographic) puts it on, a joint axis's ends are red, and a GIF
has its frame count, frame duration and loop.  ``cli view`` on the
``two_link`` fixture writes the JAX CLI's three kinds of output.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
from test_sim_io_urdf import TEST_URDF

from autourdf_tpu import viz_interactive as j_viz_interactive
from autourdf_tpu_torch import cli, viz
from autourdf_tpu_torch import viz_interactive as t_viz_interactive
from autourdf_tpu_torch.io.mesh_io import TriMesh, save_stl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def two_link(tmp_path):
    p = tmp_path / "two_link.urdf"
    p.write_text(TEST_URDF)
    return str(p)


def _scene(path):
    html = open(path).read()
    m = re.search(r"const SCENE = (\{.*?\});\n", html, re.S)
    assert m, "embedded scene JSON not found"
    return html, json.loads(m.group(1))


def test_interactive_scene_equals_jax(two_link, tmp_path):
    html_t, scene_t = _scene(t_viz_interactive.export_interactive_html(
        two_link, str(tmp_path / "t.html")))
    html_j, scene_j = _scene(j_viz_interactive.export_interactive_html(
        two_link, str(tmp_path / "j.html")))
    assert scene_t == scene_j
    assert html_t == html_j
    assert set(scene_t["links"]) == {"base", "arm", "tip"}
    assert "http://" not in html_t and "https://" not in html_t


def test_decimate_equals_jax():
    n = 100
    us, vs = np.meshgrid(np.linspace(0.1, np.pi - 0.1, n), np.linspace(0, 2 * np.pi, n),
                         indexing="ij")
    verts = np.stack([np.sin(us) * np.cos(vs), np.sin(us) * np.sin(vs), np.cos(us)],
                     -1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    quads = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]], -1)
    faces = np.concatenate([quads[..., [0, 1, 2]].reshape(-1, 3),
                            quads[..., [0, 2, 3]].reshape(-1, 3)]).astype(np.int64)
    for target in (1500, 6000, 30000):
        dv_t, df_t = t_viz_interactive._decimate(verts, faces, target_faces=target)
        dv_j, df_j = j_viz_interactive._decimate(verts, faces, target_faces=target)
        np.testing.assert_array_equal(dv_t, dv_j)
        np.testing.assert_array_equal(df_t, df_j)
    assert 0 < len(df_t) and np.all(df_t < len(dv_t))


# ---------------------------------------------------------------------------
# viz: every function's file decodes to what the rasteriser drew

def _decode(path):
    """Frames of a PNG or GIF by chip_smoke's readers, checked against PIL
    where it is installed."""
    if path.endswith(".png"):
        frames, delays, loop = [chip_smoke.read_png(path)], None, None
    else:
        frames, delays, loop = chip_smoke.read_gif(path)
    try:
        from PIL import Image
    except ImportError:
        return frames, delays, loop
    with Image.open(path) as im:
        for i, f in enumerate(frames):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), f)
    return frames, delays, loop


@pytest.fixture
def drawn(monkeypatch):
    """Records every array viz writes, by path."""
    seen = {}
    png, gif = viz.write_png, viz.write_gif

    def rec_png(path, rgb):
        seen[path] = [rgb.copy()]
        return png(path, rgb)

    def rec_gif(path, frames, duration_ms):
        seen[path] = [f.copy() for f in frames]
        return gif(path, frames, duration_ms)

    monkeypatch.setattr(viz, "write_png", rec_png)
    monkeypatch.setattr(viz, "write_gif", rec_gif)
    return seen


def _link_dir(tmp_path):
    """A recovered-links directory: two box STLs and three steps of link
    matrices."""
    d = tmp_path / "links"
    (d / "matrix").mkdir(parents=True)
    box = TriMesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float) * 0.1,
                  np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32))
    for i in range(2):
        save_stl(str(d / f"{i}.stl"), box)
    for t in range(3):
        m = np.tile(np.eye(4), (2, 1, 1))
        m[1, :3, 3] = [0.2, 0.05 * t, 0.0]
        np.save(d / "matrix" / f"{t:04}.npy", m)
    return str(d)


def _calls(tmp_path, two_link):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3))
    labels = rng.integers(0, 4, 200)

    class J:
        global_pos = np.array([0.1, 0.0, 0.2])
        global_axis = np.array([0.0, 0.0, 1.0])

    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    d = str(tmp_path)
    return {
        "render_cloud": lambda: viz.render_cloud(pts, f"{d}/cloud.png"),
        "render_clusters": lambda: viz.render_clusters(pts, labels, f"{d}/clusters.png"),
        "plot_silhouette_scores": lambda: viz.plot_silhouette_scores(
            [2, 3, 4], [0.5, 0.8, 0.3], f"{d}/sil.png"),
        "plot_distance_map": lambda: viz.plot_distance_map(rng.random((6, 6)), f"{d}/dmap.png"),
        "plot_loss_history": lambda: viz.plot_loss_history(
            np.r_[rng.random(50), np.inf], f"{d}/loss.png", lrs=np.geomspace(1e-3, 1e-5, 50)),
        "render_kinematic_tree": lambda: viz.render_kinematic_tree(
            rng.normal(size=(6, 3)) * 0.2, [{0, 1, 2}, {3, 4, 5}], [(0, 1), (2, 3), (4, 5)],
            f"{d}/tree.png", joints=[J()]),
        "render_mesh": lambda: viz.render_mesh(TriMesh(v, f), f"{d}/mesh.png"),
        "animate_clouds": lambda: viz.animate_clouds([pts, pts + 0.1], f"{d}/anim.gif",
                                                     labels=[labels, labels]),
        "replay_posed_meshes": lambda: viz.replay_posed_meshes(_link_dir(tmp_path),
                                                               f"{d}/replay.gif"),
        "urdf_snapshot": lambda: viz.urdf_snapshot(two_link, f"{d}/snap.png"),
        "sweep_joint_gif": lambda: viz.sweep_joint_gif(two_link, "hinge", f"{d}/sweep.gif",
                                                       num_frames=4),
    }


VIZ_FUNCTIONS = ["render_cloud", "render_clusters", "plot_silhouette_scores",
                 "plot_distance_map", "plot_loss_history", "render_kinematic_tree",
                 "render_mesh", "animate_clouds", "replay_posed_meshes", "urdf_snapshot",
                 "sweep_joint_gif"]


@pytest.mark.parametrize("name", VIZ_FUNCTIONS)
def test_viz_file_decodes_to_the_drawn_array(name, tmp_path, two_link, drawn):
    out = _calls(tmp_path, two_link)[name]()
    assert list(drawn) == [out]
    frames, _, _ = _decode(out)
    assert len(frames) == len(drawn[out])
    for a, b in zip(frames, drawn[out]):
        np.testing.assert_array_equal(a, b)
        assert (b != 255).any(), "nothing was drawn"


def test_viz_has_the_jax_modules_eleven_functions():
    import inspect

    from autourdf_tpu import viz as j_viz_source  # noqa: F401 (matplotlib is installed here)

    for name in VIZ_FUNCTIONS:
        assert (inspect.signature(getattr(viz, name))
                == inspect.signature(getattr(j_viz_source, name))), name


def test_a_lone_point_lands_on_its_projected_pixel():
    """matplotlib's camera: right = (-sin az, cos az, 0), up = (-sin el cos
    az, -sin el sin az, cos el); the cube of the corners fills the image's
    circumscribed circle."""
    corners = np.array([[-1.0, -2.0, 0.5], [3.0, 2.0, 2.5]])
    centre, half = corners.mean(0), 2.0
    size = 101
    el, az = np.radians(30.0), np.radians(-60.0)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az), np.cos(el)])
    for p in ([0.3, -0.7, 1.9], [2.5, 1.5, 0.6], centre):
        q = (np.asarray(p) - centre) / half
        col = round((size - 1) / 2 * (1 + q @ right / np.sqrt(3)))
        row = round((size - 1) / 2 * (1 - q @ up / np.sqrt(3)))
        img = viz.draw_cloud(np.array([p]), limits_of=corners, size=size)
        drawn = np.argwhere((img != 255).any(-1))
        np.testing.assert_array_equal(drawn, [[row, col]])
        np.testing.assert_array_equal(img[row, col], viz.C0)


def test_a_nearer_point_hides_a_farther_one():
    _, _, eye = viz.view_basis()
    corners = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])
    pts = np.stack([0.5 * eye, -0.5 * eye])          # the same pixel, nearer first
    for order in (pts, pts[::-1]):
        colors = np.array([[255, 0, 0], [0, 0, 255]], np.uint8)
        if order is not pts:
            colors = colors[::-1]
        img = viz.draw_cloud(order, colors=colors, limits_of=corners, size=51)
        np.testing.assert_array_equal(img[25, 25], [255, 0, 0])


def test_joint_axis_ends_are_red(tmp_path, drawn):
    coords = np.array([[0.0, 0.0, 0.0], [0.3, 0.1, 0.2], [0.1, 0.3, 0.0]])

    class J:
        global_pos = np.array([0.1, 0.1, 0.1])
        global_axis = np.array([1.0, 1.0, 0.0])

    out = viz.render_kinematic_tree(coords, [{0}, {1, 2}], [(0, 1)], str(tmp_path / "t.png"),
                                    joints=[J()], axis_len=0.08)
    img = _decode(out)[0][0]
    view = viz.View(*viz.cube_limits(coords), img.shape[0])
    d = J.global_axis / np.linalg.norm(J.global_axis) * 0.08
    col, row, _ = view.project(np.stack([J.global_pos - d, J.global_pos + d]))
    for c, r in zip(np.rint(col).astype(int), np.rint(row).astype(int)):
        np.testing.assert_array_equal(img[r, c], viz.RED)


@pytest.mark.parametrize("fps,ms", [(4, 250), (3, 330)])
def test_gif_frames_duration_and_loop(tmp_path, fps, ms):
    rng = np.random.default_rng(1)
    clouds = [rng.normal(size=(50, 3)) + 0.1 * t for t in range(3)]
    frames, delays, loop = _decode(viz.animate_clouds(clouds, str(tmp_path / "a.gif"), fps=fps))
    assert len(frames) == 3 and delays == [ms] * 3 and loop == 0


def test_gif_of_many_colours_takes_the_colour_cube(tmp_path):
    frames = [np.random.default_rng(2).integers(0, 256, (40, 30, 3)).astype(np.uint8)]
    palette, idx = viz.palette_frames(frames)
    got = _decode(viz.write_gif(str(tmp_path / "c.gif"), frames, 100))[0]
    np.testing.assert_array_equal(got[0], palette[idx[0]])
    assert np.abs(got[0].astype(int) - frames[0]).max() <= 26


def test_cli_view_writes_the_three_kinds_of_output(two_link, tmp_path, capsys):
    out_dir = str(tmp_path / "view")
    rc = cli.main(["view", "--urdf", two_link, "--out-dir", out_dir, "--sweep",
                   "--interactive", "--device", "cpu"])
    assert rc == 0
    outs = json.loads(capsys.readouterr().out.splitlines()[-1])["outputs"]
    assert outs == [os.path.join(out_dir, n) for n in
                    ("snapshot.png", "interactive.html", "sweep_hinge.gif")]
    assert _decode(outs[0])[0][0].shape == (700, 700, 3)
    _, scene = _scene(outs[1])
    assert {j["name"] for j in scene["joints"]} == {"hinge", "mount"}
    frames, delays, loop = _decode(outs[2])
    assert len(frames) == 16 and set(delays) == {250} and loop == 0

