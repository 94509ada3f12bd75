"""URDF parsing into a kinematic robot model.

Replaces PyBullet's ``loadURDF`` for everything the reference needs:
enumerating revolute joints with limits (SimEnv._setup_joint_control,
reference/Sim/sim_data.py:66-82), link geometry for rendering, and
joint frames for evaluation (reference/Sim/evaluation.py:115-201).

Joint order follows document order, which is also PyBullet's joint index
order — joint_map files from the reference stay meaningful.

Copy of autourdf_tpu.urdf.parser (numpy and scipy only), kept here so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np
from scipy.spatial.transform import Rotation as ScipyRot

from ..io.mesh_io import TriMesh, load_mesh


def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    # URDF rpy is fixed-axis (extrinsic) xyz
    return ScipyRot.from_euler("xyz", rpy).as_matrix()


def origin_to_transform(el: ET.Element | None) -> np.ndarray:
    T = np.eye(4)
    if el is None:
        return T
    xyz = np.array([float(v) for v in el.get("xyz", "0 0 0").split()])
    rpy = np.array([float(v) for v in el.get("rpy", "0 0 0").split()])
    T[:3, :3] = _rpy_to_matrix(rpy)
    T[:3, 3] = xyz
    return T


def _make_box(size: np.ndarray) -> TriMesh:
    sx, sy, sz = size / 2
    v = np.array(
        [[x, y, z] for x in (-sx, sx) for y in (-sy, sy) for z in (-sz, sz)]
    )
    f = np.array(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
        dtype=np.int32,
    )
    return TriMesh(v, f)


def _make_sphere(radius: float, n: int = 12) -> TriMesh:
    us = np.linspace(0, np.pi, n)
    vs = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    verts = []
    for u in us:
        for v in vs:
            verts.append(
                [radius * np.sin(u) * np.cos(v), radius * np.sin(u) * np.sin(v),
                 radius * np.cos(u)]
            )
    verts = np.asarray(verts)
    faces = []
    m = len(vs)
    for i in range(n - 1):
        for j in range(m):
            a, b = i * m + j, i * m + (j + 1) % m
            c, d = (i + 1) * m + j, (i + 1) * m + (j + 1) % m
            faces.append([a, b, d])
            faces.append([a, d, c])
    return TriMesh(verts, np.asarray(faces, dtype=np.int32))


def _make_cylinder(radius: float, length: float, n: int = 24) -> TriMesh:
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([radius * np.cos(angles), radius * np.sin(angles)], axis=1)
    top = np.concatenate([ring, np.full((n, 1), length / 2)], axis=1)
    bot = np.concatenate([ring, np.full((n, 1), -length / 2)], axis=1)
    verts = np.concatenate([top, bot, [[0, 0, length / 2]], [[0, 0, -length / 2]]])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces.append([i, j, n + j])
        faces.append([i, n + j, n + i])
        faces.append([2 * n, j, i])        # top cap
        faces.append([2 * n + 1, n + i, n + j])  # bottom cap
    return TriMesh(verts, np.asarray(faces, dtype=np.int32))


@dataclass
class Geometry:
    origin: np.ndarray              # (4, 4) geometry frame in link frame
    mesh: TriMesh | None            # resolved triangle mesh (scaled)
    mesh_path: str | None = None


@dataclass
class Link:
    name: str
    visuals: list[Geometry] = field(default_factory=list)
    collisions: list[Geometry] = field(default_factory=list)

    def geometry(self, prefer: str = "visual") -> list[Geometry]:
        first, second = (
            (self.visuals, self.collisions)
            if prefer == "visual"
            else (self.collisions, self.visuals)
        )
        return first if first else second


@dataclass
class Joint:
    name: str
    type: str
    parent: str
    child: str
    origin: np.ndarray   # (4, 4) joint frame in parent link frame
    axis: np.ndarray     # (3,) in joint frame
    lower: float = 0.0
    upper: float = 0.0
    index: int = -1      # document order over ALL joints (pybullet-style)


@dataclass
class RobotModel:
    name: str
    links: dict[str, Link]
    joints: list[Joint]
    root: str

    @property
    def revolute_joints(self) -> list[Joint]:
        return [j for j in self.joints if j.type in ("revolute", "continuous")]

    @property
    def movable_joints(self) -> list[Joint]:
        return [j for j in self.joints if j.type not in ("fixed", "floating")]

    def joint_limits(self, dof: int | None = None) -> np.ndarray:
        js = self.revolute_joints
        if dof is not None:
            js = js[:dof]
        return np.array([[j.lower, j.upper] for j in js])


def _resolve_mesh_path(filename: str, urdf_dir: str, asset_root: str | None) -> str | None:
    cand: list[str] = []
    fn = filename
    if fn.startswith("package://"):
        fn = fn[len("package://"):]
        # package name may or may not exist as a directory; try both
        cand.append(os.path.join(urdf_dir, "..", fn.split("/", 1)[-1]))
    if "$(find " in fn:
        # xacro leftover: $(find pkg)/rest -> search for rest
        fn = fn.split(")", 1)[-1].lstrip("/")
    cand.append(os.path.join(urdf_dir, fn))
    if asset_root:
        cand.append(os.path.join(asset_root, fn))
        cand.append(os.path.join(asset_root, fn.lstrip("./")))
    # walk up from the urdf dir (covers ../meshes and repo-root-relative refs)
    d = urdf_dir
    for _ in range(4):
        d = os.path.dirname(d)
        if not d:
            break
        cand.append(os.path.join(d, fn))
    for c in cand:
        if os.path.isfile(c):
            return os.path.normpath(c)
    # last resort: search by basename under the asset root and urdf tree
    base = os.path.basename(fn)
    for root_dir in filter(None, [asset_root, os.path.dirname(urdf_dir)]):
        for dirpath, _, files in os.walk(root_dir):
            if base in files:
                return os.path.join(dirpath, base)
    return None


def _parse_geometry(
    el: ET.Element, urdf_dir: str, asset_root: str | None, load_meshes: bool
) -> Geometry | None:
    origin = origin_to_transform(el.find("origin"))
    geom_el = el.find("geometry")
    if geom_el is None:
        return None
    mesh_el = geom_el.find("mesh")
    if mesh_el is not None:
        path = _resolve_mesh_path(mesh_el.get("filename", ""), urdf_dir, asset_root)
        mesh = None
        if path and load_meshes:
            try:
                mesh = load_mesh(path)
            except Exception:
                mesh = None
            if mesh is not None:
                scale = mesh_el.get("scale")
                if scale:
                    mesh = mesh.scaled([float(s) for s in scale.split()])
        return Geometry(origin, mesh, path)
    box = geom_el.find("box")
    if box is not None:
        size = np.array([float(v) for v in box.get("size").split()])
        return Geometry(origin, _make_box(size))
    sph = geom_el.find("sphere")
    if sph is not None:
        return Geometry(origin, _make_sphere(float(sph.get("radius"))))
    cyl = geom_el.find("cylinder")
    if cyl is not None:
        return Geometry(
            origin, _make_cylinder(float(cyl.get("radius")), float(cyl.get("length")))
        )
    return None


def load_urdf(
    path: str,
    asset_root: str | None = None,
    load_meshes: bool = True,
    global_scale: float = 1.0,
) -> RobotModel:
    """Parse a URDF file; mesh references resolved best-effort.

    ``global_scale`` mirrors PyBullet's ``globalScaling``: scales mesh
    geometry, joint origins, and geometry origins uniformly.
    """
    tree = ET.parse(path)
    robot_el = tree.getroot()
    urdf_dir = os.path.dirname(os.path.abspath(path))
    if asset_root is None:
        asset_root = os.environ.get("AUTOURDF_ASSET_ROOT")

    links: dict[str, Link] = {}
    for link_el in robot_el.iterfind("link"):
        link = Link(name=link_el.get("name"))
        for vis in link_el.iterfind("visual"):
            g = _parse_geometry(vis, urdf_dir, asset_root, load_meshes)
            if g is not None:
                link.visuals.append(g)
        for col in link_el.iterfind("collision"):
            g = _parse_geometry(col, urdf_dir, asset_root, load_meshes)
            if g is not None:
                link.collisions.append(g)
        links[link.name] = link

    joints: list[Joint] = []
    children = set()
    for i, joint_el in enumerate(robot_el.iterfind("joint")):
        jtype = joint_el.get("type", "fixed")
        axis_el = joint_el.find("axis")
        axis = np.array(
            [float(v) for v in (axis_el.get("xyz") if axis_el is not None else "1 0 0").split()]
        )
        limit_el = joint_el.find("limit")
        lower = float(limit_el.get("lower", "0")) if limit_el is not None else 0.0
        upper = float(limit_el.get("upper", "0")) if limit_el is not None else 0.0
        if jtype == "continuous":
            lower, upper = -np.pi, np.pi
        parent = joint_el.find("parent").get("link")
        child = joint_el.find("child").get("link")
        children.add(child)
        joints.append(
            Joint(
                name=joint_el.get("name"),
                type=jtype,
                parent=parent,
                child=child,
                origin=origin_to_transform(joint_el.find("origin")),
                axis=axis,
                lower=lower,
                upper=upper,
                index=i,
            )
        )

    roots = [name for name in links if name not in children]
    root = roots[0] if roots else next(iter(links))

    model = RobotModel(robot_el.get("name", "robot"), links, joints, root)
    if global_scale != 1.0:
        for j in model.joints:
            j.origin = j.origin.copy()
            j.origin[:3, 3] *= global_scale
        for link in model.links.values():
            for g in link.visuals + link.collisions:
                g.origin = g.origin.copy()
                g.origin[:3, 3] *= global_scale
                if g.mesh is not None:
                    g.mesh = g.mesh.scaled(global_scale)
    return model
