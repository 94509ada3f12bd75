"""Triangle-mesh I/O and surface sampling (numpy, host-side).

Replaces the Open3D/trimesh mesh plumbing the reference gets for free via
PyBullet's URDF loader.  Supported: binary + ascii STL, OBJ (v/f), and
COLLADA .dae geometry; binary STL writing for the URDF emitter
(reference/PointCloud/link.py:314 writes .stl link meshes).

Copy of autourdf_tpu.io.mesh_io (numpy only), kept here so the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray     # (F, 3) int32

    def scaled(self, scale) -> "TriMesh":
        s = np.asarray(scale, dtype=np.float64)
        return TriMesh(self.vertices * s, self.faces)

    def transformed(self, T: np.ndarray) -> "TriMesh":
        v = self.vertices @ T[:3, :3].T + T[:3, 3]
        return TriMesh(v, self.faces)

    @property
    def face_areas(self) -> np.ndarray:
        v = self.vertices
        a = v[self.faces[:, 1]] - v[self.faces[:, 0]]
        b = v[self.faces[:, 2]] - v[self.faces[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(a, b), axis=1)

    @property
    def area(self) -> float:
        return float(self.face_areas.sum())


def _load_stl_binary(data: bytes) -> TriMesh:
    (n_tri,) = struct.unpack_from("<I", data, 80)
    arr = np.frombuffer(data, dtype=np.uint8, count=n_tri * 50, offset=84)
    arr = arr.reshape(n_tri, 50)
    floats = arr[:, :48].copy().view("<f4").reshape(n_tri, 12)
    verts = floats[:, 3:12].reshape(n_tri * 3, 3).astype(np.float64)
    # weld duplicate vertices so face adjacency exists
    uniq, inv = np.unique(verts.round(8), axis=0, return_inverse=True)
    faces = inv.reshape(n_tri, 3).astype(np.int32)
    return TriMesh(uniq, faces)


def _load_stl_ascii(text: str) -> TriMesh:
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    verts = np.asarray(verts, dtype=np.float64)
    n_tri = len(verts) // 3
    uniq, inv = np.unique(verts.round(8), axis=0, return_inverse=True)
    faces = inv[: n_tri * 3].reshape(n_tri, 3).astype(np.int32)
    return TriMesh(uniq, faces)


def load_stl(path: str) -> TriMesh:
    with open(path, "rb") as f:
        data = f.read()
    # ascii STL starts with "solid" AND contains "facet"; binary may too, so
    # validate the triangle count against the file size
    if len(data) >= 84:
        (n_tri,) = struct.unpack_from("<I", data, 80)
        if 84 + n_tri * 50 == len(data):
            return _load_stl_binary(data)
    return _load_stl_ascii(data.decode("utf-8", errors="ignore"))


def save_stl(path: str, mesh: TriMesh) -> None:
    """Binary little-endian STL with recomputed facet normals."""
    v = mesh.vertices.astype(np.float32)
    f = mesh.faces
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), 0.0).astype(np.float32)
    rec = np.zeros((len(f), 50), dtype=np.uint8)
    block = np.concatenate([n, p0, p1, p2], axis=1).astype("<f4")  # (F, 12)
    rec[:, :48] = block.view(np.uint8).reshape(len(f), 48)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as out:
        out.write(b"\0" * 80)
        out.write(struct.pack("<I", len(f)))
        out.write(rec.tobytes())


def load_obj(path: str) -> TriMesh:
    verts = []
    faces = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    vi = tok.split("/")[0]
                    idx.append(int(vi))
                # negative indices are relative to current vertex count
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(
        np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)
    )


def _dae_node_transforms(root, ns) -> dict[str, np.ndarray]:
    """geometry id -> accumulated (4, 4) scene-node transform.

    Blender-style exports put the real scale/orientation in visual-scene
    node matrices (the <asset> unit/up_axis tags are often wrong, e.g. the
    ur5e meshes declare meters/Z_UP but store millimeter Y-up data), so
    ignoring nodes yields meshes ~1000x off.
    """
    out: dict[str, np.ndarray] = {}

    def local_transform(node) -> np.ndarray:
        T = np.eye(4)
        for ch in node:
            tag = ch.tag.split("}")[-1]
            if ch.text is None:
                continue
            vals = np.array(ch.text.split(), dtype=np.float64)
            if tag == "matrix" and vals.size == 16:
                T = T @ vals.reshape(4, 4)
            elif tag == "translate" and vals.size == 3:
                M = np.eye(4)
                M[:3, 3] = vals
                T = T @ M
            elif tag == "rotate" and vals.size == 4:
                from scipy.spatial.transform import Rotation as ScipyRot

                M = np.eye(4)
                M[:3, :3] = ScipyRot.from_rotvec(
                    vals[:3] / max(np.linalg.norm(vals[:3]), 1e-12)
                    * np.deg2rad(vals[3])
                ).as_matrix()
                T = T @ M
            elif tag == "scale" and vals.size == 3:
                T = T @ np.diag(np.concatenate([vals, [1.0]]))
        return T

    def walk(node, parent_T):
        T = parent_T @ local_transform(node)
        for ch in node:
            tag = ch.tag.split("}")[-1]
            if tag == "instance_geometry":
                gid = (ch.get("url") or "").lstrip("#")
                if gid:
                    out[gid] = T
            elif tag == "node":
                walk(ch, T)
        return T

    for scene in root.iterfind(".//c:visual_scene", ns):
        for node in scene.iterfind("c:node", ns):
            walk(node, np.eye(4))
    return out


def load_dae(path: str) -> TriMesh:
    """COLLADA geometry: concatenated <triangles>/<polylist> of all meshes,
    with visual-scene node transforms and the <asset> unit scale applied.
    """
    ns = {"c": "http://www.collada.org/2005/11/COLLADASchema"}
    tree = ET.parse(path)
    root = tree.getroot()
    unit = root.find("c:asset/c:unit", ns)
    scale = float(unit.get("meter", "1")) if unit is not None else 1.0
    node_T = _dae_node_transforms(root, ns)

    all_v, all_f = [], []
    offset = 0
    for geom in root.iterfind(".//c:geometry", ns):
        mesh = geom.find("c:mesh", ns)
        if mesh is None:
            continue
        sources = {}
        for src in mesh.iterfind("c:source", ns):
            arr = src.find("c:float_array", ns)
            if arr is not None and arr.text:
                sources["#" + src.get("id")] = np.array(arr.text.split(), dtype=np.float64)
        vert_el = mesh.find("c:vertices", ns)
        pos_ref = None
        if vert_el is not None:
            for inp in vert_el.iterfind("c:input", ns):
                if inp.get("semantic") == "POSITION":
                    pos_ref = inp.get("source")
        verts_map = {"#" + vert_el.get("id"): pos_ref} if vert_el is not None else {}

        for prim in list(mesh.iterfind("c:triangles", ns)) + list(
            mesh.iterfind("c:polylist", ns)
        ):
            inputs = prim.findall("c:input", ns)
            stride = max(int(i.get("offset", "0")) for i in inputs) + 1
            v_off = None
            v_src = None
            for i in inputs:
                if i.get("semantic") == "VERTEX":
                    v_off = int(i.get("offset", "0"))
                    v_src = verts_map.get(i.get("source"), i.get("source"))
            p = prim.find("c:p", ns)
            if p is None or p.text is None or v_src not in sources:
                continue
            idx = np.array(p.text.split(), dtype=np.int64)
            verts = sources[v_src].reshape(-1, 3) * scale
            gid = geom.get("id")
            if gid in node_T:
                T = node_T[gid]
                verts = verts @ T[:3, :3].T + T[:3, 3]
            if prim.tag.endswith("polylist"):
                vcount = np.array(
                    prim.find("c:vcount", ns).text.split(), dtype=np.int64
                )
                faces = []
                pos = 0
                for c in vcount:
                    poly = idx[pos + v_off : pos + c * stride : stride]
                    for k in range(1, c - 1):
                        faces.append([poly[0], poly[k], poly[k + 1]])
                    pos += c * stride
                faces = np.asarray(faces, dtype=np.int64)
            else:
                tri_idx = idx.reshape(-1, stride)[:, v_off]
                faces = tri_idx.reshape(-1, 3)
            all_v.append(verts)
            all_f.append(faces + offset)
            offset += len(verts)

    if not all_v:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int32))
    return TriMesh(
        np.concatenate(all_v), np.concatenate(all_f).astype(np.int32)
    )


def load_mesh(path: str) -> TriMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stl":
        return load_stl(path)
    if ext == ".obj":
        return load_obj(path)
    if ext == ".dae":
        return load_dae(path)
    raise ValueError(f"unsupported mesh format: {path}")


def sample_surface(
    mesh: TriMesh, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Area-weighted uniform surface sampling -> (n, 3) float32."""
    areas = mesh.face_areas
    total = areas.sum()
    if total <= 0 or len(mesh.faces) == 0:
        return np.zeros((n, 3), dtype=np.float32)
    probs = areas / total
    face_idx = rng.choice(len(mesh.faces), size=n, p=probs)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    f = mesh.faces[face_idx]
    p0 = mesh.vertices[f[:, 0]]
    p1 = mesh.vertices[f[:, 1]]
    p2 = mesh.vertices[f[:, 2]]
    pts = p0 + u[:, None] * (p1 - p0) + v[:, None] * (p2 - p0)
    return pts.astype(np.float32)
