"""Isosurface extraction from binary occupancy volumes (marching tetrahedra).

Replaces PyMCubes + pymeshfix in the reference mesh path
(reference/PointCloud/link.py:228-299).  We use the Kuhn 6-tetra
decomposition of each cube: every cube uses the identical decomposition,
and each cube face is cut along its min->max corner diagonal, so shared
faces between neighboring cubes always agree — the extracted surface of a
zero-padded binary volume is watertight **by construction**, removing the
need for a mesh-repair pass entirely.

Vertices land on edge midpoints (the 0.5 crossing of a binary field,
matching marching cubes at threshold 0 on occupancy).

Port of autourdf_tpu.mesh.marching: the numpy extractor, and the dispatch
to the host C++ library (``io/native.py``) with the same algorithm.
"""

from __future__ import annotations

import numpy as np

from ..io.mesh_io import TriMesh

# Kuhn decomposition: each permutation of (x, y, z) insertion defines a tet
# 0 -> +e_a -> +e_b -> +e_c.  Corner ids are bit codes (x | y<<1 | z<<2).
_PERms = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _tet_corners():
    tets = []
    for perm in _PERms:
        corners = [0]
        c = 0
        for axis in perm:
            c |= 1 << axis
            corners.append(c)
        tets.append(corners)
    return np.asarray(tets, dtype=np.int32)  # (6, 4)


_TETS = _tet_corners()
_CORNER_OFFSETS = np.asarray(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int32
)

# Per-tet case table: for each of the 16 inside-masks, the triangles as
# pairs of local tet-vertex indices (edges whose midpoint is a vertex).
# Orientation: normals point from inside (occupied) to outside.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_triangles(mask: int):
    inside = [i for i in range(4) if mask & (1 << i)]
    outside = [i for i in range(4) if not mask & (1 << i)]
    if len(inside) == 0 or len(inside) == 4:
        return []
    if len(inside) == 1:
        a = inside[0]
        b, c, d = outside
        return [((a, b), (a, c), (a, d))]
    if len(inside) == 3:
        a = outside[0]
        b, c, d = inside
        return [((b, a), (d, a), (c, a))]
    # two inside, two outside: quad of 4 crossing edges
    a, b = inside
    c, d = outside
    return [((a, c), (b, c), (b, d)), ((a, c), (b, d), (a, d))]


_CASES = [_tet_triangles(m) for m in range(16)]


def marching_tetrahedra(volume: np.ndarray, voxel_size: float = 1.0,
                        origin: np.ndarray | None = None) -> TriMesh:
    """Extract the 0.5-isosurface of a binary occupancy volume.

    The volume is zero-padded internally so the output surface is closed.
    Vertex coordinates are in world units: ``origin + voxel_size * index``.
    Dispatches to the native C++ extractor when built (same algorithm).
    """
    vol = np.pad(np.asarray(volume, dtype=bool), 1)
    origin = np.zeros(3) if origin is None else np.asarray(origin, dtype=np.float64)
    origin = origin - voxel_size  # account for the pad

    from ..io import native

    nat = native.marching_tetrahedra_native(vol) if native.available() else None
    if nat is not None:
        verts, faces = nat
        return TriMesh(verts * voxel_size + origin, faces)

    occ = vol
    nx, ny, nz = (np.array(vol.shape) - 1)

    # Active cubes: any corner differs.
    base = occ[:-1, :-1, :-1]
    changed = np.zeros_like(base)
    for c in range(1, 8):
        dx, dy, dz = _CORNER_OFFSETS[c]
        changed |= base != occ[dx : dx + nx, dy : dy + ny, dz : dz + nz]
    ix, iy, iz = np.nonzero(changed)
    if len(ix) == 0:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int32))

    cube_origin = np.stack([ix, iy, iz], axis=1)  # (C, 3)
    corner_vals = np.stack(
        [
            occ[ix + _CORNER_OFFSETS[c, 0], iy + _CORNER_OFFSETS[c, 1],
                iz + _CORNER_OFFSETS[c, 2]]
            for c in range(8)
        ],
        axis=1,
    )  # (C, 8) bool

    tris = []  # list of (S, 3, 3) float vertex triples
    for tet in _TETS:  # 6 tets, vectorized over cubes
        vals = corner_vals[:, tet]  # (C, 4)
        masks = vals[:, 0] * 1 + vals[:, 1] * 2 + vals[:, 2] * 4 + vals[:, 3] * 8
        tet_corner_pos = _CORNER_OFFSETS[tet].astype(np.float64)  # (4, 3)
        for m in range(1, 15):
            sel = np.nonzero(masks == m)[0]
            if len(sel) == 0:
                continue
            inside_c = tet_corner_pos[[i for i in range(4) if m & (1 << i)]].mean(0)
            outside_c = tet_corner_pos[[i for i in range(4) if not m & (1 << i)]].mean(0)
            for tri_edges in _CASES[m]:
                mids = [
                    0.5 * (tet_corner_pos[a] + tet_corner_pos[b])
                    for (a, b) in tri_edges
                ]
                # orient so the normal points from occupied toward empty —
                # decided once per (tet, case) from the static geometry
                n = np.cross(mids[1] - mids[0], mids[2] - mids[0])
                if n @ (outside_c - inside_c) < 0:
                    mids = [mids[0], mids[2], mids[1]]
                pts = [cube_origin[sel] + mid for mid in mids]  # 3 x (S, 3)
                tris.append(np.stack(pts, axis=1))  # (S, 3, 3)

    tri_arr = np.concatenate(tris, axis=0)  # (F, 3, 3) in index space
    flat = tri_arr.reshape(-1, 3)
    # weld on half-integer lattice (exact: coords are multiples of 0.5)
    keys = np.round(flat * 2).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = uniq.astype(np.float64) / 2.0 * voxel_size + origin
    faces = inv.reshape(-1, 3).astype(np.int32)
    return TriMesh(verts, faces)


def is_watertight(mesh: TriMesh) -> bool:
    """Every edge shared by exactly two faces with opposite orientation."""
    f = mesh.faces
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    und = np.sort(edges, axis=1)
    _, counts = np.unique(und, axis=0, return_counts=True)
    if not np.all(counts == 2):
        return False
    # orientation consistency: every directed edge appears exactly once
    _, dcounts = np.unique(edges, axis=0, return_counts=True)
    return bool(np.all(dcounts == 1))
