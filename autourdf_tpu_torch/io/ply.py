"""Minimal PLY point-cloud I/O (binary little-endian + ascii).

Copy of autourdf_tpu.io.ply without the native reader (``io/native.py``):
numpy only, kept here so the port imports nothing of the JAX package.
Writes binary f32 xyz (+ optional u8 rgb) — the same wire format Open3D
emits, so clouds interchange with the reference's data trees.
"""

from __future__ import annotations

import os

import numpy as np

_PLY_TYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("<u1", 1), "uint8": ("<u1", 1),
    "char": ("<i1", 1), "int8": ("<i1", 1),
    "short": ("<i2", 2), "ushort": ("<u2", 2),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def read_ply(path: str) -> np.ndarray:
    """Read xyz coordinates of the vertex element -> (N, 3) float32."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a ply file: {path}")
    header = data[:header_end].decode("ascii", errors="ignore").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n_vertex = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list property in vertex element unsupported")
            props.append((parts[2], parts[1]))

    names = [p[0] for p in props]
    if fmt == "ascii":
        rows = body.decode("ascii").split()
        arr = np.array(rows[: n_vertex * len(props)], dtype=np.float64).reshape(
            n_vertex, len(props)
        )
        xyz = arr[:, [names.index("x"), names.index("y"), names.index("z")]]
        return xyz.astype(np.float32)

    if fmt not in ("binary_little_endian",):
        raise ValueError(f"unsupported ply format {fmt}")
    dtype = np.dtype([(nm, _PLY_TYPES[tp][0]) for nm, tp in props])
    arr = np.frombuffer(body, dtype=dtype, count=n_vertex)
    return np.stack(
        [arr["x"], arr["y"], arr["z"]], axis=1
    ).astype(np.float32)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY; colors optional (N, 3) float in [0,1] or u8."""
    points = np.asarray(points, dtype=np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(points)
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            dtype = np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("r", "u1"), ("g", "u1"), ("b", "u1")]
            )
            rec = np.empty(n, dtype=dtype)
            rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
            rec["r"], rec["g"], rec["b"] = colors[:, 0], colors[:, 1], colors[:, 2]
            f.write(rec.tobytes())
