"""Binary little-endian PLY point clouds in numpy: the benchmark reads the
frames and writes the frames it makes itself, with no code of the port."""

from __future__ import annotations

import os

import numpy as np

_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
          "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1", "short": "<i2",
          "ushort": "<u2", "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4"}


def read_ply(path: str) -> np.ndarray:
    """The ``(N, 3)`` float32 xyz of a binary little-endian PLY's vertices."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"not a PLY file: {path}")
    n, props, in_vertex = 0, [], False
    for line in data[:end].decode("ascii").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format" and parts[1] != "binary_little_endian":
            raise ValueError(f"{path}: format {parts[1]} is not read here")
        if parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            props.append((parts[2], _TYPES[parts[1]]))
    arr = np.frombuffer(data[end + len(b"end_header\n"):], dtype=np.dtype(props), count=n)
    return np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)


def write_ply(path: str, points: np.ndarray) -> None:
    """Write ``(N, 3)`` points as binary little-endian float32 xyz."""
    pts = np.ascontiguousarray(points, dtype="<f4")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.tobytes())


def read_sequences(seq_dirs: list[str]) -> list[list[np.ndarray]]:
    """Every frame ``<seq>/<t>/robot.ply`` of each sequence, in name order."""
    out = []
    for d in seq_dirs:
        frames = sorted(e for e in os.listdir(d) if os.path.isdir(os.path.join(d, e)))
        out.append([read_ply(os.path.join(d, t, "robot.ply")) for t in frames
                    if os.path.exists(os.path.join(d, t, "robot.ply"))])
    return out
