"""ctypes bindings to the port's native host library (``csrc/native.cpp``).

Port of autourdf_tpu.io.native.  The card owns the compute path; this
library accelerates the host-side loops the reference delegated to C++
dependencies: marching-tetrahedra mesh extraction (PyMCubes' role), binary
PLY loading (Open3D's role), and host FPS.  Everything degrades to the
pure-numpy implementations when the library cannot be built; set
``AUTOURDF_NATIVE=0`` to force the fallback.

The source is compiled with ``g++ -O3 -fPIC -shared`` at first use into
``autourdf_tpu_torch/_build/`` under a name keyed by the source's hash, so
an edited source rebuilds and a stale library is never loaded.  Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_LIB = None
_TRIED = False
_lock = threading.Lock()
build_log = ""


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libnative_{digest}.so")


def build() -> str:
    """Compile ``csrc/native.cpp`` (if not built yet); returns the .so path."""
    global build_log
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=300)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {res.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mt_run.restype = ctypes.c_void_p
    lib.mt_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.mt_num_verts.restype = ctypes.c_int64
    lib.mt_num_verts.argtypes = [ctypes.c_void_p]
    lib.mt_num_faces.restype = ctypes.c_int64
    lib.mt_num_faces.argtypes = [ctypes.c_void_p]
    lib.mt_copy.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    lib.ply_read_xyz.restype = ctypes.c_int64
    lib.ply_read_xyz.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.fps_sample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def _load():
    global _LIB, _TRIED, build_log
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("AUTOURDF_NATIVE", "1") == "0":
            return None
        try:
            _LIB = _bind(ctypes.CDLL(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_log = build_log or str(e)
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def marching_tetrahedra_native(volume: np.ndarray):
    """Returns (verts (V,3) float64 index-space, faces (F,3) int32) or None."""
    lib = _load()
    if lib is None:
        return None
    vol = np.ascontiguousarray(volume.astype(np.uint8))
    h = lib.mt_run(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        vol.shape[0], vol.shape[1], vol.shape[2],
    )
    try:
        nv = lib.mt_num_verts(h)
        nf = lib.mt_num_faces(h)
        verts = np.empty((nv, 3), np.float64)
        faces = np.empty((nf, 3), np.int32)
        if nv:
            lib.mt_copy(
                h,
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        return verts, faces
    finally:
        lib.mt_free(h)


def read_ply_native(path: str) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    n = lib.ply_read_xyz(path.encode(), None, 0)
    if n < 0:
        return None  # ascii / exotic layout: fall back to the numpy reader
    out = np.empty((n, 3), np.float32)
    got = lib.ply_read_xyz(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
    )
    return out if got == n else None


def fps_native(pts: np.ndarray, k: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty((k,), np.int32)
    lib.fps_sample(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
