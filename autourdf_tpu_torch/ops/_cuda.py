"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface the first time a kernel is needed, and loaded with ctypes.  The
library lands in ``autourdf_tpu_torch/_build/`` under a name keyed by the
source's hash, so an edited source rebuilds and a stale library is never
loaded.  Nothing is built or imported when this module is imported: the
CPU tests import every module and never reach a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# Hopper only: sm_90a.  -fmad=false keeps every multiply and add rounded on
# its own (bit parity with the plain PyTorch versions); no fast-math.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}

# Kernel launch counts, one per wrapper: each adds one where it launches its
# kernel and nowhere else, so a run can show the main path went through it
# (the search kernels of knn.cu, then the geometry kernels of geom.cu).
launch_counts = {"nn_bidir": 0, "nn_min_bidir": 0, "nn": 0, "nn_bidir_acc": 0,
                 "fps": 0, "kabsch3": 0, "sym_eig3_min": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
_SIGNATURES = {
    "knn": {
        "knn_sweep_shared_bytes": ([_I, _I, _I], _I),
        "knn_sweep_constant": ([_I], _I),
        "knn_bidir_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
        "knn_light_shared_bytes": ([_I, _I, _I, _I], _I),
        "knn_min_bidir_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P], _I),
        "knn_nn_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P], _I),
        "knn_bidir_acc_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _U64,
                                  _P], _I),
    },
    "geom": {
        "geom_fps_setup": ([_P, _P, _P, _P], _I),
        "geom_fps_plan": ([_I, _P], _I),
        "geom_fps_launch": ([_P, _P, _I, _I, _P, _P, _P, _P], _I),
        "geom_cluster_barriers_launch": ([_I, _P], _I),
        "geom_kabsch3_launch": ([_P, _P, _I, _P], _I),
        "geom_sym_eig3_min_launch": ([_P, _P, _I, _P], _I),
    },
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built at first use")


def _library_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not built yet); returns the .so path."""
    src, so = _library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_logs[name] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def library(name: str = "knn") -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(fn, t: torch.Tensor, *args) -> int:
    """Call the launcher ``fn`` on ``t``'s device (the current one, or the
    tensors' device where that is another)."""
    if t.device.index is None or t.device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(t.device):
        return fn(*args)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
