"""autourdf_tpu_torch — the PyTorch/CUDA port of autourdf_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout and
names.  Plain tensor code is PyTorch; the Pallas TPU kernels on the ported
path are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use and bound with ctypes (``ops/_cuda.py``).  The port
imports neither ``jax`` nor ``autourdf_tpu``: what it needs of the JAX
package's numpy-only modules it keeps as its own copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA request without a card raises, nothing falls back.
"""

import torch

# The JAX ops pin precision="highest" for their fp32 products; keep TF32
# off so fp32 matmuls and convolutions on the card stay full fp32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and no card is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
