"""The plain reference the benchmark holds the port's outputs against: plain
PyTorch and numpy, float32 with TF32 off, no kernel, graph or batching of
the port.  It imports neither ``jax`` nor the JAX package nor anything of
``autourdf_tpu_torch``."""

import torch


def full_fp32() -> None:
    """Keep float32 products in float32 (no TF32), whatever ran before."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
