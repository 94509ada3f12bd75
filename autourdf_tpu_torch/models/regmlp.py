"""Residual pose-regression MLP family (port of autourdf_tpu.models.regmlp).

One tiny MLP maps all K cluster poses to refined poses each epoch.  Four
rotation parameterizations, selected by ``mode``:

- ``"q"``   : input (K, 7)  [xyz, quat wxyz] -> residual xyz + renormalized
              residual quat (the reference default)
- ``"dq"``  : input (K, 8)  dual quaternion -> residual dual quaternion
- ``"rpy"`` : input (K, 6)  [xyz, euler XYZ] -> residual xyz + tanh-bounded
              residual euler
- ``"6d"``  : input (K, 9)  [xyz, rot6d] -> residual xyz + residual 6d

All modes share the 4-octave sin/cos encoding and the Linear(enc ->
hidden) encoder.  Weights use torch's Linear init (uniform +-1/sqrt(fan_in)
for weight and bias).

Batched over sequences: every parameter carries a leading ``S`` dimension
(one independent MLP per sequence, what ``jax.vmap`` over parameter trees
did) and the products are ``torch.baddbmm`` on ``(S, K, .)``.  Weights are
stored ``(S, in, out)``, the flax kernel layout, so :func:`params_from_jax`
only renames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import dualquat as dqlib
from ..core import rotations as R
from ..core import se3

MODES = ("q", "dq", "rpy", "6d")

_REP_DIM = {"q": 7, "dq": 8, "rpy": 6, "6d": 9}
_OUT_DIM = {"q": (3, 4), "dq": (8,), "rpy": (3, 3), "6d": (3, 6)}

# port layer name -> path in the flax tree
_FLAX_PATH = {
    "encoder": ("_Dense_0",),
    "head0_l0": ("_MLPHead_0", "_Dense_0"),
    "head0_l1": ("_MLPHead_0", "_Dense_1"),
    "head1_l0": ("_MLPHead_1", "_Dense_0"),
    "head1_l1": ("_MLPHead_1", "_Dense_1"),
}


def layer_shapes(mode: str, hidden_dim: int) -> list[tuple[str, int, int]]:
    """``(name, in, out)`` of every dense layer of a mode, in flax order."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    h = hidden_dim
    layers = [("encoder", 8 * _REP_DIM[mode], h)]
    if mode == "dq":
        return layers + [("head0_l0", h, h), ("head0_l1", h, 8)]
    out_xyz, out_rot = _OUT_DIM[mode]
    return layers + [("head0_l0", h, h // 2), ("head0_l1", h // 2, out_xyz),
                     ("head1_l0", h, h), ("head1_l1", h, out_rot)]


def sin_encoding(x: torch.Tensor) -> torch.Tensor:
    """4-octave Fourier features: [sin x, cos x, sin 2x, cos 2x, ...]."""
    feats = []
    for f in (1.0, 2.0, 4.0, 8.0):
        feats.append(torch.sin(f * x))
        feats.append(torch.cos(f * x))
    return torch.cat(feats, dim=-1)


def torch_linear_init(shape, fan_in: int, generator: torch.Generator | None = None):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — torch.nn.Linear's default."""
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def pose_forward(mode: str, p: dict[str, torch.Tensor], m: torch.Tensor) -> torch.Tensor:
    """The residual MLP on ``m (S, K, 4, 4)`` with parameters ``p``."""

    def dense(name, x):
        return torch.baddbmm(p[f"{name}_b"][:, None, :], x, p[f"{name}_w"])

    rot = se3.rot_of(m)
    t = se3.trans_of(m)
    if mode == "dq":
        rep = dqlib.from_transform(m)
        feat = F.relu(dense("encoder", sin_encoding(rep)))
        delta = dense("head0_l1", F.relu(dense("head0_l0", feat)))
        return dqlib.to_transform(rep + delta)

    if mode == "q":
        q = R.matrix_to_quat(rot)
        rep = torch.cat([t, q], dim=-1)
    elif mode == "rpy":
        e = R.matrix_to_euler(rot)
        rep = torch.cat([t, e], dim=-1)
    elif mode == "6d":
        r6 = R.matrix_to_rot6d(rot)
        rep = torch.cat([t, r6], dim=-1)
    else:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    feat = F.leaky_relu(dense("encoder", sin_encoding(rep)), 0.01)
    d_xyz = dense("head0_l1", F.leaky_relu(dense("head0_l0", feat), 0.01))
    d_rot = dense("head1_l1", F.leaky_relu(dense("head1_l0", feat), 0.01))
    if mode == "q":
        new_q = R.quat_normalize(q + d_rot, eps=1e-12)
        return se3.make_transform(R.quat_to_matrix(new_q), t + d_xyz)
    if mode == "rpy":
        return se3.make_transform(R.euler_to_matrix(e + torch.tanh(d_rot)), t + d_xyz)
    return se3.make_transform(R.rot6d_to_matrix(r6 + d_rot), t + d_xyz)


class PoseRegressor(nn.Module):
    """Residual pose MLP: (S, K, 4, 4) poses in -> (S, K, 4, 4) refined poses.

    Parameters ``<layer>_w (S, in, out)`` and ``<layer>_b (S, out)``, drawn
    on the CPU from ``generator`` (so a seed gives the same weights on any
    device) and then moved to ``device``.
    """

    def __init__(self, mode: str = "q", hidden_dim: int = 512, num_seqs: int = 1,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cpu"):
        super().__init__()
        self.mode = mode
        self.hidden_dim = hidden_dim
        self.num_seqs = num_seqs
        for name, fan_in, fan_out in layer_shapes(mode, hidden_dim):
            w = torch_linear_init((num_seqs, fan_in, fan_out), fan_in, generator)
            b = torch_linear_init((num_seqs, fan_out), fan_in, generator)
            self.register_parameter(f"{name}_w", nn.Parameter(w.to(device)))
            self.register_parameter(f"{name}_b", nn.Parameter(b.to(device)))

    def forward(self, m: torch.Tensor) -> torch.Tensor:
        return pose_forward(self.mode, dict(self.named_parameters()), m)

    # --- flat (S, P) view used by the batched trainer -------------------
    def flat_params(self, params: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        """The module's parameters, or a state dict shaped like them (e.g.
        from :func:`params_from_jax`), as one detached ``(S, P)`` tensor on
        the module's device."""
        own = dict(self.named_parameters())
        params = own if params is None else params
        dev = next(iter(own.values())).device
        return torch.cat([params[name].detach().to(dev, torch.float32).reshape(
            params[name].shape[0], -1) for name in own], dim=1)

    def unflatten(self, theta: torch.Tensor) -> dict[str, torch.Tensor]:
        """Views of a flat ``(S, P)`` tensor shaped like the parameters."""
        out, off = {}, 0
        for name, p in self.named_parameters():
            n = p[0].numel()
            out[name] = theta[:, off:off + n].view((theta.shape[0],) + p.shape[1:])
            off += n
        return out

    def forward_flat(self, theta: torch.Tensor | dict[str, torch.Tensor],
                     m: torch.Tensor) -> torch.Tensor:
        """The MLP on ``m`` with the flat ``(S, P)`` parameters ``theta``, or
        with its per-parameter tensors (:meth:`unflatten`'s dict)."""
        params = theta if isinstance(theta, dict) else self.unflatten(theta)
        return pose_forward(self.mode, params, m)


def params_from_jax(tree, mode: str) -> dict[str, torch.Tensor]:
    """Map a flax ``PoseRegressor`` parameter tree (numpy leaves) to the
    port's state dict.

    Accepts ``{"params": {...}}`` or the inner dict.  Flax names: the
    encoder is ``_Dense_0``; the heads are ``_MLPHead_{0,1}/_Dense_{0,1}``
    (``kernel (in, out)``, ``bias (out,)``).  A leading ``S`` axis (a
    per-sequence stack from ``jax.vmap(init)``) is kept; without one the
    result has ``S = 1``.  Load with ``PoseRegressor.load_state_dict``.
    """
    tree = tree.get("params", tree)
    hidden = np.asarray(tree["_Dense_0"]["kernel"]).shape[-1]
    out = {}
    for name, fan_in, fan_out in layer_shapes(mode, hidden):
        node = tree
        for key in _FLAX_PATH[name]:
            node = node[key]
        kernel = np.asarray(node["kernel"], dtype=np.float32)
        bias = np.asarray(node["bias"], dtype=np.float32)
        if kernel.ndim == 2:
            kernel, bias = kernel[None], bias[None]
        if kernel.shape[1:] != (fan_in, fan_out):
            raise ValueError(f"{name}: kernel {kernel.shape} does not fit "
                             f"mode {mode!r} ({fan_in}, {fan_out})")
        out[f"{name}_w"] = torch.from_numpy(np.array(kernel))
        out[f"{name}_b"] = torch.from_numpy(np.array(bias))
    return out


def params_to_jax(state_dict: dict[str, torch.Tensor], mode: str) -> dict:
    """The inverse of :func:`params_from_jax`: a state dict of the port's
    ``PoseRegressor`` (leading ``S`` axis) as a flax parameter tree,
    ``{"params": {"_Dense_0": {"kernel", "bias"}, "_MLPHead_0": {...}, ...}}``
    with numpy ``float32`` leaves that keep the ``S`` axis: one MLP a
    sequence, the stack ``jax.vmap(init)`` makes.  Index a leaf's first axis
    for one sequence's tree."""
    hidden = state_dict["encoder_w"].shape[-1]
    tree: dict = {}
    for name, _, _ in layer_shapes(mode, hidden):
        node = tree
        for key in _FLAX_PATH[name]:
            node = node.setdefault(key, {})
        node["kernel"] = state_dict[f"{name}_w"].detach().cpu().numpy().astype(np.float32)
        node["bias"] = state_dict[f"{name}_b"].detach().cpu().numpy().astype(np.float32)
    return {"params": tree}
