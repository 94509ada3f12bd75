"""Multi-camera point-cloud capture on the device (port of
autourdf_tpu.sim.capture).

Replaces the reference's render path (PyBullet OpenGL RGB-D render ->
Open3D back-projection -> merge -> FPS, reference/Sim/sim_data.py:246-367):
instead of rasterizing triangles, densely-sampled surface points are
splatted into per-camera z-buffers (scatter-min) and the points that win
visibility in at least one camera are kept — the same occlusion semantics a
depth camera gives.  Where the JAX module maps one camera with ``vmap``,
here the camera axis is written out: every camera's projection, splat and
visibility test is one batched tensor operation over ``(C, P)``.

Differences from the JAX module, by intent: the optional noise comes from a
``torch.Generator`` in place of ``jax.random`` keys (with the noise off
nothing is drawn and the clouds match); a point whose projection lies
within round-off of a pixel edge, or whose depth lies within round-off of
its pixel's visibility tolerance, can land on the other side of it in the
two packages (the tests bound these flips).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.fps import farthest_point_sample


class CameraRig(NamedTuple):
    eyes: torch.Tensor     # (C, 3) camera positions
    targets: torch.Tensor  # (C, 3) look-at points
    ups: torch.Tensor      # (C, 3)
    fov_deg: float
    near: float
    far: float


def sphere_camera_rig(
    radius: float,
    num_cameras: int,
    rng: np.random.Generator,
    cam_angle_deg: float = 20.0,
    fov_deg: float = 60.0,
    near: float = 0.1,
    far: float = 4.0,
    device: str | torch.device = "cuda",
) -> CameraRig:
    """Cameras on a sphere looking at the origin, on ``device``.

    Mirrors SimEnv._setup_cameras (sim_data.py:85-117): < 20 cameras ->
    evenly spaced azimuth at fixed elevation; >= 20 -> random azimuth and
    elevation in [0, pi/2), drawn from ``rng`` as the JAX module draws them.
    """
    dev = resolve_device(device)
    if num_cameras < 20:
        theta = np.linspace(0, 2 * np.pi, num_cameras, endpoint=False)
        phi = np.full(num_cameras, np.pi * cam_angle_deg / 180.0)
    else:
        theta = rng.random(num_cameras) * 2 * np.pi
        phi = rng.random(num_cameras) * np.pi / 2
    xs = radius * np.cos(theta) * np.cos(phi)
    ys = radius * np.sin(theta) * np.cos(phi)
    zs = radius * np.sin(phi)
    eyes = np.stack([xs, ys, zs], axis=1).astype(np.float32)
    return CameraRig(
        eyes=torch.from_numpy(eyes).to(dev),
        targets=torch.zeros((num_cameras, 3), dtype=torch.float32, device=dev),
        ups=torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(num_cameras, 1),
        fov_deg=fov_deg,
        near=near,
        far=far,
    )


def _look_at(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor):
    """World->camera rotations ``(C, 3, 3)`` and translations ``(C, 3)``."""
    fwd = target - eye
    fwd = fwd / torch.clamp_min(torch.linalg.norm(fwd, dim=-1, keepdim=True), 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.clamp_min(torch.linalg.norm(right, dim=-1, keepdim=True), 1e-12)
    true_up = torch.linalg.cross(right, fwd)
    rot = torch.stack([right, true_up, -fwd], dim=1)
    t = -(rot @ eye[..., None])[..., 0]
    return rot, t


def focal_length(fov_deg: float) -> float:
    """1 / tan(fov / 2), rounded once to float32 (computed on the host, so the
    card and the CPU use the same value; XLA's float32 tangent makes the JAX
    module's one ulp smaller at 60 degrees)."""
    return float(np.float32(1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)))


def visible_mask(
    points: torch.Tensor, rig: CameraRig, width: int, height: int,
    depth_eps: float = 1e-3, dilation: int = 1,
) -> torch.Tensor:
    """``(C, P)`` visibility of ``points (P, 3)`` in every camera of ``rig``."""
    dev = points.device
    f = torch.tensor(focal_length(rig.fov_deg), dtype=torch.float32, device=dev)
    rot, t = _look_at(rig.eyes, rig.targets, rig.ups)
    cam = points[None] @ rot.transpose(-1, -2) + t[:, None, :]   # (C, P, 3), looks down -z
    depth = -cam[..., 2]
    in_range = (depth > rig.near) & (depth < rig.far)
    inv_d = 1.0 / torch.clamp_min(depth, 1e-6)
    x_ndc = f * cam[..., 0] * inv_d
    y_ndc = f * cam[..., 1] * inv_d
    # truncation toward zero, as astype(int32): a point up to one pixel left
    # of (or above) the screen lands on column (row) 0
    u = ((x_ndc + 1.0) * 0.5 * width).to(torch.int32).long()
    v = ((1.0 - (y_ndc + 1.0) * 0.5) * height).to(torch.int32).long()
    on_screen = (u >= 0) & (u < width) & (v >= 0) & (v < height) & in_range
    d_or_inf = torch.where(on_screen, depth, torch.inf)
    sink = width * height
    zbuf = torch.full((rig.eyes.shape[0], sink + 1), torch.inf, dtype=torch.float32, device=dev)
    # Dilated splat: each point claims its (2*dilation+1)^2 neighborhood so
    # the buffer is a hole-free lower envelope even when the surface
    # sampling is sparser than the pixel grid.  A minimum is order-free.
    for du in range(-dilation, dilation + 1):
        for dv in range(-dilation, dilation + 1):
            uu = torch.clamp(u + du, 0, width - 1)
            vv = torch.clamp(v + dv, 0, height - 1)
            p = torch.where(on_screen, vv * width + uu, sink)
            zbuf.scatter_reduce_(1, p, d_or_inf, "amin", include_self=True)
    pix = torch.where(on_screen, v * width + u, sink)
    # Visibility tolerance must cover the depth gradient across the dilated
    # splat footprint: pixel_world = depth * 2*tan(fov/2)/W.
    pix_world = depth * (2.0 / (f * width))
    tol = depth * depth_eps + (dilation + 0.5) * 3.0 * pix_world
    return on_screen & (depth <= torch.gather(zbuf, 1, pix) + tol)


def capture_cloud(
    points_world: torch.Tensor,  # (P, 3) posed dense surface samples
    rig: CameraRig,
    generator: torch.Generator | None = None,
    width: int = 800,
    height: int = 800,
    num_points: int = 5000,
    pose_noise: float = 0.0,
    point_noise: float = 0.0,
    depth_eps: float = 1e-3,
    dilation: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-camera capture -> ``(num_points, 3)`` cloud + ``(P,)`` visible mask.

    Visibility union over cameras, optional global pose noise (sigma
    ``pose_noise``, the reference's scanning drift, sim_data.py:337) and
    per-point noise drawn from ``generator``, then farthest-point
    downsampling of the visible set on the device (one read of the visible
    count from the device a capture).
    """
    visible = torch.any(visible_mask(points_world, rig, width, height, depth_eps, dilation),
                        dim=0)
    noisy = points_world
    if (pose_noise > 0 or point_noise > 0) and generator is None:
        raise ValueError("capture noise needs a torch.Generator")
    if pose_noise > 0:
        noisy = noisy + torch.randn(3, generator=generator, device=noisy.device) * pose_noise
    if point_noise > 0:
        noisy = noisy + torch.randn(points_world.shape, generator=generator,
                                    device=noisy.device) * point_noise
    # FPS over the visible points only: the same picks as the masked FPS over
    # all of them (masked points never win, and the first index among equal
    # scores keeps its order), in a fraction of the work a step
    vis_idx = torch.nonzero(visible)[:, 0]
    if len(vis_idx) == 0:
        idx = farthest_point_sample(noisy, num_points, mask=visible)
    else:
        idx = vis_idx[farthest_point_sample(noisy[vis_idx], num_points)]
    return noisy[idx], visible

