"""Parity of the port's core math (autourdf_tpu_torch.core) with the JAX
package on the CPU.

The same seeded numpy inputs go through both; both compute in fp32 with
the same formulas, so they agree to a few ulps.  Tolerance 1e-5 absolute
(unit-scale values; XLA and PyTorch may order a 3- or 4-term sum
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from autourdf_tpu.core import dualquat as jdq
from autourdf_tpu.core import rotations as jR
from autourdf_tpu.core import se3 as jse3
from autourdf_tpu_torch.core import dualquat as tdq
from autourdf_tpu_torch.core import rotations as tR
from autourdf_tpu_torch.core import se3 as tse3

ATOL = 1e-5


def _rotations(n, seed=3):
    m = ScipyRot.random(n, random_state=np.random.RandomState(seed)).as_matrix()
    # the four Shepperd branches and the identity, 180-degree turns included
    extra = [np.eye(3)] + [ScipyRot.from_rotvec(np.pi * a).as_matrix() for a in np.eye(3)]
    return np.concatenate([m, np.stack(extra)]).astype(np.float32)


def _transforms(n, seed=4):
    rng = np.random.default_rng(seed)
    rots = _rotations(n, seed)
    T = np.tile(np.eye(4, dtype=np.float32), (len(rots), 1, 1))
    T[:, :3, :3] = rots
    T[:, :3, 3] = rng.normal(size=(len(rots), 3))
    return T


def _both(np_fn_j, np_fn_t, *args):
    j = jax.jit(np_fn_j)(*(jnp.asarray(a) for a in args))
    t = np_fn_t(*(torch.from_numpy(np.array(a)) for a in args))
    return j, t


def _close(j, t, atol=ATOL):
    js = j if isinstance(j, tuple) else (j,)
    ts = t if isinstance(t, tuple) else (t,)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)


ROT_FNS = ["matrix_to_quat", "matrix_to_euler", "matrix_to_rot6d", "matrix_to_rotvec"]


@pytest.mark.parametrize("fn", ROT_FNS)
def test_rotation_from_matrix_parity(fn):
    m = _rotations(64)
    _close(*_both(getattr(jR, fn), getattr(tR, fn), m))


@pytest.mark.parametrize("fn,dim", [("quat_to_matrix", 4), ("euler_to_matrix", 3),
                                    ("rot6d_to_matrix", 6), ("rotvec_to_matrix", 3),
                                    ("quat_to_rotvec", 4), ("rotvec_to_quat", 3),
                                    ("quat_normalize", 4), ("quat_invert", 4),
                                    ("quat_standardize", 4)])
def test_rotation_to_matrix_parity(fn, dim):
    v = np.random.default_rng(5).normal(size=(64, dim)).astype(np.float32)
    _close(*_both(getattr(jR, fn), getattr(tR, fn), v))


def test_quat_products_parity():
    rng = np.random.default_rng(6)
    a, b = (rng.normal(size=(32, 4)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(32, 3)).astype(np.float32)
    _close(*_both(jR.quat_multiply, tR.quat_multiply, a, b))
    unit = a / np.linalg.norm(a, axis=-1, keepdims=True)
    _close(*_both(jR.quat_rotate, tR.quat_rotate, unit, v))
    # arccos near +-1 turns last-bit differences of its argument into ~1e-4 rad
    r1, r2 = _rotations(16, 7), _rotations(16, 8)
    _close(*_both(jR.rotmat_geodesic_distance, tR.rotmat_geodesic_distance, r1, r2), atol=1e-3)
    rv1, rv2 = rng.normal(size=(2, 32, 3)).astype(np.float32)
    _close(*_both(jR.rotvec_geodesic_distance, tR.rotvec_geodesic_distance, rv1, rv2), atol=1e-3)


def test_matrix_to_quat_shepperd_tie_picks_first():
    # identity: q_abs_sq = (4, 0, 0, 0); a 180-degree turn about x+y has
    # the x and y candidates tied; argmax picks the first in both packages
    m = np.stack([np.eye(3), ScipyRot.from_rotvec(np.pi * np.array([1, 1, 0]) / np.sqrt(2))
                  .as_matrix()]).astype(np.float32)
    j, t = _both(jR.matrix_to_quat, tR.matrix_to_quat, m)
    _close(j, t)
    np.testing.assert_allclose(t.numpy()[0], [1, 0, 0, 0], atol=1e-7)


@pytest.mark.parametrize("fn", ["inverse", "matrix_to_xyzquat", "se3_log",
                                "screw_from_transform"])
def test_se3_parity(fn):
    T = _transforms(32)
    _close(*_both(getattr(jse3, fn), getattr(tse3, fn), T), atol=1e-4)


def test_se3_points_and_roundtrips():
    rng = np.random.default_rng(9)
    T = _transforms(8)
    pts = rng.normal(size=(len(T), 50, 3)).astype(np.float32)
    _close(*_both(jse3.transform_points, tse3.transform_points, T, pts))
    _close(*_both(jse3.compose, tse3.compose, T, T[::-1].copy()))
    xq = rng.normal(size=(16, 7)).astype(np.float32)
    _close(*_both(jse3.xyzquat_to_matrix, tse3.xyzquat_to_matrix, xq))
    xyz, rpy = rng.normal(size=(2, 16, 3)).astype(np.float32)
    _close(*_both(jse3.xyzrpy_to_matrix, tse3.xyzrpy_to_matrix, xyz, rpy))
    Tt = torch.from_numpy(T)
    np.testing.assert_allclose(tse3.compose(Tt, tse3.inverse(Tt)).numpy(),
                               np.tile(np.eye(4), (len(T), 1, 1)), atol=1e-5)
    q = rng.normal(size=(4, 30, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    j, t = _both(jse3.average_quaternions, tse3.average_quaternions, q)
    # eigenvectors are defined up to sign
    np.testing.assert_allclose(np.abs((np.asarray(j) * t.numpy()).sum(-1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("fn", ["from_transform", "to_transform_of_from", "normalize",
                                "invert", "conjugate", "multiply", "transform_points"])
def test_dualquat_parity(fn):
    rng = np.random.default_rng(10)
    T = _transforms(16)
    if fn == "from_transform":
        _close(*_both(jdq.from_transform, tdq.from_transform, T))
        return
    dq = np.asarray(jdq.from_transform(jnp.asarray(T)))
    if fn == "to_transform_of_from":
        # round trip: matrix -> dual quaternion -> matrix
        _close(*_both(jdq.to_transform, tdq.to_transform, dq))
        np.testing.assert_allclose(tdq.to_transform(torch.from_numpy(dq.copy())).numpy(), T, atol=1e-5)
    elif fn == "multiply":
        _close(*_both(jdq.multiply, tdq.multiply, dq, dq[::-1].copy()))
    elif fn == "transform_points":
        pts = rng.normal(size=(len(T), 40, 3)).astype(np.float32)
        _close(*_both(jdq.transform_points, tdq.transform_points, dq, pts))
    else:
        noisy = dq + rng.normal(scale=0.1, size=dq.shape).astype(np.float32)
        _close(*_both(getattr(jdq, fn), getattr(tdq, fn), noisy))


def test_dualquat_from_point_and_quat_trans():
    rng = np.random.default_rng(11)
    p = rng.normal(size=(8, 3)).astype(np.float32)
    _close(*_both(jdq.from_point, tdq.from_point, p))
    q = rng.normal(size=(8, 4)).astype(np.float32)
    _close(*_both(jdq.from_quat_trans, tdq.from_quat_trans, q, p))
    _close(*_both(jdq.to_quat_trans, tdq.to_quat_trans,
                  np.asarray(jdq.from_quat_trans(jnp.asarray(q), jnp.asarray(p)))))
