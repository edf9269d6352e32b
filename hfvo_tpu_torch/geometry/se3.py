"""SO(3)/SE(3) utilities on torch tensors, batched over leading dims.

Port of `hfvo_tpu.geometry.se3`. Poses are 4x4 float32 matrices `T` mapping
points from the source frame to the target frame (`X_tgt = T @ X_src`); the
tracking code uses `T_cw` (world -> camera) like the reference. Twists are
[rho (translation), w (rotation)].
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sincos_coeffs(theta2: torch.Tensor):
    """(a, b, c) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), with the series
    limits below `_EPS`."""
    big = theta2 > _EPS
    t2_safe = torch.where(big, theta2, torch.ones_like(theta2))
    t_safe = torch.sqrt(t2_safe)
    a = torch.where(big, torch.sin(t_safe) / t_safe, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(t_safe)) / t2_safe, 0.5 - theta2 / 24.0)
    c = torch.where(
        big,
        (t_safe - torch.sin(t_safe)) / (t2_safe * t_safe),
        1.0 / 6.0 - theta2 / 120.0,
    )
    return a, b, c


def _eye3(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sincos_coeffs(theta2)
    W = hat(w)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), via the quaternion:
    w = 2 * atan2(|q_v|, q_w) * q_v / |q_v|."""
    q = quat_from_mat(R)  # (x, y, z, w), canonical q_w >= 0
    qv = q[..., :3]
    qw = q[..., 3]
    n = torch.linalg.norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(n, qw)
    big = n > 1e-7
    scale = torch.where(big, angle / torch.where(big, n, torch.ones_like(n)), 2.0)
    return qv * scale[..., None]


def _so3_V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3) such that exp_se3 translation = V @ rho."""
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _sincos_coeffs(theta2)
    W = hat(w)
    return _eye3(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [rho, w] (translation first) -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    t = (_so3_V(w) @ rho[..., None])[..., 0]
    return rt_to_mat(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6) [rho, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = log_so3(R)
    rho = torch.linalg.solve(_so3_V(w), t[..., None])[..., 0]
    return torch.cat([rho, w], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3): R X + t."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]


def rotate(T_or_R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply the rotation part of a pose (or a bare R) to direction vectors."""
    return torch.einsum("...ij,...j->...i", T_or_R[..., :3, :3], v)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) via SVD."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order.

    Branch-free Shepperd-style selection of the most stable of the four
    forms; `argmax` takes the first maximum like `jnp.argmax`."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4) in (w,x,y,z)
    q_wxyz = torch.take_along_dim(
        cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2
    )[..., 0, :]
    q_wxyz = q_wxyz / torch.linalg.norm(q_wxyz, dim=-1, keepdim=True)
    q_wxyz = q_wxyz * torch.where(q_wxyz[..., :1] < 0, -1.0, 1.0)
    return torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)


def mat_from_quat(q_xyzw: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    q = q_xyzw / torch.linalg.norm(q_xyzw, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4))
