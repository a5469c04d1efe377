"""Quaternion / rotation utilities, xyzw convention (port of
`wtw_tpu/utils/quat.py`; the Isaac Gym convention of the reference, e.g.
quat_rotate_inverse at go1_gym/envs/base/legged_robot.py:108-110).

All functions operate on trailing-dim tensors and broadcast over leading
batch dims.
"""
from __future__ import annotations

import math

import torch


def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, xyzw."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (body->world if q is body orientation)."""
    xyz, w = q[..., :3], q[..., 3:4]
    xyz, v = torch.broadcast_tensors(xyz, v)
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^-1 (world->body)."""
    xyz, w = q[..., :3], q[..., 3:4]
    xyz, v = torch.broadcast_tensors(xyz, v)
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v - w * t + torch.linalg.cross(xyz, t, dim=-1)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """axis must be unit; angle broadcastable to axis[..., 0]."""
    half = 0.5 * angle
    s = torch.sin(half)
    axis, s = torch.broadcast_tensors(axis, s[..., None])
    return torch.cat([axis * s, torch.cos(half)[..., None].expand(
        axis.shape[:-1] + (1,))], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix R such that R @ v == quat_rotate(q, v)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """q' = exp(dt*omega/2) ⊗ q, normalized (exponential map)."""
    theta = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * dt * theta
    k = torch.where(theta > 1e-9, torch.sin(half) / theta.clamp_min(1e-9),
                    torch.full_like(theta, 0.5 * dt))
    dq = torch.cat([omega_world * k, torch.cos(half)], dim=-1)
    out = quat_mul(dq, q)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def quat_yaw(q: torch.Tensor) -> torch.Tensor:
    """Heading (yaw) angle of the quaternion."""
    ex = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    ex[..., 0] = 1.0
    fwd = quat_rotate(q, ex)
    return torch.atan2(fwd[..., 1], fwd[..., 0])


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion with only the yaw component of q (for quat_apply_yaw)."""
    half = 0.5 * quat_yaw(q)
    zero = torch.zeros_like(half)
    return torch.stack([zero, zero, torch.sin(half), torch.cos(half)], dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw of q (reference: go1_gym/utils/math_utils.py:12-17)."""
    return quat_rotate(yaw_quat(q), v)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def quat_to_euler_xyz(q: torch.Tensor):
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """(reference: go1_gym/utils/math_utils.py:20-24)"""
    return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix: skew(v) @ u == cross(v, u)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))
