"""Sim(3) / SE(3) Lie-group library on torch tensors.

Counterpart of `splatt3r_slam_tpu/lie/sim3.py`. Storage layout is the
8-float embedding ``[tx ty tz qx qy qz qw s]`` (translation, unit
quaternion xyzw, scale); the group action is ``x' = s * R(q) @ x + t``.
Tangent vectors are 7-floats ``[tau(3), phi(3), sigma]`` applied as left
perturbations: ``retr(T, xi) = exp(xi) ∘ T``. All functions broadcast over
leading dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-6  # small-angle switch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(qi, qj):
    """Hamilton product q_i ⊗ q_j, xyzw layout."""
    xi, yi, zi, wi = qi.unbind(-1)
    xj, yj, zj, wj = qj.unbind(-1)
    x = wi * xj + xi * wj + yi * zj - zi * yj
    y = wi * yj - xi * zj + yi * wj + zi * xj
    z = wi * zj + xi * yj - yi * xj + zi * wj
    w = wi * wj - xi * xj - yi * yj - zi * zj
    return torch.stack([x, y, z, w], dim=-1)


def quat_conj(q):
    """Inverse of a unit quaternion (conjugate)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_act(q, x):
    """Rotate vector(s) x (..., 3) by unit quaternion(s) q (..., 4)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, x = torch.broadcast_tensors(qv, x)
    uv = 2.0 * _cross(qv, x)
    return x + qw * uv + _cross(qv, uv)


def quat_to_matrix(q):
    """Unit quaternion (xyzw) → 3x3 rotation matrix."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / torch.clamp((q * q).sum(-1), min=1e-12)
    rows = torch.stack(
        [
            1 - two_s * (j**2 + k**2),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i**2 + k**2),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i**2 + j**2),
        ],
        dim=-1,
    )
    return rows.reshape(q.shape[:-1] + (3, 3))


def identity(batch_shape=(), dtype=torch.float32, device="cuda"):
    """Identity Sim3 element(s), embedding [0 0 0, 0 0 0 1, 1]."""
    e = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return e.expand(tuple(batch_shape) + (8,)).clone()


def split(T):
    """(t, q, s) views of the embedding. s keeps its trailing singleton dim."""
    return T[..., 0:3], T[..., 3:7], T[..., 7:8]


def act(T, x):
    """Group action x' = s·R(q)·x + t. T: (..., 8); x: (..., 3)."""
    t, q, s = split(T)
    return s * quat_act(q, x) + t


def inverse(T):
    """Group inverse: x = (1/s)·Rᵀ·(x' − t)."""
    t, q, s = split(T)
    q_inv = quat_conj(q)
    s_inv = 1.0 / s
    t_inv = -s_inv * quat_act(q_inv, t)
    return torch.cat([t_inv, q_inv, s_inv], dim=-1)


def multiply(Ta, Tb):
    """Composition Ta ∘ Tb (act with Tb first)."""
    ta, qa, sa = split(Ta)
    tb, qb, sb = split(Tb)
    t = sa * quat_act(qa, tb) + ta
    q = quat_mul(*torch.broadcast_tensors(qa, qb))
    s = sa * sb
    t, q, s = (a.expand(q.shape[:-1] + a.shape[-1:]) for a in (t, q, s))
    return torch.cat([t, q, s], dim=-1)


def rel(Ti, Tj):
    """Relative transform T_ij = T_i⁻¹ ∘ T_j."""
    return multiply(inverse(Ti), Tj)


def normalize(T):
    """Re-normalize the quaternion part."""
    t, q, s = split(T)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([t, q, s], dim=-1)


def exp_so3(phi):
    """SO(3) exponential → quaternion."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    theta_p4 = theta_sq * theta_sq
    imag_small = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_small = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    imag_big = torch.sin(0.5 * theta) / theta
    real_big = torch.cos(0.5 * theta)
    imag = torch.where(small, imag_small, imag_big)
    real = torch.where(small, real_small, real_big)
    return torch.cat([imag * phi, real], dim=-1)


def exp(xi):
    """Sim(3) exponential map, tangent [tau, phi, sigma] → embedding.

    W = C·I + A·Φ + B·Φ² with lietorch's rxso3 coefficients; branches are
    selected with `where` over safe denominators so the unused branch never
    produces NaNs.
    """
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6:7]

    q = exp_so3(phi)
    scale = torch.exp(sigma)

    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small_theta = theta < _EPS
    small_sigma = sigma.abs() < _EPS
    one = torch.ones_like(sigma)

    theta_s = torch.where(small_theta, one, theta)
    theta_sq_s = torch.where(small_theta, one, theta_sq)
    sigma_s = torch.where(small_sigma, one, sigma)
    sigma_sq_s = sigma_s * sigma_s

    C_ss = one
    A_ss_ts = torch.full_like(sigma, 0.5)
    B_ss_ts = torch.full_like(sigma, 1.0 / 6.0)
    A_ss_tl = (1.0 - torch.cos(theta_s)) / theta_sq_s
    B_ss_tl = (theta_s - torch.sin(theta_s)) / (theta_sq_s * theta_s)

    C_sl = (scale - 1.0) / sigma_s
    A_sl_ts = ((sigma_s - 1.0) * scale + 1.0) / sigma_sq_s
    B_sl_ts = (scale * 0.5 * sigma_sq_s + scale - 1.0 - sigma_s * scale) / (
        sigma_sq_s * sigma_s
    )
    a_ = scale * torch.sin(theta_s)
    b_ = scale * torch.cos(theta_s)
    c_ = theta_sq_s + sigma_s * sigma_s
    A_sl_tl = (a_ * sigma_s + (1.0 - b_) * theta_s) / (theta_s * c_)
    B_sl_tl = (C_sl - ((b_ - 1.0) * sigma_s + a_ * theta_s) / c_) / theta_sq_s

    C = torch.where(small_sigma, C_ss, C_sl)
    A = torch.where(
        small_sigma,
        torch.where(small_theta, A_ss_ts, A_ss_tl),
        torch.where(small_theta, A_sl_ts, A_sl_tl),
    )
    B = torch.where(
        small_sigma,
        torch.where(small_theta, B_ss_ts, B_ss_tl),
        torch.where(small_theta, B_sl_ts, B_sl_tl),
    )

    phi_x_tau = _cross(phi, tau)
    phi_x2_tau = _cross(phi, phi_x_tau)
    t = C * tau + A * phi_x_tau + B * phi_x2_tau
    return torch.cat([t, q, scale], dim=-1)


def retr(T, xi):
    """Left retraction exp(xi) ∘ T."""
    return multiply(exp(xi), T)


def matrix(T):
    """4x4 homogeneous matrix [sR | t; 0 0 0 1]."""
    t, q, s = split(T)
    R = quat_to_matrix(q) * s[..., None]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(T.shape[:-1] + (1, 4), dtype=T.dtype, device=T.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def adj_inv_apply_row(T, x7):
    """Row-vector × Adj(T)⁻¹. T: (..., 8); x7: (..., 7) rows [a(3), b(3), c]."""
    t, q, s = split(T)
    a = x7[..., 0:3]
    b = x7[..., 3:6]
    c = x7[..., 6:7]
    s_inv = 1.0 / s
    Ra = quat_act(q, a)
    y0 = s_inv * Ra
    t_b = t.expand(Ra.shape)
    y1 = quat_act(q, b) + s_inv * _cross(t_b, Ra)
    y2 = c + s_inv * (t * Ra).sum(-1, keepdim=True)
    return torch.cat([y0, y1, y2], dim=-1)


def skew(x):
    """Skew-symmetric matrix [x]ₓ."""
    x0, x1, x2 = x.unbind(-1)
    o = torch.zeros_like(x0)
    rows = torch.stack([o, -x2, x1, x2, o, -x0, -x1, x0, o], dim=-1)
    return rows.reshape(x.shape[:-1] + (3, 3))


def act_jacobian(pW):
    """Jacobian of ξ ↦ exp(ξ)·pW at ξ=0: [I₃ | −[pW]ₓ | pW], (..., 3, 7)."""
    batch = pW.shape[:-1]
    eye = torch.eye(3, dtype=pW.dtype, device=pW.device).expand(batch + (3, 3))
    return torch.cat([eye, -skew(pW), pW[..., :, None]], dim=-1)


def to_se3(T):
    """Drop scale: 8-vec → 7-vec [t q]."""
    return T[..., :7]


def se3_matrix(T7):
    """SE3 7-vec [t q] → 4x4 matrix."""
    t = T7[..., 0:3]
    R = quat_to_matrix(T7[..., 3:7])
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(T7.shape[:-1] + (1, 4), dtype=T7.dtype,
                         device=T7.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
