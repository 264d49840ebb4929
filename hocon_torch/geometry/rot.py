"""Rotation representations, batched over leading dims.

Port of ``hocon/geometry/rot.py``: Rodrigues with Taylor fallbacks near
zero, the 6D (Zhou et al.) parameterization, the log map, and 4x4 packing.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) to rotation matrices (..., 3, 3)."""
    theta_sq = torch.sum(axisang * axisang, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    sin_over = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    cos_term = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta)) / (theta_sq + _EPS * _EPS),
    )
    x, y, z = axisang[..., 0], axisang[..., 1], axisang[..., 2]
    zeros = torch.zeros_like(x)
    k = torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )
    k2 = torch.matmul(k, k)
    eye = torch.eye(3, dtype=axisang.dtype, device=axisang.device).expand(k.shape)
    return eye + sin_over[..., None, None] * k + cos_term[..., None, None] * k2


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) to a rotation matrix (..., 3, 3) by Gram-Schmidt."""
    a1 = x[..., 0:3]
    a2 = x[..., 3:6]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + _EPS)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.norm(a2p, dim=-1, keepdim=True) + _EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2).transpose(-1, -2)


def matrix_to_rodrigues(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) to axis-angle (..., 3), angle in [0, pi].

    Same two branches as the reference: the skew part with atan2 away from
    pi, and the symmetric part with sign anchoring near pi.
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    ax = torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = 0.5 * torch.linalg.norm(ax, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(
        theta < 1e-4, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t + _EPS)
    )
    aa_skew = ax * scale[..., None]

    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], -1)
    a_abs = torch.sqrt(
        torch.clamp(
            (diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), 0.0, 1.0
        )
    )
    m01 = rot[..., 0, 1] + rot[..., 1, 0]
    m02 = rot[..., 0, 2] + rot[..., 2, 0]
    m12 = rot[..., 1, 2] + rot[..., 2, 1]
    one = torch.ones_like(m01)

    def sgn(v):
        return torch.where(v >= 0, one, -one)

    a0, a1, a2 = a_abs[..., 0], a_abs[..., 1], a_abs[..., 2]
    k0 = (a0 >= a1) & (a0 >= a2)
    k1 = ~k0 & (a1 >= a2)
    s0 = torch.where(k0, one, torch.where(k1, sgn(m01), sgn(m02)))
    s1 = torch.where(k1, one, torch.where(k0, sgn(m01), sgn(m12)))
    s2 = torch.where(k0 | k1, torch.where(k0, sgn(m02), sgn(m12)), one)
    aa_pi = a_abs * torch.stack([s0, s1, s2], -1) * theta[..., None]

    near_pi = (sin_t < 1e-3) & (cos_t < 0.0)
    return torch.where(near_pi[..., None], aa_pi, aa_skew)


def with_zeros_4x4(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Pack (..., 3, 3) rotation + (..., 3) translation into (..., 4, 4)."""
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device
    ).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
