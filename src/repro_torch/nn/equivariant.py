"""E(3)-equivariant building blocks for MACE and DimeNet (the counterpart
of `repro/nn/equivariant.py`): real spherical harmonics, numerically
projected Clebsch-Gordan coupling tensors and radial bases.

The host-side construction (`real_sh_np`, `_random_rotation`,
`_sh_sample_points`, `wigner_d`, `cg_tensor`, `valid_paths`) is numpy and
a copy of the JAX package's, bit for bit: for each (l1, l2 → l3) the
tensor C with C · (D_l1(R) ⊗ D_l2(R)) = D_l3(R) · C for all rotations R
is the null space of stacked (T_R − I) over a few seeded rotations, with
Wigner matrices from the polynomial harmonics, so the construction is
convention-free and self-consistent.  `real_sh`, `bessel_basis` and
`cosine_cutoff` act on tensors.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch


def real_sh_np(r: np.ndarray, l_max: int) -> Dict[int, np.ndarray]:
    """Real solid harmonics on unit vectors r [..., 3], polynomial basis."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    out = {0: np.ones(r.shape[:-1] + (1,), r.dtype)}
    if l_max >= 1:
        out[1] = np.stack([y, z, x], axis=-1)
    if l_max >= 2:
        s3 = np.sqrt(3.0)
        out[2] = np.stack([
            s3 * x * y, s3 * y * z,
            0.5 * (3 * z * z - 1.0),
            s3 * x * z,
            0.5 * s3 * (x * x - y * y)], axis=-1)
    return out


def real_sh(r: torch.Tensor, l_max: int) -> Dict[int, torch.Tensor]:
    """`real_sh_np` on a tensor of unit vectors `r [..., 3]`, in its dtype
    (the constants are float64 numbers, as numpy scalars are in JAX)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    out = {0: torch.ones(tuple(r.shape[:-1]) + (1,), dtype=r.dtype,
                         device=r.device)}
    if l_max >= 1:
        out[1] = torch.stack([y, z, x], dim=-1)
    if l_max >= 2:
        s3 = float(np.sqrt(3.0))
        out[2] = torch.stack([
            s3 * x * y, s3 * y * z,
            0.5 * (3 * z * z - 1.0),
            s3 * x * z,
            0.5 * s3 * (x * x - y * y)], dim=-1)
    return out


def _random_rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


@lru_cache(maxsize=None)
def _sh_sample_points(l_max: int) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    rng = np.random.default_rng(1234)
    pts = rng.normal(size=(64, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    sh = real_sh_np(pts, l_max)
    pinv = {l: np.linalg.pinv(sh[l]) for l in sh}
    return pts, pinv


def wigner_d(l: int, R: np.ndarray) -> np.ndarray:
    """Numeric Wigner matrix: Y_l(R r) = D_l(R) Y_l(r)."""
    if l == 0:
        return np.ones((1, 1))
    pts, pinv = _sh_sample_points(l)
    sh_rot = real_sh_np(pts @ R.T, l)[l]            # [N, 2l+1]
    return (pinv[l] @ sh_rot).T                     # [2l+1, 2l+1]


@lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, n_rotations: int = 4) -> np.ndarray:
    """Equivariant coupling tensor C [2l3+1, 2l1+1, 2l2+1] (or zeros if the
    path (l1 ⊗ l2 → l3) does not exist), unit Frobenius norm: the last
    right-singular vector of the stacked (T_R − I), where T_R(C) =
    D3(R)^{-1} C (D1(R) ⊗ D2(R)); the paths here are one-dimensional."""
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    dim = d1 * d2 * d3
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((d3, d1, d2))
    rng = np.random.default_rng(42 + 100 * l1 + 10 * l2 + l3)
    rows = []
    for _ in range(n_rotations):
        R = _random_rotation(rng)
        D1, D2, D3 = wigner_d(l1, R), wigner_d(l2, R), wigner_d(l3, R)
        T = np.kron(np.linalg.inv(D3), np.kron(D1.T, D2.T))
        rows.append(T - np.eye(dim))
    M = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(M)
    # near-zero singular values: the null space's dimension
    nullity = int(np.sum(s < 1e-8)) + (dim - s.shape[0])
    if nullity == 0:
        return np.zeros((d3, d1, d2))
    C = vt[-1].reshape(d3, d1, d2)
    return C / np.linalg.norm(C)


def valid_paths(l_max: int) -> List[Tuple[int, int, int]]:
    """All (l1, l2, l3) with a nonzero coupling, l ≤ l_max everywhere."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    if np.linalg.norm(cg_tensor(l1, l2, l3)) > 1e-6:
                        paths.append((l1, l2, l3))
    return paths


def bessel_basis(d: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Sine Bessel radial basis (DimeNet eq. 7): sqrt(2/c)·sin(nπd/c)/d,
    `[..., n]` in d's dtype."""
    dn = torch.clamp(d, min=1e-6)[..., None]
    freq = math.pi * torch.arange(1, n + 1, device=d.device, dtype=d.dtype)
    return math.sqrt(2.0 / cutoff) * torch.sin(freq * dn / cutoff) / dn


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    u = torch.clamp(d / cutoff, 0.0, 1.0)
    return 0.5 * (torch.cos(math.pi * u) + 1.0)
