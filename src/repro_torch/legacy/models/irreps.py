"""Real spherical harmonics (l ≤ 2) and their coupling (Gaunt) tensors
(mirrors ``repro.legacy.models.irreps``).

NequIP needs O(3)-equivariant tensor products of irrep features, in the
real SH basis and the e3nn component order:

  l=0: 1/√(4π)
  l=1: √(3/4π)  · (y, z, x)                      (m = -1, 0, 1)
  l=2: √(15/4π) · (xy, yz, (3z²−r²)/(2√3), xz, (x²−y²)/2)

Coupling coefficients are Gaunt tensors G[l1,m1; l2,m2; l3,m3] =
∫ Y_{l1m1} Y_{l2m2} Y_{l3m3} dΩ, computed by Gauss–Legendre × trapezoid
quadrature, exact for the trig polynomials of degree ≤ 3·l_max involved.
The numpy half is the reference's own code, so ``gaunt`` gives the
reference's float32 bits; ``sh_torch`` is the runtime twin of ``sh_np``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .layers import div

L_MAX = 2


def sh_np(l: int, xyz: np.ndarray) -> np.ndarray:
    """Real SH components (..., 2l+1) for unit vectors xyz (..., 3)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if l == 0:
        return np.full(xyz.shape[:-1] + (1,), 0.5 / np.sqrt(np.pi))
    if l == 1:
        c = np.sqrt(3.0 / (4 * np.pi))
        return c * np.stack([y, z, x], axis=-1)
    if l == 2:
        c = np.sqrt(15.0 / (4 * np.pi))
        r2 = x * x + y * y + z * z
        return c * np.stack(
            [x * y, y * z, (3 * z * z - r2) / (2 * np.sqrt(3.0)),
             x * z, (x * x - y * y) / 2], axis=-1)
    raise NotImplementedError(l)


def sh_torch(l: int, xyz: torch.Tensor) -> torch.Tensor:
    """The torch twin of ``sh_np`` (keep the two in lockstep), in
    ``xyz``'s dtype, the constants rounded to it as the reference's are;
    the one divide by a constant goes through a tensor (``layers.div``),
    since CUDA multiplies by a host scalar's reciprocal."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if l == 0:
        return torch.full(xyz.shape[:-1] + (1,), float(0.5 / np.sqrt(np.pi)),
                          dtype=xyz.dtype, device=xyz.device)
    if l == 1:
        c = float(np.sqrt(3.0 / (4 * np.pi)))
        return c * torch.stack([y, z, x], dim=-1)
    if l == 2:
        c = float(np.sqrt(15.0 / (4 * np.pi)))
        r2 = x * x + y * y + z * z
        return c * torch.stack(
            [x * y, y * z, div(3 * z * z - r2, float(2 * np.sqrt(3.0))),
             x * z, (x * x - y * y) / 2], dim=-1)
    raise NotImplementedError(l)


@functools.lru_cache(maxsize=None)
def _quadrature(n_theta: int = 32, n_phi: int = 64):
    """Exact spherical quadrature for trig polys of degree ≤ 2·n_theta−1."""
    ct, wt = np.polynomial.legendre.leggauss(n_theta)  # cosθ nodes
    phi = np.arange(n_phi) * 2 * np.pi / n_phi
    wp = 2 * np.pi / n_phi
    st = np.sqrt(1 - ct**2)
    x = st[:, None] * np.cos(phi)[None, :]
    y = st[:, None] * np.sin(phi)[None, :]
    z = np.broadcast_to(ct[:, None], x.shape)
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    w = np.repeat(wt * wp, n_phi)
    return pts, w


@functools.lru_cache(maxsize=None)
def gaunt(l1: int, l2: int, l3: int) -> np.ndarray:
    """G (2l1+1, 2l2+1, 2l3+1) = ∫ Y_{l1} ⊗ Y_{l2} ⊗ Y_{l3} dΩ,
    normalized to unit Frobenius norm per block (path normalization)."""
    pts, w = _quadrature()
    y1 = sh_np(l1, pts)
    y2 = sh_np(l2, pts)
    y3 = sh_np(l3, pts)
    G = np.einsum("ni,nj,nk,n->ijk", y1, y2, y3, w)
    norm = np.linalg.norm(G)
    if norm < 1e-10:
        return np.zeros_like(G)
    return (G / norm).astype(np.float32)


def allowed_paths(l_max: int = L_MAX):
    """All (l_in, l_filter, l_out) with nonzero Gaunt coupling, l ≤ l_max."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if (l1 + l2 + l3) % 2 == 0:  # parity (SH of r̂ are even basis)
                    if np.linalg.norm(gaunt(l1, l2, l3)) > 1e-8:
                        paths.append((l1, l2, l3))
    return paths


def wigner_d_numeric(l: int, R: np.ndarray) -> np.ndarray:
    """Real-basis Wigner-D for rotation R, solved numerically from
    Y_l(R r̂) = D_l(R) Y_l(r̂) over random unit vectors (tests only)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(8 * (2 * l + 1), 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    A = sh_np(l, pts)                 # (N, 2l+1)
    B = sh_np(l, pts @ R.T)           # (N, 2l+1)
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T  # rows: output components
