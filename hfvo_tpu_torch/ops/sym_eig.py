"""Batched small symmetric eigendecompositions by cyclic Jacobi rotations,
a closed-form 3x3 inverse and a blocked 6x6 inverse.

Port of `hfvo_tpu.ops.sym_eig.eigh3` and `eigh4`: 5 (3x3) or 6 (4x4)
sweeps of the cyclic rotation schedule, then eigenvalues in ascending order
with their eigenvectors as columns. They are ported as the Jacobi routine
itself and not `torch.linalg.eigh`, because the sign of each eigenvector is
part of the result: `lines3d.fit_lines_3d` orders a 3D line's endpoints by
it, and the map lines' X0 -> X1 direction feeds the directional gate of
`search_lines_by_projection`. The rotations start from the identity, so
the signs are those of the JAX package. (`eigh4` feeds only the
triangulation's DLT null vector, which is dehomogenised and so sign-free;
it shares the routine so that both packages agree to rounding.)

`inv3x3` is the adjugate over the determinant, as in the JAX package,
which chose it on purpose for local BA's damped 3x3 landmark blocks.
`inv6x6_blocked` is the JAX package's 2x2-of-3x3 block Schur inverse on
two `inv3x3` calls; no path of either package calls it.
"""
from __future__ import annotations

import torch

_PAIRS3 = ((0, 1), (0, 2), (1, 2))
_PAIRS4 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _jacobi_rotate(A: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One Jacobi rotation zeroing A[..., p, q], applied to both sides of A
    and accumulated into V (columns)."""
    apq = A[..., p, q]
    app = A[..., p, p]
    aqq = A[..., q, q]
    # atan2(0, 0) = 0 gives the identity rotation on all-zero blocks.
    theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    A = A.clone()
    Acp, Acq = A[..., :, p].clone(), A[..., :, q].clone()
    A[..., :, p] = c * Acp - s * Acq
    A[..., :, q] = s * Acp + c * Acq
    Arp, Arq = A[..., p, :].clone(), A[..., q, :].clone()
    A[..., p, :] = c * Arp - s * Arq
    A[..., q, :] = s * Arp + c * Arq
    V = V.clone()
    Vcp, Vcq = V[..., :, p].clone(), V[..., :, q].clone()
    V[..., :, p] = c * Vcp - s * Vcq
    V[..., :, q] = s * Vcp + c * Vcq
    return A, V


def _eigh_jacobi(A: torch.Tensor, pairs, sweeps: int):
    n = A.shape[-1]
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p, q in pairs:
            A, V = _jacobi_rotate(A, V, p, q)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.sort(w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def eigh3(A: torch.Tensor, sweeps: int = 5):
    """(..., 3, 3) symmetric -> (w (..., 3) ascending, V (..., 3, 3)) with
    V[..., i] the i-th eigenvector, as `jnp.linalg.eigh` returns them. Equal
    eigenvalues keep their index order (a stable sort), as the JAX package's
    rank one-hot does."""
    assert A.shape[-2:] == (3, 3), A.shape
    return _eigh_jacobi(A, _PAIRS3, sweeps)


def eigh4(A: torch.Tensor, sweeps: int = 6):
    """(..., 4, 4) symmetric -> (w (..., 4) ascending, V (..., 4, 4)), as
    `eigh3`."""
    assert A.shape[-2:] == (4, 4), A.shape
    return _eigh_jacobi(A, _PAIRS4, sweeps)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det). Callers damp their
    blocks first, so det is bounded away from 0; a 1e-30 guard keeps masked
    identity blocks finite."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = e * i - f * h
    c12 = c * h - b * i
    c13 = b * f - c * e
    c21 = f * g - d * i
    c22 = a * i - c * g
    c23 = c * d - a * f
    c31 = d * h - e * g
    c32 = b * g - a * h
    c33 = a * e - b * d
    det = a * c11 + b * c21 + c * c31
    r = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    rows = torch.stack([
        torch.stack([c11, c12, c13], dim=-1),
        torch.stack([c21, c22, c23], dim=-1),
        torch.stack([c31, c32, c33], dim=-1),
    ], dim=-2)
    return rows * r[..., None, None]


def inv6x6_blocked(A: torch.Tensor) -> torch.Tensor:
    """Batched (..., 6, 6) inverse by the 2x2-of-3x3 block Schur complement:
    two closed-form 3x3 inverses and small matmuls. The leading 3x3 block
    and its Schur complement must be invertible, which holds for damped
    SPD blocks."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    R = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    Pi = inv3x3(P)
    W = inv3x3(S - R @ Pi @ Q)
    PiQ = Pi @ Q
    top_left = Pi + PiQ @ W @ (R @ Pi)
    top_right = -(PiQ @ W)
    bot_left = -(W @ R @ Pi)
    return torch.cat(
        [torch.cat([top_left, top_right], dim=-1), torch.cat([bot_left, W], dim=-1)], dim=-2
    )
