"""Batched symmetric 3x3 eigendecomposition by cyclic Jacobi rotations.

Port of `hfvo_tpu.ops.sym_eig.eigh3`: 5 sweeps of the (0,1), (0,2), (1,2)
rotation schedule, then eigenvalues in ascending order with their
eigenvectors as columns. It is ported as the Jacobi routine itself and not
`torch.linalg.eigh`, because the sign of each eigenvector is part of the
result: `lines3d.fit_lines_3d` orders a 3D line's endpoints by it, and the
map lines' X0 -> X1 direction feeds the directional gate of
`search_lines_by_projection`. The rotations start from the identity, so
the signs are those of the JAX package. `eigh4`, `inv3x3` and
`inv6x6_blocked` come with the planes and keyframe-path slices.
"""
from __future__ import annotations

import torch

_PAIRS3 = ((0, 1), (0, 2), (1, 2))


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


def eigh3(A: torch.Tensor, sweeps: int = 5):
    """(..., 3, 3) symmetric -> (w (..., 3) ascending, V (..., 3, 3)) with
    V[..., i] the i-th eigenvector, as `jnp.linalg.eigh` returns them. Equal
    eigenvalues keep their index order (a stable sort), as the JAX package's
    rank one-hot does."""
    assert A.shape[-2:] == (3, 3), A.shape
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p, q in _PAIRS3:
            A, V = _jacobi_rotate(A, V, p, q)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.sort(w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V
