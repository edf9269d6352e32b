"""Vanishing points from 2D line segments by hypothesis voting.

Port of `hfvo_tpu.ops.vp` (reference: `getVPHypVia2Lines`,
src/Frame.cc:442; `getSphereGrids` :546; `getBestVpsHyp` :651; `line2Vps`
:708): each segment lifts to a great-circle normal on the Gaussian sphere;
512 two-line hypotheses v = n_i x n_j (a fixed numpy `RandomState(17)`
pattern over the valid lines) are refined against their loose-cone inliers
(the smallest eigenvector of the weighted normal scatter), scored by
length-weighted support, and the best orthogonal triple wins. The tracker
calls it only from its coarse Manhattan init.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import Intrinsics
from . import sym_eig

N_PAIRS = 512  # two-line hypotheses scored
# The hypotheses' line-index pairs, before the modulo by the valid count.
_RAW_PAIRS = np.random.RandomState(17).randint(0, 1 << 30, size=(N_PAIRS, 2)).astype(np.int32)


class VPResult(NamedTuple):
    vps: torch.Tensor  # (3, 3) unit VP directions in camera coordinates
    support: torch.Tensor  # (3,) supporting line counts
    line_vp: torch.Tensor  # (NL,) int64 assignment (-1 none)
    ok: torch.Tensor  # () bool: at least 2 strong orthogonal VPs


def line_normals(intr: Intrinsics, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Great-circle normals (NL, 3) of segments on the Gaussian sphere."""
    def lift(p):
        return torch.stack([(p[:, 0] - intr.cx) / intr.fx, (p[:, 1] - intr.cy) / intr.fy,
                            torch.ones_like(p[:, 0])], dim=1)

    n = torch.linalg.cross(lift(p0), lift(p1), dim=1)
    return n / (torch.linalg.norm(n, dim=1, keepdim=True) + 1e-12)


def estimate_vps(
    intr: Intrinsics,
    p0: torch.Tensor,  # (NL, 2)
    p1: torch.Tensor,
    valid: torch.Tensor,  # (NL,)
    cone_deg: float = 1.0,
) -> VPResult:
    dev = p0.device
    n = line_normals(intr, p0, p1)
    # Length-weighted votes, normalized to mean 1 over the valid lines.
    wv = torch.where(valid, torch.linalg.norm(p1 - p0, dim=1), 0.0)
    wv = wv / torch.clamp(torch.sum(wv) / torch.clamp(torch.sum(valid), min=1), min=1e-9)

    # The fixed pair pattern, drawn over the compacted valid lines.
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid slots first
    n_valid = torch.clamp(torch.sum(valid), min=1)
    idx = order[torch.from_numpy(_RAW_PAIRS).to(dev).long() % n_valid]
    v = torch.linalg.cross(n[idx[:, 0]], n[idx[:, 1]], dim=1)
    norm = torch.linalg.norm(v, dim=1, keepdim=True)
    v = v / torch.clamp(norm, min=1e-9)
    hyp_ok = (norm[:, 0] > 1e-3) & valid[idx[:, 0]] & valid[idx[:, 1]]

    # Refine each hypothesis against its loose-cone inliers: the smallest
    # eigenvector of sum(w n n^T) (the sphere-grid peak of getSphereGrids).
    th_loose = math.sin(math.radians(3.0 * cone_deg))
    supp_l = (torch.abs(v @ n.T) < th_loose) & valid[None, :]
    w_l = supp_l.float() * wv[None, :]
    M = torch.einsum("hl,li,lj->hij", w_l, n, n)
    _, evecs = sym_eig.eigh3(M + 1e-9 * torch.eye(3, device=dev))
    v = torch.where((torch.sum(supp_l, dim=1) >= 3)[:, None], evecs[:, :, 0], v)

    th = math.sin(math.radians(cone_deg))
    supp = (torch.abs(v @ n.T) < th) & valid[None, :]
    counts = torch.sum(supp * wv[None, :], dim=1) * hyp_ok

    # Best VP first; the second by the joint support of the orthogonalized
    # candidate and the completing third axis (getBestVpsHyp).
    b1 = torch.argmax(counts)
    v1 = v[b1]
    ortho2 = torch.abs(v @ v1) < 0.2588  # within 75-105 deg
    v2_cand = v - (v @ v1)[:, None] * v1[None, :]
    v2_cand = v2_cand / (torch.linalg.norm(v2_cand, dim=1, keepdim=True) + 1e-12)
    v3_cand = torch.linalg.cross(v1[None, :].expand_as(v2_cand), v2_cand, dim=1)
    c2 = torch.sum(((torch.abs(v2_cand @ n.T) < th) & valid[None, :]) * wv[None, :], dim=1)
    c3 = torch.sum(((torch.abs(v3_cand @ n.T) < th) & valid[None, :]) * wv[None, :], dim=1)
    joint = (c2 + c3) * ortho2 * hyp_ok
    b2 = torch.argmax(joint)
    vps = torch.stack([v1, v2_cand[b2], v3_cand[b2]])

    # Line assignment at the reference's 1 deg gate (Frame.h:365).
    A = torch.abs(vps @ n.T)
    line_vp = torch.where((torch.amin(A, dim=0) < th) & valid, torch.argmin(A, dim=0), -1)
    support = torch.stack([torch.sum(line_vp == k) for k in range(3)])
    ok = (counts[b1] >= 4) & (joint[b2] >= 3)
    return VPResult(vps, support, line_vp, ok)
