"""Distributed global bundle adjustment: edge-sharded CG-Schur over the ranks.

Port of `hfvo_tpu.parallel.dist_gba` on `torch.distributed`: the post-loop
whole-map BA (reference: LoopClosing::RunGlobalBundleAdjustment,
src/LoopClosing.cc:647-653) with both edge tables (point reprojection and
line-endpoint observations) split over the mesh's `edge` ranks and the
keyframe poses and landmarks replicated. The math is
`solve.global_ba.global_bundle_adjustment` with its `reduce` hook: each rank
builds the partial normal equations and Schur matvec terms of its edge
block, and every sum is reduced over the ranks, so each rank computes the
same update up to the order of the reduction. Collectives an LM iteration:
one all-reduce of the normal equations and the cost, two a CG step (the
landmark sum and the keyframe scatter-back), one for the reduced right-hand
side, one for the back-substitution and one for the trial cost.
"""
from __future__ import annotations

import torch

from ..geometry.camera import Intrinsics
from ..solve.global_ba import GlobalBAProblem, GlobalBAResult, global_bundle_adjustment
from .mesh import Mesh, take_blocks

_EDGE_FIELDS = (
    "e_kf", "e_pt", "e_obs", "e_stereo", "e_inv_sigma2", "e_valid",
    "le_kf", "le_lm", "le_line2d", "le_inv_sigma2", "le_valid",
)


def _pad_axis(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def pad_problem_for_mesh(prob: GlobalBAProblem, n_dev: int) -> GlobalBAProblem:
    """Pad both edge tables to multiples of `n_dev` (the padding rows are
    invalid, so they contribute nothing)."""
    E = -(-prob.e_kf.shape[0] // n_dev) * n_dev
    El = -(-prob.le_kf.shape[0] // n_dev) * n_dev
    return prob._replace(**{f: _pad_axis(getattr(prob, f), E if f.startswith("e_") else El)
                            for f in _EDGE_FIELDS})


def dist_global_bundle_adjustment(
    mesh: Mesh,
    prob: GlobalBAProblem,
    intr: Intrinsics,
    n_iters: int = 10,
    cg_iters: int = 40,
) -> GlobalBAResult:
    """The whole-map BA with the edges split over `mesh`'s 'edge' ranks,
    from the same `prob` on every rank (hfvo_tpu/parallel/dist_gba.py:
    70-121). kf_T_cw, pt_X and chi2 are replicated; the per-edge inlier
    masks are gathered (global, over the padded edge tables)."""
    prob = pad_problem_for_mesh(prob, mesh.shape["edge"])
    local = GlobalBAProblem(**take_blocks(mesh, prob._asdict(), _EDGE_FIELDS))
    res = global_bundle_adjustment(local, intr, n_iters=n_iters, cg_iters=cg_iters, reduce=mesh.psum_all)
    return res._replace(e_inlier=mesh.all_gather(res.e_inlier), le_inlier=mesh.all_gather(res.le_inlier))
