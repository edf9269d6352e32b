"""Distributed pose-graph optimization: edge-sharded LM-CG over the ranks.

Port of `hfvo_tpu.parallel.dist_pose_graph` on `torch.distributed`: the
essential-graph solve after a loop closure (reference:
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:4339) with the keyframe
poses replicated and the SE(3) edge table split over the mesh's `edge`
ranks. The math is `solve.pose_graph.optimize_pose_graph` with its `reduce`
hook: each rank linearizes its edge block, and the gradient, the diagonal
blocks and each CG matvec are summed over the ranks, so every rank takes
the same steps. Collectives a solve: (3 + cg_iters) all-reduces an LM
iteration (the cost, gradient and diagonal blocks in one, the first residual
and each CG step's matvec, the trial cost), plus the identical-problem check.
"""
from __future__ import annotations

import torch

from ..solve.pose_graph import PoseGraph, optimize_pose_graph
from .mesh import Mesh, take_blocks

_EDGE_FIELDS = ("e_i", "e_j", "e_Tij", "e_weight")


def pad_graph_for_mesh(pg: PoseGraph, n_dev: int) -> PoseGraph:
    """Pad the edge table to a multiple of `n_dev` with weight-0 identity
    edges from pose 0 to itself, which contribute nothing."""
    E = pg.e_i.shape[0]
    p = -E % n_dev
    if p == 0:
        return pg
    eye = torch.eye(4, dtype=pg.e_Tij.dtype, device=pg.e_Tij.device).expand(p, 4, 4)
    return pg._replace(
        e_i=torch.cat([pg.e_i, pg.e_i.new_zeros(p)]),
        e_j=torch.cat([pg.e_j, pg.e_j.new_zeros(p)]),
        e_Tij=torch.cat([pg.e_Tij, eye]),
        e_weight=torch.cat([pg.e_weight, pg.e_weight.new_zeros(p)]),
    )


def dist_optimize_pose_graph(mesh: Mesh, pg: PoseGraph, n_iters: int = 20, cg_iters: int = 60) -> torch.Tensor:
    """Edge-sharded pose-graph solve from the same `pg` on every rank;
    returns the corrected poses (K, 4, 4), replicated
    (hfvo_tpu/parallel/dist_pose_graph.py:44-79)."""
    pg = pad_graph_for_mesh(pg, mesh.shape["edge"])
    local = PoseGraph(**take_blocks(mesh, pg._asdict(), _EDGE_FIELDS))
    return optimize_pose_graph(local, n_iters=n_iters, cg_iters=cg_iters, reduce=mesh.psum_all)
