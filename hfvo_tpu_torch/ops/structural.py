"""Structural line constraints: par/perp discovery + endpoint refinement.

Port of `hfvo_tpu.ops.structural`, which replaces the reference's
`Manhattan::computeStructConstrains` (src/Manhattan.cpp:107-161),
`computeStructConstInMap` (:163-214) and `Optimizer::LineOptStruct`
(src/Optimizer.cc:1480-1876): pair discovery is one masked angle matrix per
relation, and the endpoint refinement is gradient descent on the same cost
with the same schedule (2 rounds of 10 steps, lr 0.01, x1.2 on an accepted
step and x0.5 on a rejected one, a prune before each round).

The JAX package takes the cost's gradient with `jax.grad`; here it is
`torch.autograd.grad` of the same cost, written with the same primitives
(the vector norm as sqrt(sum(x * x)), `where` masks), so that a degenerate
zero-length line gives the same NaN gradient, and with it the same rejected
step, as in the JAX package.

Every function also takes a leading sequence axis. Batched, the refinement
keeps its cost, step size and accept test per sequence, and takes the
gradient of the sum of the sequences' costs, so that one sequence's step
never decides another's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class StructPairs(NamedTuple):
    par: torch.Tensor  # (NL, NL) bool, i<j upper-triangular parallel pairs
    perp: torch.Tensor  # (NL, NL) bool


def _cos_deg(deg: float) -> float:
    return float(torch.cos(torch.deg2rad(torch.tensor(deg, dtype=torch.float32))))


def discover_pairs(
    dir2d: torch.Tensor,  # (NL, 2) unit 2D segment directions
    dir3d: torch.Tensor,  # (NL, 3) unit 3D directions
    valid: torch.Tensor,  # (NL,)
    par_deg: float = 3.0,
    perp_deg: float = 87.0,
) -> StructPairs:
    """Par/perp pair masks gated in both 2D and 3D (reference thresholds)."""
    NL = dir2d.shape[-2]
    c2 = torch.abs(dir2d @ dir2d.transpose(-1, -2))
    c3 = torch.abs(dir3d @ dir3d.transpose(-1, -2))
    cos_par, cos_perp = _cos_deg(par_deg), _cos_deg(perp_deg)
    both = valid[..., :, None] & valid[..., None, :]
    upper = torch.ones((NL, NL), dtype=torch.bool, device=dir2d.device).triu(1)
    par = both & upper & (c2 > cos_par) & (c3 > cos_par)
    perp = both & upper & (c2 < cos_perp) & (c3 < cos_perp)
    return StructPairs(par, perp)


def discover_pairs_vs_map(
    dir_frame_w: torch.Tensor,  # (NL, 3) frame line dirs in world coords
    valid_frame: torch.Tensor,
    dir_map_w: torch.Tensor,  # (M, 3) map line dirs (world)
    valid_map: torch.Tensor,
    par_deg: float = 5.0,
    perp_deg: float = 85.0,
):
    """(NL, M) par/perp masks vs map lines (reference: computeStructConstInMap)."""
    c = torch.abs(dir_frame_w @ dir_map_w.transpose(-1, -2))
    both = valid_frame[..., :, None] & valid_map[..., None, :]
    par = both & (c > _cos_deg(par_deg))
    perp = both & (c < _cos_deg(perp_deg))
    return par, perp


def _directions(X0: torch.Tensor, X1: torch.Tensor) -> torch.Tensor:
    d = X1 - X0
    return d / (torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)) + 1e-9)


def line_opt_struct(
    X0: torch.Tensor,  # (NL, 3) measured endpoint
    X1: torch.Tensor,  # (NL, 3)
    valid: torch.Tensor,  # (NL,)
    par: torch.Tensor,  # (NL, NL) parallel pair mask
    perp: torch.Tensor,  # (NL, NL)
    axis_dir: torch.Tensor,  # (NL, 3) Manhattan axis per line (zeros if none)
    axis_valid: torch.Tensor,  # (NL,)
    map_dir: Optional[torch.Tensor] = None,  # (M, 3) map-line dirs, camera frame
    par_map: Optional[torch.Tensor] = None,  # (NL, M) frame-line || map-line
    perp_map: Optional[torch.Tensor] = None,  # (NL, M)
    n_iters: int = 10,
    w_struct: float = 20.0,
    w_anchor: float = 20.0,
    chi2_prune: float = 0.02,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine endpoints so constrained pairs are structurally consistent
    (LineOptStruct's schedule: prune, optimize, prune on the optimized
    geometry, optimize again; reference: src/Optimizer.cc:1480-1876).
    With `map_dir`/`par_map`/`perp_map`, frame lines are also pulled par /
    perp to fixed map-line directions. Returns (X0', X1'); invalid rows keep
    their input."""
    use_map = map_dir is not None
    zero = torch.zeros((), dtype=X0.dtype, device=X0.device)
    ax_on = axis_valid & valid

    def cost(X0v, X1v, par_m, perp_m, par_mm, perp_mm):
        """Per-sequence cost, (*B,)."""
        u = _directions(X0v, X1v)
        c = u @ u.transpose(-1, -2)
        # sin^2 for parallel/axis and cos^2 for perpendicular: quadratic in
        # the angle deviation.
        e_par = torch.where(par_m, 1.0 - c * c, zero)
        e_perp = torch.where(perp_m, c * c, zero)
        ca = torch.sum(u * axis_dir, dim=-1)
        e_axis = torch.where(ax_on, 1.0 - ca * ca, zero)
        e_anchor = torch.sum((X0v - X0) ** 2 + (X1v - X1) ** 2, dim=-1)
        total = (
            w_struct * (e_par.sum((-2, -1)) + e_perp.sum((-2, -1)) + e_axis.sum(-1))
            + w_anchor * torch.where(valid, e_anchor, zero).sum(-1)
        )
        if use_map:
            cm = u @ map_dir.transpose(-1, -2)
            total = total + w_struct * (
                torch.where(par_mm, 1.0 - cm * cm, zero).sum((-2, -1))
                + torch.where(perp_mm, cm * cm, zero).sum((-2, -1))
            )
        return total

    def run_round(X0v, X1v, masks):
        with torch.no_grad():
            cp = cost(X0v, X1v, *masks)
        lr = torch.full_like(cp, 0.01)
        for _ in range(n_iters):
            with torch.enable_grad():
                a = X0v.detach().requires_grad_(True)
                b = X1v.detach().requires_grad_(True)
                g0, g1 = torch.autograd.grad(cost(a, b, *masks).sum(), (a, b))
            with torch.no_grad():
                step = lr[..., None, None]
                n0, n1 = X0v - step * g0, X1v - step * g1
                cn = cost(n0, n1, *masks)
                better = cn < cp
                X0v = torch.where(better[..., None, None], n0, X0v)
                X1v = torch.where(better[..., None, None], n1, X1v)
                cp = torch.where(better, cn, cp)
                lr = torch.where(better, lr * 1.2, lr * 0.5)
        return X0v, X1v

    with torch.no_grad():
        # Prune pairings that are inconsistent in the measured geometry
        # (reference prunes by chi2 > 0.02 after the first round,
        # src/Optimizer.cc:1833-1851).
        u0 = _directions(X0, X1)
        c0 = u0 @ u0.transpose(-1, -2)
        par1 = par & (1.0 - torch.abs(c0) <= chi2_prune)
        perp1 = perp & (torch.abs(c0) <= chi2_prune)
        zmap = torch.zeros(X0.shape[:-1] + (1,), dtype=torch.bool, device=X0.device)
        if use_map:
            cm0 = torch.abs(u0 @ map_dir.transpose(-1, -2))
            par_m1 = par_map & (1.0 - cm0 <= chi2_prune)
            perp_m1 = perp_map & (cm0 <= chi2_prune)
        else:
            par_m1 = perp_m1 = zmap
    X0v, X1v = run_round(X0, X1, (par1, perp1, par_m1, perp_m1))
    with torch.no_grad():
        # Second prune on the optimized geometry, then the final round.
        u = _directions(X0v, X1v)
        c = u @ u.transpose(-1, -2)
        par2 = par1 & (1.0 - c * c <= chi2_prune)
        perp2 = perp1 & (c * c <= chi2_prune)
        if use_map:
            cm = torch.abs(u @ map_dir.transpose(-1, -2))
            par_m2 = par_m1 & (1.0 - cm * cm <= chi2_prune)
            perp_m2 = perp_m1 & (cm * cm <= chi2_prune)
        else:
            par_m2 = perp_m2 = zmap
    X0v, X1v = run_round(X0v, X1v, (par2, perp2, par_m2, perp_m2))
    keep = valid[..., None]
    return torch.where(keep, X0v, X0), torch.where(keep, X1v, X1)

