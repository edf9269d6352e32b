"""Distributed local bundle adjustment over the ranks: the full problem.

Port of `hfvo_tpu.parallel.dist_ba` on `torch.distributed`. The landmarks
(and their edges) are placed in per-rank blocks, and each rank owns its
landmark block end to end, so

- Hll, U and bl need no communication (all edges of a landmark live with it);
- the pose blocks Hpp, bp, the reduced camera system
  S = Hpp - sum_p U_p A_p U_p^T and its right-hand side are partial sums,
  reduced by one all-reduce an LM iteration;
- every rank solves the same small (6K, 6K) system, then back-substitutes
  only its own landmarks and axis-pair blocks.

Every edge family of `solve.ba.BAProblem` is sharded: line-endpoint edges,
per-line Manhattan axis pairs (paired 6-dof landmark blocks, kept on one
rank), cross-line par/perp edges and the per-keyframe axis anchors
(replicated, added to the pose system after the reduction). The residual and
Jacobian math is the single-device solver's (`solve.ba.point_edge_terms`
etc.), so both descend the same objective.

A line's two endpoint rows sit in one rank's block (`shard_ba_problem` packs
pairs first), so axis-pair blocks stay on one rank. A cross-line edge couples
two lines that may live on different ranks: it is materialized twice, once
on each line's owner with that line's one-sided Hessian and gradient (the
single-device solver's), and its chi2 is halved so the reduced total
matches. The remote endpoints come from the landmark table, gathered once an
LM iteration.

`shard_ba_problem` and its helpers are host numpy, copied from the JAX
package with its stable sorts, so the blocks and `new_of_old` are the JAX
package's. Every rank builds the same blocked problem from the same host
problem and keeps its own block (`parallel.multihost.globalize_sharded_ba`,
which checks that the ranks' problems are identical). Collectives a solve:
per LM iteration one gather of the landmark table, one all-reduce of the
Schur partial sums and the cost, one of the trial cost and one MIN of the
finite flag; then one gather of the inlier masks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..ops import sym_eig
from ..ops.batch import resolve_device
from ..solve.ba import (
    _CHI2_LINE,
    _CHI2_MONO,
    _CHI2_STEREO,
    _N_ITERS1,
    _N_ITERS2,
    BAProblem,
    _jtwj,
    _jtwr,
    _robust,
    axis_anchor_terms_x,
    line_axis_terms_x,
    line_edge_terms,
    line_pair_terms_x,
    point_edge_terms,
)
from .mesh import Mesh


class ShardedBA(NamedTuple):
    """Per-rank-blocked BA problem, host numpy. Leading axes of the edge and
    landmark tables are concatenations of ndev equal blocks; landmark
    indices are LOCAL to the owning block except ll_sb / ll_eb, which are
    GLOBAL (they may point into a remote block and are resolved against the
    gathered landmark table). Index tables are int32, as the JAX
    package's."""

    kf_T_cw: np.ndarray  # (K, 4, 4) replicated
    kf_free: np.ndarray  # (K,)
    pt_X: np.ndarray  # (P, 3) blocked, PERMUTED order
    pt_valid: np.ndarray  # (P,)
    # Point (+ stereo) reprojection edges, blocked by landmark owner.
    e_kf: np.ndarray
    e_pt: np.ndarray  # local
    e_obs: np.ndarray
    e_stereo: np.ndarray
    e_inv_sigma2: np.ndarray
    e_valid: np.ndarray
    # Line-endpoint edges, blocked by endpoint owner.
    le_kf: np.ndarray
    le_lm: np.ndarray  # local
    le_line2d: np.ndarray
    le_inv_sigma2: np.ndarray
    le_valid: np.ndarray
    # Per-line Manhattan axis pairs (paired 6-dof Schur blocks), rank-local.
    lp_s: np.ndarray  # local
    lp_e: np.ndarray  # local
    lp_axis: np.ndarray
    lp_w: np.ndarray
    lp_valid: np.ndarray
    # Cross-line par/perp edges, duplicated once per side; a-side local.
    ll_sa: np.ndarray  # local (this rank's line)
    ll_ea: np.ndarray  # local
    ll_sb: np.ndarray  # GLOBAL (possibly remote line)
    ll_eb: np.ndarray  # GLOBAL
    ll_kind: np.ndarray
    ll_w: np.ndarray
    ll_valid: np.ndarray
    # Per-KF Manhattan axis anchors, replicated (zero weight = absent).
    kf_axes_c: np.ndarray  # (K, 3, 3)
    kf_axes_w: np.ndarray  # (3, 3)
    kf_w_axis: np.ndarray  # (K, 3)
    # new_of_old[old_row] = permuted row; `unshard_points` maps solved
    # landmarks back to problem order.
    new_of_old: np.ndarray
    n_dropped: int  # edges dropped by per-rank capacity (0 in practice)


# Fields blocked over the 'edge' ranks and fields every rank holds whole
# (hfvo_tpu/parallel/multihost.py:40-47).
EDGE_FIELDS = (
    "pt_X", "pt_valid",
    "e_kf", "e_pt", "e_obs", "e_stereo", "e_inv_sigma2", "e_valid",
    "le_kf", "le_lm", "le_line2d", "le_inv_sigma2", "le_valid",
    "lp_s", "lp_e", "lp_axis", "lp_w", "lp_valid",
    "ll_sa", "ll_ea", "ll_sb", "ll_eb", "ll_kind", "ll_w", "ll_valid",
)
REPL_FIELDS = ("kf_T_cw", "kf_free", "kf_axes_c", "kf_axes_w", "kf_w_axis")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def unshard_points(sp: ShardedBA, pt_X) -> np.ndarray:
    """Map the solver's (permuted) landmark table back to the original
    BAProblem row order."""
    return _np(pt_X)[sp.new_of_old]


def _derive_pairs(prob: BAProblem) -> np.ndarray:
    """Endpoint-row pairs that must be co-located: from the axis-pair table
    and both sides of every cross-line edge."""
    pairs = []
    if prob.lp_s is not None:
        v = _np(prob.lp_valid)
        pairs.append(np.stack([_np(prob.lp_s)[v], _np(prob.lp_e)[v]], 1))
    if prob.ll_sa is not None:
        v = _np(prob.ll_valid)
        pairs.append(np.stack([_np(prob.ll_sa)[v], _np(prob.ll_ea)[v]], 1))
        pairs.append(np.stack([_np(prob.ll_sb)[v], _np(prob.ll_eb)[v]], 1))
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.unique(np.concatenate(pairs, 0).astype(np.int64), axis=0)


def shard_ba_problem(prob: BAProblem, ndev: int, pair_rows: np.ndarray | None = None) -> ShardedBA:
    """Pack landmarks group-wise into ndev blocks (line endpoint pairs
    co-located), localize edge indices, and block every edge family
    (hfvo_tpu/parallel/dist_ba.py:106-327). `prob` may hold numpy arrays or
    tensors."""
    P_cap = prob.pt_X.shape[0]
    if P_cap % ndev:
        raise ValueError(f"landmark capacity {P_cap} must divide over {ndev} ranks")
    blk = P_cap // ndev
    if pair_rows is None:
        pair_rows = _derive_pairs(prob)
    pair_rows = np.asarray(pair_rows, np.int64).reshape(-1, 2)

    e_pt = _np(prob.e_pt)
    e_valid = _np(prob.e_valid)
    le_lm = _np(prob.le_lm)
    le_valid = _np(prob.le_valid)

    # Edge count per row for load balance.
    cnt = np.zeros(P_cap, np.int64)
    np.add.at(cnt, e_pt[e_valid], 1)
    np.add.at(cnt, le_lm[le_valid], 1)

    in_pair = np.zeros(P_cap, bool)
    in_pair[pair_rows.reshape(-1)] = True
    singles = np.nonzero(~in_pair)[0]

    # Greedy: pairs first (two rows in one block), heaviest first, to the
    # least-loaded rank with room.
    load = np.zeros(ndev, np.int64)
    room = np.full(ndev, blk, np.int64)
    next_free = np.arange(ndev, dtype=np.int64) * blk
    new_of_old = np.full(P_cap, -1, np.int64)

    def place(rows, cost):
        order = np.argsort(load, kind="stable")
        for d in order:
            if room[d] >= len(rows):
                for r in rows:
                    new_of_old[r] = next_free[d]
                    next_free[d] += 1
                room[d] -= len(rows)
                load[d] += cost
                return
        raise RuntimeError("no rank's block has room (fragmentation)")

    pcost = cnt[pair_rows[:, 0]] + cnt[pair_rows[:, 1]]
    for i in np.argsort(-pcost, kind="stable"):
        place(pair_rows[i], pcost[i])
    scost = cnt[singles]
    for i in np.argsort(-scost, kind="stable"):
        place(singles[i: i + 1], scost[i])
    if not (new_of_old >= 0).all():
        raise RuntimeError("shard_ba_problem left landmark rows unplaced")

    def owner(rows):
        return new_of_old[rows] // blk

    def local(rows):
        return (new_of_old[rows] % blk).astype(np.int32)

    # Permute the landmark table.
    old_of_new = np.empty(P_cap, np.int64)
    old_of_new[new_of_old] = np.arange(P_cap)
    pt_X = _np(prob.pt_X)[old_of_new]
    pt_valid = _np(prob.pt_valid)[old_of_new]

    dropped = 0

    def block_family(dev_of, fields, cap):
        """Pack (dev_of (N,), {name: (N, ...)}) into (ndev * per_dev, ...)."""
        nonlocal dropped
        # Slack over the even split: the greedy balance is within the largest
        # group's edge count, so a 25 % + constant margin makes a drop a true
        # overload rather than a rounding artifact.
        per_dev = -(-cap // ndev) + max(8, cap // (4 * ndev))
        out = {k: np.zeros((ndev, per_dev) + v.shape[1:], v.dtype) for k, v in fields.items()}
        valid_b = np.zeros((ndev, per_dev), bool)
        for d in range(ndev):
            sel = np.nonzero(dev_of == d)[0]
            if len(sel) > per_dev:
                dropped += len(sel) - per_dev
                sel = sel[:per_dev]
            n = len(sel)
            for k, v in fields.items():
                out[k][d, :n] = v[sel]
            valid_b[d, :n] = True
        return {k: v.reshape((-1,) + v.shape[2:]) for k, v in out.items()}, valid_b.reshape(-1)

    # Point edges.
    ei = np.nonzero(e_valid)[0]
    pe, pe_valid = block_family(
        owner(e_pt[ei]),
        dict(
            e_kf=_np(prob.e_kf)[ei].astype(np.int32),
            e_pt=local(e_pt[ei]),
            e_obs=_np(prob.e_obs)[ei],
            e_stereo=_np(prob.e_stereo)[ei],
            e_is=_np(prob.e_inv_sigma2)[ei],
        ),
        prob.e_kf.shape[0],
    )
    # Line-endpoint edges.
    li = np.nonzero(le_valid)[0]
    le, le_valid_b = block_family(
        owner(le_lm[li]),
        dict(
            le_kf=_np(prob.le_kf)[li].astype(np.int32),
            le_lm=local(le_lm[li]),
            le_line2d=_np(prob.le_line2d)[li],
            le_is=_np(prob.le_inv_sigma2)[li],
        ),
        max(prob.le_kf.shape[0], ndev),
    )
    # Axis pairs (rank-local by construction).
    if prob.lp_s is not None:
        lv = np.nonzero(_np(prob.lp_valid))[0]
        lp_s = _np(prob.lp_s)[lv]
        lp, lp_valid_b = block_family(
            owner(lp_s),
            dict(
                lp_s=local(lp_s),
                lp_e=local(_np(prob.lp_e)[lv]),
                lp_axis=_np(prob.lp_axis)[lv],
                lp_w=_np(prob.lp_w)[lv],
            ),
            max(prob.lp_s.shape[0], ndev),
        )
    else:
        lp = dict(lp_s=np.zeros((ndev,), np.int32), lp_e=np.zeros((ndev,), np.int32),
                  lp_axis=np.zeros((ndev, 3), np.float32), lp_w=np.zeros((ndev,), np.float32))
        lp_valid_b = np.zeros((ndev,), bool)
    # Cross-line edges: one copy per side (swapped roles on the b side).
    if prob.ll_sa is not None:
        lv = np.nonzero(_np(prob.ll_valid))[0]
        sa, ea = _np(prob.ll_sa)[lv], _np(prob.ll_ea)[lv]
        sb, eb = _np(prob.ll_sb)[lv], _np(prob.ll_eb)[lv]
        kind = _np(prob.ll_kind)[lv].astype(np.int32)
        w = _np(prob.ll_w)[lv]
        ll, ll_valid_b = block_family(
            np.concatenate([owner(sa), owner(sb)]),
            dict(
                ll_sa=np.concatenate([local(sa), local(sb)]),
                ll_ea=np.concatenate([local(ea), local(eb)]),
                ll_sb=np.concatenate([new_of_old[sb], new_of_old[sa]]).astype(np.int32),
                ll_eb=np.concatenate([new_of_old[eb], new_of_old[ea]]).astype(np.int32),
                ll_kind=np.concatenate([kind, kind]),
                ll_w=np.concatenate([w, w]),
            ),
            max(2 * prob.ll_sa.shape[0], ndev),
        )
    else:
        ll = {k: np.zeros((ndev,), np.int32) for k in ("ll_sa", "ll_ea", "ll_sb", "ll_eb", "ll_kind")}
        ll["ll_w"] = np.zeros((ndev,), np.float32)
        ll_valid_b = np.zeros((ndev,), bool)

    K = prob.kf_T_cw.shape[0]
    if prob.kf_axes_c is not None:
        axes_c, axes_w, w_axis = _np(prob.kf_axes_c), _np(prob.kf_axes_w), _np(prob.kf_w_axis)
    else:
        axes_c = np.zeros((K, 3, 3), np.float32)
        axes_w = np.eye(3, dtype=np.float32)
        w_axis = np.zeros((K, 3), np.float32)

    return ShardedBA(
        kf_T_cw=_np(prob.kf_T_cw), kf_free=_np(prob.kf_free),
        pt_X=pt_X, pt_valid=pt_valid,
        e_kf=pe["e_kf"], e_pt=pe["e_pt"], e_obs=pe["e_obs"],
        e_stereo=pe["e_stereo"], e_inv_sigma2=pe["e_is"], e_valid=pe_valid,
        le_kf=le["le_kf"], le_lm=le["le_lm"], le_line2d=le["le_line2d"],
        le_inv_sigma2=le["le_is"], le_valid=le_valid_b,
        lp_s=lp["lp_s"], lp_e=lp["lp_e"], lp_axis=lp["lp_axis"],
        lp_w=lp["lp_w"], lp_valid=lp_valid_b,
        ll_sa=ll["ll_sa"], ll_ea=ll["ll_ea"], ll_sb=ll["ll_sb"],
        ll_eb=ll["ll_eb"], ll_kind=ll["ll_kind"], ll_w=ll["ll_w"],
        ll_valid=ll_valid_b,
        kf_axes_c=axes_c, kf_axes_w=axes_w, kf_w_axis=w_axis,
        new_of_old=new_of_old,
        n_dropped=dropped,
    )


def _scatter(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return vals.new_zeros((n,) + tuple(vals.shape[1:])).index_add_(0, idx, vals)


def dist_local_bundle_adjustment(mesh: Mesh, sp: ShardedBA, intr: Intrinsics, n_iters1: int = _N_ITERS1,
                                 n_iters2: int = _N_ITERS2, chi2_mono: float = _CHI2_MONO,
                                 chi2_stereo: float = _CHI2_STEREO, chi2_line: float = _CHI2_LINE,
                                 device="cuda"):
    """The two-stage BA (5 robust LM iterations, the inlier re-gate, 10
    plain ones) over the full edge set, split over `mesh`'s 'edge' ranks
    (hfvo_tpu/parallel/dist_ba.py:330-608). `sp` is the blocked problem every
    rank built (this rank keeps its block) or this rank's part from
    `multihost.globalize_sharded_ba`. Returns (kf_T_cw (K, 4, 4), pt_X (P, 3)
    in the PERMUTED order (use `unshard_points`), e_inlier, le_inlier), every
    one whole and the same on every rank, the masks in the blocked edge order
    of `sp`, on `device`."""
    from .multihost import globalize_sharded_ba

    device = resolve_device(device)
    if sp.pt_X.shape[0] == len(sp.new_of_old):
        sp = globalize_sharded_ba(sp, mesh, device)
    else:
        sp = sp._replace(**{f: torch.as_tensor(getattr(sp, f), device=device) for f in EDGE_FIELDS + REPL_FIELDS})
    dev = sp.pt_X.device
    ix = {f: getattr(sp, f).long() for f in ("e_kf", "e_pt", "le_kf", "le_lm", "lp_s", "lp_e",
                                               "ll_sa", "ll_ea", "ll_sb", "ll_eb")}
    e_kf, e_pt, le_kf, le_lm = ix["e_kf"], ix["e_pt"], ix["le_kf"], ix["le_lm"]
    lp_s, lp_e, lp_va, lp_w = ix["lp_s"], ix["lp_e"], sp.lp_valid, sp.lp_w
    kf_free = sp.kf_free
    K, Pl = sp.kf_T_cw.shape[0], sp.pt_X.shape[0]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    th_e = torch.where(sp.e_stereo, f32(chi2_stereo), f32(chi2_mono))
    delta_e = torch.sqrt(th_e)
    delta_l = torch.sqrt(f32(chi2_line))
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)

    def pt_terms(kf_T, pt_X):
        return point_edge_terms(kf_T, pt_X, e_kf, e_pt, sp.e_obs, sp.e_stereo, sp.e_inv_sigma2, intr)

    def ln_terms(kf_T, pt_X):
        return line_edge_terms(kf_T, pt_X, le_kf, le_lm, sp.le_line2d, sp.le_inv_sigma2, intr)

    def lp_terms(pt_X):
        return line_axis_terms_x(pt_X[lp_s], pt_X[lp_e], sp.lp_axis, lp_w, lp_va)

    def ll_terms(pt_X, pt_full):
        return line_pair_terms_x(pt_X[ix["ll_sa"]], pt_X[ix["ll_ea"]], pt_full[ix["ll_sb"]],
                                 pt_full[ix["ll_eb"]], sp.ll_kind, sp.ll_w, sp.ll_valid)

    def anchor_blocks(kf_T):
        r_ax, J_ax = axis_anchor_terms_x(kf_T, sp.kf_axes_c, sp.kf_axes_w)
        H = kf_T.new_zeros((K, 6, 6))
        H[:, 3:, 3:] = torch.einsum("kaci,ka,kacj->kij", J_ax, sp.kf_w_axis, J_ax)
        b = kf_T.new_zeros((K, 6))
        b[:, 3:] = torch.einsum("kaci,kac->ki", J_ax, sp.kf_w_axis[:, :, None] * r_ax)
        return H, b, torch.sum(sp.kf_w_axis * torch.sum(r_ax * r_ax, dim=-1))

    def masked_sum(on, chi2):
        return torch.sum(torch.where(on, chi2, torch.zeros_like(chi2)))

    def chi2_part(kf_T, pt_X, pt_full, e_active, le_active):
        """This rank's share of the cost (without the replicated anchors)."""
        *_, chi2, okd = pt_terms(kf_T, pt_X)
        part = masked_sum(e_active & okd, chi2)
        *_, chi2l, okdl = ln_terms(kf_T, pt_X)
        part = part + masked_sum(le_active & okdl, chi2l)
        part = part + torch.sum(lp_terms(pt_X)[3])
        return part + 0.5 * torch.sum(ll_terms(pt_X, pt_full)[4])  # duplicated per side

    # Landmarks in a line-axis pair leave the 3x3 path for the 6x6 one.
    in_pair = _scatter(Pl, lp_s, lp_va.float()).index_add_(0, lp_e, lp_va.float()) > 0

    def lm_stage(kf_T, pt_X, pt_full, e_active, le_active, n_iters, robust):
        lam = f32(1e-4)
        for _ in range(n_iters):
            # ---- this rank's blocks (solve.ba._build_blocks).
            r, Jp, Jx, comp, chi2, okd = pt_terms(kf_T, pt_X)
            w = torch.where(e_active & okd, sp.e_inv_sigma2, torch.zeros_like(chi2))
            if robust:
                w = _robust(w, chi2, delta_e)
            Wc = w[:, None] * comp
            Hpp = _scatter(K, e_kf, _jtwj(Jp, Wc, Jp))
            bp = _scatter(K, e_kf, _jtwr(Jp, Wc * r))
            Hll = _scatter(Pl, e_pt, _jtwj(Jx, Wc, Jx))
            U = _scatter(Pl * K, e_pt * K + e_kf, _jtwj(Jp, Wc, Jx))
            bl = _scatter(Pl, e_pt, _jtwr(Jx, Wc * r))
            part = masked_sum(e_active & okd, chi2)

            rl, Jpl, Jxl, chi2l, okdl = ln_terms(kf_T, pt_X)
            wl = torch.where(le_active & okdl, sp.le_inv_sigma2, torch.zeros_like(chi2l))
            if robust:
                wl = _robust(wl, chi2l, delta_l)
            Wl = wl[:, None]
            Hpp.index_add_(0, le_kf, _jtwj(Jpl, Wl, Jpl))
            Hll.index_add_(0, le_lm, _jtwj(Jxl, Wl, Jxl))
            U.index_add_(0, le_lm * K + le_kf, _jtwj(Jpl, Wl, Jxl))
            bp.index_add_(0, le_kf, _jtwr(Jpl, Wl * rl))
            bl.index_add_(0, le_lm, _jtwr(Jxl, Wl * rl))
            part = part + masked_sum(le_active & okdl, chi2l)
            U = U.view(Pl, K, 6, 3)

            # Cross-line edges: this rank's (a-)side contributions only.
            r_ll, J_ea, _, w_ll, chi2_ll = ll_terms(pt_X, pt_full)
            HJa = torch.einsum("lab,l,lac->lbc", J_ea, w_ll, J_ea)
            g_a = torch.einsum("lab,la->lb", J_ea, w_ll[:, None] * r_ll)
            Hll.index_add_(0, ix["ll_ea"], HJa).index_add_(0, ix["ll_sa"], HJa)
            bl.index_add_(0, ix["ll_ea"], g_a).index_add_(0, ix["ll_sa"], -g_a)
            part = part + 0.5 * torch.sum(chi2_ll)

            # Axis pairs -> paired 6-dof blocks (rank-local).
            r_lp, Je, w_lp, chi2_lp = lp_terms(pt_X)
            HJ = torch.einsum("lab,l,lcb->lac", Je, w_lp, Je)
            Hll.index_add_(0, lp_s, HJ).index_add_(0, lp_e, HJ)
            Hx = -HJ
            g_e = torch.einsum("lab,la->lb", Je, w_lp[:, None] * r_lp)
            bl.index_add_(0, lp_e, g_e).index_add_(0, lp_s, -g_e)
            part = part + torch.sum(chi2_lp)

            # ---- Schur partial sums (solve.ba._schur_solve), isotropic
            # per-block damping of the landmark blocks.
            dmax = torch.diagonal(Hll, dim1=1, dim2=2).amax(dim=-1)
            Hll_d = Hll + lam * torch.clamp(dmax, min=1e-6)[:, None, None] * eye3
            observed = torch.abs(Hll).sum(dim=(1, 2)) > 1e-9
            Hll_d = torch.where(observed[:, None, None], Hll_d, eye3)
            A = sym_eig.inv3x3(Hll_d)
            A = torch.where(in_pair[:, None, None], torch.zeros_like(A), A)
            T1 = U @ A[:, None]
            S_part = -torch.einsum("pkac,pmdc->kmad", T1, U)
            b_part = -torch.einsum("pkac,pc->ka", T1, bl)

            H6 = torch.cat([
                torch.cat([Hll_d[lp_s], Hx], dim=-1),
                torch.cat([Hx.transpose(1, 2), Hll_d[lp_e]], dim=-1),
            ], dim=-2)
            pair_obs = lp_va & (observed[lp_s] | observed[lp_e] | (lp_w > 0))
            H6 = torch.where(pair_obs[:, None, None], H6, eye6)
            A6 = torch.linalg.inv_ex(H6).inverse
            A6 = torch.where(pair_obs[:, None, None], A6, torch.zeros_like(A6))
            U6 = torch.cat([U[lp_s], U[lp_e]], dim=-1)
            bl6 = torch.cat([bl[lp_s], bl[lp_e]], dim=-1)
            T16 = U6 @ A6[:, None]
            S_part = S_part - torch.einsum("lkac,lmdc->kmad", T16, U6)
            b_part = b_part - torch.einsum("lkac,lc->ka", T16, bl6)

            # One all-reduce of the pose-sized sums and the cost.
            Hpp, bp, S, b_part, part = mesh.psum_all(Hpp, bp, S_part, b_part, part)
            H_ax, b_ax, chi2_ax = anchor_blocks(kf_T)
            Hpp, chi2_cur = Hpp + H_ax, part + chi2_ax
            b_red = bp + b_ax + b_part

            damp = lam * torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
            kk = torch.arange(K, device=dev)
            S[kk, kk] += Hpp + torch.diag_embed(damp)
            S = torch.where((kf_free[:, None] & kf_free[None, :])[:, :, None, None], S, torch.zeros_like(S))
            S[kk, kk] += (~kf_free).float()[:, None, None] * eye6
            b_red = torch.where(kf_free[:, None], b_red, torch.zeros_like(b_red))
            S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K) + 1e-8 * torch.eye(6 * K, device=dev)
            dpose = -torch.linalg.solve_ex(S_dense, b_red.reshape(-1, 1)).result.reshape(K, 6)
            dpose = torch.where(kf_free[:, None], dpose, torch.zeros_like(dpose))

            # Back-substitute this rank's landmarks only.
            rhs = bl + torch.einsum("pkab,ka->pb", U, dpose)
            dpt = -(A @ rhs[..., None])[..., 0]
            dpt = torch.where((observed & ~in_pair)[:, None], dpt, torch.zeros_like(dpt))
            rhs6 = bl6 + torch.einsum("lkab,ka->lb", U6, dpose)
            d6 = -(A6 @ rhs6[..., None])[..., 0]
            d6 = torch.where(pair_obs[:, None], d6, torch.zeros_like(d6))
            dpt = dpt.index_add(0, lp_s, d6[:, :3]).index_add(0, lp_e, d6[:, 3:])

            kf_T_new = se3.exp_se3(dpose) @ kf_T
            pt_X_new = pt_X + dpt
            pt_full_new = mesh.all_gather(pt_X_new)
            chi2_new = mesh.psum(chi2_part(kf_T_new, pt_X_new, pt_full_new, e_active, le_active)) \
                + anchor_blocks(kf_T_new)[2]
            finite = mesh.pmin(torch.isfinite(kf_T_new).all() & torch.isfinite(pt_X_new).all())
            accept = (chi2_new < chi2_cur) & finite
            kf_T = torch.where(accept, kf_T_new, kf_T)
            pt_X = torch.where(accept, pt_X_new, pt_X)
            pt_full = torch.where(accept, pt_full_new, pt_full)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 5.0, max=1e5))
        return kf_T, pt_X, pt_full

    e_active = sp.e_valid & sp.pt_valid[e_pt]
    le_active = sp.le_valid & sp.pt_valid[le_lm]
    kf_T, pt_X, pt_full = lm_stage(sp.kf_T_cw, sp.pt_X, mesh.all_gather(sp.pt_X), e_active, le_active,
                                   n_iters1, True)
    *_, chi2, okd = pt_terms(kf_T, pt_X)
    e_active = e_active & (chi2 <= th_e) & okd
    *_, chi2l, okdl = ln_terms(kf_T, pt_X)
    le_active = le_active & (chi2l <= chi2_line) & okdl
    kf_T, pt_X, pt_full = lm_stage(kf_T, pt_X, pt_full, e_active, le_active, n_iters2, False)
    *_, chi2, okd = pt_terms(kf_T, pt_X)
    e_inlier = sp.e_valid & (chi2 <= th_e) & okd
    *_, chi2l, okdl = ln_terms(kf_T, pt_X)
    le_inlier = sp.le_valid & (chi2l <= chi2_line) & okdl
    # One gather of both inlier masks (every rank's blocks have one length).
    n_e = e_inlier.shape[0]
    masks = mesh.all_gather(torch.cat([e_inlier, le_inlier])[None])
    return kf_T, pt_full, masks[:, :n_e].reshape(-1), masks[:, n_e:].reshape(-1)
