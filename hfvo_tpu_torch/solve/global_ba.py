"""Global bundle adjustment: full-map Schur LM with a matrix-free CG solve.

Port of `hfvo_tpu.solve.global_ba` on one device (reference:
`Optimizer::GlobalBundleAdjustemnt`, src/Optimizer.cc:51-66 ->
BundleAdjustment with lines, src/Optimizer.cc:256-652, run after every
accepted loop closure, src/LoopClosing.cc:580-581, :647-653).

The reduced camera system S = Hpp - sum_p U_p A_p U_p^T is never formed:
the per-edge blocks U_e = Jp^T W Jx are built once an LM iteration, S v is
two segment sums over the edge tables (`index_add_`) a CG step, and CG is
preconditioned by the block-Jacobi inverse of the damped Hpp. Line
endpoints are landmarks with point-to-2D-line edges, as in local BA; one
keyframe is the gauge. The 10 LM iterations of 40 CG steps have fixed
counts and their accept and convergence decisions are `torch.where`s, so
they never synchronize with the host.

The JAX package pads every table to a power of two so that repeated runs
reuse a few compiled programs; eager torch compiles nothing, so the tables
here have their exact sizes, as the JAX package's `pad=False` builds them
(the padded rows there are masked out of every sum).
`reduce` is the JAX package's `axis_name` form: with the edge tables
split over ranks (`parallel/dist_gba.py`), every edge-indexed sum is reduced
over the ranks where `_gba_impl` applies `_ps`, so each rank computes the
same update.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..ops import sym_eig
from ..ops.batch import resolve_device, to_host
from .ba import _jtwj, _jtwr, line_edge_terms, point_edge_terms


class GlobalBAProblem(NamedTuple):
    """Whole-map BA problem (points + line endpoints); index tables int64."""

    kf_T_cw: torch.Tensor  # (K, 4, 4)
    kf_free: torch.Tensor  # (K,) bool; the gauge False
    pt_X: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,)
    e_kf: torch.Tensor  # (E,)
    e_pt: torch.Tensor  # (E,)
    e_obs: torch.Tensor  # (E, 3) (u, v, u_r)
    e_stereo: torch.Tensor  # (E,)
    e_inv_sigma2: torch.Tensor  # (E,)
    e_valid: torch.Tensor  # (E,)
    le_kf: torch.Tensor  # (El,)
    le_lm: torch.Tensor  # (El,)
    le_line2d: torch.Tensor  # (El, 3)
    le_inv_sigma2: torch.Tensor  # (El,)
    le_valid: torch.Tensor  # (El,)


class GlobalBAResult(NamedTuple):
    kf_T_cw: torch.Tensor
    pt_X: torch.Tensor
    e_inlier: torch.Tensor
    le_inlier: torch.Tensor
    chi2: torch.Tensor


def global_bundle_adjustment(
    prob: GlobalBAProblem,
    intr: Intrinsics,
    n_iters: int = 10,
    cg_iters: int = 40,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    chi2_line: float = 3.84,
    reduce: Optional[Callable[..., list]] = None,
) -> GlobalBAResult:
    """Huber-reweighted LM over the whole map, 10 iterations like the
    reference's post-loop GBA (hfvo_tpu/solve/global_ba.py:71-296).
    `reduce(*xs)` sums each tensor over the ranks of an edge-sharded solve
    (`Mesh.psum_all`); None on one device."""
    ps = reduce or (lambda *xs: list(xs))
    kf_T, pt_X = prob.kf_T_cw, prob.pt_X
    K, P = kf_T.shape[0], pt_X.shape[0]
    th_e = torch.where(prob.e_stereo, chi2_stereo, chi2_mono).to(pt_X.dtype)
    delta_e = torch.sqrt(th_e)
    delta_l = float(np.sqrt(chi2_line))
    eye3 = torch.eye(3, dtype=pt_X.dtype, device=pt_X.device)
    eye6 = torch.eye(6, dtype=pt_X.dtype, device=pt_X.device)
    free = prob.kf_free[:, None]
    e_active = prob.e_valid & prob.pt_valid[prob.e_pt]
    le_active = prob.le_valid & prob.pt_valid[prob.le_lm]

    def terms(kf_T, pt_X):
        return point_edge_terms(kf_T, pt_X, prob.e_kf, prob.e_pt, prob.e_obs, prob.e_stereo,
                                prob.e_inv_sigma2, intr)

    def lterms(kf_T, pt_X):
        return line_edge_terms(kf_T, pt_X, prob.le_kf, prob.le_lm, prob.le_line2d, prob.le_inv_sigma2, intr)

    def mv(A, x):
        """Batched matrix-vector product A x: (..., m, n), (..., n)."""
        return (A @ x[..., None])[..., 0]

    def masked_sum(on, chi2):
        return torch.sum(torch.where(on, chi2, torch.zeros_like(chi2)))

    def chi2_total(kf_T, pt_X):
        *_, chi2, okd = terms(kf_T, pt_X)
        *_, chi2l, okdl = lterms(kf_T, pt_X)
        return ps(masked_sum(e_active & okd, chi2) + masked_sum(le_active & okdl, chi2l))[0]

    def to_kf(rows_e, rows_l):
        return kf_T.new_zeros((K, 6)).index_add_(0, prob.e_kf, rows_e).index_add_(0, prob.le_kf, rows_l)

    def to_lm(rows_e, rows_l):
        return pt_X.new_zeros((P, 3)).index_add_(0, prob.e_pt, rows_e).index_add_(0, prob.le_lm, rows_l)

    lam = kf_T.new_tensor(1e-4)
    for _ in range(n_iters):
        r, Jp, Jx, comp, chi2, okd = terms(kf_T, pt_X)
        on = e_active & okd
        w = torch.where(on, prob.e_inv_sigma2, torch.zeros_like(chi2))
        w = w * torch.clamp(delta_e / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
        Wc = w[:, None] * comp  # (E, 3)
        # Per-edge blocks (E x small, never P x K).
        U_e = _jtwj(Jp, Wc, Jx)  # (E, 6, 3)
        rl, Jpl, Jxl, chi2l, okdl = lterms(kf_T, pt_X)
        onl = le_active & okdl
        wl = torch.where(onl, prob.le_inv_sigma2, torch.zeros_like(chi2l))
        wl = wl * torch.clamp(delta_l / torch.sqrt(torch.clamp(chi2l, min=1e-12)), max=1.0)
        Wl = wl[:, None]
        Ul_e = _jtwj(Jpl, Wl, Jxl)  # (El, 6, 3)
        U_eT, Ul_eT = U_e.transpose(1, 2), Ul_e.transpose(1, 2)
        Hpp = kf_T.new_zeros((K, 6, 6)).index_add_(0, prob.e_kf, _jtwj(Jp, Wc, Jp)) \
            .index_add_(0, prob.le_kf, _jtwj(Jpl, Wl, Jpl))
        Hll = pt_X.new_zeros((P, 3, 3)).index_add_(0, prob.e_pt, _jtwj(Jx, Wc, Jx)) \
            .index_add_(0, prob.le_lm, _jtwj(Jxl, Wl, Jxl))
        bp = to_kf(_jtwr(Jp, Wc * r), _jtwr(Jpl, Wl * rl))
        bl = to_lm(_jtwr(Jx, Wc * r), _jtwr(Jxl, Wl * rl))
        chi2_cur = masked_sum(on, chi2) + masked_sum(onl, chi2l)
        # Edge blocks on several ranks: make the normal equations and the
        # cost whole before the factorization.
        Hpp, Hll, bp, bl, chi2_cur = ps(Hpp, Hll, bp, bl, chi2_cur)

        # Damped landmark blocks and their inverses (isotropic damping: a
        # line endpoint's block is near-singular along its line).
        dmax = torch.amax(torch.diagonal(Hll, dim1=1, dim2=2), dim=-1)
        Hll_d = Hll + (lam * torch.clamp(dmax, min=1e-6))[:, None, None] * eye3
        observed = torch.abs(Hll).sum(dim=(1, 2)) > 1e-9
        Hll_d = torch.where(observed[:, None, None], Hll_d, eye3)
        A = sym_eig.inv3x3(Hll_d)  # (P, 3, 3)
        Hpp_d = Hpp + lam * torch.diag_embed(torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6))
        # Gauge: fixed keyframes become identity rows with zero rhs.
        Hpp_d = torch.where(free[:, :, None], Hpp_d, eye6)

        def back_to_kf(wv):
            """sum over edges of U_e (wv of the edge's landmark), per keyframe."""
            return ps(to_kf(mv(U_e, wv[prob.e_pt]), mv(Ul_e, wv[prob.le_lm])))[0]

        def S_matvec(v):
            v = torch.where(free, v, torch.zeros_like(v))
            out = mv(Hpp_d, v)
            t = ps(to_lm(mv(U_eT, v[prob.e_kf]), mv(Ul_eT, v[prob.le_kf])))[0]  # t_p = sum_k U^T v_k
            out = out - back_to_kf(mv(A, t))
            return torch.where(free, out, torch.zeros_like(out))

        b_red = bp - back_to_kf(mv(A, bl))
        rhs = torch.where(free, -b_red, torch.zeros_like(b_red))  # S x = -b_red

        # Block-Jacobi preconditioned CG (LU inverses: tail keyframes with
        # few observations make Hpp_d ill-conditioned).
        M = torch.linalg.inv_ex(Hpp_d)[0]
        x = torch.zeros_like(rhs)
        rr = rhs - S_matvec(x)
        z = mv(M, rr)
        p = z
        rz = torch.sum(rr * z)
        tol2 = 1e-12 * torch.clamp(torch.sum(rhs * rhs), min=1e-20)
        for _ in range(cg_iters):
            live = torch.sum(rr * rr) > tol2
            Sp = S_matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * Sp), min=1e-20)
            x_n = x + alpha * p
            r_n = rr - alpha * Sp
            z_n = mv(M, r_n)
            rz_n = torch.sum(r_n * z_n)
            beta = rz_n / torch.clamp(rz, min=1e-20)
            p_n = z_n + beta * p
            x = torch.where(live, x_n, x)
            rr = torch.where(live, r_n, rr)
            p = torch.where(live, p_n, p)
            rz = torch.where(live, rz_n, rz)
        dpose = torch.where(free, x, torch.zeros_like(x))

        # Back-substitute the landmarks.
        t = ps(to_lm(mv(U_eT, dpose[prob.e_kf]), mv(Ul_eT, dpose[prob.le_kf])))[0]
        dpt = -mv(A, bl + t)
        dpt = torch.where(observed[:, None], dpt, torch.zeros_like(dpt))

        kf_T_new = se3.exp_se3(dpose) @ kf_T
        pt_X_new = pt_X + dpt
        finite = torch.isfinite(kf_T_new).all() & torch.isfinite(pt_X_new).all()
        accept = (chi2_total(kf_T_new, pt_X_new) < chi2_cur) & finite
        kf_T = torch.where(accept, kf_T_new, kf_T)
        pt_X = torch.where(accept, pt_X_new, pt_X)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 5.0, max=1e5))

    *_, chi2, okd = terms(kf_T, pt_X)
    e_inlier = prob.e_valid & (chi2 <= th_e) & okd
    *_, chi2l, okdl = lterms(kf_T, pt_X)
    le_inlier = prob.le_valid & (chi2l <= chi2_line) & okdl
    total = ps(masked_sum(e_inlier, chi2) + masked_sum(le_inlier, chi2l))[0]
    return GlobalBAResult(kf_T, pt_X, e_inlier, le_inlier, total)


def build_global_ba_problem(vomap, gauge_kf: Optional[int] = None, max_edges: Optional[int] = None,
                            max_line_edges: Optional[int] = None, device="cuda"):
    """Assemble the whole-map problem from the flat VOMap tables
    (hfvo_tpu/solve/global_ba.py:303-395; the reference gathers all
    keyframes and landmarks, src/Optimizer.cc:52-66) on `device`. Returns
    (prob, window, upts, ulines), `window` the keyframe slots in pose
    order, for the write-back. With `max_edges`, that many point edges are
    drawn without replacement by `np.random.RandomState(0)` (the landmarks
    stay those of every edge); with `max_line_edges`, the first that many
    line-endpoint edges are kept. The tables are those of the JAX
    package's `pad=False`: exact sizes, and one invalid row where the
    problem has no line edge."""
    device = resolve_device(device)
    kf = vomap.keyframes
    window = np.nonzero(kf.valid)[0]
    window = window[np.argsort(kf.order[window], kind="stable")]
    K = len(window)

    pid = kf.point_id[window]
    ov = kf.obs_valid[window] & (pid >= 0) & vomap.points.valid[np.maximum(pid, 0)]
    k_idx, c_idx = np.nonzero(ov)
    e_pt_global = pid[k_idx, c_idx]
    e_obs = kf.obs[window][k_idx, c_idx]
    e_oct = kf.octave[window][k_idx, c_idx]
    upts, e_pt_local = np.unique(e_pt_global, return_inverse=True)
    if max_edges is not None and len(k_idx) > max_edges:
        sel = np.random.RandomState(0).choice(len(k_idx), max_edges, replace=False)
        k_idx, e_pt_local, e_obs, e_oct = k_idx[sel], e_pt_local[sel], e_obs[sel], e_oct[sel]

    kl = vomap.kf_lines
    lid = kl.line_id[window]
    lov = kl.obs_valid[window] & (lid >= 0) & vomap.lines.valid[np.maximum(lid, 0)]
    lk_idx, lc_idx = np.nonzero(lov)
    le_l2d_seg = kl.line2d[window][lk_idx, lc_idx]
    ulines, le_line_local = np.unique(lid[lk_idx, lc_idx], return_inverse=True)
    npt, nu = len(upts), len(ulines)
    lm_X = np.concatenate([
        vomap.points.X_w[upts], vomap.lines.X0_w[ulines], vomap.lines.X1_w[ulines],
    ]).astype(np.float32)
    le_kf = np.concatenate([lk_idx, lk_idx])
    le_lm = np.concatenate([npt + le_line_local, npt + nu + le_line_local])
    le_l2d = np.concatenate([le_l2d_seg, le_l2d_seg]).astype(np.float32).reshape(-1, 3)
    if max_line_edges is not None and len(le_kf) > max_line_edges:
        le_kf, le_lm, le_l2d = le_kf[:max_line_edges], le_lm[:max_line_edges], le_l2d[:max_line_edges]

    free = np.ones((K,), bool)
    gauge = 0 if gauge_kf is None else int(np.nonzero(window == gauge_kf)[0][0])
    free[gauge] = False
    E, El = len(k_idx), len(le_kf)
    El_cap = max(El, 1)

    def up(a, dtype, n=None):
        out = np.zeros((len(a) if n is None else n,) + a.shape[1:], dtype)
        out[: len(a)] = a
        return torch.from_numpy(out).to(device)

    prob = GlobalBAProblem(
        kf_T_cw=up(kf.T_cw[window], np.float32),
        kf_free=up(free, bool),
        pt_X=up(lm_X, np.float32),
        pt_valid=up(np.ones(len(lm_X), bool), bool),
        e_kf=up(k_idx, np.int64),
        e_pt=up(e_pt_local, np.int64),
        e_obs=up(e_obs, np.float32),
        e_stereo=up(e_obs[:, 2] > 0, bool),
        e_inv_sigma2=up(1.0 / 1.2 ** (2.0 * e_oct), np.float32),
        e_valid=up(np.ones(E, bool), bool),
        le_kf=up(le_kf, np.int64, El_cap),
        le_lm=up(le_lm, np.int64, El_cap),
        le_line2d=up(le_l2d, np.float32, El_cap),
        le_inv_sigma2=up(np.ones(El, np.float32), np.float32, El_cap),
        le_valid=up(np.ones(El, bool), bool, El_cap),
    )
    return prob, window, upts, ulines


def run_global_ba(vomap, intr: Intrinsics, gauge_kf: Optional[int] = None, n_iters: int = 10,
                  device="cuda") -> float:
    """Build, solve on `device` and write back the whole-map BA (reference:
    LoopClosing::RunGlobalBundleAdjustment, src/LoopClosing.cc:647-720).
    Returns the final inlier chi2."""
    prob, window, upts, ulines = build_global_ba_problem(vomap, gauge_kf, device=device)
    res = global_bundle_adjustment(prob, intr, n_iters=n_iters)
    T, lm, chi2 = to_host([res.kf_T_cw, res.pt_X, res.chi2])
    vomap.keyframes.T_cw[window] = T
    npt, nu = len(upts), len(ulines)
    vomap.points.X_w[upts] = lm[:npt]
    if nu:
        vomap.lines.X0_w[ulines] = lm[npt: npt + nu]
        vomap.lines.X1_w[ulines] = lm[npt + nu: npt + 2 * nu]
    return float(chi2)
