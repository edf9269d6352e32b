"""Local bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Port of `hfvo_tpu.solve.ba` (reference: `Optimizer::LocalMapOptimization`,
src/Optimizer.cc:3014-3941): local keyframes free, frontier keyframes fixed,
point landmarks and line endpoints marginalized through the Schur
complement, a two-stage schedule (5 robust iterations, outlier demotion, 10
plain iterations) with chi2 gates 5.991 / 7.815 / 3.84, and the final gate
that decides which observations the caller erases.

Everything is fixed-capacity and batched, as in the JAX package: edges live
in flat tables; the per-block Hessians are segment sums over them
(`index_add_`, the JAX package's `.at[].add`); the reduced camera system
S = Hpp - U A U^T is dense ((6K, 6K), K <= 16) and solved by LU. The LM's
iterations are a Python loop whose accept step is a `torch.where` on the
device, so the 15 iterations run without a host synchronization. On the
card the segment sums use atomics, so their summation order, and so the
last bits of every sum, vary from run to run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..ops import sym_eig
from . import residuals


class BAProblem(NamedTuple):
    """Fixed-capacity local BA problem (`hfvo_tpu.solve.ba.BAProblem`).

    The landmark table `pt_X` holds point landmarks AND line endpoints (the
    reference models line endpoints as two marginalized vertices,
    src/Optimizer.cc:3368-3378). Point edges carry (u, v, u_r) reprojection
    residuals; line edges tie one endpoint to an observed 2D infinite line
    with a 1-D distance residual (include/g2oMSC.h:561). Index tables are
    int64."""

    kf_T_cw: torch.Tensor  # (K, 4, 4)
    kf_free: torch.Tensor  # (K,) bool — False: fixed frontier / invalid
    pt_X: torch.Tensor  # (P, 3) landmarks: points + line endpoints
    pt_valid: torch.Tensor  # (P,) bool
    e_kf: torch.Tensor  # (E,)
    e_pt: torch.Tensor  # (E,)
    e_obs: torch.Tensor  # (E, 3) (u, v, u_r)
    e_stereo: torch.Tensor  # (E,) bool
    e_inv_sigma2: torch.Tensor  # (E,)
    e_valid: torch.Tensor  # (E,) bool
    le_kf: torch.Tensor  # (El,)
    le_lm: torch.Tensor  # (El,) landmark row (an endpoint)
    le_line2d: torch.Tensor  # (El, 3) normalized (a, b, c)
    le_inv_sigma2: torch.Tensor  # (El,)
    le_valid: torch.Tensor  # (El,) bool
    # Line-axis parallelism edges (include/g2oMSC.h:123): residual
    # cross(dir, axis) between a line's two endpoints, which are solved as
    # one 6-dof landmark block in the Schur complement.
    lp_s: Optional[torch.Tensor] = None  # (Lc,) start endpoint landmark row
    lp_e: Optional[torch.Tensor] = None  # (Lc,) end endpoint landmark row
    lp_axis: Optional[torch.Tensor] = None  # (Lc, 3) world Manhattan axis
    lp_w: Optional[torch.Tensor] = None  # (Lc,) information (0 = no axis edge)
    lp_valid: Optional[torch.Tensor] = None  # (Lc,) pair exists
    # Cross-line par/perp edges (include/g2oMSC.h:332-559): parallel ->
    # cross(dir_a, dir_b) = 0, perpendicular -> dot(dir_a, dir_b) = 0, with
    # block-Jacobi curvature (the cross blocks between lines are dropped).
    ll_sa: Optional[torch.Tensor] = None  # (Lq,) line a start-endpoint row
    ll_ea: Optional[torch.Tensor] = None  # (Lq,) line a end-endpoint row
    ll_sb: Optional[torch.Tensor] = None  # (Lq,) line b start-endpoint row
    ll_eb: Optional[torch.Tensor] = None  # (Lq,) line b end-endpoint row
    ll_kind: Optional[torch.Tensor] = None  # (Lq,) 0 = parallel, 1 = perpendicular
    ll_w: Optional[torch.Tensor] = None  # (Lq,) information
    ll_valid: Optional[torch.Tensor] = None  # (Lq,) bool
    # Per-KF Manhattan axis anchors: row a of kf_axes_c[k] is axis a
    # measured in KF k's camera, kf_axes_w's rows the world axes, kf_w_axis
    # the per-axis information (0 disables).
    kf_axes_c: Optional[torch.Tensor] = None  # (K, 3, 3)
    kf_axes_w: Optional[torch.Tensor] = None  # (3, 3)
    kf_w_axis: Optional[torch.Tensor] = None  # (K, 3)


# The two stages' iteration counts and the chi2 gates (mono, stereo, line
# endpoint at 95 %) of the reference (hfvo_tpu/solve/ba.py:468-472).
_N_ITERS1, _N_ITERS2 = 5, 10
_CHI2_MONO, _CHI2_STEREO, _CHI2_LINE = 5.991, 7.815, 3.84


class BAResult(NamedTuple):
    kf_T_cw: torch.Tensor
    pt_X: torch.Tensor
    e_inlier: torch.Tensor  # (E,) bool post-gating
    le_inlier: torch.Tensor  # (El,) bool
    chi2: torch.Tensor  # final total inlier chi2


def point_edge_terms(kf_T, pt_X, e_kf, e_pt, e_obs, e_stereo, e_inv_sigma2, intr: Intrinsics):
    """Residuals r (E, 3), pose Jacobian Jp (E, 3, 6), point Jacobian
    Jx (E, 3, 3), per-component weights, per-edge chi2, depth validity."""
    T_e = kf_T[e_kf]
    r, Jp, z = residuals.point_stereo_residual(T_e, pt_X[e_pt], e_obs, intr)
    one = torch.ones_like(e_inv_sigma2)
    comp = torch.stack([one, one, e_stereo.to(r.dtype)], dim=-1)
    # Jp = Jproj @ [I | -hat(X_c)]; the point Jacobian is Jproj @ R.
    Jx = Jp[:, :, :3] @ T_e[:, :3, :3]
    chi2 = torch.sum(r * r * comp, dim=-1) * e_inv_sigma2
    return r, Jp, Jx, comp, chi2, z > 1e-3


def line_edge_terms(kf_T, pt_X, le_kf, le_lm, le_line2d, le_inv_sigma2, intr: Intrinsics):
    """1-D point-to-2D-line residuals of line-endpoint edges."""
    T_e = kf_T[le_kf]
    r, Jp, z = residuals.line_endpoint_residual(T_e, pt_X[le_lm], le_line2d, intr)
    Jx = Jp[:, :, :3] @ T_e[:, :3, :3]  # (El, 1, 3)
    chi2 = (r[..., 0] ** 2) * le_inv_sigma2
    return r, Jp, Jx, chi2, z > 1e-3


def _edge_terms(prob: BAProblem, kf_T, pt_X, intr):
    return point_edge_terms(kf_T, pt_X, prob.e_kf, prob.e_pt, prob.e_obs, prob.e_stereo,
                            prob.e_inv_sigma2, intr)


def _line_edge_terms(prob: BAProblem, kf_T, pt_X, intr):
    return line_edge_terms(kf_T, pt_X, prob.le_kf, prob.le_lm, prob.le_line2d,
                           prob.le_inv_sigma2, intr)


def _jtwj(Ja, W, Jb):
    """sum_k Ja[e, k, i] W[e, k] Jb[e, k, j] -> (E, i, j)."""
    return (Ja * W[..., None]).transpose(-1, -2) @ Jb


def _jtwr(J, Wr):
    """sum_k J[e, k, i] Wr[e, k] -> (E, i)."""
    return (J.transpose(-1, -2) @ Wr[..., None])[..., 0]


def _robust(w, chi2, delta):
    return w * torch.clamp(delta / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)


def _build_blocks(prob: BAProblem, kf_T, pt_X, intr, e_active, le_active, robust, delta_e, delta_l):
    """Accumulate Hpp (K,6,6), Hll (P,3,3), the pair cross block Hx,
    U (P,K,6,3), b_p (K,6), b_l (P,3) and the total chi2."""
    K, P = kf_T.shape[0], pt_X.shape[0]
    r, Jp, Jx, comp, chi2, okd = _edge_terms(prob, kf_T, pt_X, intr)
    on = e_active & okd
    w = torch.where(on, prob.e_inv_sigma2, torch.zeros_like(chi2))
    if robust:
        w = _robust(w, chi2, delta_e)
    Wc = w[:, None] * comp  # (E, 3)
    Hpp = kf_T.new_zeros((K, 6, 6)).index_add_(0, prob.e_kf, _jtwj(Jp, Wc, Jp))
    Hll = pt_X.new_zeros((P, 3, 3)).index_add_(0, prob.e_pt, _jtwj(Jx, Wc, Jx))
    U = pt_X.new_zeros((P * K, 6, 3)).index_add_(0, prob.e_pt * K + prob.e_kf, _jtwj(Jp, Wc, Jx))
    bp = kf_T.new_zeros((K, 6)).index_add_(0, prob.e_kf, _jtwr(Jp, Wc * r))
    bl = pt_X.new_zeros((P, 3)).index_add_(0, prob.e_pt, _jtwr(Jx, Wc * r))
    total = torch.sum(torch.where(on, chi2, torch.zeros_like(chi2)))

    # Line-endpoint edges fold into the same blocks.
    rl, Jpl, Jxl, chi2l, okdl = _line_edge_terms(prob, kf_T, pt_X, intr)
    onl = le_active & okdl
    wl = torch.where(onl, prob.le_inv_sigma2, torch.zeros_like(chi2l))
    if robust:
        wl = _robust(wl, chi2l, delta_l)
    Wl = wl[:, None]
    Hpp.index_add_(0, prob.le_kf, _jtwj(Jpl, Wl, Jpl))
    Hll.index_add_(0, prob.le_lm, _jtwj(Jxl, Wl, Jxl))
    U.index_add_(0, prob.le_lm * K + prob.le_kf, _jtwj(Jpl, Wl, Jxl))
    bp.index_add_(0, prob.le_kf, _jtwr(Jpl, Wl * rl))
    bl.index_add_(0, prob.le_lm, _jtwr(Jxl, Wl * rl))
    total = total + torch.sum(torch.where(onl, chi2l, torch.zeros_like(chi2l)))
    U = U.view(P, K, 6, 3)

    if prob.kf_axes_c is not None:
        r_ax, J_ax = axis_anchor_terms_x(kf_T, prob.kf_axes_c, prob.kf_axes_w)
        wa = prob.kf_w_axis  # (K, 3)
        Hpp[:, 3:, 3:] += torch.einsum("kaci,ka,kacj->kij", J_ax, wa, J_ax)
        bp[:, 3:] += torch.einsum("kaci,kac->ki", J_ax, wa[:, :, None] * r_ax)
        total = total + torch.sum(wa * torch.sum(r_ax * r_ax, dim=-1))

    if prob.ll_sa is not None:
        r_ll, J_ea, J_eb, w_ll, chi2_ll = _line_pair_terms(prob, pt_X)
        HJa = torch.einsum("lab,l,lac->lbc", J_ea, w_ll, J_ea)
        HJb = torch.einsum("lab,l,lac->lbc", J_eb, w_ll, J_eb)
        g_a = torch.einsum("lab,la->lb", J_ea, w_ll[:, None] * r_ll)
        g_b = torch.einsum("lab,la->lb", J_eb, w_ll[:, None] * r_ll)
        # Diagonal (block-Jacobi) curvature only — see BAProblem.ll_*.
        Hll.index_add_(0, prob.ll_ea, HJa).index_add_(0, prob.ll_sa, HJa)
        Hll.index_add_(0, prob.ll_eb, HJb).index_add_(0, prob.ll_sb, HJb)
        bl.index_add_(0, prob.ll_ea, g_a).index_add_(0, prob.ll_sa, -g_a)
        bl.index_add_(0, prob.ll_eb, g_b).index_add_(0, prob.ll_sb, -g_b)
        total = total + torch.sum(chi2_ll)

    Hx = None
    if prob.lp_s is not None:
        r_lp, Je, w_lp, chi2_lp = _line_axis_terms(prob, pt_X)
        # J wrt end = Je, wrt start = -Je: both landmark blocks get HJ, the
        # start-end cross block (of the paired Schur solve) gets -HJ.
        HJ = torch.einsum("lab,l,lcb->lac", Je, w_lp, Je)
        Hll.index_add_(0, prob.lp_s, HJ).index_add_(0, prob.lp_e, HJ)
        Hx = -HJ
        g_e = torch.einsum("lab,la->lb", Je, w_lp[:, None] * r_lp)
        bl.index_add_(0, prob.lp_e, g_e).index_add_(0, prob.lp_s, -g_e)
        total = total + torch.sum(chi2_lp)
    return Hpp, Hll, Hx, U, bp, bl, total


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def line_pair_terms_x(Xsa, Xea, Xsb, Xeb, ll_kind, ll_w, ll_valid):
    """Cross-line par/perp residuals r (Lq, 3), per-endpoint Jacobians
    (J_ea, J_eb; the start endpoints' are their negations), weights, chi2.
    Parallel: r = cross(da, db); perpendicular: r = (da.db, 0, 0)."""
    va, vb = Xea - Xsa, Xeb - Xsb
    na = torch.linalg.norm(va, dim=-1)
    nb = torch.linalg.norm(vb, dim=-1)
    da = va / torch.clamp(na, min=1e-6)[:, None]
    db = vb / torch.clamp(nb, min=1e-6)[:, None]
    perp = ll_kind == 1
    r_par = torch.linalg.cross(da, db, dim=-1)
    dot = torch.sum(da * db, dim=-1)
    r_perp = torch.cat([dot[:, None], torch.zeros_like(da[:, :2])], dim=-1)
    r = torch.where(perp[:, None], r_perp, r_par)
    # d r / d da: par -> -hat(db); perp -> row 0 = db.
    z = torch.zeros_like(da)
    J_da = torch.where(perp[:, None, None], torch.stack([db, z, z], dim=-2), -se3.hat(db))
    J_db = torch.where(perp[:, None, None], torch.stack([da, z, z], dim=-2), se3.hat(da))
    eye = _eye(3, da)
    Pa = (eye - da[:, :, None] * da[:, None, :]) / torch.clamp(na, min=1e-6)[:, None, None]
    Pb = (eye - db[:, :, None] * db[:, None, :]) / torch.clamp(nb, min=1e-6)[:, None, None]
    ok = ll_valid & (na > 1e-3) & (nb > 1e-3)
    w = torch.where(ok, ll_w, torch.zeros_like(ll_w))
    return r, J_da @ Pa, J_db @ Pb, w, w * torch.sum(r * r, dim=-1)


def _line_pair_terms(prob: BAProblem, pt_X):
    return line_pair_terms_x(pt_X[prob.ll_sa], pt_X[prob.ll_ea], pt_X[prob.ll_sb],
                             pt_X[prob.ll_eb], prob.ll_kind, prob.ll_w, prob.ll_valid)


def line_axis_terms_x(Xs, Xe, lp_axis, lp_w, lp_valid):
    """cross(unit(end - start), axis) residuals (Lc, 3), the Jacobian wrt
    the END endpoint (the start's is its negation), weights, chi2."""
    d = Xe - Xs
    nrm = torch.linalg.norm(d, dim=-1)
    dn = d / torch.clamp(nrm, min=1e-6)[:, None]
    r = torch.linalg.cross(dn, lp_axis, dim=-1)  # |r| = sin(angle to axis)
    P_t = (_eye(3, dn) - dn[:, :, None] * dn[:, None, :]) / torch.clamp(nrm, min=1e-6)[:, None, None]
    Je = -(se3.hat(lp_axis) @ P_t)
    ok = lp_valid & (nrm > 1e-3)
    w = torch.where(ok, lp_w, torch.zeros_like(lp_w))
    return r, Je, w, w * torch.sum(r * r, dim=-1)


def _line_axis_terms(prob: BAProblem, pt_X):
    return line_axis_terms_x(pt_X[prob.lp_s], pt_X[prob.lp_e], prob.lp_axis, prob.lp_w, prob.lp_valid)


def axis_anchor_terms_x(kf_T, kf_axes_c, kf_axes_w):
    """Per-KF axis-direction anchor residuals r (K, 3, 3) and rotation-block
    Jacobians -hat(v) (K, 3, 3, 3); v_{k,a} = R_k a_w,a."""
    V = torch.einsum("kij,aj->kai", kf_T[:, :3, :3], kf_axes_w)
    return V - kf_axes_c, -se3.hat(V)


def _chi2_total(prob: BAProblem, kf_T, pt_X, intr, e_active, le_active):
    *_, chi2, okd = _edge_terms(prob, kf_T, pt_X, intr)
    t = torch.sum(torch.where(e_active & okd, chi2, torch.zeros_like(chi2)))
    *_, chi2l, okdl = _line_edge_terms(prob, kf_T, pt_X, intr)
    t = t + torch.sum(torch.where(le_active & okdl, chi2l, torch.zeros_like(chi2l)))
    if prob.kf_axes_c is not None:
        r_ax, _ = axis_anchor_terms_x(kf_T, prob.kf_axes_c, prob.kf_axes_w)
        t = t + torch.sum(prob.kf_w_axis * torch.sum(r_ax * r_ax, dim=-1))
    if prob.lp_s is not None:
        t = t + torch.sum(_line_axis_terms(prob, pt_X)[3])
    if prob.ll_sa is not None:
        t = t + torch.sum(_line_pair_terms(prob, pt_X)[4])
    return t


def _add_diag_blocks(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S (K, K, 6, 6) with blocks (K, 6, 6) added to its diagonal blocks."""
    idx = torch.arange(S.shape[0], device=S.device)
    S[idx, idx] += blocks
    return S


def _schur_solve(prob: BAProblem, Hpp, Hll, Hx, U, bp, bl, lam):
    """Solve the damped system through the Schur complement; returns
    (dpose (K, 6), dpt (P, 3)). Landmarks coupled by a line-axis edge are
    marginalized as paired 6-dof blocks, all others as independent 3x3."""
    K = Hpp.shape[0]
    P = Hll.shape[0]
    eye3, eye6 = _eye(3, Hll), _eye(6, Hll)
    # ISOTROPIC per-block damping (lam * max diag): a line endpoint's block
    # is near-singular along the 3D line (a point-to-2D-line edge cannot see
    # it slide), and per-coordinate damping would leave an axis-aligned
    # line's null direction undamped.
    dmax = torch.diagonal(Hll, dim1=1, dim2=2).amax(dim=-1)
    Hll_d = Hll + lam * torch.clamp(dmax, min=1e-6)[:, None, None] * eye3
    # Unobserved landmarks get an identity block (their rhs is 0).
    observed = torch.abs(Hll).sum(dim=(1, 2)) > 1e-9
    Hll_d = torch.where(observed[:, None, None], Hll_d, eye3)
    A = sym_eig.inv3x3(Hll_d)

    paired = prob.lp_s is not None
    if paired:
        s_rows, e_rows, pair_ok = prob.lp_s, prob.lp_e, prob.lp_valid
        # Pair members leave the 3x3 path for the 6x6 one.
        n_in = Hll.new_zeros((P,)).index_add_(0, s_rows, pair_ok.to(Hll.dtype))
        n_in.index_add_(0, e_rows, pair_ok.to(Hll.dtype))
        A = torch.where((n_in > 0)[:, None, None], torch.zeros_like(A), A)

    T1 = U @ A[:, None]  # (P, K, 6, 3)
    S = -torch.einsum("pkac,pmdc->kmad", T1, U)  # (K, K, 6, 6)
    b_red = bp - torch.einsum("pkac,pc->ka", T1, bl)

    if paired:
        # 6x6 pair blocks [[H_ss, Hx], [Hx^T, H_ee]] (damping already on the
        # diagonal blocks; the cross block is not damped), inverted by LU.
        H6 = torch.cat([
            torch.cat([Hll_d[s_rows], Hx], dim=-1),
            torch.cat([Hx.transpose(1, 2), Hll_d[e_rows]], dim=-1),
        ], dim=-2)
        pair_obs = pair_ok & (observed[s_rows] | observed[e_rows] | (prob.lp_w > 0))
        H6 = torch.where(pair_obs[:, None, None], H6, eye6)
        A6 = torch.linalg.inv_ex(H6).inverse
        A6 = torch.where(pair_obs[:, None, None], A6, torch.zeros_like(A6))
        U6 = torch.cat([U[s_rows], U[e_rows]], dim=-1)  # (Lc, K, 6, 6)
        bl6 = torch.cat([bl[s_rows], bl[e_rows]], dim=-1)  # (Lc, 6)
        T16 = U6 @ A6[:, None]
        S = S - torch.einsum("lkac,lmdc->kmad", T16, U6)
        b_red = b_red - torch.einsum("lkac,lc->ka", T16, bl6)
    # Hpp on the diagonal, with Marquardt damping.
    damp = lam * torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
    S = _add_diag_blocks(S, Hpp + torch.diag_embed(damp))

    # Gauge: fixed keyframes get identity rows/cols and zero rhs.
    free = prob.kf_free
    S = torch.where((free[:, None] & free[None, :])[:, :, None, None], S, torch.zeros_like(S))
    S = _add_diag_blocks(S, (~free).to(S.dtype)[:, None, None] * eye6)
    b_red = torch.where(free[:, None], b_red, torch.zeros_like(b_red))

    S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K) + 1e-8 * _eye(6 * K, S)
    dpose = -torch.linalg.solve_ex(S_dense, b_red.reshape(-1, 1)).result.reshape(K, 6)
    dpose = torch.where(free[:, None], dpose, torch.zeros_like(dpose))

    # Back-substitute landmarks: dl = -A (bl + U^T dpose summed over KFs).
    rhs = bl + torch.einsum("pkab,ka->pb", U, dpose)
    dpt = -(A @ rhs[..., None])[..., 0]
    dpt = torch.where(observed[:, None], dpt, torch.zeros_like(dpt))
    if paired:
        rhs6 = bl6 + torch.einsum("lkab,ka->lb", U6, dpose)
        d6 = -(A6 @ rhs6[..., None])[..., 0]
        d6 = torch.where(pair_obs[:, None], d6, torch.zeros_like(d6))
        dpt = dpt.index_add(0, s_rows, d6[:, :3]).index_add(0, e_rows, d6[:, 3:])
    return dpose, dpt


def local_bundle_adjustment(prob: BAProblem, intr: Intrinsics) -> BAResult:
    """Two-stage local BA with outlier demotion between the stages
    (reference: src/Optimizer.cc:3818-3899, optimize(5) -> gate ->
    optimize(10)). No host synchronization: the result stays on the
    problem's device."""
    dev = prob.pt_X.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    th_e = torch.where(prob.e_stereo, f32(_CHI2_STEREO), f32(_CHI2_MONO))
    delta_e = torch.sqrt(th_e)
    delta_l = torch.sqrt(f32(_CHI2_LINE))

    def lm_stage(kf_T, pt_X, e_active, le_active, n_iters, robust):
        lam = f32(1e-4)
        for _ in range(n_iters):
            Hpp, Hll, Hx, U, bp, bl, chi2_cur = _build_blocks(
                prob, kf_T, pt_X, intr, e_active, le_active, robust, delta_e, delta_l)
            dpose, dpt = _schur_solve(prob, Hpp, Hll, Hx, U, bp, bl, lam)
            kf_T_new = se3.exp_se3(dpose) @ kf_T
            pt_X_new = pt_X + dpt
            chi2_new = _chi2_total(prob, kf_T_new, pt_X_new, intr, e_active, le_active)
            finite = torch.isfinite(kf_T_new).all() & torch.isfinite(pt_X_new).all()
            accept = (chi2_new < chi2_cur) & finite
            kf_T = torch.where(accept, kf_T_new, kf_T)
            pt_X = torch.where(accept, pt_X_new, pt_X)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), torch.clamp(lam * 5.0, max=1e5))
        return kf_T, pt_X

    e_active = prob.e_valid & prob.pt_valid[prob.e_pt]
    le_active = prob.le_valid & prob.pt_valid[prob.le_lm]
    kf_T, pt_X = lm_stage(prob.kf_T_cw, prob.pt_X, e_active, le_active, _N_ITERS1, True)
    # Outlier demotion between the stages.
    *_, chi2, okd = _edge_terms(prob, kf_T, pt_X, intr)
    e_active = e_active & (chi2 <= th_e) & okd
    *_, chi2l, okdl = _line_edge_terms(prob, kf_T, pt_X, intr)
    le_active = le_active & (chi2l <= _CHI2_LINE) & okdl
    kf_T, pt_X = lm_stage(kf_T, pt_X, e_active, le_active, _N_ITERS2, False)
    # Final gate for write-back (the reference erases these observations).
    *_, chi2, okd = _edge_terms(prob, kf_T, pt_X, intr)
    e_inlier = prob.e_valid & (chi2 <= th_e) & okd
    *_, chi2l, okdl = _line_edge_terms(prob, kf_T, pt_X, intr)
    le_inlier = prob.le_valid & (chi2l <= _CHI2_LINE) & okdl
    total = torch.sum(torch.where(e_inlier, chi2, torch.zeros_like(chi2))) + torch.sum(
        torch.where(le_inlier, chi2l, torch.zeros_like(chi2l)))
    return BAResult(kf_T, pt_X, e_inlier, le_inlier, total)
