"""The local BA that ORB-SLAM2's Optimizer::LocalBundleAdjustment solves,
with the line and Manhattan terms of MSC-VO (include/g2oMSC.h), written
from the published definitions:

- a point edge: the squared (u, v, u_r) error of the projection u = fx x /
  z + cx, v = fy y / z + cy, u_r = u - bf / z against the observation (u_r
  only for a stereo edge), times the edge's information;
- a line-endpoint edge: the squared distance a u + b v + c of the projected
  endpoint to the observed 2D line, times its information;
- a keyframe's Manhattan anchor: |R a_w - a_c|^2 for each world axis a_w
  and its measurement a_c in the keyframe, times its weight;
- a line-axis edge: |unit(X_e - X_s) x axis|^2; a line pair: |d_a x d_b|^2
  (parallel) or (d_a . d_b)^2 (perpendicular) of the unit directions;
- the gates: an edge is an inlier where its point lies in front of the
  camera (depth > 1 mm) and its chi2 is within 5.991 (mono), 7.815
  (stereo) or 3.84 (line endpoint), the 95 % points of chi2 with 2, 3 and
  1 degrees of freedom;
- the solve: 5 Levenberg-Marquardt iterations on the Huber-robust cost,
  the edges past their gate demoted, 10 plain iterations, the final gate.

Keyframes with `kf_free` false stay fixed. A pose moves by a left
perturbation T <- exp(xi^) T, xi = (translation, rotation). The Gauss-Newton
step marginalizes the landmarks through the Schur complement; the line
terms that tie landmarks to each other enter it by their diagonal blocks
only. Evaluated in float64 (`tf32`: float32 with every state and input
rounded to TF32, the control). A problem is read by its field names; the
reference imports nothing of the program.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from . import rounder

GATE_MONO, GATE_STEREO, GATE_LINE = 5.991, 7.815, 3.84
MIN_DEPTH = 1e-3
# An edge whose reference chi2 lies within this share of its gate may fall
# on either side of it in float32: its flag is the program's to choose.
GATE_BAND = 1e-3


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _cam(T, X):
    return torch.einsum("nij,nj->ni", T[:, :3, :3], X) + T[:, :3, 3]


def _uv(Xc, cam):
    z = Xc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    return cam["fx"] * Xc[:, 0] * iz + cam["cx"], cam["fy"] * Xc[:, 1] * iz + cam["cy"], iz


def _proj_jac(Xc, cam):
    """d(u, v, u_r) / d X_c, (N, 3, 3)."""
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    zero = torch.zeros_like(z)
    du = torch.stack([cam["fx"] * iz, zero, -cam["fx"] * x * iz * iz], -1)
    dv = torch.stack([zero, cam["fy"] * iz, -cam["fy"] * y * iz * iz], -1)
    dur = du + torch.stack([zero, zero, cam["bf"] * iz * iz], -1)
    return torch.stack([du, dv, dur], -2)


def _pose_jac(Xc):
    """d X_c / d xi for the left perturbation, (N, 3, 6)."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    return torch.cat([eye, -_hat(Xc)], -1)


def _opt(p, name):
    return getattr(p, name, None)


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-6)


def _axis_r(Xs, Xe, axis):
    """unit(X_e - X_s) x axis, of one row or of a table of rows."""
    return torch.linalg.cross(_unit(Xe - Xs), axis, dim=-1)


def _pair_r(Xsa, Xea, Xsb, Xeb, perp):
    """d_a x d_b (parallel) or (d_a . d_b, 0, 0) (perpendicular)."""
    da, db = _unit(Xea - Xsa), _unit(Xeb - Xsb)
    dot = (da * db).sum(-1, keepdim=True)
    return torch.where(perp[..., None], torch.cat([dot, torch.zeros_like(da[..., :2])], -1),
                       torch.linalg.cross(da, db, dim=-1))


class Terms:
    """A problem's tables in one dtype, and its cost terms at a state."""

    def __init__(self, p, cam: dict, dt, rnd):
        self.p, self.cam, self.dt, self.rnd = p, cam, dt, rnd
        self.e_obs = rnd(p.e_obs.to(dt))
        self.e_w = p.e_inv_sigma2.to(dt)
        self.le_l2 = rnd(p.le_line2d.to(dt))
        self.le_w = p.le_inv_sigma2.to(dt)
        self.gate_e = torch.where(p.e_stereo, torch.tensor(GATE_STEREO, dtype=dt, device=self.e_w.device),
                                  torch.tensor(GATE_MONO, dtype=dt, device=self.e_w.device))

    def point(self, T, X):
        """Per-edge chi2 (E,) and depth validity."""
        p = self.p
        Xc = _cam(T[p.e_kf], X[p.e_pt])
        u, v, iz = _uv(Xc, self.cam)
        r = torch.stack([u, v, u - self.cam["bf"] * iz], -1) - self.e_obs
        r = r * torch.stack([torch.ones_like(u), torch.ones_like(u), p.e_stereo.to(u.dtype)], -1)
        return (r * r).sum(-1) * self.e_w, Xc[:, 2] > MIN_DEPTH

    def line(self, T, X):
        p = self.p
        Xc = _cam(T[p.le_kf], X[p.le_lm])
        u, v, _ = _uv(Xc, self.cam)
        r = self.le_l2[:, 0] * u + self.le_l2[:, 1] * v + self.le_l2[:, 2]
        return r * r * self.le_w, Xc[:, 2] > MIN_DEPTH

    def prior(self, T, X):
        """The Manhattan anchors, line-axis and line-pair costs (scalar)."""
        p, total = self.p, torch.zeros((), dtype=self.dt, device=X.device)
        if _opt(p, "kf_axes_c") is not None:
            r = self._anchor_res(T)
            total = total + (p.kf_w_axis.to(self.dt) * (r * r).sum(-1)).sum()
        if _opt(p, "lp_s") is not None:
            r, w = self._axis_res(X[p.lp_s], X[p.lp_e])
            total = total + (w * (r * r).sum(-1)).sum()
        if _opt(p, "ll_sa") is not None:
            r, w = self._pair_res(X[p.ll_sa], X[p.ll_ea], X[p.ll_sb], X[p.ll_eb])
            total = total + (w * (r * r).sum(-1)).sum()
        return total

    def _anchor_res(self, T):
        p = self.p
        return torch.einsum("kij,aj->kai", T[:, :3, :3], p.kf_axes_w.to(self.dt)) - p.kf_axes_c.to(self.dt)

    def _axis_res(self, Xs, Xe):
        p = self.p
        n = torch.linalg.norm(Xe - Xs, dim=-1)
        w = torch.where(p.lp_valid & (n > 1e-3), p.lp_w.to(self.dt), torch.zeros_like(n))
        return _axis_r(Xs, Xe, p.lp_axis.to(self.dt)), w

    def _pair_res(self, Xsa, Xea, Xsb, Xeb):
        p = self.p
        na, nb = torch.linalg.norm(Xea - Xsa, dim=-1), torch.linalg.norm(Xeb - Xsb, dim=-1)
        w = torch.where(p.ll_valid & (na > 1e-3) & (nb > 1e-3), p.ll_w.to(self.dt), torch.zeros_like(na))
        return _pair_r(Xsa, Xea, Xsb, Xeb, p.ll_kind == 1), w

    def gates(self, T, X):
        """(point inliers, line inliers, point band, line band) at a state."""
        p = self.p
        c, ok = self.point(T, X)
        cl, okl = self.line(T, X)
        e_in = p.e_valid & ok & (c <= self.gate_e)
        le_in = p.le_valid & okl & (cl <= GATE_LINE)
        return e_in, le_in, torch.abs(c - self.gate_e) <= GATE_BAND * self.gate_e, \
            torch.abs(cl - GATE_LINE) <= GATE_BAND * GATE_LINE

    def edge_cost(self, T, X, e_use, le_use, robust=False):
        c, ok = self.point(T, X)
        cl, okl = self.line(T, X)
        if robust:
            c, cl = _huber(c, self.gate_e), _huber(cl, torch.full_like(cl, GATE_LINE))
        return torch.where(e_use & ok, c, torch.zeros_like(c)).sum() + \
            torch.where(le_use & okl, cl, torch.zeros_like(cl)).sum()

    def cost(self, T, X, e_use, le_use, robust=False):
        return self.edge_cost(T, X, e_use, le_use, robust) + self.prior(T, X)


def _huber(c, d2):
    """g2o's Huber of a chi2 c with threshold d2 = delta^2."""
    return torch.where(c <= d2, c, 2.0 * torch.sqrt(d2 * torch.clamp(c, min=0.0)) - d2)


def _irls(c, d2):
    return torch.clamp(torch.sqrt(d2) / torch.sqrt(torch.clamp(c, min=1e-12)), max=1.0)


def gn_step(tm: Terms, T, X, e_use, le_use, lam: float, robust=False, free=None, hold=None):
    """One damped Gauss-Newton step (dxi (K, 6), dX (P, 3)) of the cost
    over the edges `e_use`, `le_use` and the prior terms. The keyframes
    `free` (a (K,) mask, the problem's `kf_free` by default) move; the
    landmarks `hold` (a (P,) mask) stay where they are."""
    p, cam, dt = tm.p, tm.cam, tm.dt
    K, P = T.shape[0], X.shape[0]
    Hpp = T.new_zeros((K, 6, 6))
    bp = T.new_zeros((K, 6))
    Hll = X.new_zeros((P, 3, 3))
    bl = X.new_zeros((P, 3))
    U = X.new_zeros((P * K, 6, 3))

    def add_edges(kf, lm, r, Jc, w):
        # r (N, m), Jc = d r / d X_c (N, m, 3), w (N, m): one block of edges.
        Xc = _cam(T[kf], X[lm])
        Jp = Jc @ _pose_jac(Xc)
        Jx = Jc @ T[kf, :3, :3]
        Hpp.index_add_(0, kf, (Jp * w[..., None]).transpose(1, 2) @ Jp)
        Hll.index_add_(0, lm, (Jx * w[..., None]).transpose(1, 2) @ Jx)
        U.index_add_(0, lm * K + kf, (Jp * w[..., None]).transpose(1, 2) @ Jx)
        bp.index_add_(0, kf, ((Jp * w[..., None]).transpose(1, 2) @ r[..., None])[..., 0])
        bl.index_add_(0, lm, ((Jx * w[..., None]).transpose(1, 2) @ r[..., None])[..., 0])

    c, ok = tm.point(T, X)
    w = torch.where(e_use & ok, tm.e_w, torch.zeros_like(c))
    if robust:
        w = w * _irls(c, tm.gate_e)
    Xc = _cam(T[p.e_kf], X[p.e_pt])
    u, v, iz = _uv(Xc, cam)
    r = torch.stack([u, v, u - cam["bf"] * iz], -1) - tm.e_obs
    comp = torch.stack([torch.ones_like(u), torch.ones_like(u), p.e_stereo.to(dt)], -1)
    add_edges(p.e_kf, p.e_pt, r, _proj_jac(Xc, cam), w[:, None] * comp)

    cl, okl = tm.line(T, X)
    wl = torch.where(le_use & okl, tm.le_w, torch.zeros_like(cl))
    if robust:
        wl = wl * _irls(cl, torch.full_like(cl, GATE_LINE))
    Xc = _cam(T[p.le_kf], X[p.le_lm])
    u, v, _ = _uv(Xc, cam)
    l2 = tm.le_l2
    rl = (l2[:, 0] * u + l2[:, 1] * v + l2[:, 2])[:, None]
    J = _proj_jac(Xc, cam)
    add_edges(p.le_kf, p.le_lm, rl, (l2[:, 0, None] * J[:, 0] + l2[:, 1, None] * J[:, 1])[:, None], wl[:, None])

    if _opt(p, "kf_axes_c") is not None:
        ra = tm._anchor_res(T)  # (K, 3 axes, 3)
        V = torch.einsum("kij,aj->kai", T[:, :3, :3], p.kf_axes_w.to(dt))
        Ja = -_hat(V)  # d r / d rotation, (K, 3, 3, 3)
        wa = p.kf_w_axis.to(dt)[..., None, None]
        Hpp[:, 3:, 3:] += (Ja.transpose(-1, -2) @ (wa * Ja)).sum(1)
        bp[:, 3:] += (Ja.transpose(-1, -2) @ (wa * ra[..., None]))[..., 0].sum(1)
    for rows, fn, extra, res_w in _landmark_terms(tm, X):
        from torch.func import jacrev, vmap

        xs = [X[i] for i in rows]
        Js = vmap(jacrev(fn, argnums=tuple(range(len(xs)))))(*xs, extra)
        r, wr = res_w
        for i, Ji in zip(rows, Js):
            Hll.index_add_(0, i, wr[:, None, None] * (Ji.transpose(1, 2) @ Ji))
            bl.index_add_(0, i, wr[:, None] * (Ji.transpose(1, 2) @ r[..., None])[..., 0])

    # Landmarks: isotropic damping by their largest curvature; an
    # unobserved landmark does not move.
    eye3 = torch.eye(3, dtype=dt, device=X.device)
    dmax = torch.diagonal(Hll, dim1=1, dim2=2).amax(-1)
    seen = dmax > 0
    if hold is not None:
        seen = seen & ~hold
    A = torch.linalg.inv(torch.where(seen[:, None, None], Hll + (lam * dmax + 1e-12)[:, None, None] * eye3, eye3))
    A = torch.where(seen[:, None, None], A, torch.zeros_like(A))
    U = U.view(P, K, 6, 3)
    UA = U @ A[:, None]
    S = -torch.einsum("pkac,pmdc->kmad", UA, U)
    ks = torch.arange(K, device=X.device)
    S[ks, ks] += Hpp + torch.diag_embed(lam * torch.diagonal(Hpp, dim1=1, dim2=2) + 1e-12)
    b = bp - torch.einsum("pkac,pc->ka", UA, bl)
    free = p.kf_free if free is None else free
    idx = torch.nonzero(free.to(X.device)).flatten()
    dxi = T.new_zeros((K, 6))
    if idx.numel():
        Sf = S[idx][:, idx].permute(0, 2, 1, 3).reshape(6 * idx.numel(), 6 * idx.numel())
        dxi[idx] = -torch.linalg.solve(Sf, b[idx].reshape(-1, 1)).reshape(-1, 6)
    dX = -(A @ (bl + torch.einsum("pkab,ka->pb", U, dxi))[..., None])[..., 0]
    return dxi, dX


def _landmark_terms(tm: Terms, X):
    """The terms that tie landmarks together: (landmark row tables, the
    residual of one row, its further argument, (residuals, weights))."""
    p, out = tm.p, []
    if _opt(p, "lp_s") is not None:
        out.append(((p.lp_s, p.lp_e), _axis_r, p.lp_axis.to(tm.dt), tm._axis_res(X[p.lp_s], X[p.lp_e])))
    if _opt(p, "ll_sa") is not None:
        out.append(((p.ll_sa, p.ll_ea, p.ll_sb, p.ll_eb), _pair_r, p.ll_kind == 1,
                    tm._pair_res(X[p.ll_sa], X[p.ll_ea], X[p.ll_sb], X[p.ll_eb])))
    return out


def apply(T, X, dxi, dX):
    """The state moved by a step: T <- exp(dxi^) T, X <- X + dX."""
    tw = torch.zeros((T.shape[0], 4, 4), dtype=T.dtype, device=T.device)
    tw[:, :3, :3] = _hat(dxi[:, 3:])
    tw[:, :3, 3] = dxi[:, :3]
    return torch.linalg.matrix_exp(tw) @ T, X + dX


def endpoint_rows(p, P: int):
    """(P,) mask of the landmarks that are line endpoints."""
    m = torch.zeros(P, dtype=torch.bool, device=p.le_lm.device)
    m[p.le_lm[p.le_valid]] = True
    for name in ("lp_s", "lp_e", "ll_sa", "ll_ea", "ll_sb", "ll_eb"):
        if _opt(p, name) is not None:
            m[getattr(p, name)] = True
    return m


# The point step's damping, a share of each point's largest curvature. A
# far point with few observations barely fixes its depth: an undamped step
# moves it centimetres along that valley for a few thousandths of the cost,
# which any damped solver leaves for later. The damped step reads where the
# cost holds a point; it scales a well-determined step by 1 / 1.1.
POINT_STEP_DAMPING = 0.1


def point_step_gain(tm: Terms, T, X, e_use, le_use) -> float:
    """The share of the cost that one damped Gauss-Newton step of the point
    landmarks, the keyframe poses held as given, takes off from (T, X): the
    best of the step and its halvings (0 where none lowers it). A solve
    that has converged leaves each point at its optimum for the poses it
    returns. Line endpoints stay: an endpoint's edges to 2D lines do not
    see it slide along its 3D line, so the cost does not hold it to one
    place there."""
    c0 = float(tm.cost(T, X, e_use, le_use))
    if not c0 > 0:
        return 0.0
    dxi, dX = gn_step(tm, T, X, e_use, le_use, POINT_STEP_DAMPING, free=torch.zeros_like(tm.p.kf_free),
                      hold=endpoint_rows(tm.p, X.shape[0]))
    best = c0
    for s in (1.0, 0.5, 0.25, 0.125, 0.0625):
        T2, X2 = apply(T, X, s * dxi, s * dX)
        c = float(tm.cost(T2, X2, e_use, le_use))
        if c == c:
            best = min(best, c)
    return (c0 - best) / c0


def solve(p, cam: dict, tf32: bool = False, n_iters1: int = 5, n_iters2: int = 10):
    """The two-stage solve from the problem's state; a result with the
    fields of the program's (`kf_T_cw`, `pt_X`, `e_inlier`, `le_inlier`,
    `chi2`)."""
    rnd = rounder(tf32)
    dt = torch.float32 if tf32 else torch.float64
    tm = Terms(p, cam, dt, rnd)
    T, X = rnd(p.kf_T_cw.to(dt)), rnd(p.pt_X.to(dt))
    e_use = p.e_valid & p.pt_valid[p.e_pt]
    le_use = p.le_valid & p.pt_valid[p.le_lm]

    def lm(T, X, e_use, le_use, n, robust):
        lam = 1e-4
        c = float(tm.cost(T, X, e_use, le_use, robust))
        for _ in range(n):
            T2, X2 = apply(T, X, *gn_step(tm, T, X, e_use, le_use, lam, robust))
            T2, X2 = rnd(T2), rnd(X2)
            c2 = float(tm.cost(T2, X2, e_use, le_use, robust))
            if c2 < c:
                T, X, c, lam = T2, X2, c2, max(lam * 0.5, 1e-7)
            else:
                lam = min(lam * 5.0, 1e5)
        return T, X

    T, X = lm(T, X, e_use, le_use, n_iters1, True)
    e_in, le_in, _, _ = tm.gates(T, X)
    T, X = lm(T, X, e_use & e_in, le_use & le_in, n_iters2, False)
    e_in, le_in, _, _ = tm.gates(T, X)
    return SimpleNamespace(kf_T_cw=T, pt_X=X, e_inlier=e_in, le_inlier=le_in,
                           chi2=rnd(tm.edge_cost(T, X, e_in, le_in).to(torch.float32)))


def judge(p, res, cam: dict) -> dict:
    """The numbers of a BA result `res` for its problem `p`, in float64:
    - `ba_chi2_rel_err`: the cost the result reports against the cost of
      its poses and landmarks over the edges the reference's gates pass
      there (the result's flag inside the rounding band of a gate);
    - `ba_flags_wrong`: edges whose inlier flag differs from the gate's
      outside that band;
    - `ba_cost_ratio`: the whole cost over those edges at the returned
      state, over the same at the problem's state;
    - `ba_point_step_gain`: the share of that cost one more damped
      Gauss-Newton step of the point landmarks at the returned poses takes
      off."""
    tm = Terms(p, cam, torch.float64, rounder(False))
    T, X = res.kf_T_cw.double(), res.pt_X.double()
    e_in, le_in, e_band, le_band = tm.gates(T, X)
    wrong = int(((res.e_inlier != e_in) & ~e_band).sum()) + int(((res.le_inlier != le_in) & ~le_band).sum())
    e_use = torch.where(e_band, res.e_inlier, e_in)
    le_use = torch.where(le_band, res.le_inlier, le_in)
    want = float(tm.edge_cost(T, X, e_use, le_use))
    got = float(res.chi2)
    after = want + float(tm.prior(T, X))
    before = float(tm.cost(p.kf_T_cw.double(), p.pt_X.double(), e_use, le_use))
    return dict(ba_chi2_rel_err=abs(got - want) / max(abs(want), 1e-12), ba_flags_wrong=float(wrong),
                ba_cost_ratio=after / before if before > 0 else (0.0 if after == 0 else float("inf")),
                ba_point_step_gain=point_step_gain(tm, T, X, e_use, le_use))
