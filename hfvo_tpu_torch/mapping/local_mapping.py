"""Local mapping: new landmarks, local BA and the keyframe bookkeeping.

Port of `hfvo_tpu.mapping.local_mapping` on one device (reference:
src/LocalMapping.cc:53-155): epipolar point triangulation
(`create_new_map_points`) and two-view line triangulation with a third
view's check (`create_new_map_lines`) on the device (`ops/triangulate.py`);
local BA (`run_local_ba`): the window and frontier from covisibility, the
point, line-endpoint, line-axis and par/perp edges and the per-keyframe
axis anchors assembled on the host into a fixed-capacity `BAProblem`,
solved by the Schur LM on the device (`solve/ba.py`), and written back with
the outlier observations erased (reference: src/Optimizer.cc:3902-3941);
duplicate-point and duplicate-line fusion, distinctive-descriptor
re-election and redundant-keyframe culling (numpy over the flat map tables,
as in the JAX package). With `use_distributed` and a process group of more
than one rank, local BA is split over the ranks (`parallel/dist_ba.py`);
every rank must hold the same map, as every JAX device does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..config import VOConfig
from ..ops.batch import to_host
from ..solve.ba import BAProblem, final_gate, local_bundle_adjustment
from ..vomap.map import VOMap

# Set-bit count of every byte value (popcount lookup for Hamming distances).
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
# Oldest window keyframes held fixed as the gauge: RGB-D has metric scale,
# so one fixed pose pins it (hfvo_tpu/mapping/local_mapping.py:31-34).
_N_FIXED = 1


@dataclass
class LocalMapper:
    cfg: VOConfig
    vomap: VOMap
    device: torch.device = "cuda"  # where triangulation and BA run (the tracker's)
    n_ba_runs: int = 0
    # Local BA split over the ranks of the default process group when it has
    # more than one (the JAX package's over several devices); on one rank
    # the single-device BA runs, as the JAX package's on one device.
    use_distributed: bool = False
    _kf_db: object = None  # KeyFrameDatabase for erase-on-cull (set by Tracker)
    # The tracker's world Manhattan axes once initialized; they enable the
    # per-keyframe axis anchors and the line-axis edges of local BA.
    R_wm: np.ndarray | None = None
    manh_valid: bool = False

    def _up(self, a: np.ndarray) -> torch.Tensor:
        with tracing.span("upload"):
            a = np.ascontiguousarray(a)
            if a.dtype in (np.int32, np.uint32):
                a = a.astype(np.int64)
            return torch.from_numpy(a).to(self.device)

    def run_local_ba(self) -> bool:
        """Optimize the recent keyframe window; returns True if BA ran.

        Gate mirrors the reference (`KeyFramesInMap() > 3`,
        src/LocalMapping.cc:116)."""
        with tracing.span("ba.build"):
            vm = self.vomap
            kf_ids = np.nonzero(vm.keyframes.valid)[0]
            if len(kf_ids) <= 3:
                return False
            cap = self.cfg.cap
            K = cap.local_kfs
            # Window = newest KF + its best-connected covisible neighbours; the
            # fixed frontier = further covisible KFs that share points with the
            # window (reference: src/Optimizer.cc:3025-3120). The frontier goes
            # FIRST in the pose array so its rows are the fixed ones.
            newest = vm.newest_kf_slot
            free_kfs = vm.local_kf_window(K - _N_FIXED)
            neigh_all = vm.covisible_kfs(newest, min_weight=1, cap=0)
            in_window = set(free_kfs.tolist())
            frontier = np.asarray([s for s in neigh_all if s not in in_window],
                                  dtype=np.int64)[: max(_N_FIXED, cap.ba_fixed_kfs)]
            if len(frontier) == 0:
                # No covisible frontier (early map): fix the oldest window KF.
                order = np.argsort(vm.keyframes.order[free_kfs], kind="stable")
                free_kfs = free_kfs[order]
                frontier, free_kfs = free_kfs[:1], free_kfs[1:]
            if len(frontier) + len(free_kfs) > K:
                frontier = frontier[: K - len(free_kfs)]
            window = np.concatenate([frontier, free_kfs])
            n_fixed = len(frontier)

            kf = vm.keyframes
            # Point edges from the window's observation snapshots.
            pid = kf.point_id[window]  # (k, C)
            ov = kf.obs_valid[window] & (pid >= 0) & vm.points.valid[np.maximum(pid, 0)]
            k_idx, c_idx = np.nonzero(ov)
            e_pt_global = pid[k_idx, c_idx]
            e_obs = kf.obs[window][k_idx, c_idx]
            e_oct = kf.octave[window][k_idx, c_idx]
            e_stereo = e_obs[:, 2] > 0

            upts, e_pt_local = np.unique(e_pt_global, return_inverse=True)
            P = cap.local_points
            E = cap.ba_edges
            if len(upts) > P:
                # Keep the most-observed points.
                counts = np.bincount(e_pt_local, minlength=len(upts))
                keep = np.argsort(-counts)[:P]
                keep_mask = np.isin(e_pt_local, keep)
                remap = np.full(len(upts), -1, np.int64)
                remap[keep] = np.arange(len(keep))
                k_idx, c_idx = k_idx[keep_mask], c_idx[keep_mask]
                e_pt_local = remap[e_pt_local[keep_mask]]
                e_obs, e_oct, e_stereo = e_obs[keep_mask], e_oct[keep_mask], e_stereo[keep_mask]
                upts = upts[keep]
            if len(k_idx) > E:
                sel = np.random.RandomState(0).choice(len(k_idx), E, replace=False)
                k_idx, c_idx = k_idx[sel], c_idx[sel]
                e_pt_local, e_obs, e_oct, e_stereo = e_pt_local[sel], e_obs[sel], e_oct[sel], e_stereo[sel]
            ne = len(k_idx)
            npt = len(upts)

            def pad(a, n, fill=0):
                out = np.full((n,) + a.shape[1:], fill, a.dtype)
                out[: len(a)] = a
                return out

            T_full = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
            T_full[: len(window)] = kf.T_cw[window]
            free = np.zeros((K,), bool)
            free[n_fixed: len(window)] = True

            # Line-endpoint edges: two landmark rows per map line, after the
            # points (reference: src/Optimizer.cc:3368-3378).
            kl = vm.kf_lines
            lid = kl.line_id[window]
            lov = kl.obs_valid[window] & (lid >= 0) & vm.lines.valid[np.maximum(lid, 0)]
            lk_idx, lc_idx = np.nonzero(lov)
            le_line2d = kl.line2d[window][lk_idx, lc_idx]
            ulines, le_line_local = np.unique(lid[lk_idx, lc_idx], return_inverse=True)
            if npt + 2 * len(ulines) > P:
                # Capacity: points take priority over line edges.
                max_lines = max((P - npt) // 2, 0)
                keepl = le_line_local < max_lines
                lk_idx, lc_idx = lk_idx[keepl], lc_idx[keepl]
                le_line_local, le_line2d = le_line_local[keepl], le_line2d[keepl]
                ulines = ulines[:max_lines]
            nu = len(ulines)
            lm_X = vm.points.X_w[upts].astype(np.float32)
            if nu:
                lm_X = np.concatenate([lm_X, vm.lines.X0_w[ulines].astype(np.float32),
                                       vm.lines.X1_w[ulines].astype(np.float32)])
            n_lm = len(lm_X)
            # Endpoint landmark rows: X0 at npt + i, X1 at npt + nu + i.
            le_kf = np.concatenate([lk_idx, lk_idx]).astype(np.int32)
            le_lm = np.concatenate([npt + le_line_local, npt + nu + le_line_local]).astype(np.int32)
            le_l2d = np.concatenate([le_line2d, le_line2d]).astype(np.float32)
            El = cap.ba_edges // 4
            nle = min(len(le_kf), El)
            le_kf, le_lm, le_l2d = le_kf[:nle], le_lm[:nle], le_l2d[:nle]

            extra = {}
            mc = self.cfg.manhattan
            manh = self.manh_valid and self.cfg.use_manhattan and self.R_wm is not None
            # Line-axis edges: each Manhattan-assigned map line in the window
            # keeps its endpoint pair parallel to its world axis (reference:
            # ParEptsNVector3DSingleFrame, src/Optimizer.cc:3382-3410).
            if nu and manh:
                LPC = cap.ba_line_pairs
                nl = min(nu, LPC)
                lp_s = np.zeros((LPC,), np.int32)
                lp_e = np.zeros((LPC,), np.int32)
                lp_axis = np.zeros((LPC, 3), np.float32)
                lp_w = np.zeros((LPC,), np.float32)
                lp_valid = np.zeros((LPC,), bool)
                midx = vm.lines.manh_idx[ulines[:nl]]
                lp_s[:nl] = npt + np.arange(nl)
                lp_e[:nl] = npt + nu + np.arange(nl)
                lp_axis[:nl] = self.R_wm.T[np.maximum(midx, 0)]
                lp_w[:nl] = np.where(midx >= 0, mc.line_axis_info, 0.0)
                lp_valid[:nl] = True
                extra.update(lp_s=lp_s, lp_e=lp_e, lp_axis=lp_axis, lp_w=lp_w, lp_valid=lp_valid)

            # Cross-line par/perp edges between the window's map lines, found
            # from their world directions at the frame-level thresholds (3 deg
            # par / 87 deg perp, src/Manhattan.cpp:28-34); the fixed-shape
            # tables are passed (possibly all invalid) whenever lines are on.
            if self.cfg.use_lines:
                LQ = cap.ba_line_pair_edges
                ll = {k: np.zeros((LQ,), np.int32) for k in ("ll_sa", "ll_ea", "ll_sb", "ll_eb", "ll_kind")}
                ll_w = np.zeros((LQ,), np.float32)
                ll_valid = np.zeros((LQ,), bool)
                if nu >= 2:
                    dirs = vm.lines.X1_w[ulines] - vm.lines.X0_w[ulines]
                    dn = np.linalg.norm(dirs, axis=1)
                    dirs = dirs / np.maximum(dn, 1e-9)[:, None]
                    usable = dn > 1e-3
                    C = np.abs(dirs @ dirs.T)
                    iu, ju = np.triu_indices(nu, 1)
                    ok_pair = usable[iu] & usable[ju]
                    cosv = C[iu, ju]
                    is_par = ok_pair & (cosv > np.cos(np.radians(mc.par_deg_2d3d)))
                    is_perp = ok_pair & (cosv < np.cos(np.radians(mc.perp_deg_2d3d)))
                    pi = np.concatenate([iu[is_par], iu[is_perp]])
                    pj = np.concatenate([ju[is_par], ju[is_perp]])
                    pkind = np.concatenate([np.zeros(int(is_par.sum()), np.int32),
                                            np.ones(int(is_perp.sum()), np.int32)])
                    if len(pi) > LQ:
                        sel = np.random.RandomState(1).choice(len(pi), LQ, replace=False)
                        pi, pj, pkind = pi[sel], pj[sel], pkind[sel]
                    nq = len(pi)
                    ll["ll_sa"][:nq] = npt + pi
                    ll["ll_ea"][:nq] = npt + nu + pi
                    ll["ll_sb"][:nq] = npt + pj
                    ll["ll_eb"][:nq] = npt + nu + pj
                    ll["ll_kind"][:nq] = pkind
                    ll_w[:nq] = mc.line_pair_info
                    ll_valid[:nq] = True
                extra.update(ll, ll_w=ll_w, ll_valid=ll_valid)

            # Per-KF Manhattan axis anchors: the axes each KF measured from its
            # normals pin the window's rotations, so BA cannot walk keyframe
            # poses along the per-frame (t_x, r_y) valley. Same gates as the
            # tracker's anchors.
            if manh:
                axc = kf.axes_c[window].astype(np.float32)  # (k, 3, 3)
                sup = kf.axes_sup[window].astype(np.float32)  # (k, 3)
                axes_w = self.R_wm.T.astype(np.float32)  # rows = world axes
                pred = np.einsum("kij,aj->kai", kf.T_cw[window][:, :3, :3], axes_w)
                cos_ax = np.sum(pred * axc, axis=-1)
                ok = (sup >= mc.rot_prior_min_support) & (cos_ax > np.cos(mc.rot_prior_max_correction))
                w_raw = mc.rot_prior_weight * sup
                w_sat = w_raw / (1.0 + w_raw * mc.rot_prior_bias ** 2)
                axc_full = np.zeros((K, 3, 3), np.float32)
                axc_full[: len(window)] = axc
                w_full = np.zeros((K, 3), np.float32)
                w_full[: len(window)] = np.where(ok, w_sat, 0.0)
                extra.update(kf_axes_c=axc_full, kf_axes_w=axes_w, kf_w_axis=w_full)

            host = BAProblem(
                kf_T_cw=T_full, kf_free=free,
                pt_X=pad(lm_X, P), pt_valid=pad(np.ones(n_lm, bool), P),
                e_kf=pad(k_idx.astype(np.int32), E),
                e_pt=pad(e_pt_local.astype(np.int32), E),
                e_obs=pad(e_obs.astype(np.float32), E),
                e_stereo=pad(e_stereo, E),
                e_inv_sigma2=pad((1.0 / 1.2 ** (2.0 * e_oct)).astype(np.float32), E),
                e_valid=pad(np.ones(ne, bool), E),
                le_kf=pad(le_kf, El), le_lm=pad(le_lm, El),
                le_line2d=pad(le_l2d, El),
                le_inv_sigma2=pad(np.ones(nle, np.float32), El),
                le_valid=pad(np.ones(nle, bool), El),
                **extra,
            )
            prob = BAProblem(*(None if a is None else self._up(a) for a in host))
        with tracing.span("ba.solve"):
            if self.use_distributed and dist.is_initialized() and dist.get_world_size() > 1:
                res = self._dist_local_ba(prob, host, npt, nu)
            else:
                res = local_bundle_adjustment(prob, self.cfg.camera)
            T_new, lm_out, inlier, le_inlier = to_host([res.kf_T_cw, res.pt_X, res.e_inlier, res.le_inlier])
        with tracing.span("ba.writeback"):

            # Write back poses, points and line endpoints.
            kf.T_cw[window] = T_new[: len(window)]
            vm.points.X_w[upts] = lm_out[:npt]
            if nu:
                vm.lines.X0_w[ulines] = lm_out[npt: npt + nu]
                vm.lines.X1_w[ulines] = lm_out[npt + nu: npt + 2 * nu]
            # Erase outlier observations (reference: Optimizer.cc:3907-3929).
            bad = ~inlier[:ne]
            if bad.any():
                bk, bc = k_idx[bad], c_idx[bad]
                kf.obs_valid[window[bk], bc] = False
                np.add.at(vm.points.n_obs, kf.point_id[window[bk], bc], -1)
                kf.point_id[window[bk], bc] = -1
            # An edge covers one endpoint; a line observation is erased when
            # either of its endpoint edges fails the gate.
            le_in = le_inlier[:nle]
            half = nle // 2
            bad_l = ~(le_in[:half] & le_in[half: 2 * half])
            if bad_l.any():
                blk, blc = lk_idx[:half][bad_l], lc_idx[:half][bad_l]
                kl.obs_valid[window[blk], blc] = False
                np.add.at(vm.lines.n_obs, kl.line_id[window[blk], blc], -1)
                kl.line_id[window[blk], blc] = -1
            self.n_ba_runs += 1
            return True

    def _dist_local_ba(self, prob: BAProblem, host: BAProblem, npt: int, nu: int):
        """Local BA split over the ranks of the default process group
        (hfvo_tpu/mapping/local_mapping.py:301-340): the blocked problem with
        each line's endpoint rows on one rank, solved; the landmarks
        un-permuted and the inliers gated again in the original edge order
        with the single-device rule."""
        from ..parallel.dist_ba import dist_local_bundle_adjustment, shard_ba_problem, unshard_points
        from ..parallel.mesh import make_mesh

        mesh = make_mesh()
        # Line i's endpoints sit at rows (npt + i, npt + nu + i).
        pairs = np.stack([npt + np.arange(nu), npt + nu + np.arange(nu)], axis=1) if nu else None
        sp = shard_ba_problem(host, mesh.shape["edge"], pair_rows=pairs)
        kf_T, pt_X, _, _ = dist_local_bundle_adjustment(mesh, sp, self.cfg.camera, device=self.device)
        return final_gate(prob, kf_T, self._up(unshard_points(sp, pt_X)), self.cfg.camera)

    def create_new_map_points(self, max_neighbors: int = 5) -> int:
        """Triangulate new map points for the newest keyframe's landmark-less
        keypoints against its `max_neighbors` best covisible neighbours (reference:
        LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:335-660); all
        neighbours in one batched call and one pull. Depth already
        landmarks keypoints with valid depth; this reaches beyond the depth
        range. Returns the number of points created."""
        vm = self.vomap
        newest = vm.newest_kf_slot
        if newest < 0 or not vm.keyframes.valid[newest]:
            return 0
        kf = vm.keyframes
        cam = self.cfg.camera
        neigh = vm.covisible_kfs(newest, min_weight=10, cap=max_neighbors)
        if len(neigh) == 0:
            return 0
        from ..ops.triangulate import triangulate_multi

        cand_a = kf.kp_valid[newest] & (kf.point_id[newest] < 0)
        uv_a = kf.obs[newest, :, :2]
        T_a = kf.T_cw[newest]
        C_a = -T_a[:3, :3].T @ T_a[:3, 3]
        # The RGB-D virtual stereo baseline: closer neighbours add no
        # parallax beyond depth (reference: src/LocalMapping.cc:398-410).
        min_baseline = cam.bf / cam.fx
        Nn = max_neighbors
        C = uv_a.shape[0]
        uv_b = np.zeros((Nn, C, 2), np.float32)
        desc_b = np.zeros((Nn,) + kf.desc[newest].shape, kf.desc.dtype)
        cand_b = np.zeros((Nn, C), bool)
        oct_b = np.zeros((Nn, C), np.int32)
        T_ab = np.tile(np.eye(4, dtype=np.float32), (Nn, 1, 1))
        used = []
        for nb in neigh:
            T_b = kf.T_cw[nb]
            C_b = -T_b[:3, :3].T @ T_b[:3, 3]
            if np.linalg.norm(C_a - C_b) < min_baseline:
                continue
            cb = kf.kp_valid[nb] & (kf.point_id[nb] < 0)
            if not cb.any():
                continue
            j = len(used)
            if j >= Nn:
                break
            uv_b[j] = kf.obs[nb, :, :2]
            desc_b[j] = kf.desc[nb]
            cand_b[j] = cb
            oct_b[j] = kf.octave[nb]
            T_ab[j] = (T_a @ np.linalg.inv(T_b)).astype(np.float32)
            used.append(int(nb))
        if not used:
            return 0
        up = self._up
        res = triangulate_multi(
            cam, up(uv_a.astype(np.float32)), up(kf.desc[newest]), up(cand_a),
            up(kf.octave[newest]), up(uv_b), up(desc_b), up(cand_b), up(oct_b), up(T_ab),
            scale_factor=self.cfg.orb.scale_factor,
        )
        ok_all, match_all, X_all = to_host([res.ok, res.match_b, res.X_a])
        T_wa = np.linalg.inv(T_a)
        created = 0
        for j, nb in enumerate(used):
            ia = np.nonzero(ok_all[j] & cand_a)[0]
            if len(ia) == 0:
                continue
            ib = match_all[j][ia]
            X_w = (T_wa[:3, :3] @ X_all[j][ia].T).T + T_wa[:3, 3]
            normal = X_w - C_a[None, :]
            normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-9
            ids = vm.add_points(
                X_w.astype(np.float32), kf.desc[newest][ia], normal.astype(np.float32),
                kf.octave[newest][ia], int(kf.frame_id[newest]),
            )
            made = ids >= 0
            ia, ib, ids = ia[made], ib[made], ids[made]
            if len(ia) == 0:
                continue
            # Register both observations (mono edges: u_r stays -1).
            kf.point_id[newest, ia] = ids
            kf.obs_valid[newest, ia] = True
            kf.point_id[nb, ib] = ids
            kf.obs_valid[nb, ib] = True
            vm.points.n_obs[ids] = 2
            vm.points.first_kf[ids] = newest
            cand_a[ia] = False
            created += len(ia)
        return created

    def create_new_map_lines(self, max_neighbors: int = 3) -> int:
        """Triangulate new map lines for the newest keyframe's landmark-less
        segments against up to `max_neighbors` covisible neighbours, each
        checked in a third keyframe (reference: LocalMapping::CreateNewMapLinesConstraint,
        src/LocalMapping.cc:1064-1203). Returns the number of lines
        created."""
        vm = self.vomap
        newest = vm.newest_kf_slot
        if newest < 0 or not vm.keyframes.valid[newest]:
            return 0
        kf = vm.keyframes
        kl = vm.kf_lines
        cam = self.cfg.camera
        neigh = vm.covisible_kfs(newest, min_weight=10, cap=max_neighbors + 1)
        if len(neigh) < 2:
            return 0
        from ..ops.triangulate import triangulate_lines_pair

        cand_a = kl.seg_valid[newest] & (kl.line_id[newest] < 0)
        if not cand_a.any():
            return 0
        T_a = kf.T_cw[newest]
        C_a = -T_a[:3, :3].T @ T_a[:3, 3]
        min_baseline = cam.bf / cam.fx
        T_wa = np.linalg.inv(T_a)
        up = self._up
        created = 0
        for nb in neigh[:max_neighbors]:
            if not cand_a.any():
                break
            T_b = kf.T_cw[nb]
            C_b = -T_b[:3, :3].T @ T_b[:3, 3]
            if np.linalg.norm(C_a - C_b) < min_baseline:
                continue
            cand_b = kl.seg_valid[nb] & (kl.line_id[nb] < 0)
            if not cand_b.any():
                continue
            # Third view: the best covisible neighbour that is not b.
            third = [c for c in neigh if c != nb][0]
            T_ab = (T_a @ np.linalg.inv(T_b)).astype(np.float32)
            T_ca = (kf.T_cw[third] @ T_wa).astype(np.float32)
            res = triangulate_lines_pair(
                cam, up(kl.p0[newest]), up(kl.p1[newest]), up(kl.desc[newest]), up(cand_a),
                up(kl.p0[nb]), up(kl.p1[nb]), up(kl.desc[nb]), up(cand_b), up(T_ab),
                up(kl.p0[third]), up(kl.p1[third]), up(kl.seg_valid[third]), up(T_ca),
            )
            ok, mb, X0a, X1a = to_host([res.ok, res.match_b, res.X0_a, res.X1_a])
            ia = np.nonzero(ok & cand_a)[0]
            if len(ia) == 0:
                continue
            ib = mb[ia]
            X0w = (T_wa[:3, :3] @ X0a[ia].T).T + T_wa[:3, 3]
            X1w = (T_wa[:3, :3] @ X1a[ia].T).T + T_wa[:3, 3]
            lids = vm.add_lines(
                X0w.astype(np.float32), X1w.astype(np.float32), kl.desc[newest][ia],
                int(kf.frame_id[newest]), first_kf=newest,
            )
            made = lids >= 0
            ia, ib, lids = ia[made], ib[made], lids[made]
            if len(ia) == 0:
                continue
            kl.line_id[newest, ia] = lids
            kl.obs_valid[newest, ia] = True
            kl.line_id[nb, ib] = lids
            kl.obs_valid[nb, ib] = True
            vm.lines.n_obs[lids] = 2
            # line2d of the b observation from its own segment.
            h0 = np.concatenate([kl.p0[nb][ib], np.ones((len(ib), 1))], axis=1)
            h1 = np.concatenate([kl.p1[nb][ib], np.ones((len(ib), 1))], axis=1)
            l2 = np.cross(h0, h1)
            l2 /= np.linalg.norm(l2[:, :2], axis=1, keepdims=True) + 1e-9
            kl.line2d[nb, ib] = l2.astype(np.float32)
            cand_a[ia] = False
            created += len(ia)
        return created

    def fuse_points(self, radius_px: float = 2.0, max_desc: int = 30) -> int:
        """Merge duplicate map points observed by the recent window.

        (reference: LocalMapping::SearchInNeighbors -> ORBmatcher::Fuse,
        src/LocalMapping.cc:1567, src/ORBmatcher.cc:838: project candidates
        into neighbor keyframes and Replace on match.) Here: project every
        windowed point into the newest keyframe, bucket by pixel cell, and
        merge near-coincident points with close descriptors — the survivor
        is the more-observed one, and keyframe observations re-point to it.
        """
        vm = self.vomap
        if vm.n_keyframes() < 2 or vm.newest_kf_slot < 0:
            return 0
        newest = vm.newest_kf_slot
        T = vm.keyframes.T_cw[newest]
        cam = self.cfg.camera
        ids = vm.local_point_ids(self.cfg.cap.local_kfs, self.cfg.cap.local_points)
        if len(ids) < 2:
            return 0
        p = vm.points
        X = p.X_w[ids]
        Xc = (T[:3, :3] @ X.T).T + T[:3, 3]
        z = Xc[:, 2]
        vis = z > 0.1
        u = cam.fx * Xc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * Xc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        vis &= (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        cell = (np.floor(v / radius_px).astype(np.int64) * 10000
                + np.floor(u / radius_px).astype(np.int64))
        cell[~vis] = -1
        # Vectorized duplicate detection: sort by (cell, depth); duplicate
        # candidates are sort-adjacent entries sharing a cell (offset 1 and
        # 2 cover the typical 2-3-point buckets; chains resolve over the
        # repeated per-keyframe calls). One batched Hamming check — no
        # per-bucket Python loop.
        ord_idx = np.lexsort((z, cell))
        sc = cell[ord_idx]
        cand_a, cand_b = [], []
        for off in (1, 2):
            same = (sc[:-off] == sc[off:]) & (sc[:-off] >= 0)
            cand_a.append(ord_idx[:-off][same])
            cand_b.append(ord_idx[off:][same])
        A = np.concatenate(cand_a)
        B = np.concatenate(cand_b)
        if len(A) == 0:
            return 0
        dz_ok = np.abs(z[A] - z[B]) <= 0.05
        A, B = A[dz_ok], B[dz_ok]
        if len(A) == 0:
            return 0
        da = p.desc[ids[A]].view(np.uint8)
        db = p.desc[ids[B]].view(np.uint8)
        hd = _POP8[np.bitwise_xor(da, db)].sum(axis=1)
        keep_pair = hd <= max_desc
        A, B = A[keep_pair], B[keep_pair]
        remap = {}
        for a, b in zip(ids[A], ids[B]):  # only actual merge pairs (few)
            ia, ib = int(a), int(b)
            while ia in remap:
                ia = remap[ia]
            while ib in remap:
                ib = remap[ib]
            if ia == ib or not (p.valid[ia] and p.valid[ib]):
                continue
            keep, drop = (ia, ib) if p.n_obs[ia] >= p.n_obs[ib] else (ib, ia)
            remap[drop] = keep
            p.n_obs[keep] += p.n_obs[drop]
            p.n_found[keep] += p.n_found[drop]
            p.n_visible[keep] += p.n_visible[drop]
            p.valid[drop] = False
        if remap:
            # Resolve chains drop->keep->keep2, then one vectorized re-point.
            def resolve(k):
                while k in remap:
                    k = remap[k]
                return k

            lut = np.arange(p.valid.shape[0], dtype=np.int32)
            for d_, k_ in remap.items():
                lut[d_] = resolve(k_)
            pid = vm.keyframes.point_id
            mask = pid >= 0
            pid[mask] = lut[pid[mask]]
        return len(remap)

    def fuse_lines(self, max_desc: float = 0.4) -> int:
        """Merge duplicate map lines observed by the local window
        (reference: LocalMapping::SearchLineInNeighbors -> LSDmatcher::Fuse,
        src/LocalMapping.cc:1699, src/LSDmatcher.cpp:1297). Vectorized:
        pairwise direction alignment + mutual endpoint-to-line distance +
        descriptor distance; the survivor is the more-observed line and
        keyframe observations re-point to it. Returns #merges."""
        vm = self.vomap
        ids = vm.local_line_ids(self.cfg.cap.local_kfs, self.cfg.cap.local_lines)
        if len(ids) < 2:
            return 0
        t = vm.lines
        X0, X1 = t.X0_w[ids], t.X1_w[ids]
        d = X1 - X0
        ln = np.linalg.norm(d, axis=1)
        usable = ln > 1e-3
        u = d / np.maximum(ln, 1e-9)[:, None]
        cosd = np.abs(u @ u.T)
        # Perpendicular distance of i's midpoint to j's infinite line.
        mid = 0.5 * (X0 + X1)
        rel = mid[:, None, :] - X0[None, :, :]  # (n, n, 3)
        along = np.einsum("ijc,jc->ij", rel, u)
        perp = rel - along[:, :, None] * u[None, :, :]
        dperp = np.linalg.norm(perp, axis=-1)
        # Along-line overlap: i's midpoint must fall inside j's span (+20%).
        overlap = (along > -0.2 * ln[None, :]) & (along < 1.2 * ln[None, :])
        desc = t.desc[ids]
        dn = desc / (np.linalg.norm(desc, axis=1, keepdims=True) + 1e-9)
        ddist = 1.0 - dn @ dn.T
        near = (
            (cosd > np.cos(np.radians(3.0)))
            & (dperp < 0.08) & (dperp.T < 0.08)
            & overlap & overlap.T
            & (ddist < max_desc)
            & usable[:, None] & usable[None, :]
        )
        np.fill_diagonal(near, False)
        ai, bj = np.nonzero(np.triu(near, 1))
        if len(ai) == 0:
            return 0
        remap: dict = {}
        for a, b in zip(ids[ai], ids[bj]):
            ia, ib = int(a), int(b)
            while ia in remap:
                ia = remap[ia]
            while ib in remap:
                ib = remap[ib]
            if ia == ib or not (t.valid[ia] and t.valid[ib]):
                continue
            keep, drop = (ia, ib) if t.n_obs[ia] >= t.n_obs[ib] else (ib, ia)
            remap[drop] = keep
            t.n_obs[keep] += t.n_obs[drop]
            t.n_found[keep] += t.n_found[drop]
            t.n_visible[keep] += t.n_visible[drop]
            t.valid[drop] = False
        if remap:
            def resolve(k):
                while k in remap:
                    k = remap[k]
                return k

            lut = np.arange(t.valid.shape[0], dtype=np.int32)
            for d_, k_ in remap.items():
                lut[d_] = resolve(k_)
            lid = vm.kf_lines.line_id
            mask = lid >= 0
            lid[mask] = lut[lid[mask]]
        return len(remap)

    def reelect_point_descriptors(self, max_window: int = 6) -> int:
        """Re-elect each tracked point's distinctive descriptor: among its
        observation descriptors across the covisible keyframe window, keep
        the one with the smallest median Hamming distance to the others
        (reference: MapPoint::ComputeDistinctiveDescriptors,
        src/MapPoint.cc:120-170, run per processed keyframe from
        LocalMapping::ProcessNewKeyFrame, src/LocalMapping.cc:185-257).

        Batched: one (W, W, P) popcount tensor over the window's
        observation descriptors — no per-point loop."""
        vm = self.vomap
        newest = vm.newest_kf_slot
        if newest < 0 or vm.n_keyframes() < 2:
            return 0
        kf = vm.keyframes
        window = np.concatenate(
            [[newest], vm.covisible_kfs(newest, min_weight=1, cap=max_window - 1)]
        ).astype(np.int64)
        W = len(window)
        if W < 2:
            return 0
        pid_new = kf.point_id[newest]
        tgt = np.unique(pid_new[kf.obs_valid[newest] & (pid_new >= 0)])
        tgt = tgt[vm.points.valid[tgt]]
        P = len(tgt)
        if P == 0:
            return 0
        descs = np.zeros((W, P, 8), np.uint32)
        have = np.zeros((W, P), bool)
        inv = np.full((vm.points.valid.shape[0],), -1, np.int64)
        for w, k in enumerate(window):
            pid = kf.point_id[k]
            rows = np.nonzero(kf.obs_valid[k] & (pid >= 0))[0]
            inv[:] = -1
            inv[pid[rows]] = rows
            r = inv[tgt]
            hv = r >= 0
            descs[w, hv] = kf.desc[k, r[hv]]
            have[w, hv] = True
        nobs = have.sum(0)
        if not (nobs >= 2).any():
            return 0
        d8 = descs.view(np.uint8)  # (W, P, 32)
        x = _POP8[d8[:, None] ^ d8[None, :]].sum(-1).astype(np.int32)
        big = np.int32(10000)
        x = np.where(have[:, None] & have[None, :], x, big)
        # Reference semantics: for candidate i the score is the median of
        # its distances to ALL of the point's observations (self distance 0
        # included), i.e. sorted[(n-1)//2]; invalid pairs sort to the back.
        xs = np.sort(x, axis=1)  # (W, W, P)
        med_idx = np.broadcast_to((nobs - 1) // 2, (W, P))[:, None, :]
        med = np.take_along_axis(xs, med_idx.astype(np.int64), axis=1)[:, 0, :]
        med = np.where(have, med, big)
        best_w = med.argmin(axis=0)
        ar = np.arange(P)
        upd = (nobs >= 2) & have[best_w, ar]
        vm.points.desc[tgt[upd]] = descs[best_w, ar][upd]
        return int(upd.sum())

    def cull_keyframes(self) -> list:
        """Cull keyframes whose close points are >=90% observed by >=3 other
        keyframes at the same or finer octave (reference:
        LocalMapping::KeyFrameCulling, src/LocalMapping.cc:1875-1990).
        Returns the culled slots so the tracker can re-anchor trajectory
        entries before the slots are recycled."""
        vm = self.vomap
        order = vm.kf_slots_by_order()
        if len(order) <= 5:
            return []
        kf = vm.keyframes
        culled = []
        # Per-point octave of each observation, gathered once: for candidate
        # KF k, an observation elsewhere is redundant cover if its octave is
        # <= the candidate's octave + 1 (reference: scaleLevel <=
        # scaleLevel + 1, src/LocalMapping.cc:1930).
        for k in order[2:-2]:  # never cull the map origin pair or newest two
            pid = kf.point_id[k]
            ov = kf.obs_valid[k] & (pid >= 0)
            n_own = int(ov.sum())
            if n_own == 0:
                culled.append(int(k))
                continue
            own_pids = pid[ov]
            own_oct = kf.octave[k][ov]
            oct_of = np.full((vm.points.valid.shape[0],), -2, np.int32)
            oct_of[own_pids] = own_oct
            flag = oct_of >= 0
            others = np.nonzero(kf.valid)[0]
            others = others[others != k]
            opid = kf.point_id[others]
            oov = kf.obs_valid[others] & (opid >= 0)
            safe = np.maximum(opid, 0)
            covers = oov & flag[safe] & (kf.octave[others] <= oct_of[safe] + 1)
            n_cover = np.zeros((vm.points.valid.shape[0],), np.int32)
            np.add.at(n_cover, safe[covers], 1)
            redundant = n_cover[own_pids] >= 3
            if redundant.mean() > 0.9:
                culled.append(int(k))
        for k in culled:
            vm.release_keyframe(k)  # decrements landmark n_obs itself
            if self._kf_db is not None:
                self._kf_db.erase(int(k))
        return culled
