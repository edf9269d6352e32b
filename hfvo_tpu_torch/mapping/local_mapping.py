"""Local mapping: the keyframe-path bookkeeping that runs without BA.

Port of the host-side parts of `hfvo_tpu.mapping.local_mapping` that
keyframe insertion calls when local BA is off: duplicate-point and
duplicate-line fusion (`fuse_points`, `fuse_lines`), distinctive-descriptor
re-election (`reelect_point_descriptors`) and redundant-keyframe culling
(`cull_keyframes`). They are numpy over the flat map tables, as in the JAX
package. Local BA (`solve/ba.py`), epipolar point triangulation and line
triangulation arrive with the keyframe-path slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import VOConfig
from ..vomap.map import VOMap

# Set-bit count of every byte value (popcount lookup for Hamming distances).
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


@dataclass
class LocalMapper:
    cfg: VOConfig
    vomap: VOMap
    _kf_db: object = None  # KeyFrameDatabase for erase-on-cull (set by Tracker)
    # The tracker's world Manhattan axes once initialized (local BA's axis
    # anchors read them, with the keyframe-path slice).
    R_wm: np.ndarray | None = None
    manh_valid: bool = False

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
