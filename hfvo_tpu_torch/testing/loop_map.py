"""A synthetic loop map: a drifted ring of keyframes whose last keyframe
re-views the first one's scene through new point ids.

Numpy only, and written against the `VOMap` and `KeyFrameDatabase` API
that the JAX package and this port share, so that the same map can be
built into either package's tables (the parity tests build both; the card
run builds the port's). The scene:

- 20 keyframes on a circle of radius 0.3 m (y is down), each looking
  outward at a cylindrical wall of radius 4 m; sector s of the wall holds
  40 points and 2 vertical lines, and keyframe i sees sectors i-1, i, i+1.
- The estimated poses drift: keyframe i's world is off by G_i = exp(i d)
  (a yaw of 0.25 degrees and 8 mm a keyframe), and a landmark created by
  keyframe c sits at G_c X (exact in its creator's camera). Observations
  are the true projections plus 0.3 px of noise.
- As a tracker without loop closing would build it: keyframe 0 creates
  sectors 19, 0 and 1; keyframe i creates sector i + 1 and reuses the ids
  its predecessor saw; so keyframe 18 re-creates sector 19 and keyframe 19
  re-creates sector 0 under new ids (with the same descriptors). Keyframe
  19 shares no point with keyframe 0, so the two are not covisible.
- Keyframe 18 also re-creates 8 points of sector 18 that keyframe 17
  created (within 0.5 mm of them, the same descriptors, owned by keyframe
  17): duplicates inside the newest keyframe's window, for the fuse after
  a closure.
- Map planes: the floor (keyframe 0), a drifted copy of it (keyframe 19)
  and the ceiling (keyframe 10).
- The keyframe database holds each keyframe's BoW histogram, from the LSH
  words of its keypoints' descriptors.
"""
from __future__ import annotations

import numpy as np

from ..bow.vocab import PROTOTYPES, bow_histogram_np

N_KF = 20
PTS_PER_SECTOR = 40
LINES_PER_SECTOR = 2
RING_R, WALL_R, WALL_H = 0.3, 4.0, 1.2
DRIFT_YAW_DEG, DRIFT_T_M = 0.25, 0.008
N_INNER_DUP = 8


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _pose(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def true_poses() -> np.ndarray:
    """(N_KF, 4, 4) float64 camera-from-world poses on the ring."""
    out = []
    for i in range(N_KF):
        th = 2 * np.pi * i / N_KF
        z = np.array([np.sin(th), 0.0, np.cos(th)])
        x = np.array([np.cos(th), 0.0, -np.sin(th)])
        R_wc = np.stack([x, [0.0, 1.0, 0.0], z], axis=1)
        out.append(np.linalg.inv(_pose(R_wc, RING_R * z)))
    return np.stack(out)


def drift(i: int) -> np.ndarray:
    """G_i: keyframe i's world-frame error (estimated map = G_i true map)."""
    return _pose(_rot_y(np.radians(DRIFT_YAW_DEG) * i), np.array([DRIFT_T_M * i, 0.0, 0.0]))


def _words(desc: np.ndarray) -> np.ndarray:
    """LSH word ids of packed descriptors (N, 8) uint32, as
    `bow.vocab.compute_words` computes them."""
    bits = (desc[:, :, None].astype(np.int64) >> np.arange(32)) & 1
    bip = bits.reshape(len(desc), 256).astype(np.float32) * 2.0 - 1.0
    return np.argmax(bip @ PROTOTYPES.T, axis=-1)


def build_loop_map(vomap, kf_db, cfg, seed: int = 0) -> dict:
    """Fill an empty `vomap` and `kf_db` with the loop map. Returns the
    ground truth: {"T_true" (N_KF, 4, 4) true poses, "slots" keyframe slot
    per keyframe, "dup_pairs" (original id, duplicate id) of every
    re-created point}."""
    rng = np.random.default_rng(seed)
    cam = cfg.camera
    n_sec = N_KF
    half = np.pi / n_sec
    # Physical scene: points and line endpoints on the wall, per sector.
    phi = (2 * np.pi * np.arange(n_sec)[:, None] / n_sec
           + rng.uniform(-half, half, (n_sec, PTS_PER_SECTOR)))
    h = rng.uniform(-WALL_H, WALL_H, (n_sec, PTS_PER_SECTOR))
    X_true = np.stack([WALL_R * np.sin(phi), h, WALL_R * np.cos(phi)], axis=-1)
    desc_true = rng.integers(0, 2 ** 32, (n_sec, PTS_PER_SECTOR, 8), dtype=np.uint64).astype(np.uint32)
    lphi = (2 * np.pi * np.arange(n_sec)[:, None] / n_sec
            + rng.uniform(-0.8 * half, 0.8 * half, (n_sec, LINES_PER_SECTOR)))
    l_lo = rng.uniform(-WALL_H, -0.3, (n_sec, LINES_PER_SECTOR))
    l_hi = rng.uniform(0.3, WALL_H, (n_sec, LINES_PER_SECTOR))
    L0_true = np.stack([WALL_R * np.sin(lphi), l_lo, WALL_R * np.cos(lphi)], axis=-1)
    L1_true = np.stack([WALL_R * np.sin(lphi), l_hi, WALL_R * np.cos(lphi)], axis=-1)
    ldesc = rng.uniform(-1, 1, (n_sec, LINES_PER_SECTOR, vomap.lines.desc.shape[1])).astype(np.float32)

    T_true = true_poses()
    G = np.stack([drift(i) for i in range(N_KF)])
    T_est = np.stack([T_true[i] @ np.linalg.inv(G[i]) for i in range(N_KF)]).astype(np.float32)

    def est_world(X, c):
        return (X @ G[c][:3, :3].T + G[c][:3, 3]).astype(np.float32)

    # Map ids per (sector, point): the copy each keyframe uses.
    ids = {}  # (copy name, sector) -> (PTS,) ids
    line_ids = {}

    def create(name, s, c, sel=None, drift_of=None):
        sel = np.arange(PTS_PER_SECTOR) if sel is None else sel
        X = est_world(X_true[s, sel], c if drift_of is None else drift_of)
        if drift_of is not None:
            X = X + rng.normal(0, 5e-4, X.shape).astype(np.float32)
        Cw = np.linalg.inv(T_est[c])[:3, 3]
        nrm = X - Cw
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        out = np.full(PTS_PER_SECTOR, -1, np.int64)
        out[sel] = vomap.add_points(X, desc_true[s, sel], nrm.astype(np.float32),
                                    np.zeros(len(sel), np.int32), c)
        ids[(name, s)] = out

    def create_lines(s, c):
        line_ids[s] = vomap.add_lines(est_world(L0_true[s], c), est_world(L1_true[s], c), ldesc[s], c)

    C = cfg.cap.keypoints
    Cl = vomap.kf_lines.line_id.shape[1]
    slots = []
    for i in range(N_KF):
        # What keyframe i creates, and which copy of each sector it sees.
        if i == 0:
            for s in (n_sec - 1, 0, 1):
                create("a", s, 0)
                create_lines(s, 0)
            seen = [("a", n_sec - 1), ("a", 0), ("a", 1)]
        else:
            s_new = (i + 1) % n_sec
            if i < N_KF - 2:
                create("a", s_new, i)
                create_lines(s_new, i)
                seen = [("a", i - 1), ("a", i), ("a", s_new)]
            elif i == N_KF - 2:  # sector 19 again, and 8 duplicates of sector 18
                create("b", s_new, i)
                create("d", i, i, sel=np.arange(N_INNER_DUP), drift_of=i - 1)
                seen = [("a", i - 1), ("a+d", i), ("b", s_new)]
            else:  # sector 0 again
                create("c", s_new, i)
                seen = [("a+d", i - 1), ("b", i), ("c", s_new)]
        pid_rows, X_rows, d_rows = [], [], []
        for name, s in seen:
            if name == "a+d":
                pid = np.where(ids[("d", s)] >= 0, ids[("d", s)], ids[("a", s)])
            else:
                pid = ids[(name, s)]
            pid_rows.append(pid)
            X_rows.append(X_true[s])
            d_rows.append(desc_true[s])
        pid = np.concatenate(pid_rows)
        Xc = np.concatenate(X_rows) @ T_true[i][:3, :3].T + T_true[i][:3, 3]
        z = Xc[:, 2]
        u = cam.fx * Xc[:, 0] / z + cam.cx + rng.normal(0, 0.3, len(z))
        v = cam.fy * Xc[:, 1] / z + cam.cy + rng.normal(0, 0.3, len(z))
        ok = (z > 0.1) & (u > 2) & (u < cam.width - 2) & (v > 2) & (v < cam.height - 2)
        n = int(ok.sum())
        point_id = np.full(C, -1, np.int32)
        obs = np.zeros((C, 3), np.float32)
        desc = np.zeros((C, 8), np.uint32)
        valid = np.zeros(C, bool)
        point_id[:n] = pid[ok]
        obs[:n] = np.stack([u, v, u - cam.bf / z], axis=1)[ok]
        desc[:n] = np.concatenate(d_rows)[ok]
        valid[:n] = True
        k = vomap.add_keyframe(T_est[i], i, point_id, obs, np.zeros(C, np.int32), desc, valid)
        slots.append(k)
        kf_db.add(k, bow_histogram_np(_words(desc), valid))

        # Line observations: the lines of the sectors in view (each one copy).
        lsec = [(i - 1) % n_sec, i, (i + 1) % n_sec]
        lid = np.full(Cl, -1, np.int32)
        l2d = np.zeros((Cl, 3), np.float32)
        lok = np.zeros(Cl, bool)
        row = 0
        for s in lsec:
            for j in range(LINES_PER_SECTOR):
                if s not in line_ids or line_ids[s][j] < 0:
                    continue
                P = np.stack([L0_true[s, j], L1_true[s, j]]) @ T_true[i][:3, :3].T + T_true[i][:3, 3]
                p = np.stack([cam.fx * P[:, 0] / P[:, 2] + cam.cx, cam.fy * P[:, 1] / P[:, 2] + cam.cy], 1)
                dd = p[1] - p[0]
                nn = np.array([-dd[1], dd[0]]) / (np.linalg.norm(dd) + 1e-9)
                lid[row] = line_ids[s][j]
                l2d[row] = [nn[0], nn[1], -nn @ p[0]]
                lok[row] = True
                row += 1
        vomap.add_kf_line_obs(k, lid, l2d, lok)
        new = lid[lok][vomap.lines.first_kf[lid[lok]] < 0]
        vomap.lines.first_kf[new] = k  # the creator is each line's first observer

    # Map planes: the floor and the ceiling in their creator's drifted world,
    # and a drifted copy of the floor made by the last keyframe.
    for y, c in ((1.5, 0), (-1.5, N_KF // 2), (1.5, N_KF - 1)):
        n_est = G[c][:3, :3] @ np.array([0.0, -np.sign(y), 0.0])
        cen = est_world(np.array([[0.0, y, 0.0]]), c)[0]
        pi = np.append(n_est, -n_est @ cen).astype(np.float32)
        cov = np.diag([1.0, 1e-4, 1.0])
        R = G[c][:3, :3]
        vomap.add_planes(pi[None], cen[None].astype(np.float32), np.array([5000.0], np.float32), c,
                         cov_w=(R @ cov @ R.T)[None], first_kf=slots[c])
    # The inner duplicates belong to keyframe 17, as their originals do, so
    # that a loop correction moves both alike.
    d = ids[("d", N_KF - 2)]
    vomap.points.first_kf[d[d >= 0]] = slots[N_KF - 3]
    dup_pairs = [(int(a), int(b)) for s, nm in ((N_KF - 1, "b"), (0, "c"), (N_KF - 2, "d"))
                 for a, b in zip(ids[("a", s)], ids[(nm, s)]) if b >= 0]
    return {"T_true": T_true, "slots": np.array(slots), "dup_pairs": dup_pairs}
