"""Offline visualization: frame overlays and map renders.

Replaces the reference's Pangolin viewer stack (reference: src/Viewer.cc
`RunWithLine`, src/FrameDrawer.cc:38 `DrawFrame` — tracked points/lines
overlaid on the current image; src/MapDrawer.cc:42-304 — map points, lines,
planes, keyframe frusta, covisibility, Manhattan axes). There is no GL
window here; drawers render to PNG files with matplotlib (headless Agg),
which suits batch/debug workflows on a headless host.

Port of `hfvo_tpu.viz.drawers` (numpy + matplotlib, copied). matplotlib is
imported inside the drawing functions, so the package imports without it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_frame(
    gray: np.ndarray,
    path: str,
    kp_uv: Optional[np.ndarray] = None,
    kp_tracked: Optional[np.ndarray] = None,
    line_p0: Optional[np.ndarray] = None,
    line_p1: Optional[np.ndarray] = None,
    line_valid: Optional[np.ndarray] = None,
    title: str = "",
) -> None:
    """Current frame with tracked features (reference: FrameDrawer::DrawFrame:
    green = tracked keypoints, lines overlaid; status text)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    ax.imshow(np.asarray(gray), cmap="gray", vmin=0, vmax=255)
    n_trk = 0
    if kp_uv is not None:
        kp_uv = np.asarray(kp_uv)
        trk = (
            np.asarray(kp_tracked)
            if kp_tracked is not None
            else np.zeros(len(kp_uv), bool)
        )
        ax.scatter(kp_uv[~trk, 0], kp_uv[~trk, 1], s=4, c="yellow", alpha=0.4)
        ax.scatter(kp_uv[trk, 0], kp_uv[trk, 1], s=6, c="lime")
        n_trk = int(trk.sum())
    if line_p0 is not None:
        p0 = np.asarray(line_p0)
        p1 = np.asarray(line_p1)
        v = (
            np.asarray(line_valid)
            if line_valid is not None
            else np.ones(len(p0), bool)
        )
        for a, b in zip(p0[v], p1[v]):
            ax.plot([a[0], b[0]], [a[1], b[1]], c="red", lw=1.2)
    ax.set_title(title or f"tracked: {n_trk}")
    ax.set_xlim(0, gray.shape[1])
    ax.set_ylim(gray.shape[0], 0)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def draw_map(
    vomap,
    path: str,
    trajectory: Optional[np.ndarray] = None,
    R_wm: Optional[np.ndarray] = None,
    max_points: int = 4000,
) -> None:
    """3D map render: points, lines, keyframe positions, trajectory, and
    Manhattan axes (reference: MapDrawer::DrawMapPoints/DrawMapLines/
    DrawKeyFrames/DrawManhAxis)."""
    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    fig = plt.figure(figsize=(9, 7), dpi=100)
    ax = fig.add_subplot(projection="3d")
    pt = vomap.points
    X = pt.X_w[pt.valid]
    if len(X) > max_points:
        X = X[:: len(X) // max_points]
    if len(X):
        ax.scatter(X[:, 0], X[:, 1], X[:, 2], s=1, c="k", alpha=0.4)
    lt = vomap.lines
    lv = lt.valid
    if lv.any():
        segs = np.stack([lt.X0_w[lv], lt.X1_w[lv]], axis=1)
        colors = np.array(["tab:red", "tab:green", "tab:blue", "tab:gray"])
        c = colors[np.clip(lt.manh_idx[lv], -1, 2)]
        ax.add_collection3d(Line3DCollection(segs, colors=c, linewidths=1.5))
    kf = vomap.keyframes
    ks = np.nonzero(kf.valid)[0]
    if len(ks):
        T_wc = np.linalg.inv(kf.T_cw[ks])
        ax.scatter(
            T_wc[:, 0, 3], T_wc[:, 1, 3], T_wc[:, 2, 3],
            s=25, c="tab:orange", marker="^", label="keyframes",
        )
    if trajectory is not None and len(trajectory):
        t = np.asarray(trajectory)[:, :3, 3]
        ax.plot(t[:, 0], t[:, 1], t[:, 2], c="tab:blue", lw=1.0, label="trajectory")
    if R_wm is not None:
        o = np.zeros(3)
        for i, c in enumerate(["r", "g", "b"]):
            a = np.asarray(R_wm)[:, i]
            ax.plot([o[0], a[0]], [o[1], a[1]], [o[2], a[2]], c=c, lw=2.5)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
