"""Deterministic synthetic BA problem of the distributed checks.

Port of `hfvo_tpu.testing.ba_fixture` in numpy and torch on the CPU: every
rank of a distributed run builds it from the seed and must hold the same
bytes (`parallel.mesh.Mesh.check_identical` checks)."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera, se3
from ..geometry.camera import Intrinsics
from ..solve.ba import BAProblem


def synthetic_ba_problem(intr: Intrinsics, n_blocks: int, K: int = 6, pts_per_block: int = 40,
                         seed: int = 0):
    """K poses on a line, `pts_per_block * n_blocks` landmarks with EXACT
    stereo observations (the global optimum is the ground truth to machine
    precision), poses 2.. and points perturbed. Returns (prob, T_gt), the
    problem as CPU tensors (hfvo_tpu/testing/ba_fixture.py:14-64)."""
    rng = np.random.default_rng(seed)
    Pn = pts_per_block * n_blocks
    X_gt = np.stack(
        [rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn), rng.uniform(3, 7, Pn)], 1
    ).astype(np.float32)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0] = [0.15 * k for k in range(K)]
    T_gt = se3.exp_se3(torch.from_numpy(xi)).numpy()
    e_kf, e_pt, e_obs = [], [], []
    for k in range(K):
        X_c = se3.transform(torch.from_numpy(T_gt[k]), torch.from_numpy(X_gt))
        uvr = camera.project_stereo(intr, X_c).numpy()
        X_c = X_c.numpy()
        vis = (
            (X_c[:, 2] > 0.5)
            & (uvr[:, 0] > 0) & (uvr[:, 0] < 640)
            & (uvr[:, 1] > 0) & (uvr[:, 1] < 480)
        )
        ids = np.nonzero(vis)[0]
        e_kf += [k] * len(ids)
        e_pt += list(ids)
        e_obs += list(uvr[ids])
    E = len(e_kf)
    T_init = T_gt.copy()
    for k in range(2, K):
        d = torch.from_numpy(rng.normal(size=6).astype(np.float32) * 0.02)
        T_init[k] = se3.exp_se3(d).numpy() @ T_gt[k]
    pt_X = X_gt + rng.normal(size=(Pn, 3)).astype(np.float32) * 0.02
    t = torch.from_numpy
    prob = BAProblem(
        kf_T_cw=t(T_init),
        kf_free=t(np.arange(K) >= 2),
        pt_X=t(pt_X),
        pt_valid=torch.ones((Pn,), dtype=torch.bool),
        e_kf=t(np.array(e_kf, np.int64)),
        e_pt=t(np.array(e_pt, np.int64)),
        e_obs=t(np.stack(e_obs).astype(np.float32)),
        e_stereo=torch.ones((E,), dtype=torch.bool),
        e_inv_sigma2=torch.ones((E,)),
        e_valid=torch.ones((E,), dtype=torch.bool),
        **BAProblem.empty_line_edges(),
    )
    return prob, T_gt
