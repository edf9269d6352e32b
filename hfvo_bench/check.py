"""The numbers that decide `correct`, each from the program's output and the
plain reference under `hfvo_bench/reference/`.

- `pose_ate_m`: every pose returned in the window against the ground truth
  the generator rendered from: the TUM benchmark's ATE (RMSE after one rigid
  alignment) of each sequence's window, the largest over the sequences (the
  configuration's stated guarantee is its limit).
- `pose_rot_max_deg`: the largest geodesic error of a returned orientation
  after one rotation of each sequence's returned world onto the true one.
- `frames_unmatched`: frames handed in whose pose never came back, and
  poses that came back for no frame handed in (0).
- `pyramid_max_abs_err`: the pyramid levels the FAST launch received on the
  sampled frames against the reference pyramid of the frames handed in.
- `fast_max_abs_err`: the FAST scores of those launches (K1 / K1b) against
  the reference scores of the same levels (exact).
- `sobel_mag_max_abs_err`, `sobel_ang_max_abs_err`: the gradient magnitude
  and angle the Hough launch received against the reference Sobel of the
  frames handed in (the angle where the magnitude votes).
- `hough_max_rel_err`: the Hough accumulators of those launches (K3 / K3b)
  against the reference vote of the same magnitude and angle.
- for a local BA solve of the window, captured with its input problem
  (`reference/ba.py::judge`): `ba_chi2_rel_err`, the cost it reports
  against the reference cost of its returned state over the edges the
  published chi2 gates pass there; `ba_flags_wrong`, the edges whose
  returned inlier flag the gates contradict; `ba_cost_ratio`, the whole
  cost at the returned state over that at the input, over those edges;
  `ba_point_step_gain`, the share of that cost one more damped Gauss-Newton
  step of the point landmarks at the returned poses takes off (a solve that
  stops short of the minimum).

With `tf32`, each reference result computed in TF32 stands in the
program's place (for the BA, the reference's own solve of the captured
problem): that is the control, which these limits have to reject.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .reference import ba as ref_ba
from .reference import to_tf32
from .reference import fast as ref_fast
from .reference import hough as ref_hough
from .reference import poses as ref_poses
from .reference import pyramid as ref_pyramid
from .reference import sobel as ref_sobel


def pose_numbers(answers, traffic, n_seq: int, tf32: bool = False) -> Dict[str, float]:
    """The largest over the sequences of the TUM ATE (RMSE after rigid
    alignment) and of the largest rotation error of every pose the window
    returned. answers: [(seq, frame index, TrackResult)]; inf where a
    sequence returned fewer than 3."""
    ate = rot = 0.0
    for s in range(n_seq):
        rows = [(i, r) for q, i, r in answers if q == s]
        if len(rows) < 3:
            return dict(pose_ate_m=math.inf, pose_rot_max_deg=math.inf)
        gt = np.stack([traffic.T_wc[traffic.frame(s, i)] for i, _ in rows]).astype(np.float64)
        if tf32:
            est = to_tf32(torch.from_numpy(gt.astype(np.float32))).double().numpy()
        else:
            est = np.stack([np.linalg.inv(np.asarray(r.T_cw, np.float64)) for _, r in rows])
        ate = max(ate, ref_poses.ate_rmse(est, gt))
        rot = max(rot, ref_poses.rot_max_deg(est, gt))
    return dict(pose_ate_m=ate, pose_rot_max_deg=rot)


def _frames(sample, traffic, device):
    """The uint8 frames (S, H, W) handed in with a sampled call."""
    idx = sample["tag"]
    return torch.from_numpy(np.stack([traffic.gray[k] for k in idx])).to(device)


def kernel_numbers(samples, traffic, cfg, tf32: bool = False) -> Dict[str, Optional[float]]:
    pyr_err = fast_err = mag_err = ang_err = hough_err = None
    for smp in samples:
        f, h = smp["fast"], smp["hough"]
        if f is None or h is None:
            return dict(pyramid_max_abs_err=math.inf, fast_max_abs_err=math.inf,
                        sobel_mag_max_abs_err=math.inf, sobel_ang_max_abs_err=math.inf,
                        hough_max_rel_err=math.inf)
        dev = f["levels"][0].device
        gray = _frames(smp, traffic, dev)
        want = ref_pyramid.pyramid(gray, cfg.orb.n_levels, cfg.orb.scale_factor)
        got_levels = (ref_pyramid.pyramid(gray, cfg.orb.n_levels, cfg.orb.scale_factor, tf32=True) if tf32
                      else f["levels"])
        e = 0.0 if len(got_levels) == len(want) else math.inf
        for g, w in zip(got_levels, want):
            if g.numel() != w.numel():
                e = math.inf
                break
            e = max(e, float((g.double() - w.reshape(g.shape).double()).abs().max()))
        pyr_err = max(pyr_err or 0.0, e)

        e = 0.0
        for lv, out in zip(f["levels"], f["out"]):
            ref = ref_fast.dual_score(lv, f["th_low"], f["th_high"], f["bonus"])
            got = ref_fast.dual_score(lv, f["th_low"], f["th_high"], f["bonus"], tf32=True) if tf32 else out
            e = max(e, float((got.double() - ref.double()).abs().max()))
        fast_err = max(fast_err or 0.0, e)

        mag, ang = ref_sobel.gradients(gray.reshape(h["mag"].shape))
        got_mag, got_ang = (ref_sobel.gradients(gray.reshape(h["mag"].shape), tf32=True) if tf32
                            else (h["mag"], h["ang"]))
        mag_err = max(mag_err or 0.0, float((got_mag.double() - mag).abs().max()))
        d = (got_ang.double() - ang).abs()
        d = torch.minimum(d, math.pi - d)
        votes = mag > h["mag_th"]
        ang_err = max(ang_err or 0.0, float(d[votes].max()) if bool(votes.any()) else 0.0)

        ref = ref_hough.vote(h["mag"], h["ang"], h["mag_th"])
        got = ref_hough.vote(h["mag"], h["ang"], h["mag_th"], tf32=True) if tf32 else h["out"]
        got = got.reshape(ref.shape).double()
        hough_err = max(hough_err or 0.0, float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()))
    return dict(pyramid_max_abs_err=pyr_err, fast_max_abs_err=fast_err, sobel_mag_max_abs_err=mag_err,
                sobel_ang_max_abs_err=ang_err, hough_max_rel_err=hough_err)


BA_NUMBERS = ("ba_chi2_rel_err", "ba_flags_wrong", "ba_cost_ratio", "ba_point_step_gain")


def ba_numbers(ba, cam: dict, tf32: bool = False) -> Dict[str, Optional[float]]:
    """The BA numbers of the captured solve (None each where no BA ran in
    the window); with `tf32`, of the reference's TF32 solve of its problem."""
    if ba is None:
        return dict.fromkeys(BA_NUMBERS)
    res = ref_ba.solve(ba["prob"], cam, tf32=True) if tf32 else ba["res"]
    return ref_ba.judge(ba["prob"], res, cam)


def numbers(answers, unmatched: int, samples, ba, traffic, cfg, cam: dict, n_seq: int,
            tf32: bool = False) -> Dict[str, Optional[float]]:
    out = pose_numbers(answers, traffic, n_seq, tf32)
    out["frames_unmatched"] = float(unmatched)
    out.update(kernel_numbers(samples, traffic, cfg, tf32))
    out.update(ba_numbers(ba, cam, tf32))
    return out
