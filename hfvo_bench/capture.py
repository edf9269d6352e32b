"""What the timed path produces, captured where the program produces it.

The harness wraps three functions of the program, once a process: the FAST
launcher (`ops.fast.fast_score_dual_levels`, kernels K1 / K1b), the Hough
vote (`ops.lines.hough_vote`, K3 / K3b) and the local BA solve
(`mapping.local_mapping.local_bundle_adjustment`). The wrappers call the
original and return its result unchanged. While a sampled frame is in
flight they keep device copies of the first FAST and Hough call's inputs
and outputs; the BA wrapper keeps the window's BA run drawn from the seed.
With `record_launches` on (the traced slice) they also keep each launch's
shapes, for the roofline readers. Nothing is pulled to the host here.
"""
from __future__ import annotations

from typing import List, Optional

import torch


# The program's functions before the first install (one set a process).
_ORIGINALS: dict = {}


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_clone(v) for v in x)
    if hasattr(x, "_fields"):  # NamedTuple
        return type(x)(*(_clone(v) for v in x))
    return x


class Capture:
    def __init__(self):
        self.frame_tag = None  # set while a sampled frame's call runs
        self.samples: List[dict] = []
        self.ba_armed = False
        self.ba_target = 0  # capture the window's BA run of this index (or the last before it)
        self.ba_seen = 0
        self.ba: Optional[dict] = None
        self.record_launches = False
        self.fast_launches: List[list] = []  # level shapes of each FAST call
        self.hough_launches: List[tuple] = []  # (mag, mag_th) of each Hough call
        self._cur: Optional[dict] = None

    def begin_sample(self, tag) -> None:
        self._cur = {"tag": tag, "fast": None, "hough": None}

    def end_sample(self) -> None:
        if self._cur is not None:
            self.samples.append(self._cur)
        self._cur = None

    def install(self) -> None:
        """Point the program's three functions at wrappers that feed this
        capture (a later install replaces them; the originals are kept)."""
        from hfvo_tpu_torch.mapping import local_mapping
        from hfvo_tpu_torch.ops import fast, lines

        if not _ORIGINALS:
            _ORIGINALS.update(fast=fast.fast_score_dual_levels, hough=lines.hough_vote,
                              ba=local_mapping.local_bundle_adjustment)
        fast_fn, hough_fn, ba_fn = _ORIGINALS["fast"], _ORIGINALS["hough"], _ORIGINALS["ba"]
        cap = self

        def fast_wrapped(levels, th_low, th_high, bonus=1e4):
            out = fast_fn(levels, th_low, th_high, bonus)
            if cap.record_launches:
                cap.fast_launches.append([tuple(x.shape) for x in levels])
            if cap._cur is not None and cap._cur["fast"] is None:
                cap._cur["fast"] = dict(levels=_clone(list(levels)), out=_clone(list(out)),
                                        th_low=float(th_low), th_high=float(th_high), bonus=float(bonus))
            return out

        def hough_wrapped(mag, normal_ang, mag_th):
            out = hough_fn(mag, normal_ang, mag_th)
            if cap.record_launches:
                cap.hough_launches.append((mag, float(mag_th)))
            if cap._cur is not None and cap._cur["hough"] is None:
                cap._cur["hough"] = dict(mag=_clone(mag), ang=_clone(normal_ang), out=_clone(out),
                                         mag_th=float(mag_th))
            return out

        def ba_wrapped(prob, intr):
            if not cap.ba_armed or cap.ba_seen > cap.ba_target:
                return ba_fn(prob, intr)
            kept = _clone(prob)
            res = ba_fn(prob, intr)
            cap.ba = dict(prob=kept, res=_clone(res), index=cap.ba_seen)
            cap.ba_seen += 1
            return res

        fast.fast_score_dual_levels = fast_wrapped
        lines.hough_vote = hough_wrapped
        local_mapping.local_bundle_adjustment = ba_wrapped
