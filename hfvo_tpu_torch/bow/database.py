"""Keyframe appearance database: BoW matrix + candidate retrieval.

Replaces the reference's inverted file `vector<list<KeyFrame*>>`
(reference: include/KeyFrameDatabase.h:55-66,
`DetectRelocalizationCandidates` src/KeyFrameDatabase.cc:199) with a dense
(K, W) histogram matrix — a query is one matvec; candidates are the top-k
L1 scores. At map scale (K <= 512, W = 1024) this is a 2 MB matrix; the
sharded multi-host variant partitions the K axis (SURVEY.md §5.8).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .vocab import N_WORDS


@dataclass
class KeyFrameDatabase:
    capacity: int
    hists: np.ndarray = field(init=False)  # (K, W) L1-normalized
    valid: np.ndarray = field(init=False)

    def __post_init__(self):
        self.hists = np.zeros((self.capacity, N_WORDS), np.float32)
        self.valid = np.zeros((self.capacity,), bool)

    def add(self, kf_slot: int, hist: np.ndarray) -> None:
        self.hists[kf_slot] = hist
        self.valid[kf_slot] = True

    def erase(self, kf_slot: int) -> None:
        self.valid[kf_slot] = False

    def query(self, hist: np.ndarray, top_k: int = 5, exclude: int = -1):
        """Top-k candidate KF slots by L1 similarity (reference gates
        candidates at 0.75x best score, src/KeyFrameDatabase.cc:256)."""
        scores = 1.0 - 0.5 * np.abs(self.hists - hist[None, :]).sum(axis=1)
        scores[~self.valid] = -1.0
        if 0 <= exclude < len(scores):
            scores[exclude] = -1.0
        order = np.argsort(-scores)[:top_k]
        best = scores[order[0]] if len(order) else -1.0
        keep = scores[order] >= max(0.0, 0.75 * best)
        return order[keep], scores[order[keep]]
