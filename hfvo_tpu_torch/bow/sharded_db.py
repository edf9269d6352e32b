"""Keyframe-axis-sharded appearance database over the ranks.

Port of `hfvo_tpu.bow.sharded_db` on `torch.distributed`: DBoW2's inverted
file at fleet scale (reference: `KeyFrameDatabase`, include/
KeyFrameDatabase.h:55-66, queried by DetectRelocalizationCandidates,
src/KeyFrameDatabase.cc:199). The dense (K, W) histogram matrix is split over
the mesh's `edge` ranks (the JAX package's `kf` axis); a query is a
rank-local L1 score and top-k, then one gather of (ranks x top_k)
candidates, merged on the host.

The host tables are the source of truth on every rank (`add` and `erase` are
numpy writes, which every rank makes alike); this rank's block goes to the
device before a query when it changed. Queries are rare (relocalization,
loop detection) next to per-frame tracking.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.batch import resolve_device, to_host
from ..parallel.mesh import Mesh
from .vocab import N_WORDS


class ShardedKeyFrameDatabase:
    """`KeyFrameDatabase`'s query contract (top-k L1 candidates gated at
    0.75x the best, src/KeyFrameDatabase.cc:256), the K axis split over the
    ranks of `mesh`'s 'edge' axis."""

    def __init__(self, mesh: Mesh, capacity: int, top_k: int = 5, device="cuda"):
        self.mesh = mesh
        n_dev = mesh.shape["edge"]
        self.capacity = -(-capacity // n_dev) * n_dev
        self.top_k = top_k
        self.device = resolve_device(device)
        self.hists = np.zeros((self.capacity, N_WORDS), np.float32)
        self.valid = np.zeros((self.capacity,), bool)
        self._rows = mesh.block_range(self.capacity)
        self._dev = None

    def add(self, kf_slot: int, hist: np.ndarray) -> None:
        self.hists[kf_slot] = hist
        self.valid[kf_slot] = True
        self._dev = None

    def erase(self, kf_slot: int) -> None:
        self.valid[kf_slot] = False
        self._dev = None

    def query(self, hist: np.ndarray, top_k: int | None = None, exclude: int = -1):
        """Top-k candidate keyframe slots by L1 similarity across all ranks
        (hfvo_tpu/bow/sharded_db.py:81-100); the same on every rank."""
        k = self.top_k if top_k is None else top_k
        if self._dev is None:
            self._dev = (torch.from_numpy(self.hists[self._rows]).to(self.device),
                         torch.from_numpy(self.valid[self._rows]).to(self.device))
        h_blk, v_blk = self._dev
        q = torch.from_numpy(np.asarray(hist, np.float32)).to(self.device)
        scores = 1.0 - 0.5 * torch.sum(torch.abs(h_blk - q[None, :]), dim=1)
        gids = self._rows.start + torch.arange(h_blk.shape[0], device=self.device)
        scores = torch.where(v_blk & (gids != exclude), scores, torch.full_like(scores, -1.0))
        s, i = torch.topk(scores, min(k, h_blk.shape[0]))
        # One gather of every rank's (score, slot) candidates; the slots are
        # exact in float64.
        cand = self.mesh.all_gather(torch.stack([s.double(), (gids[i]).double()], dim=1))
        s, i = to_host([cand[:, 0].float(), cand[:, 1].long()])
        order = np.argsort(-s)[:k]
        s, i = s[order], i[order]
        keep = (s >= 0) & (s >= max(0.0, 0.75 * (s[0] if len(s) else 0.0)))
        return i[keep], s[keep]
