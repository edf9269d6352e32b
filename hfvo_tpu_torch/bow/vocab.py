"""Appearance vocabulary: descriptor -> word quantization.

Port of the LSH path of `hfvo_tpu.bow.vocab`: words come from a fixed bank
of random bipolar prototypes, `word = argmax(prototypes @ bits)`, built
from the same `np.random.RandomState(123)`. Scores are exact integers in
float32, and `argmax` takes the first maximum like `jnp.argmax`, so the
words agree exactly. A trained DBoW2 vocabulary file belongs to the
relocalization slice.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.hamming import unpack_bits

N_WORDS = 1024

_rs = np.random.RandomState(123)
# Bipolar prototype bank (W, 256).
PROTOTYPES = (_rs.rand(N_WORDS, 256) < 0.5).astype(np.float32) * 2.0 - 1.0


@functools.lru_cache(maxsize=None)
def _prototypes_on(device: str) -> torch.Tensor:
    return torch.from_numpy(PROTOTYPES).to(device)


def compute_words(desc: torch.Tensor) -> torch.Tensor:
    """Packed descriptors (*B, N, 8) int64 words -> word ids (*B, N) int64."""
    bits = unpack_bits(desc) * 2.0 - 1.0
    scores = bits @ _prototypes_on(str(desc.device)).T
    return torch.argmax(scores, dim=-1)


def bow_histogram_np(words: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side word histogram, L1-normalized (N_WORDS,)."""
    h = np.bincount(
        np.asarray(words)[np.asarray(valid)], minlength=N_WORDS
    ).astype(np.float32)
    return h / max(h.sum(), 1.0)
