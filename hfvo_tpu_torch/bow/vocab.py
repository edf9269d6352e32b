"""Appearance vocabulary: descriptor -> word quantization.

Port of the LSH path of `hfvo_tpu.bow.vocab`: words come from a fixed bank
of random bipolar prototypes, `word = argmax(prototypes @ bits)`, built
from the same `np.random.RandomState(123)`. Scores are exact integers in
float32, and `argmax` takes the first maximum like `jnp.argmax`, so the
words agree exactly. With a trained DBoW2 vocabulary active
(`set_vocabulary`), words come from its tree (`dbow2.compute_words_tree`)
folded modulo N_WORDS into the same fixed-width histogram, as in the JAX
package (hfvo_tpu/bow/vocab.py:39-69).
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


# The active trained DBoW2 vocabulary (set_vocabulary), or None for the
# prototype bank. The JAX package reads it when it traces the fused step;
# eager torch reads it at each call, and `VOSystem` sets it before it builds
# its tracker, so both see the same vocabulary there.
_ACTIVE_TREE = None


def set_vocabulary(path: str | None) -> None:
    """Load a trained DBoW2 text vocabulary (e.g. ORBvoc.txt; reference:
    System.cc:70-74 loadFromTextFile). Pass None to return to the
    file-free LSH prototype bank."""
    global _ACTIVE_TREE
    if path is None:
        _ACTIVE_TREE = None
        return
    from .dbow2 import load_dbow2_text

    _ACTIVE_TREE = load_dbow2_text(path)


@functools.lru_cache(maxsize=None)
def _prototypes_on(device: str) -> torch.Tensor:
    return torch.from_numpy(PROTOTYPES).to(device)


def compute_words(desc: torch.Tensor) -> torch.Tensor:
    """Packed descriptors (*B, N, 8) int64 words -> word ids (*B, N) int64."""
    if _ACTIVE_TREE is not None:
        from .dbow2 import compute_words_tree

        return compute_words_tree(desc, _ACTIVE_TREE) % N_WORDS
    bits = unpack_bits(desc) * 2.0 - 1.0
    scores = bits @ _prototypes_on(str(desc.device)).T
    return torch.argmax(scores, dim=-1)


def bow_histogram_np(words: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side word histogram, L1-normalized (N_WORDS,)."""
    h = np.bincount(
        np.asarray(words)[np.asarray(valid)], minlength=N_WORDS
    ).astype(np.float32)
    return h / max(h.sum(), 1.0)


def bow_histogram(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Word ids (N,) + validity -> L1-normalized histogram (N_WORDS,), on
    the words' device."""
    h = torch.zeros((N_WORDS,), dtype=torch.float32, device=words.device)
    h = h.index_add(0, words, valid.float())
    return h / torch.clamp(torch.sum(h), min=1.0)


def l1_score(h1, h2):
    """DBoW2 L1 similarity in [0, 1]: 1 - 0.5 * |h1 - h2|_1 over the last
    axis (reference: DBoW2/ScoringObject.cpp L1Scoring)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(h1 - h2), dim=-1)
