"""The DBoW2 vocabulary against hfvo_tpu's: the text round trip, the
offline builder, the tree descent and `compute_words` with a tree active.

Inputs are seeded numpy arrays: tests/test_dbow2.py's random vocabularies
(full k-ary trees of random descriptors) and random 256-bit descriptors.
Word ids are integers and are held exactly; the text files byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from hfvo_tpu.bow import dbow2 as jdbow2
from hfvo_tpu.bow import vocab as jvocab
from hfvo_tpu_torch.bow import dbow2 as tdbow2
from hfvo_tpu_torch.bow import vocab as tvocab
from test_dbow2 import _random_vocab
from torch_helpers import t


def _desc(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _port_vocab(v):
    return tdbow2.DBoW2Vocab(*v)


@pytest.mark.parametrize("k,L,seed", [(3, 3, 0), (4, 2, 2), (10, 2, 5)])
def test_tree_descent_matches_jax(k, L, seed):
    v = _random_vocab(np.random.default_rng(seed), k=k, L=L)
    q = _desc(seed + 1, 96)
    want = np.asarray(jdbow2.compute_words_tree(jnp.asarray(q), v))
    got = tdbow2.compute_words_tree(t(q.astype(np.int64)), _port_vocab(v))
    np.testing.assert_array_equal(got.numpy(), want)
    # Leading batch dims and the tie rule: a descriptor equal to a node
    # takes that node; duplicated children resolve to the first.
    q2 = np.stack([q[:8], v.desc[1:9]])
    got2 = tdbow2.compute_words_tree(t(q2.astype(np.int64)), _port_vocab(v)).numpy()
    want2 = np.stack([np.asarray(jdbow2.compute_words_tree(jnp.asarray(r), v)) for r in q2])
    np.testing.assert_array_equal(got2, want2)


def test_text_round_trip_is_the_jax_format(tmp_path):
    v = _random_vocab(np.random.default_rng(2), k=4, L=2)
    pj, pt = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jdbow2.save_dbow2_text(pj, v)
    tdbow2.save_dbow2_text(pt, _port_vocab(v))
    assert open(pt).read() == open(pj).read()
    back = tdbow2.load_dbow2_text(pj)
    ref = jdbow2.load_dbow2_text(pj)
    for name, a in ref._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), np.asarray(a), err_msg=name)
    q = _desc(3, 32)
    np.testing.assert_array_equal(
        tdbow2.compute_words_tree(t(q.astype(np.int64)), back).numpy(),
        np.asarray(jdbow2.compute_words_tree(jnp.asarray(q), v)))


def test_build_vocabulary_equal_on_seeded_descriptors():
    rng = np.random.default_rng(7)
    base = _desc(8, 40)
    # Clustered descriptors: 40 centres, each with noisy copies (bit flips).
    flips = (rng.random((400, 8, 32)) < 0.05)
    noise = (flips * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    desc = base[rng.integers(0, 40, 400)] ^ noise
    doc = rng.integers(0, 12, 400)
    want = jdbow2.build_vocabulary(desc, k=5, L=3, doc_ids=doc, seed=3)
    got = tdbow2.build_vocabulary(desc, k=5, L=3, doc_ids=doc, seed=3)
    for name, a in want._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(a), err_msg=name)
    assert want.n_words > 40


def test_compute_words_through_an_active_tree(tmp_path):
    v = _random_vocab(np.random.default_rng(4), k=12, L=3)  # 1728 words > N_WORDS
    path = str(tmp_path / "voc.txt")
    jdbow2.save_dbow2_text(path, v)
    q = _desc(5, 128)
    lsh = tvocab.compute_words(t(q.astype(np.int64))).numpy()
    try:
        jvocab.set_vocabulary(path)
        tvocab.set_vocabulary(path)
        want = np.asarray(jvocab.compute_words(jnp.asarray(q)))
        got = tvocab.compute_words(t(q.astype(np.int64))).numpy()
    finally:
        jvocab.set_vocabulary(None)
        tvocab.set_vocabulary(None)
    np.testing.assert_array_equal(got, want)
    assert got.max() < tvocab.N_WORDS and (got != lsh).any()
    np.testing.assert_array_equal(tvocab.compute_words(t(q.astype(np.int64))).numpy(), lsh)
    np.testing.assert_array_equal(lsh, np.asarray(jvocab.compute_words(jnp.asarray(q))))
