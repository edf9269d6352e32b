"""DBoW2 hierarchical vocabulary: text-file loader + batched tree descent.

Port of `hfvo_tpu.bow.dbow2`: the text loader, writer and the offline
vocabulary builder are numpy and copied; the tree descent runs on torch
tensors. A trained ORB vocabulary in the DBoW2 text format (reference:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h — `loadFromTextFile`: header
"k L scoring weighting", then one node per line `parent_id is_leaf <32
descriptor bytes> weight`) quantizes descriptors by levelized descent: all
descriptors descend one level at a time, with a gather of the k child
descriptors of each live node and a popcount over the 32-bit words, so a
frame quantizes in L + 1 steps (hfvo_tpu/bow/dbow2.py:98-119).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DBoW2Vocab(NamedTuple):
    """Levelized vocabulary. Node 0 is the root. `children[i]` are the k
    child node ids of internal node i (-1 padded); `desc` packs each node's
    256-bit descriptor as 8 uint32; leaves carry `word_id` >= 0 and the
    TF-IDF `word_weight`."""

    children: np.ndarray  # (M, k) int32
    desc: np.ndarray  # (M, 8) uint32
    is_leaf: np.ndarray  # (M,) bool
    word_id: np.ndarray  # (M,) int32, -1 for internal
    word_weight: np.ndarray  # (W,) float32
    k: int
    L: int
    n_words: int


def load_dbow2_text(path: str) -> DBoW2Vocab:
    """Parse a DBoW2 ORB vocabulary in text format (e.g. ORBvoc.txt)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaf_flags, descs, weights = [0], [False], [np.zeros(32, np.uint8)], [0.0]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(parts[1] == "1")
            descs.append(np.array([int(b) for b in parts[2:34]], dtype=np.uint8))
            weights.append(float(parts[34]))
    M = len(parents)
    parent = np.asarray(parents, np.int64)
    is_leaf = np.asarray(leaf_flags)
    desc_bytes = np.stack(descs)
    weight = np.asarray(weights, np.float32)

    children = np.full((M, k), -1, np.int32)
    slot = np.zeros((M,), np.int32)
    for i in range(1, M):
        p = parent[i]
        children[p, slot[p]] = i
        slot[p] += 1

    word_id = np.full((M,), -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
    word_weight = weight[leaves].astype(np.float32)

    desc_packed = np.zeros((M, 8), np.uint32)
    for w in range(8):
        b = desc_bytes[:, 4 * w : 4 * w + 4].astype(np.uint32)
        desc_packed[:, w] = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)

    return DBoW2Vocab(
        children=children,
        desc=desc_packed,
        is_leaf=is_leaf,
        word_id=word_id,
        word_weight=word_weight,
        k=k,
        L=L,
        n_words=len(leaves),
    )


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


_TREE_CACHE: dict = {}  # (id(vocab), device) -> (vocab, tensors): one vocabulary at a time


def _tree_on(vocab: DBoW2Vocab, device: torch.device):
    """(children, node descriptors, word ids) of `vocab` as int64 tensors on
    `device`, uploaded once for the vocabulary's later frames."""
    key = (id(vocab), str(device))
    hit = _TREE_CACHE.get(key)
    if hit is None or hit[0] is not vocab:
        _TREE_CACHE.clear()
        hit = _TREE_CACHE[key] = (vocab, tuple(
            torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
            for a in (vocab.children, vocab.desc, vocab.word_id)
        ))
    return hit[1]


def compute_words_tree(desc: torch.Tensor, vocab: DBoW2Vocab) -> torch.Tensor:
    """Packed descriptors (*B, N, 8) int64 (32-bit words) -> DBoW2 word ids
    (*B, N) int64, on the descriptors' device. Each level gathers the k
    children of every live node, takes the Hamming distance to each and
    moves to the first nearest; a leaf keeps its node."""
    children, node_desc, word_id = _tree_on(vocab, desc.device)
    q = desc.reshape(-1, 8)
    cur = torch.zeros(q.shape[:1], dtype=torch.int64, device=desc.device)
    for _ in range(vocab.L + 1):
        ch = children[cur]  # (N, k)
        cd = node_desc[torch.clamp(ch, min=0)]  # (N, k, 8)
        dist = torch.sum(_popcount32(cd ^ q[:, None, :]), dim=-1)
        dist = torch.where(ch >= 0, dist, 1 << 14)
        nxt = torch.gather(ch, 1, torch.argmin(dist, dim=-1, keepdim=True))[:, 0]
        cur = torch.where(nxt >= 0, nxt, cur)
    return word_id[cur].reshape(desc.shape[:-1])


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _hamming_np(a_bytes: np.ndarray, b_bytes: np.ndarray) -> np.ndarray:
    """(N, 32) x (K, 32) uint8 -> (N, K) Hamming distances."""
    x = np.bitwise_xor(a_bytes[:, None, :], b_bytes[None, :, :])
    return _POP8[x].sum(axis=-1, dtype=np.int32)


def _majority_centroid(rows: np.ndarray) -> np.ndarray:
    """Bitwise-majority mean of (M, 32) uint8 descriptor rows (the FORB
    meanValue of DBoW2: each bit set iff set in more than half the rows,
    Thirdparty/DBoW2/DBoW2/FORB.cpp)."""
    bits = np.unpackbits(rows, axis=1)  # (M, 256)
    maj = (bits.sum(axis=0) * 2 > rows.shape[0]).astype(np.uint8)
    return np.packbits(maj)


def build_vocabulary(
    desc: np.ndarray,
    k: int = 10,
    L: int = 5,
    doc_ids: np.ndarray | None = None,
    seed: int = 42,
    kmeans_iters: int = 8,
) -> DBoW2Vocab:
    """Train a hierarchical k-means ORB vocabulary from packed descriptors
    (N, 8) uint32 (reference: TemplatedVocabulary::create,
    Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h — k-means++ seeding,
    Hamming assignment, bitwise-majority centroids, recursion to depth L;
    clusters of <= k or identical descriptors become leaves early).

    `doc_ids` (N,) optional training-image id per descriptor: enables
    DBoW2's TF-IDF node weights w_i = log(N_images / N_images_containing_i)
    (TemplatedVocabulary::setNodeWeights); without it all weights are 1.

    Offline tool (pure numpy) — quantization at runtime stays the batched
    `compute_words_tree` descent."""
    rng = np.random.default_rng(seed)
    desc = np.ascontiguousarray(np.asarray(desc, np.uint32))
    dbytes = desc.view(np.uint8).reshape(-1, 32)  # little-endian byte order
    N = dbytes.shape[0]

    children: list[list[int]] = [[]]
    node_desc: list[np.ndarray] = [np.zeros(32, np.uint8)]
    node_rows: list[np.ndarray | None] = [None]  # member rows for leaves

    def new_node(parent: int, centroid: np.ndarray) -> int:
        nid = len(children)
        children.append([])
        node_desc.append(centroid)
        node_rows.append(None)
        children[parent].append(nid)
        return nid

    def kmeanspp_centers(rows: np.ndarray, kk: int) -> np.ndarray:
        c = [rows[rng.integers(len(rows))]]
        d = _hamming_np(rows, np.stack(c))[:, 0].astype(np.float64)
        for _ in range(1, kk):
            p = d * d
            s = p.sum()
            if s <= 0:
                break
            c.append(rows[rng.choice(len(rows), p=p / s)])
            d = np.minimum(d, _hamming_np(rows, c[-1][None])[:, 0])
        return np.stack(c)

    stack = [(0, np.arange(N), 0)]
    while stack:
        parent, idx, lev = stack.pop()
        rows = dbytes[idx]
        uniq = np.unique(rows, axis=0)
        if len(uniq) <= k:
            # Each distinct descriptor is its own cluster (DBoW2: when the
            # group has <= k descriptors each becomes a cluster center).
            for u in uniq:
                nid = new_node(parent, u)
                node_rows[nid] = idx[(rows == u).all(axis=1)]
            continue
        centers = kmeanspp_centers(rows, k)
        assign = np.argmin(_hamming_np(rows, centers), axis=1)
        for _ in range(kmeans_iters):
            moved = False
            for c in range(len(centers)):
                sel = assign == c
                if sel.any():
                    nc = _majority_centroid(rows[sel])
                    if not np.array_equal(nc, centers[c]):
                        centers[c] = nc
                        moved = True
            if not moved:
                break
            assign = np.argmin(_hamming_np(rows, centers), axis=1)
        for c in range(len(centers)):
            sel = assign == c
            if not sel.any():
                continue
            nid = new_node(parent, centers[c])
            sub = idx[sel]
            if lev + 1 < L and len(np.unique(rows[sel], axis=0)) > 1:
                stack.append((nid, sub, lev + 1))
            else:
                node_rows[nid] = sub

    M = len(children)
    ch = np.full((M, k), -1, np.int32)
    for i, cs in enumerate(children):
        ch[i, : len(cs)] = cs
    is_leaf = np.array([len(cs) == 0 for cs in children], bool)
    is_leaf[0] = False
    word_id = np.full((M,), -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)

    weights = np.ones((len(leaves),), np.float32)
    if doc_ids is not None:
        doc_ids = np.asarray(doc_ids)
        n_docs = len(np.unique(doc_ids))
        for w, leaf in enumerate(leaves):
            rows_w = node_rows[leaf]
            ni = len(np.unique(doc_ids[rows_w])) if rows_w is not None else 0
            weights[w] = np.log(n_docs / ni) if ni > 0 else 0.0

    packed = np.zeros((M, 8), np.uint32)
    nb = np.stack(node_desc).astype(np.uint32)
    for w in range(8):
        b = nb[:, 4 * w : 4 * w + 4]
        packed[:, w] = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)

    return DBoW2Vocab(
        children=ch,
        desc=packed,
        is_leaf=is_leaf,
        word_id=word_id,
        word_weight=weights,
        k=k,
        L=L,
        n_words=len(leaves),
    )


def save_dbow2_text(path: str, vocab: DBoW2Vocab) -> None:
    """Write the DBoW2 text format (round-trip / test helper)."""
    M = vocab.children.shape[0]
    parent = np.zeros((M,), np.int64)
    for i in range(M):
        for c in vocab.children[i]:
            if c >= 0:
                parent[c] = i
    w_of_node = np.zeros((M,), np.float32)
    leaf_rows = np.nonzero(vocab.is_leaf)[0]
    w_of_node[leaf_rows] = vocab.word_weight[vocab.word_id[leaf_rows]]
    with open(path, "w") as f:
        f.write(f"{vocab.k} {vocab.L} 0 0\n")
        for i in range(1, M):
            by = []
            for w in range(8):
                v = int(vocab.desc[i, w])
                by += [v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, (v >> 24) & 0xFF]
            f.write(
                f"{parent[i]} {1 if vocab.is_leaf[i] else 0} "
                + " ".join(str(b) for b in by)
                + f" {w_of_node[i]:.6f}\n"
            )
