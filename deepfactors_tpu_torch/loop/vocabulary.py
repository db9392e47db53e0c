"""Bag-of-words retrieval over binary descriptors (the DBoW2 equivalent).

PyTorch port of ``deepfactors_tpu/loop/vocabulary.py`` (reference
sources/core/system/loop_detector.{h,cpp}, the FBrisk adapter fbrisk.h:
35-54, the vocabulary of the voc_builder tool). A FLAT vocabulary of V
binary centroids: a word is assigned by one batched Hamming distance
matrix and an argmin (among equally near words the first wins, as
``jnp.argmin`` picks), tf-idf BoW vectors, and the DBoW2 L1 score
  s(v, w) = 1 - 0.5 * || v/|v|_1 - w/|w|_1 ||_1
of a vector against every database row at once.

Words are ``int32`` holding the bits of the JAX package's ``uint32`` words,
as the descriptors of ``features/detector.py`` are; ``vocabulary_from_numpy``
carries a vocabulary across. Training and saving run on the host in numpy.

Plain PyTorch on the device of its input: no hand-written kernel.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..features.matching import popcount32

Tensor = torch.Tensor


class Vocabulary(NamedTuple):
    words: Tensor   # [V, 8] int32 binary centroids (uint32 bits)
    idf: Tensor     # [V] float32 inverse document frequency weights


def vocabulary_from_numpy(words: np.ndarray, idf: np.ndarray,
                          device="cuda") -> Vocabulary:
    """A vocabulary from host arrays (``uint32`` or ``int32`` words [V, 8],
    idf [V]), e.g. the JAX package's ``Vocabulary`` after ``np.asarray``."""
    w = np.ascontiguousarray(np.asarray(words).astype(np.uint32)).view(np.int32)
    return Vocabulary(words=torch.as_tensor(w, device=device),
                      idf=torch.as_tensor(np.array(idf, np.float32),
                                          device=device))


def vocabulary_to_numpy(voc: Vocabulary):
    """(words [V, 8] uint32, idf [V] float32) on the host."""
    return (voc.words.detach().cpu().numpy().view(np.uint32),
            voc.idf.detach().cpu().numpy())


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(
        x.view(np.uint8).reshape(a.shape[0], b.shape[0], 32), axis=2
    ).sum(axis=2)


def train_vocabulary(descriptors: np.ndarray, num_words: int = 256,
                     iters: int = 8, seed: int = 0,
                     device="cuda") -> Vocabulary:
    """Binary k-means (k-majority) over training descriptors [N, 8]
    (``uint32`` words, or ``int32`` holding their bits): the voc_builder
    equivalent, on the host, offline."""
    descriptors = np.ascontiguousarray(descriptors).view(np.uint32)
    rng = np.random.RandomState(seed)
    N = descriptors.shape[0]
    words = descriptors[rng.choice(N, min(num_words, N), replace=False)]
    if words.shape[0] < num_words:
        words = np.concatenate(
            [words, rng.randint(0, 2**32, (num_words - words.shape[0], 8),
                                dtype=np.uint32)])
    bits = np.unpackbits(descriptors.view(np.uint8).reshape(N, 32), axis=1)
    for _ in range(iters):
        assign = _hamming_np(descriptors, words).argmin(axis=1)
        new_words = []
        for v in range(num_words):
            sel = bits[assign == v]
            if len(sel) == 0:
                new_words.append(words[v])
                continue
            maj = (sel.mean(axis=0) > 0.5).astype(np.uint8)
            new_words.append(np.packbits(maj).view(np.uint32))
        words = np.stack(new_words)
    # idf from the training assignment frequencies
    assign = _hamming_np(descriptors, words).argmin(axis=1)
    counts = np.bincount(assign, minlength=num_words).astype(np.float32)
    idf = np.log(N / np.maximum(counts, 1.0))
    return vocabulary_from_numpy(words, idf, device)


def save_vocabulary(path: str, voc: Vocabulary) -> None:
    words, idf = vocabulary_to_numpy(voc)
    np.savez(path, words=words, idf=idf)


def load_vocabulary(path: str, device="cuda") -> Vocabulary:
    """Load a trained vocabulary (.npz from ``save_vocabulary`` or the JAX
    package's tools/voc_builder.py); the reference loads its DBoW2
    vocabulary at Init (loop_detector.cpp:26-34)."""
    d = np.load(path)
    return vocabulary_from_numpy(d["words"], d["idf"], device)


def default_vocabulary(device="cuda") -> Vocabulary:
    """The shipped room-corpus vocabulary, ``data/voc_room256.npz`` (a
    missing file raises)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data", "voc_room256.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"the shipped vocabulary {path} is missing")
    return load_vocabulary(path, device)


def random_vocabulary(num_words: int = 256, seed: int = 3,
                      device="cuda") -> Vocabulary:
    """LSH-style random vocabulary, usable without training data (random
    binary centroids still partition descriptor space); the same draws as
    the JAX package's. Only on request: a detector without a vocabulary
    loads the shipped one."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2**32, (num_words, 8), dtype=np.uint32)
    return vocabulary_from_numpy(words, np.ones((num_words,), np.float32),
                                 device)


def assign_words(voc: Vocabulary, desc: Tensor) -> Tensor:
    """The nearest word [K] of each descriptor [K, 8] by Hamming distance;
    among equally near words the first."""
    x = torch.bitwise_xor(desc[:, None, :], voc.words[None, :, :])
    d = torch.sum(popcount32(x), dim=-1, dtype=torch.int32)   # [K, V]
    return torch.argmin(d, dim=-1)


def bow_vector(voc: Vocabulary, desc: Tensor, valid: Tensor) -> Tensor:
    """tf-idf BoW vector [V] from descriptors [K, 8] with validity mask."""
    assign = assign_words(voc, desc)
    V = voc.words.shape[0]
    # a histogram of 1.0s and 0.0s: exact in any order of the adds
    hist = torch.zeros((V,), dtype=torch.float32, device=desc.device)
    hist.index_add_(0, assign, valid.to(torch.float32))
    v = hist * voc.idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def similarity(v: Tensor, db: Tensor, db_valid: Tensor) -> Tensor:
    """DBoW2 L1 score of v [V] against every database row [K, V] -> [K]
    (-inf where ``db_valid`` is false)."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(v[None, :] - db), dim=-1)
    return torch.where(db_valid, s, torch.full_like(s, float("-inf")))
