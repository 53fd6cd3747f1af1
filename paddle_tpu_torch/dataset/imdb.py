"""IMDB sentiment (reference ``python/paddle/dataset/imdb.py``): word-id
sequences + binary label.  Synthetic fallback: two vocab regions with
class-dependent frequencies."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "word_dict"]

_VOCAB = 5147  # close to the reference's cutoff vocab


def word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _synthetic(split, n):
    rng = common.synthetic_rng("imdb", split)
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(20, 120))
        center = _VOCAB // 4 if label == 0 else 3 * _VOCAB // 4
        ids = np.clip(rng.normal(center, _VOCAB // 6, length).astype(int),
                      0, _VOCAB - 1)
        yield list(ids), label


def train(word_idx=None):
    def reader():
        yield from _synthetic("train", 2000)
    return reader


def test(word_idx=None):
    def reader():
        yield from _synthetic("test", 500)
    return reader


def fetch():
    pass
