"""Movie-review sentiment (reference ``python/paddle/dataset/sentiment.py``
over NLTK movie_reviews).  Synthetic fallback mirrors imdb."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "get_word_dict"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 3000


def get_word_dict():
    return [(f"w{i}", i) for i in range(_VOCAB)]


def _synthetic(split, n):
    rng = common.synthetic_rng("sentiment", split)
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(10, 60))
        center = _VOCAB // 4 if label == 0 else 3 * _VOCAB // 4
        ids = np.clip(rng.normal(center, _VOCAB // 5, length).astype(int),
                      0, _VOCAB - 1)
        yield list(ids), label


def train():
    def reader():
        yield from _synthetic("train", NUM_TRAINING_INSTANCES)
    return reader


def test():
    def reader():
        yield from _synthetic("test",
                              NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES)
    return reader


def fetch():
    pass
