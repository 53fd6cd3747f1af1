"""Oxford-102 flowers (reference ``python/paddle/dataset/flowers.py``):
3x224x224 images, 102 classes.  Synthetic fallback."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "valid"]


def _synthetic(split, n, use_xmap):
    rng = common.synthetic_rng("flowers", split)
    base = rng.normal(0, 1, size=(102, 12)).astype(np.float32)
    for _ in range(n):
        label = int(rng.randint(0, 102))
        # low-rank image: class signature outer product + noise
        u = base[label].reshape(12, 1, 1)
        img = (np.broadcast_to(u, (12, 224, 224)).reshape(
            3, 4, 224, 224).mean(axis=1) * 0.25 + 0.5)
        img = img + rng.normal(0, 0.1, size=(3, 224, 224))
        yield np.clip(img, 0, 1).astype(np.float32).flatten(), label


def train(mapper=None, buffered_size=1024, use_xmap=True):
    def reader():
        yield from _synthetic("train", 512, use_xmap)
    return reader


def test(mapper=None, buffered_size=1024, use_xmap=True):
    def reader():
        yield from _synthetic("test", 128, use_xmap)
    return reader


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    def reader():
        yield from _synthetic("valid", 128, use_xmap)
    return reader


def fetch():
    pass
