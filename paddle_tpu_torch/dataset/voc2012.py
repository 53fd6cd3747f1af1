"""Pascal VOC2012 segmentation (reference
``python/paddle/dataset/voc2012.py``): (image, segmentation-label) pairs.
Synthetic fallback: colored rectangles with matching masks."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "val"]

_N_CLASSES = 21
_H = _W = 128


def _synthetic(split, n):
    rng = common.synthetic_rng("voc2012", split)
    for _ in range(n):
        img = rng.normal(0.5, 0.1, size=(3, _H, _W)).astype(np.float32)
        label = np.zeros((_H, _W), dtype=np.int32)
        for _ in range(int(rng.randint(1, 4))):
            cls = int(rng.randint(1, _N_CLASSES))
            x0, y0 = rng.randint(0, _H // 2), rng.randint(0, _W // 2)
            h, w = rng.randint(16, _H // 2), rng.randint(16, _W // 2)
            label[x0:x0 + h, y0:y0 + w] = cls
            img[:, x0:x0 + h, y0:y0 + w] += cls / _N_CLASSES - 0.5
        yield np.clip(img, 0, 1), label


def train():
    def reader():
        yield from _synthetic("train", 256)
    return reader


def test():
    def reader():
        yield from _synthetic("test", 64)
    return reader


def val():
    def reader():
        yield from _synthetic("val", 64)
    return reader


def fetch():
    pass
