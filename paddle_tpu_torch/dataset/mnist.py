"""MNIST (reference ``python/paddle/dataset/mnist.py``): 28x28 grayscale
digits, normalized to [-1, 1], labels 0-9.  Reads the IDX files from the
local cache when present; otherwise yields deterministic synthetic digits
(class-dependent blob patterns so simple models actually converge)."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test"]

TRAIN_IMAGE = "train-images-idx3-ubyte.gz"
TRAIN_LABEL = "train-labels-idx1-ubyte.gz"
TEST_IMAGE = "t10k-images-idx3-ubyte.gz"
TEST_LABEL = "t10k-labels-idx1-ubyte.gz"


def _read_idx(image_path, label_path):
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    with gzip.open(label_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    images = images.astype(np.float32) / 255.0 * 2.0 - 1.0
    return images, labels.astype(np.int64)


def _cached(image_name, label_name):
    d = os.path.join(common.DATA_HOME, "mnist")
    ip, lp = os.path.join(d, image_name), os.path.join(d, label_name)
    if os.path.exists(ip) and os.path.exists(lp):
        return _read_idx(ip, lp)
    return None


def _synthetic(split, n):
    rng = common.synthetic_rng("mnist", split)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    # class-dependent gaussian blob at a per-class location + noise
    xs = np.zeros((n, 784), dtype=np.float32)
    grid = np.stack(np.meshgrid(np.arange(28), np.arange(28),
                                indexing="ij"), -1).reshape(-1, 2)
    centers = np.stack([(7 + 4 * (k % 5), 7 + 9 * (k // 5))
                        for k in range(10)])
    for k in range(10):
        mask = labels == k
        cnt = int(mask.sum())
        if cnt == 0:
            continue
        d2 = np.sum((grid - centers[k]) ** 2, axis=1)
        blob = np.exp(-d2 / 20.0).astype(np.float32)
        xs[mask] = blob[None, :] + \
            rng.normal(0, 0.15, size=(cnt, 784)).astype(np.float32)
    xs = np.clip(xs, 0, 1) * 2.0 - 1.0
    return xs, labels


def _reader_creator(split, image_name, label_name, n_synth):
    def reader():
        data = _cached(image_name, label_name)
        if data is None:
            data = _synthetic(split, n_synth)
        images, labels = data
        for img, lbl in zip(images, labels):
            yield img, int(lbl)
    return reader


def train():
    return _reader_creator("train", TRAIN_IMAGE, TRAIN_LABEL, 8192)


def test():
    return _reader_creator("test", TEST_IMAGE, TEST_LABEL, 2048)


def fetch():
    pass
