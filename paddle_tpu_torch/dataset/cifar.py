"""CIFAR-10/100 (reference ``python/paddle/dataset/cifar.py``): 3x32x32
images scaled to [0,1].  Synthetic fallback keyed by class."""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train10", "test10", "train100", "test100"]


def _tar_reader(path, sub_name):
    def reader():
        with tarfile.open(path, mode="r") as f:
            names = [n for n in f.getnames() if sub_name in n]
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                data = batch[b"data"]
                labels = batch.get(b"labels", batch.get(b"fine_labels"))
                for s, l in zip(data, labels):
                    yield s.astype(np.float32) / 255.0, int(l)
    return reader


def _synthetic_reader(split, num_classes, n):
    def reader():
        rng = common.synthetic_rng(f"cifar{num_classes}", split)
        labels = rng.randint(0, num_classes, size=n)
        base = rng.normal(0, 1, size=(num_classes, 3072)).astype(np.float32)
        for i in range(n):
            img = base[labels[i]] * 0.3 + \
                rng.normal(0, 0.2, 3072).astype(np.float32) + 0.5
            yield np.clip(img, 0, 1), int(labels[i])
    return reader


def _creator(fname, sub_name, split, num_classes, n_synth):
    path = os.path.join(common.DATA_HOME, "cifar", fname)
    if os.path.exists(path):
        return _tar_reader(path, sub_name)
    return _synthetic_reader(split, num_classes, n_synth)


def train10():
    return _creator("cifar-10-python.tar.gz", "data_batch", "train", 10, 4096)


def test10():
    return _creator("cifar-10-python.tar.gz", "test_batch", "test", 10, 1024)


def train100():
    return _creator("cifar-100-python.tar.gz", "train", "train", 100, 4096)


def test100():
    return _creator("cifar-100-python.tar.gz", "test", "test", 100, 1024)


def fetch():
    pass
