"""UCI housing (reference ``python/paddle/dataset/uci_housing.py``):
13 normalized features -> price.  Synthetic fallback: linear model +
noise, so fit-a-line converges to a known solution."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test"]

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT"]


def _load():
    path = os.path.join(common.DATA_HOME, "uci_housing", "housing.data")
    if os.path.exists(path):
        data = np.fromfile(path, sep=" ").reshape(-1, 14)
        maximums = data.max(axis=0)
        minimums = data.min(axis=0)
        avgs = data.sum(axis=0) / data.shape[0]
        for i in range(13):
            data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
        return data.astype(np.float32)
    rng = common.synthetic_rng("uci_housing")
    n = 506
    x = rng.normal(0, 0.3, size=(n, 13)).astype(np.float32)
    w = np.linspace(-2, 2, 13).astype(np.float32)
    y = x @ w + 3.0 + rng.normal(0, 0.1, n).astype(np.float32)
    return np.concatenate([x, y[:, None]], axis=1)


def train():
    def reader():
        data = _load()
        split = int(data.shape[0] * 0.8)
        for row in data[:split]:
            yield row[:-1], row[-1:]
    return reader


def test():
    def reader():
        data = _load()
        split = int(data.shape[0] * 0.8)
        for row in data[split:]:
            yield row[:-1], row[-1:]
    return reader


def fetch():
    pass
