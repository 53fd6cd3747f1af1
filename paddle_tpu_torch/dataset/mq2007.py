"""MQ2007 learning-to-rank (reference ``python/paddle/dataset/mq2007.py``):
query-grouped 46-dim feature vectors with relevance labels; pairwise /
listwise / pointwise readers."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test"]

_N_FEATURES = 46


def _synthetic_queries(split, n_queries):
    rng = common.synthetic_rng("mq2007", split)
    w = rng.normal(0, 1, _N_FEATURES)
    for _ in range(n_queries):
        n_docs = int(rng.randint(5, 20))
        feats = rng.normal(0, 1, size=(n_docs, _N_FEATURES)).astype(
            np.float32)
        scores = feats @ w + rng.normal(0, 0.5, n_docs)
        rel = np.digitize(scores, np.percentile(scores, [50, 80]))
        yield feats, rel.astype(np.int64)


def _pairwise(split, n_queries):
    for feats, rel in _synthetic_queries(split, n_queries):
        order = np.argsort(-rel)
        for i in range(len(order)):
            for j in range(i + 1, len(order)):
                if rel[order[i]] > rel[order[j]]:
                    yield 1.0, feats[order[i]], feats[order[j]]


def _listwise(split, n_queries):
    for feats, rel in _synthetic_queries(split, n_queries):
        yield feats, rel


def _pointwise(split, n_queries):
    for feats, rel in _synthetic_queries(split, n_queries):
        for f, r in zip(feats, rel):
            yield f, float(r)


def train(format="pairwise"):
    def reader():
        if format == "pairwise":
            yield from _pairwise("train", 120)
        elif format == "listwise":
            yield from _listwise("train", 120)
        else:
            yield from _pointwise("train", 120)
    return reader


def test(format="pairwise"):
    def reader():
        if format == "pairwise":
            yield from _pairwise("test", 30)
        elif format == "listwise":
            yield from _listwise("test", 30)
        else:
            yield from _pointwise("test", 30)
    return reader


def fetch():
    pass
