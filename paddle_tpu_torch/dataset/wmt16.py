"""WMT-16 en<->de with BPE (reference ``python/paddle/dataset/wmt16.py``)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "validation", "get_dict"]


def get_dict(lang, dict_size, reverse=False):
    d = {f"{lang}{i}": i for i in range(dict_size)}
    if reverse:
        d = {v: k for k, v in d.items()}
    return d


def _synthetic(split, n, src_dict_size, trg_dict_size):
    rng = common.synthetic_rng("wmt16", split)
    for _ in range(n):
        length = int(rng.randint(4, 24))
        src = rng.randint(3, src_dict_size, length).tolist()
        trg = [3 + ((t * 3 + 11) % (trg_dict_size - 3)) for t in src]
        yield src, [0] + trg, trg + [1]


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    def reader():
        yield from _synthetic("train", 2000, src_dict_size, trg_dict_size)
    return reader


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    def reader():
        yield from _synthetic("test", 400, src_dict_size, trg_dict_size)
    return reader


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    def reader():
        yield from _synthetic("val", 400, src_dict_size, trg_dict_size)
    return reader


def fetch():
    pass
