"""WMT-14 fr->en (reference ``python/paddle/dataset/wmt14.py``):
(src_ids, trg_ids, trg_next_ids) with <s>/<e>/<unk>.  Synthetic fallback:
invertible toy translation (target = f(source tokens))."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "get_dict"]

dict_size = 30000
START = 0  # <s>
END = 1    # <e>
UNK = 2    # <unk>


def get_dict(dict_size=dict_size, reverse=False):
    src_dict = {f"s{i}": i for i in range(dict_size)}
    trg_dict = {f"t{i}": i for i in range(dict_size)}
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict


def _synthetic(split, n, dict_size):
    rng = common.synthetic_rng("wmt14", split)
    for _ in range(n):
        length = int(rng.randint(4, 20))
        src = rng.randint(3, dict_size, length).tolist()
        # deterministic "translation": shifted tokens, reversed order
        trg = [3 + ((t + 7) % (dict_size - 3)) for t in reversed(src)]
        trg_in = [START] + trg
        trg_next = trg + [END]
        yield src, trg_in, trg_next


def train(dict_size=dict_size):
    def reader():
        yield from _synthetic("train", 2000, dict_size)
    return reader


def test(dict_size=dict_size):
    def reader():
        yield from _synthetic("test", 400, dict_size)
    return reader


def fetch():
    pass
