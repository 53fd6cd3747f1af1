"""CoNLL-2005 SRL (reference ``python/paddle/dataset/conll05.py``):
(word, ctx_n2..ctx_p2, verb, mark) sequences -> IOB label sequence.
Synthetic fallback with verb-anchored label structure."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["test", "get_dict", "get_embedding", "word_dict_len",
           "label_dict_len", "pred_dict_len"]

word_dict_len = 44068
label_dict_len = 59
pred_dict_len = 3162


def get_dict():
    word_dict = {f"w{i}": i for i in range(word_dict_len)}
    verb_dict = {f"v{i}": i for i in range(pred_dict_len)}
    label_dict = {f"l{i}": i for i in range(label_dict_len)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = common.synthetic_rng("conll05", "emb")
    return rng.normal(0, 0.1, size=(word_dict_len, 32)).astype(np.float32)


def _synthetic(split, n):
    rng = common.synthetic_rng("conll05", split)
    for _ in range(n):
        length = int(rng.randint(5, 40))
        words = rng.randint(0, word_dict_len, length).tolist()
        verb_pos = int(rng.randint(0, length))
        verb = int(rng.randint(0, pred_dict_len))
        mark = [1 if i == verb_pos else 0 for i in range(length)]

        def ctx(offset):
            idx = min(max(verb_pos + offset, 0), length - 1)
            return [words[idx]] * length

        labels = []
        for i in range(length):
            d = abs(i - verb_pos)
            labels.append(int(min(d, 2) * 19 + rng.randint(0, 19)) %
                          label_dict_len)
        yield (words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
               [verb] * length, mark, labels)


def test():
    def reader():
        yield from _synthetic("test", 400)
    return reader


def train():
    def reader():
        yield from _synthetic("train", 1600)
    return reader


def fetch():
    pass
