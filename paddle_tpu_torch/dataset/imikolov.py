"""PTB-style n-gram LM data (reference ``python/paddle/dataset/imikolov.py``
builds n-grams for word2vec).  Synthetic fallback: Markov-chain text."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "build_dict"]

N_WORDS = 2073  # reference vocab ~2073 after min-freq cut


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(N_WORDS)}


def _synthetic_sentences(split, n_sent):
    rng = common.synthetic_rng("imikolov", split)
    # Zipfian unigrams (like real text) + skewed sparse Markov transitions:
    # the unigram prior alone is worth ~2 nats over uniform, and the
    # dominant successor carries most of the conditional mass, so both are
    # learnable at book-test scale.
    zipf_p = 1.0 / (np.arange(N_WORDS) + 10.0)
    zipf_p /= zipf_p.sum()
    next_words = rng.choice(N_WORDS, size=(N_WORDS, 4), p=zipf_p)
    probs = np.asarray([0.7, 0.15, 0.1, 0.05])
    for _ in range(n_sent):
        length = int(rng.randint(6, 25))
        w = int(rng.choice(N_WORDS, p=zipf_p))
        sent = [w]
        for _ in range(length - 1):
            w = int(next_words[w, rng.choice(4, p=probs)])
            sent.append(w)
        yield sent


def train(word_idx=None, n=5, data_type=1):
    def reader():
        for sent in _synthetic_sentences("train", 2000):
            if len(sent) >= n:
                sent_arr = np.asarray(sent)
                for i in range(n - 1, len(sent)):
                    yield tuple(sent_arr[i - n + 1:i + 1])
    return reader


def test(word_idx=None, n=5, data_type=1):
    def reader():
        for sent in _synthetic_sentences("test", 400):
            if len(sent) >= n:
                sent_arr = np.asarray(sent)
                for i in range(n - 1, len(sent)):
                    yield tuple(sent_arr[i - n + 1:i + 1])
    return reader


def fetch():
    pass
