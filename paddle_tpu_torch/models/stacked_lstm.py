"""Stacked dynamic-LSTM sentiment classifier (the port of
``paddle_tpu.models.stacked_lstm``): the reference benchmark workload
``benchmark/fluid/stacked_dynamic_lstm.py``, an IMDB-style classifier:
embedding -> fc -> N stacked LSTMs over the ragged sequence -> last and
max pooling -> softmax.  Each layer is one ``dynamic_lstm`` op.
"""

from __future__ import annotations

import numpy as np

import paddle_tpu_torch.layers as layers

__all__ = ["stacked_lstm_net", "fake_batch", "BENCHMARK_LSTM"]

#: LSTM-IMDB-H512: the reference's stacked dynamic LSTM benchmark
#: (``benchmark/fluid/stacked_dynamic_lstm.py``; ``benchmark/README.md``'s
#: table: IMDB sentiment, 2 LSTM layers with peepholes, dictionary 30k,
#: sequences up to 100 words, batch 64) at a hidden width of 512;
#: ``Adam(lr)``, float32.  Build with ``stacked_lstm_net(dict_size,
#: emb_dim, hidden_dim, n_layers, class_num)``, feed ``fake_batch(batch,
#: max_len, dict_size, seed)``.
BENCHMARK_LSTM = dict(dict_size=30000, emb_dim=512, hidden_dim=512,
                      n_layers=2, class_num=2, batch=64, max_len=100,
                      lr=1e-3)


def stacked_lstm_net(dict_size, emb_dim=64, hidden_dim=64, n_layers=2,
                     class_num=2):
    """Build the classifier; returns (avg_cost, accuracy, prediction).

    Feeds: ``words`` int64 [N, 1] lod_level=1, ``label`` int64 [B, 1].
    """
    words = layers.data(name="words", shape=[-1, 1], dtype="int64",
                        append_batch_size=False, lod_level=1)
    label = layers.data(name="label", shape=[-1, 1], dtype="int64",
                        append_batch_size=False)
    emb = layers.embedding(input=words, size=[dict_size, emb_dim])
    h = layers.fc(input=emb, size=hidden_dim, act="tanh")
    h.lod_level = 1
    for _ in range(n_layers):
        proj = layers.fc(input=h, size=hidden_dim * 4)
        proj.lod_level = 1
        h, _ = layers.dynamic_lstm(input=proj, size=hidden_dim * 4)
    last = layers.sequence_last_step(h)
    mx = layers.sequence_pool(h, "max")
    feat = layers.concat([last, mx], axis=1)
    prediction = layers.fc(input=feat, size=class_num, act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction


def fake_batch(batch, max_len, dict_size, seed=0):
    """Synthetic learnable batch: the label is a parity-style function of
    the word ids, so the classifier can overfit it.  ``words`` is fed as
    ``(ids [N, 1], lod)``, lengths uniform in 2 … max_len."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(2, max_len + 1, batch)
    splits = np.concatenate([[0], np.cumsum(lengths)])
    words = rng.randint(0, dict_size, (splits[-1], 1)).astype("int64")
    labels = np.array([
        int(words[splits[i]:splits[i + 1]].sum() % 2)
        for i in range(batch)], "int64").reshape(-1, 1)
    return {"words": (words, [[int(s) for s in splits]]),
            "label": labels}
