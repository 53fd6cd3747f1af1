"""Wide & Deep CTR model (Cheng et al. 2016; the port of
``paddle_tpu.models.wide_and_deep``, same signature and defaults).

Sparse id features look up embedding tables built with
``is_sparse=True``, so the backward emits SelectedRows grads and the
optimizer touches only the rows a batch used.  Both tables are also
marked ``is_distributed=True``, as in the JAX package (the IR is the
same); the port has no sharded tables yet and keeps each on one device.
"""

from __future__ import annotations

import numpy as np

import paddle_tpu_torch.layers as layers

#: the JAX package's default geometry (divisible by 2 and 4 shards)
DEFAULT_VOCAB = 64

#: W&D-Criteo, the widths the port trains on the card: the feature
#: layout of the Criteo Display Advertising data (13 dense and 26
#: categorical features), the Wide & Deep paper's embedding width (32)
#: and first ReLU layer (1024; the model's two ReLU layers share one
#: width), and one shared hashed table of 2**23 rows (1 GiB in float32)
CRITEO = dict(vocab_size=2 ** 23, num_slots=26, emb_dim=32, dense_dim=13,
              hidden=1024)
CRITEO_BATCH = 4096
#: the ids of :func:`fake_batch` lie below this
FAKE_ID_RANGE = 2 ** 20


def wide_and_deep_train_program(batch_size, vocab_size=DEFAULT_VOCAB,
                                num_slots=4, emb_dim=8, dense_dim=8,
                                hidden=16):
    """CTR click prediction: ``num_slots`` sparse id features + a dense
    feature vector -> P(click).  Returns ``(avg_cost, acc,
    feed_names)`` like every zoo model's program.

    * **deep**: per-slot ``emb_dim`` embeddings, concatenated with the
      dense features, through two relu FCs of width ``hidden``;
    * **wide**: a second ``[vocab, 1]`` table, the linear cross-feature
      term, sum-pooled over slots;
    * head: wide + deep concatenated into a 2-way softmax against the
      click label.
    """
    slot_ids = layers.data(name="slot_ids",
                           shape=[batch_size, num_slots, 1],
                           dtype="int64", append_batch_size=False)
    dense = layers.data(name="dense", shape=[batch_size, dense_dim],
                        dtype="float32", append_batch_size=False)
    label = layers.data(name="label", shape=[batch_size, 1],
                        dtype="int64", append_batch_size=False)

    deep_emb = layers.embedding(
        slot_ids, size=[vocab_size, emb_dim], is_sparse=True,
        is_distributed=True, param_attr="wide_deep_emb")
    deep_in = layers.reshape(deep_emb,
                             [batch_size, num_slots * emb_dim])
    deep = layers.concat([deep_in, dense], axis=1)
    deep = layers.fc(deep, hidden, act="relu")
    deep = layers.fc(deep, hidden, act="relu")

    wide_emb = layers.embedding(
        slot_ids, size=[vocab_size, 1], is_sparse=True,
        is_distributed=True, param_attr="wide_lr_w")
    wide = layers.reshape(wide_emb, [batch_size, num_slots])
    wide = layers.reduce_sum(wide, dim=1, keep_dim=True)

    joint = layers.concat([wide, deep], axis=1)
    predict = layers.fc(joint, 2, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc, ["slot_ids", "dense", "label"]


def fake_batch(batch_size, seed=0, vocab_size=CRITEO["vocab_size"],
               num_slots=CRITEO["num_slots"],
               dense_dim=CRITEO["dense_dim"]):
    """A seeded synthetic CTR batch for the program's feeds.  Per slot a
    power law (``zipf(1.2) - 1``: hot ids repeat within a batch) shifted
    by a per-slot hash offset, below ``min(vocab_size, FAKE_ID_RANGE)``;
    clicks correlated with the first slot and the first dense feature,
    as ``tests/test_book_wide_deep.py`` makes them."""
    rng = np.random.RandomState(seed % (2 ** 31))
    ids = ((rng.zipf(1.2, (batch_size, num_slots)) - 1)
           + rng.randint(0, FAKE_ID_RANGE, num_slots)) \
        % min(vocab_size, FAKE_ID_RANGE)
    dense = rng.rand(batch_size, dense_dim).astype("float32")
    logit = ((ids[:, 0] % 7) - 3) * 0.8 + (dense[:, 0] - 0.5) * 2.0
    click = 1.0 / (1.0 + np.exp(-logit)) > rng.rand(batch_size)
    return {"slot_ids": ids.reshape(batch_size, num_slots, 1)
            .astype("int64"),
            "dense": dense, "label": click.astype("int64").reshape(-1, 1)}
