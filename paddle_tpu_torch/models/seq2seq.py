"""Attention seq2seq NMT (the port of ``paddle_tpu.models.seq2seq``) —
the reference benchmark workload ``benchmark/fluid/machine_translation.py``
(bi-LSTM encoder + DynamicRNN decoder with Bahdanau-style additive
attention).

Per decoder step: the decoder state expands over the encoder tokens
(``sequence_expand``), an additive score per token feeds
``sequence_softmax``, and the attention-weighted sum of encoder states
becomes the context vector — the same op chain the reference composes.
The decoder is one ``while`` over the target steps, run as a Python loop
on the device (``ops/control_flow_ops.py``).

``SEQ2SEQ_NMT_512`` is the benchmark's configuration
(``bench_seq2seq.py:22-24``): dictionaries of 30000 words, embeddings,
encoder and decoder of 512, 16 sentence pairs of 2 ... 50 tokens each
side, Adam(1e-3), float32.
"""

from __future__ import annotations

import numpy as np

import paddle_tpu_torch.layers as layers

__all__ = ["seq_to_seq_net", "fake_batch", "SEQ2SEQ_NMT_512"]

#: ``bench_seq2seq.py``'s widths and batch (nothing cut)
SEQ2SEQ_NMT_512 = dict(src_dict_size=30000, trg_dict_size=30000,
                       emb_dim=512, encoder_size=512, decoder_size=512,
                       batch=16, src_max=50, trg_max=50, lr=1e-3)


def _bi_lstm_encoder(src_emb, size):
    fwd_proj = layers.fc(input=src_emb, size=size * 4, bias_attr=False)
    fwd_proj.lod_level = 1
    fwd, _ = layers.dynamic_lstm(input=fwd_proj, size=size * 4)
    rev_proj = layers.fc(input=src_emb, size=size * 4, bias_attr=False)
    rev_proj.lod_level = 1
    rev, _ = layers.dynamic_lstm(input=rev_proj, size=size * 4,
                                 is_reverse=True)
    return layers.concat([fwd, rev], axis=1)


def seq_to_seq_net(src_dict_size, trg_dict_size, emb_dim=32,
                   encoder_size=32, decoder_size=32):
    """Build the training graph; returns (avg_cost, prediction).

    Feeds: ``src_word`` / ``trg_word`` / ``label`` int64 [N, 1]
    lod_level=1 (label shares trg_word's lod).
    """
    src = layers.data(name="src_word", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    trg = layers.data(name="trg_word", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    label = layers.data(name="label", shape=[-1, 1], dtype="int64",
                        append_batch_size=False, lod_level=1)

    src_emb = layers.embedding(input=src, size=[src_dict_size, emb_dim])
    encoded = _bi_lstm_encoder(src_emb, encoder_size)   # [N, 2*enc]
    encoded.lod_level = 1
    # projection used by the additive attention score
    encoded_proj = layers.fc(input=encoded, size=decoder_size,
                             bias_attr=False)
    encoded_proj.lod_level = 1
    # decoder boot state from the encoder's last step
    enc_last = layers.sequence_last_step(encoded)
    boot = layers.fc(input=enc_last, size=decoder_size, act="tanh")

    trg_emb = layers.embedding(input=trg, size=[trg_dict_size, emb_dim])

    drnn = layers.DynamicRNN()
    with drnn.block():
        cur = drnn.step_input(trg_emb)                   # [B, emb]
        enc_vec = drnn.static_input(encoded)             # ragged [N, 2e]
        enc_proj = drnn.static_input(encoded_proj)       # ragged [N, d]
        hidden = drnn.memory(init=boot)                  # [B, d]
        # additive attention: score(tok) = v . tanh(proj_tok + W h)
        state_proj = layers.fc(input=hidden, size=decoder_size,
                               bias_attr=False)
        expanded = layers.sequence_expand(x=state_proj, y=enc_proj)
        att_in = layers.elementwise_add(enc_proj, expanded)
        att_in = layers.tanh(att_in)
        att_in.lod_level = 1
        scores = layers.fc(input=att_in, size=1, bias_attr=False)
        scores.lod_level = 1
        weights = layers.sequence_softmax(scores)        # ragged [N, 1]
        weighted = layers.elementwise_mul(enc_vec, weights, axis=0)
        weighted.lod_level = 1
        context = layers.sequence_pool(weighted, "sum")  # [B, 2e]
        new_hidden = layers.fc(input=[cur, context, hidden],
                               size=decoder_size, act="tanh")
        drnn.update_memory(hidden, new_hidden)
        out = layers.fc(input=new_hidden, size=trg_dict_size,
                        act="softmax")
        drnn.output(out)
    prediction = drnn()

    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    return avg_cost, prediction


def fake_batch(batch, src_max, trg_max, src_dict, trg_dict, seed=0):
    """Deterministic learnable toy task: trg[t] = f(trg[t-1], src[0])."""
    rng = np.random.RandomState(seed)
    s_lens = rng.randint(2, src_max + 1, batch)
    t_lens = rng.randint(2, trg_max + 1, batch)
    s_splits = np.concatenate([[0], np.cumsum(s_lens)])
    t_splits = np.concatenate([[0], np.cumsum(t_lens)])
    src = rng.randint(0, src_dict, (s_splits[-1], 1)).astype("int64")
    trg_rows, lab_rows = [], []
    for b in range(batch):
        first_src = int(src[s_splits[b], 0])
        seq = [1]
        for _ in range(t_lens[b] - 1):
            seq.append((seq[-1] * 3 + first_src + 1) % trg_dict)
        trg_rows += seq
        lab_rows += seq[1:] + [(seq[-1] * 3 + first_src + 1) % trg_dict]
    return {
        "src_word": (src, [[int(s) for s in s_splits]]),
        "trg_word": (np.asarray(trg_rows, "int64").reshape(-1, 1),
                     [[int(s) for s in t_splits]]),
        "label": (np.asarray(lab_rows, "int64").reshape(-1, 1),
                  [[int(s) for s in t_splits]]),
    }
