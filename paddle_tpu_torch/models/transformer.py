"""Transformer (Vaswani et al.) built on the Program IR layers (the
port of ``paddle_tpu.models.transformer``; the JAX package's training
flagship, ``bench.py:95-158``).

The program-building functions are the JAX package's, op for op, so the
two packages build the same IR dict: dense padded batches with explicit
[B, S] key masks, attention either composed (``matmul -> softmax(Bias)
-> matmul``, the bias-softmax kernels) or fused into the
``scaled_dot_product_attention`` op (the flash kernels) from
``PADDLE_TPU_FLASH_MIN_S`` on.  Its default of 512 is the JAX package's
TPU crossover, kept so that the IR matches; it has not been measured on
the H100.  ``tp_shardings`` gives the tensor-parallel placement rules
that ``ParallelExecutor(param_shardings=...)`` takes.
"""

from __future__ import annotations

import numpy as np

import paddle_tpu_torch.layers as layers
from paddle_tpu_torch.initializer import NumpyArrayInitializer
from paddle_tpu_torch.param_attr import ParamAttr


class ModelHyperParams:
    """Transformer-base (mirrors test_parallel_executor.py:308 defaults)."""
    src_vocab_size = 10000
    trg_vocab_size = 10000
    pos_pad_idx = 0
    src_pad_idx = 0
    trg_pad_idx = 0
    max_length = 256
    d_model = 512
    d_inner_hid = 2048
    d_key = 64
    d_value = 64
    n_head = 8
    n_layer = 6
    dropout = 0.1
    # attention-weight dropout (reference uses hp.dropout here too; the
    # flash kernel path supports 0.0 only — set >0 to force the composed
    # softmax path with weight dropout)
    attention_dropout = 0.0
    use_flash = True


def position_encoding_init(n_position, d_model):
    """Sinusoid position encoding table."""
    position = np.arange(n_position)[:, None].astype("float64")
    div = np.exp(np.arange(0, d_model, 2).astype("float64")
                 * -(np.log(10000.0) / d_model))
    table = np.zeros((n_position, d_model))
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div[: d_model // 2])
    return table.astype("float32")


def _shared_padding_bias(k_mask):
    """[B,S] mask -> [B,1,1,S] additive bias, built ONCE per mask var
    (layers share the constant instead of re-emitting it)."""
    name = k_mask.name + "@attn_bias"
    block = k_mask.block
    if block.has_var(name) and any(name in op.output_arg_names
                                   for op in block.ops):
        return block.var(name)
    neg = layers.scale(k_mask, scale=1e9, bias=-1e9)
    b, sk = k_mask.shape
    out = layers.reshape(neg, shape=[b, 1, 1, sk])
    block.vars.pop(out.name, None)
    out.name = name
    block.vars[name] = out
    block.ops[-1].outputs["Out"] = [name]
    return out


def _shared_causal_bias(block, sq):
    """[1,1,S,S] causal constant, one copy per program per length."""
    name = f"@causal_bias_{sq}"
    if block.has_var(name):
        return block.var(name)
    tri = np.triu(np.full((sq, sq), -1e9, dtype="float32"), 1)
    out = layers.assign(tri.reshape(1, 1, sq, sq))
    block.vars.pop(out.name, None)
    out.name = name
    block.vars[name] = out
    block.ops[-1].outputs["Out"] = [name]
    return out


def multi_head_attention(queries, keys, values, d_key, d_value, d_model,
                         n_head=1, dropout_rate=0.0, k_mask=None,
                         causal=False, use_flash=True, prefix=None):
    """Multi-head scaled-dot-product attention over dense [B,S,D] tensors.

    ``k_mask`` [B, S_k] (1=attend) covers padding; ``causal`` covers the
    decoder self-attention triangle.  With ``use_flash`` (from
    ``PADDLE_TPU_FLASH_MIN_S`` keys on) the fused op runs the flash
    kernels (no [B,H,S,S] tensor in device memory); the flash path
    applies no attention-weight dropout — the composed-op path is used
    instead when attention dropout is requested.
    """
    keys = queries if keys is None else keys
    values = keys if values is None else values

    def pa(role):
        # structured names let tensor-parallel sharding rules (tp_shardings)
        # address parameters by role
        return ParamAttr(name=f"{prefix}_{role}.w") if prefix else None

    q = layers.fc(queries, d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=pa("q"))
    k = layers.fc(keys, d_key * n_head, num_flatten_dims=2, bias_attr=False,
                  param_attr=pa("k"))
    v = layers.fc(values, d_value * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=pa("v"))

    def split_heads(x, d_per_head):
        # [B, S, H*D] -> [B, H, S, D]
        b, s = x.shape[0], x.shape[1]
        x = layers.reshape(x, shape=[b, s, n_head, d_per_head])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    q = split_heads(q, d_key)
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)
    scale = float(d_key) ** -0.5

    # the fused op wins once the [S,S] score tensor dominates the memory
    # traffic; the crossover is workload-dependent, so the threshold is a
    # knob (PADDLE_TPU_FLASH_MIN_S).  Its default of 512 is the JAX
    # package's TPU crossover, kept so the two packages build the same
    # IR; the H100's own crossover is not derived yet.
    import os
    flash_min_s = int(os.environ.get("PADDLE_TPU_FLASH_MIN_S", "512"))
    use_flash = use_flash and (k.shape[2] >= flash_min_s)
    # sequence/context parallelism: shard S over the mesh 'seq' axis and
    # attend with the ppermute ring (parallel/ring_attention.py); only for
    # self-attention (q and k share the sequence sharding)
    from paddle_tpu_torch.executor import _env_flag
    seq_parallel = _env_flag("PADDLE_TPU_SEQ_PARALLEL") and \
        keys is queries and k_mask is None

    if seq_parallel and not dropout_rate:
        ctx = layers.ring_attention(q, k, v, causal=causal, scale=scale)
    elif use_flash and not dropout_rate:
        ctx = layers.fused_attention(q, k, v, k_mask=k_mask, causal=causal,
                                     scale=scale)
    else:
        product = layers.matmul(q, k, transpose_y=True, alpha=scale)
        # fold the mask into the softmax op: under bf16 AMP the [B,H,S,S]
        # scores then stay bf16 in device memory (an f32 add would promote
        # them); the bias-softmax kernel adds the bias and computes in f32
        bias = None
        if k_mask is not None:
            bias = _shared_padding_bias(k_mask)
        if causal:
            cb = _shared_causal_bias(q.block, q.shape[2])
            bias = cb if bias is None else bias + cb
        weights = layers.softmax(product, bias=bias)
        if dropout_rate:
            weights = layers.dropout(weights, dropout_prob=dropout_rate)
        ctx = layers.matmul(weights, v)

    # [B, H, S, D] -> [B, S, H*D]
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    b, s = ctx.shape[0], ctx.shape[1]
    ctx = layers.reshape(ctx, shape=[b, s, n_head * d_value])
    return layers.fc(ctx, d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=pa("attnout"))


def positionwise_feed_forward(x, d_inner_hid, d_hid, prefix=None):
    def pa(role, suffix="w"):
        return ParamAttr(name=f"{prefix}_{role}.{suffix}") if prefix \
            else None
    hidden = layers.fc(x, d_inner_hid, num_flatten_dims=2, act="relu",
                       param_attr=pa("ffn1"),
                       bias_attr=pa("ffn1", "b"))
    return layers.fc(hidden, d_hid, num_flatten_dims=2,
                     param_attr=pa("ffn2"),
                     bias_attr=pa("ffn2", "b"))


def pre_post_process_layer(prev_out, out, process_cmd, dropout_rate=0.0):
    for cmd in process_cmd:
        if cmd == "a":
            out = out + prev_out if prev_out is not None else out
        elif cmd == "n":
            out = layers.layer_norm(
                out, begin_norm_axis=len(out.shape) - 1,
                param_attr=ParamAttr(initializer=None),
                bias_attr=ParamAttr(initializer=None))
        elif cmd == "d" and dropout_rate:
            out = layers.dropout(out, dropout_prob=dropout_rate)
    return out


def encoder_layer(enc_input, src_mask, hp: ModelHyperParams, idx=0):
    attn = multi_head_attention(enc_input, None, None,
                                hp.d_key, hp.d_value, hp.d_model,
                                hp.n_head, hp.attention_dropout,
                                k_mask=src_mask, use_flash=hp.use_flash,
                                prefix=f"enc{idx}_attn")
    attn = pre_post_process_layer(enc_input, attn, "dan", hp.dropout)
    ffd = positionwise_feed_forward(attn, hp.d_inner_hid, hp.d_model,
                                    prefix=f"enc{idx}")
    return pre_post_process_layer(attn, ffd, "dan", hp.dropout)


def decoder_layer(dec_input, enc_output, src_mask, hp: ModelHyperParams,
                  idx=0):
    self_attn = multi_head_attention(dec_input, None, None,
                                     hp.d_key, hp.d_value, hp.d_model,
                                     hp.n_head, hp.attention_dropout,
                                     causal=True, use_flash=hp.use_flash,
                                     prefix=f"dec{idx}_self")
    self_attn = pre_post_process_layer(dec_input, self_attn, "dan",
                                       hp.dropout)
    cross = multi_head_attention(self_attn, enc_output, enc_output,
                                 hp.d_key, hp.d_value, hp.d_model,
                                 hp.n_head, hp.attention_dropout,
                                 k_mask=src_mask, use_flash=hp.use_flash,
                                 prefix=f"dec{idx}_cross")
    cross = pre_post_process_layer(self_attn, cross, "dan", hp.dropout)
    ffd = positionwise_feed_forward(cross, hp.d_inner_hid, hp.d_model,
                                    prefix=f"dec{idx}")
    return pre_post_process_layer(cross, ffd, "dan", hp.dropout)


def prepare_embedding(ids, pos_ids, vocab_size, hp: ModelHyperParams,
                      name_prefix):
    word_emb = layers.embedding(
        ids, size=[vocab_size, hp.d_model],
        param_attr=ParamAttr(name=name_prefix + "_word_emb"))
    word_emb = layers.scale(word_emb, scale=float(hp.d_model) ** 0.5)
    pos_table = position_encoding_init(hp.max_length, hp.d_model)
    pos_emb = layers.embedding(
        pos_ids, size=[hp.max_length, hp.d_model],
        param_attr=ParamAttr(
            name=name_prefix + "_pos_emb", trainable=False,
            initializer=NumpyArrayInitializer(pos_table)))
    out = word_emb + pos_emb
    if hp.dropout:
        out = layers.dropout(out, dropout_prob=hp.dropout)
    return out


def encoder(src_ids, src_pos, src_mask, hp: ModelHyperParams):
    x = prepare_embedding(src_ids, src_pos, hp.src_vocab_size, hp, "src")
    for i in range(hp.n_layer):
        x = encoder_layer(x, src_mask, hp, idx=i)
    return x


def decoder(trg_ids, trg_pos, enc_output, src_mask, hp: ModelHyperParams):
    x = prepare_embedding(trg_ids, trg_pos, hp.trg_vocab_size, hp, "trg")
    for i in range(hp.n_layer):
        x = decoder_layer(x, enc_output, src_mask, hp, idx=i)
    return x


def build_inputs(batch_size, src_len, trg_len, hp: ModelHyperParams):
    """Declare the dense feed variables.

    Only ids and [B, S] masks are fed; position ids and the [B,1,S,S]
    additive attention biases are built IN-GRAPH as constants/cheap
    broadcasts (unlike the reference benchmark which feeds dense
    [B, n_head, S, S] bias tensors).
    """
    def data(name, shape, dtype):
        return layers.data(name=name, shape=shape, dtype=dtype,
                           append_batch_size=False)

    src_ids = data("src_word", [batch_size, src_len], "int32")
    trg_ids = data("trg_word", [batch_size, trg_len], "int32")
    src_mask = data("src_mask", [batch_size, src_len], "float32")
    labels = data("lbl_word", [batch_size, trg_len], "int32")
    weights = data("lbl_weight", [batch_size, trg_len], "float32")
    return src_ids, trg_ids, src_mask, labels, weights


def _position_ids(batch_size, seq_len):
    """Constant [B, S] int32 position-id tensor (in-graph)."""
    pos = np.tile(np.arange(seq_len, dtype="int32"), (batch_size, 1))
    return layers.assign(pos)


def transformer(batch_size, src_len, trg_len, hp: ModelHyperParams = None,
                input_vars=None):
    """Build the full training graph; returns (avg_cost, feed_vars).

    ``input_vars``: optional 5-tuple (src_ids, trg_ids, src_mask, labels,
    weights) of pre-built variables — e.g. ``layers.read_file`` outputs of
    a recordio reader pipeline — replacing the dense feed declarations.
    """
    hp = hp or ModelHyperParams()
    if input_vars is not None:
        src_ids, trg_ids, src_mask, labels, weights = input_vars
    else:
        src_ids, trg_ids, src_mask, labels, weights = build_inputs(
            batch_size, src_len, trg_len, hp)

    src_pos = _position_ids(batch_size, src_len)
    trg_pos = _position_ids(batch_size, trg_len)

    enc_out = encoder(src_ids, src_pos, src_mask, hp)
    dec_out = decoder(trg_ids, trg_pos, enc_out, src_mask, hp)

    logits = layers.fc(dec_out, hp.trg_vocab_size, num_flatten_dims=2,
                       bias_attr=False,
                       param_attr=ParamAttr(name="proj_logits.w"))
    logits2d = layers.reshape(
        logits, shape=[batch_size * trg_len, hp.trg_vocab_size])
    labels2d = layers.reshape(labels, shape=[batch_size * trg_len, 1])
    cost = layers.softmax_with_cross_entropy(logits2d, labels2d)
    weights2d = layers.reshape(weights, shape=[batch_size * trg_len, 1])
    weighted = cost * weights2d
    sum_cost = layers.reduce_sum(weighted)
    token_count = layers.reduce_sum(weights2d)
    avg_cost = sum_cost / token_count
    feeds = ["src_word", "trg_word", "src_mask", "lbl_word", "lbl_weight"]
    return avg_cost, feeds


def fake_batch(batch_size, src_len, trg_len, hp: ModelHyperParams = None,
               seed=0):
    """Synthetic dense batch for benchmarking/compile checks."""
    hp = hp or ModelHyperParams()
    rng = np.random.RandomState(seed)
    src_word = rng.randint(1, hp.src_vocab_size,
                           size=(batch_size, src_len)).astype("int32")
    trg_word = rng.randint(1, hp.trg_vocab_size,
                           size=(batch_size, trg_len)).astype("int32")
    src_mask = np.ones((batch_size, src_len), dtype="float32")
    lbl_word = rng.randint(1, hp.trg_vocab_size,
                           size=(batch_size, trg_len)).astype("int32")
    lbl_weight = np.ones((batch_size, trg_len), dtype="float32")
    return {
        "src_word": src_word, "trg_word": trg_word, "src_mask": src_mask,
        "lbl_word": lbl_word, "lbl_weight": lbl_weight,
    }


def param_count(hp: ModelHyperParams = None):
    """Approximate dense parameter count: the matmul params plus the
    embedding tables and the per-layer layernorm scale/bias terms
    (2 layernorms/encoder layer, 3/decoder layer, 2 params each of
    width d)."""
    hp = hp or ModelHyperParams()
    d = hp.d_model
    emb = (hp.src_vocab_size + hp.trg_vocab_size) * d
    layernorm = hp.n_layer * (4 * d + 6 * d)
    return matmul_param_count(hp) + emb + layernorm


def matmul_param_count(hp: ModelHyperParams = None):
    """Parameters that participate in matmuls — the honest basis for the
    6N-FLOPs/token MFU estimate.  Excludes the input embedding tables
    (their forward is a gather, not a matmul; their backward is a
    scatter-add) and the layernorm scale/bias terms (elementwise), but
    includes the output projection, which IS a matmul.
    """
    hp = hp or ModelHyperParams()
    d, dff = hp.d_model, hp.d_inner_hid
    per_enc = 4 * d * d + 2 * d * dff
    per_dec = 8 * d * d + 2 * d * dff
    proj = d * hp.trg_vocab_size
    return hp.n_layer * (per_enc + per_dec) + proj


def train_flops_per_token(hp: ModelHyperParams = None, seq=None):
    """Analytical training FLOPs per (target) token — the 6N-matmul +
    attention accounting ``bench.py`` derives MFU from:

    * ``6 * matmul_param_count`` — fwd (2N) + bwd (4N) per matmul
      parameter; input embeddings excluded (gather, not matmul), the
      output projection included.
    * attention: 3 modules/layer (enc-self, dec-self, cross), each
      QK^T + AV = ``4*S*d`` FLOPs/token fwd, bwd 2x => ``12*S*d``.
"""
    hp = hp or ModelHyperParams()
    seq = seq if seq is not None else hp.max_length
    attn_flops = 12 * seq * hp.d_model * (3 * hp.n_layer)
    return 6 * matmul_param_count(hp) + attn_flops


def tp_shardings():
    """Megatron-style tensor-parallel partition-spec rules for the
    model's parameters (and, by substring match, their Adam moments) over
    a mesh with a ``model`` axis: the JAX package's seven rules.  Pass to
    ``ParallelExecutor(param_shardings=...)``; DTensor's sharding
    propagation makes the collectives."""
    from paddle_tpu_torch.parallel.mesh import P
    return [
        (r"_(q|k|v)\.w", P(None, "model")),         # column parallel
        (r"_attnout\.w", P("model", None)),         # row parallel
        (r"_ffn1\.w", P(None, "model")),
        (r"_ffn1\.b", P("model")),                  # bias [FF]
        (r"_ffn2\.w", P("model", None)),
        (r"(src|trg)_word_emb", P(None, "model")),  # shard d_model
        (r"proj_logits\.w", P(None, "model")),      # shard vocab
    ]
