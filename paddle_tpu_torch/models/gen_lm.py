"""Generative causal LM with a prefill/decode phase split (the port of
``paddle_tpu.models.gen_lm``): the model side of the continuous-batching
runtime in :mod:`paddle_tpu_torch.gen`.

One set of parameters (shared names) is exported as TWO inference
programs:

* **prefill**: one prompt padded to a length bucket; the full causal
  forward gives the next-token logits at the last real position plus the
  per-layer K/V rows (zero on pad rows) that seed the request's cache.
* **decode**: one token for every slot of a fixed cache pool.  The
  default export is PAGED (:func:`build_paged_decode_program`): the pool
  is ``[num_pages, page_len, H*D]`` pages plus a per-slot page table,
  and each step attends only the pages covering ``[0, len)`` of a slot.
  ``paged=False`` exports the dense ``[num_slots, max_len]`` layout.

The program-building functions are the JAX package's, op for op, so the
two packages build the same IR dict and exchange bundles.
"""

from __future__ import annotations

import json
import os

import numpy as np

import paddle_tpu_torch.layers as layers
from paddle_tpu_torch import framework
from paddle_tpu_torch.initializer import NumpyArrayInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["GenConfig", "build_prefill_program", "build_decode_program",
           "build_paged_decode_program", "gen_lm_train_program",
           "export_gen_model",
           "META_FILENAME", "PAGE_LEN_DEFAULT", "cache_var_names",
           "paged_cache_var_names", "default_page_buckets"]

META_FILENAME = "gen_meta.json"

#: default KV page length (rows per page) for paged exports
PAGE_LEN_DEFAULT = 16


class GenConfig:
    """Toy-scale causal LM hyperparameters."""
    vocab_size = 64
    d_model = 32
    n_head = 2
    d_head = 16          # n_head * d_head == d_model
    n_layer = 2
    d_ffn = 64
    max_len = 64         # cache length L (bucketed max sequence length)
    eos_id = -1          # <0: no EOS in the base model (requests may
                         # override per call)


def _pa(name, **kw):
    return ParamAttr(name=name, **kw)


def _pos_table(hp):
    from paddle_tpu_torch.models.transformer import position_encoding_init
    return position_encoding_init(hp.max_len, hp.d_model)


def _embed(ids, pos_ids, hp):
    """Shared token + position embedding (works for [B, T] prefill ids
    and [S, 1] decode ids — lookup_table squeezes a trailing 1)."""
    word = layers.embedding(ids, size=[hp.vocab_size, hp.d_model],
                            param_attr=_pa("genlm_word_emb"))
    word = layers.scale(word, scale=float(hp.d_model) ** 0.5)
    pos = layers.embedding(
        pos_ids, size=[hp.max_len, hp.d_model],
        param_attr=_pa("genlm_pos_emb", trainable=False,
                       initializer=NumpyArrayInitializer(_pos_table(hp))))
    return word + pos


def _ln(x, idx, tag):
    return layers.layer_norm(
        x, begin_norm_axis=len(x.shape) - 1,
        param_attr=_pa(f"genlm{idx}_{tag}.scale"),
        bias_attr=_pa(f"genlm{idx}_{tag}.bias"))


def _ffn(x, hp, idx):
    h = layers.fc(x, hp.d_ffn, num_flatten_dims=2, act="relu",
                  param_attr=_pa(f"genlm{idx}_ffn1.w"),
                  bias_attr=_pa(f"genlm{idx}_ffn1.b"))
    return layers.fc(h, hp.d_model, num_flatten_dims=2,
                     param_attr=_pa(f"genlm{idx}_ffn2.w"),
                     bias_attr=_pa(f"genlm{idx}_ffn2.b"))


def _qkv(x, hp, idx):
    """Q/K/V projections over [B, T, d] (or [S, 1, d])."""
    def proj(role):
        return layers.fc(x, hp.n_head * hp.d_head, num_flatten_dims=2,
                         bias_attr=False,
                         param_attr=_pa(f"genlm{idx}_{role}.w"))
    return proj("q"), proj("k"), proj("v")


def _heads(x, hp, length):
    """[B, T, H*D] -> [B, H, T, D]; ``length`` may be -1 (dynamic)."""
    x = layers.reshape(x, shape=[x.shape[0], length, hp.n_head, hp.d_head])
    return layers.transpose(x, perm=[0, 2, 1, 3])


def _merge_heads(ctx, hp, length):
    """[B, H, T, D] -> [B, T, H*D]."""
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    return layers.reshape(
        ctx, shape=[ctx.shape[0], length, hp.n_head * hp.d_head])


def _attend(q, k, v, bias, hp, idx, q_len, k_len):
    """Scaled-dot-product attention with an additive ``bias`` mask
    (broadcastable against [B, H, Sq, Sk] scores)."""
    scale = float(hp.d_head) ** -0.5
    qh = _heads(q, hp, q_len)
    kh = _heads(k, hp, k_len)
    vh = _heads(v, hp, k_len)
    scores = layers.matmul(qh, kh, transpose_y=True, alpha=scale)
    weights = layers.softmax(scores, bias=bias)
    ctx = layers.matmul(weights, vh)
    ctx = _merge_heads(ctx, hp, q_len)
    return layers.fc(ctx, hp.d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=_pa(f"genlm{idx}_attnout.w"))


def _block_tail(x, attn, hp, idx):
    x = _ln(x + attn, idx, "ln1")
    return _ln(x + _ffn(x, hp, idx), idx, "ln2")


def cache_var_names(hp):
    """The dense decode program's persistable KV-cache tensor names, in
    the (k, v) per-layer order the prefill fetch list follows."""
    names = []
    for i in range(hp.n_layer):
        names.append(f"genlm_cache_k_{i}")
        names.append(f"genlm_cache_v_{i}")
    return names


def paged_cache_var_names(hp):
    """The PAGED decode program's persistable page-pool tensor names, in
    the same (k, v) per-layer order as :func:`cache_var_names`."""
    names = []
    for i in range(hp.n_layer):
        names.append(f"genlm_paged_k_{i}")
        names.append(f"genlm_paged_v_{i}")
    return names


def default_page_buckets(pages_per_slot):
    """Power-of-two page-count bucket ladder capped at
    ``pages_per_slot``."""
    edges, b = [], 1
    while b < int(pages_per_slot):
        edges.append(b)
        b *= 2
    edges.append(int(pages_per_slot))
    return sorted(set(edges))


def _data(name, shape, dtype="float32"):
    return layers.data(name=name, shape=shape, dtype=dtype,
                       append_batch_size=False)


# ---------------------------------------------------------------------------
# prefill: one prompt, dynamic (bucketed) length
# ---------------------------------------------------------------------------

def build_prefill_program(hp):
    """Build the prefill forward in the CURRENT program guard.

    Feeds (length-dynamic; callers pad to a bucket): ``gen_ids`` [1, T]
    int32, ``gen_pos`` [1, T] int32, ``gen_mask`` [1, T] f32 (1 = real
    token), ``gen_attn_bias`` [1, 1, T, T] f32 (combined causal+padding
    additive bias), ``gen_last`` [1, T] f32 (one-hot of the last real
    position).  Fetches: ``[logits [1, V], k_0, v_0, k_1, v_1, ...]``
    with each K/V [1, T, H*D] zeroed on pad rows.
    """
    ids = _data("gen_ids", [1, -1], "int32")
    pos = _data("gen_pos", [1, -1], "int32")
    mask = _data("gen_mask", [1, -1])
    bias = _data("gen_attn_bias", [1, 1, -1, -1])
    last = _data("gen_last", [1, -1])

    x = _embed(ids, pos, hp)
    kv = []
    for i in range(hp.n_layer):
        q, k, v = _qkv(x, hp, i)
        k_m = layers.elementwise_mul(k, mask, axis=0)
        v_m = layers.elementwise_mul(v, mask, axis=0)
        kv += [k_m, v_m]
        attn = _attend(q, k_m, v_m, bias, hp, i, q_len=-1, k_len=-1)
        x = _block_tail(x, attn, hp, i)
    last3 = layers.reshape(last, shape=[1, 1, -1])
    lasth = layers.matmul(last3, x)                    # [1, 1, d]
    lasth = layers.reshape(lasth, shape=[-1, hp.d_model])
    logits = layers.fc(lasth, hp.vocab_size, bias_attr=False,
                       param_attr=_pa("genlm_logits.w"))
    feeds = ["gen_ids", "gen_pos", "gen_mask", "gen_attn_bias", "gen_last"]
    return feeds, [logits] + kv


# ---------------------------------------------------------------------------
# dense decode: one token for every cache slot, constant signature
# ---------------------------------------------------------------------------

def build_decode_program(hp, num_slots):
    """Build the dense single-token decode step in the CURRENT program
    guard.

    Feeds: ``gen_token`` [S, 1] int32, ``gen_pos`` [S, 1] int32,
    ``gen_pos_onehot`` [S, L] f32 (1 at the write position for live
    slots, all-zero rows for free slots), ``gen_attn_mask`` [S, L] f32
    (1 = attendable cache position, including the current token's own).
    Persistable state: per-layer ``genlm_cache_k_i`` / ``genlm_cache_v_i``
    [S, L, H*D], updated in place.  Fetches: ``logits`` [S, V].
    """
    S, L = int(num_slots), int(hp.max_len)
    hd = hp.n_head * hp.d_head

    token = _data("gen_token", [S, 1], "int32")
    pos = _data("gen_pos", [S, 1], "int32")
    pos_onehot = _data("gen_pos_onehot", [S, L])
    attn_mask = _data("gen_attn_mask", [S, L])

    block = framework.default_main_program().global_block()
    caches = {}
    for name in cache_var_names(hp):
        c = block.create_var(name=name, shape=[S, L, hd], dtype="float32")
        c.persistable = True
        c.stop_gradient = True
        caches[name] = c

    x = _embed(token, pos, hp)                         # [S, d]
    x = layers.reshape(x, shape=[S, 1, hp.d_model])
    po3 = layers.reshape(pos_onehot, shape=[S, L, 1])
    bias = layers.reshape(layers.scale(attn_mask, scale=1e9, bias=-1e9),
                          shape=[S, 1, 1, L])
    for i in range(hp.n_layer):
        q, k, v = _qkv(x, hp, i)                       # [S, 1, H*D]
        ck, cv = caches[f"genlm_cache_k_{i}"], caches[f"genlm_cache_v_{i}"]
        # scatter the new token's K/V into its cache position: an outer
        # product against the position one-hot, added into the cache
        # (free slots feed an all-zero one-hot row, so nothing is written)
        for cache, new in ((ck, k), (cv, v)):
            delta = layers.matmul(po3, new)            # [S, L, H*D]
            block.append_op(type="elementwise_add",
                            inputs={"X": [cache.name], "Y": [delta.name]},
                            outputs={"Out": [cache.name]},
                            attrs={"axis": -1})
        # attention over the UPDATED cache
        attn = _attend(q, ck, cv, bias, hp, i, q_len=1, k_len=L)
        x = _block_tail(x, attn, hp, i)
    x2 = layers.reshape(x, shape=[S, hp.d_model])
    logits = layers.fc(x2, hp.vocab_size, bias_attr=False,
                       param_attr=_pa("genlm_logits.w"))
    feeds = ["gen_token", "gen_pos", "gen_pos_onehot", "gen_attn_mask"]
    return feeds, [logits]


# ---------------------------------------------------------------------------
# paged decode: page-pool cache, page-table feed bucketed by page count
# ---------------------------------------------------------------------------

def build_paged_decode_program(hp, num_slots, page_len, num_pages):
    """Build the PAGED single-token decode step in the CURRENT program
    guard.

    Feeds: ``gen_token`` [S, 1] int32, ``gen_pos`` [S, 1] int32,
    ``gen_page_table`` [S, P] int32 (per-slot page ids in prefix order;
    ``P`` is dynamic, padded by the predictor to a ``page_buckets``
    edge), ``gen_lens`` [S, 1] int32 (rows INCLUDING the current token;
    0 = free slot).  Persistable state: per-layer ``genlm_paged_k_i`` /
    ``genlm_paged_v_i`` [num_pages, page_len, H*D], updated in place by
    the ``paged_attention`` op.  Fetches: ``logits`` [S, V].
    """
    S, PL, NP = int(num_slots), int(page_len), int(num_pages)
    hd = hp.n_head * hp.d_head

    token = _data("gen_token", [S, 1], "int32")
    pos = _data("gen_pos", [S, 1], "int32")
    page_table = _data("gen_page_table", [S, -1], "int32")
    lens = _data("gen_lens", [S, 1], "int32")

    block = framework.default_main_program().global_block()
    caches = {}
    for name in paged_cache_var_names(hp):
        c = block.create_var(name=name, shape=[NP, PL, hd],
                             dtype="float32")
        c.persistable = True
        c.stop_gradient = True
        caches[name] = c

    x = _embed(token, pos, hp)                         # [S, d]
    x = layers.reshape(x, shape=[S, 1, hp.d_model])
    for i in range(hp.n_layer):
        q, k, v = _qkv(x, hp, i)                       # [S, 1, H*D]
        pk = caches[f"genlm_paged_k_{i}"]
        pv = caches[f"genlm_paged_v_{i}"]
        helper = LayerHelper("paged_attention")
        ctxv = helper.create_tmp_variable("float32")
        helper.append_op(
            type="paged_attention",
            inputs={"Q": [q], "K": [k], "V": [v],
                    "KCache": [pk], "VCache": [pv],
                    "PageTable": [page_table], "Lens": [lens]},
            outputs={"Out": [ctxv], "KCacheOut": [pk], "VCacheOut": [pv]},
            attrs={"n_head": int(hp.n_head),
                   "scale": float(hp.d_head) ** -0.5})
        attn = layers.fc(ctxv, hp.d_model, num_flatten_dims=2,
                         bias_attr=False,
                         param_attr=_pa(f"genlm{i}_attnout.w"))
        x = _block_tail(x, attn, hp, i)
    x2 = layers.reshape(x, shape=[S, hp.d_model])
    logits = layers.fc(x2, hp.vocab_size, bias_attr=False,
                       param_attr=_pa("genlm_logits.w"))
    feeds = ["gen_token", "gen_pos", "gen_page_table", "gen_lens"]
    return feeds, [logits]


# ---------------------------------------------------------------------------
# training graph (teacher-forced)
# ---------------------------------------------------------------------------

def gen_lm_train_program(batch_size, seq_len, hp: GenConfig = None):
    """Causal-LM training forward in the current program guard; returns
    ``(avg_cost, feed_names)``.  Feeds: ``gen_ids`` / ``gen_labels``
    [B, T] int32."""
    hp = hp or GenConfig()
    B, T = int(batch_size), int(seq_len)

    ids = layers.data(name="gen_ids", shape=[B, T], dtype="int32",
                      append_batch_size=False)
    labels = layers.data(name="gen_labels", shape=[B, T], dtype="int32",
                         append_batch_size=False)
    pos_np = np.tile(np.arange(T, dtype="int32"), (B, 1))
    pos = layers.assign(pos_np)
    tri = np.triu(np.full((T, T), -1e9, dtype="float32"), 1)
    bias = layers.assign(tri.reshape(1, 1, T, T))

    x = _embed(ids, pos, hp)
    for i in range(hp.n_layer):
        q, k, v = _qkv(x, hp, i)
        attn = _attend(q, k, v, bias, hp, i, q_len=T, k_len=T)
        x = _block_tail(x, attn, hp, i)
    logits = layers.fc(x, hp.vocab_size, num_flatten_dims=2,
                       bias_attr=False, param_attr=_pa("genlm_logits.w"))
    logits2d = layers.reshape(logits, shape=[B * T, hp.vocab_size])
    labels2d = layers.reshape(labels, shape=[B * T, 1])
    cost = layers.softmax_with_cross_entropy(logits2d, labels2d)
    avg_cost = layers.mean(x=cost)
    return avg_cost, ["gen_ids", "gen_labels"]


# ---------------------------------------------------------------------------
# export: one parameter set -> prefill/ + decode/ + gen_meta.json
# ---------------------------------------------------------------------------

def _write_model(dirname, program, feed_names, fetch_vars, executor):
    """The ``__model__`` + ``__params__`` pair ``io.load_inference_model``
    reads, written WITHOUT pruning (the decode program's in-place cache
    writes are side effects a fetch-target prune would drop)."""
    from paddle_tpu_torch import io as _io
    os.makedirs(dirname, exist_ok=True)
    model = {
        "program": program.to_dict(),
        "feed_var_names": list(feed_names),
        "fetch_var_names": [v.name for v in fetch_vars],
    }
    with open(os.path.join(dirname, "__model__"), "w") as f:
        json.dump(model, f)
    _io.save_persistables(executor, dirname, program, "__params__")


def export_gen_model(dirname, hp: GenConfig = None, num_slots=8,
                     prompt_buckets=None, paged=True,
                     page_len=PAGE_LEN_DEFAULT, num_pages=None,
                     page_buckets=None, place=None, seed=0):
    """Export a generation bundle: ``<dirname>/prefill/``,
    ``<dirname>/decode/`` (each a loadable inference model over ONE
    shared parameter set) and ``<dirname>/gen_meta.json`` describing the
    cache pool geometry.  Returns ``dirname``.

    ``paged=True`` (the default) exports the page-pool decode variant:
    ``page_len`` rows per page (clamped to ``max_len``), ``num_pages``
    pool pages (default ``num_slots * ceil(max_len / page_len)``),
    ``page_buckets`` the declared page-count ladder.  ``paged=False``
    keeps the dense ``[num_slots, max_len]`` layout.  The weights are
    drawn on ``place`` (default ``cuda:0``) by the startup program,
    seeded with ``seed``."""
    from paddle_tpu_torch.executor import Executor
    from paddle_tpu_torch.lod import bucket_edges
    from paddle_tpu_torch.scope import Scope, scope_guard

    hp = hp or GenConfig()
    num_slots = int(num_slots)
    if prompt_buckets is None:
        prompt_buckets = bucket_edges(1, hp.max_len)
    if paged:
        page_len = max(1, min(int(page_len), int(hp.max_len)))
        pps = -(-int(hp.max_len) // page_len)
        num_pages = num_slots * pps if num_pages is None else int(num_pages)
        if page_buckets is None:
            page_buckets = default_page_buckets(pps)
    scope = Scope()
    with scope_guard(scope):
        exe = Executor(place)
        pre_main, pre_startup = framework.Program(), framework.Program()
        pre_startup.random_seed = int(seed)
        with framework.program_guard(pre_main, pre_startup):
            pre_feeds, pre_fetches = build_prefill_program(hp)
        exe.run(pre_startup)
        _write_model(os.path.join(dirname, "prefill"), pre_main,
                     pre_feeds, pre_fetches, exe)

        dec_main, dec_startup = framework.Program(), framework.Program()
        with framework.program_guard(dec_main, dec_startup):
            if paged:
                dec_feeds, dec_fetches = build_paged_decode_program(
                    hp, num_slots, page_len, num_pages)
            else:
                dec_feeds, dec_fetches = build_decode_program(hp,
                                                              num_slots)
        # decode shares the ALREADY-initialized parameters (its startup
        # is never run); the cache pool starts as zeros
        hd = hp.n_head * hp.d_head
        if paged:
            for name in paged_cache_var_names(hp):
                scope.set_var(name, np.zeros((num_pages, page_len, hd),
                                             dtype="float32"))
        else:
            for name in cache_var_names(hp):
                scope.set_var(name, np.zeros((num_slots, hp.max_len, hd),
                                             dtype="float32"))
        _write_model(os.path.join(dirname, "decode"), dec_main,
                     dec_feeds, dec_fetches, exe)

    meta = {
        "format": "paddle_tpu.gen/1",
        "num_slots": num_slots,
        "max_len": int(hp.max_len),
        "vocab_size": int(hp.vocab_size),
        "n_layer": int(hp.n_layer),
        "eos_id": int(hp.eos_id),
        "cache_vars": (paged_cache_var_names(hp) if paged
                       else cache_var_names(hp)),
        "prompt_buckets": [int(b) for b in prompt_buckets],
    }
    if paged:
        meta.update({
            "page_len": int(page_len),
            "num_pages": int(num_pages),
            "page_buckets": [int(b) for b in page_buckets],
            "page_table_feed": "gen_page_table",
        })
    with open(os.path.join(dirname, META_FILENAME), "w") as f:
        json.dump(meta, f, indent=2)
    # post-export contract: the prefill/decode pair must satisfy the
    # constant-signature contract against the meta (a drifted bundle
    # fails here, not at the first /generate); PTA018 hazards are logged
    from paddle_tpu_torch.analysis import verify_gen_bundle
    verify_gen_bundle(dirname, where="gen_lm.export_gen_model")
    return dirname
