"""Composite networks (the port of ``paddle_tpu.nets``; reference
``python/paddle/fluid/nets.py``: ``simple_img_conv_pool``,
``img_conv_group``, ``sequence_conv_pool``, ``glu``,
``scaled_dot_product_attention``).  All five build the JAX package's IR
and run."""

from __future__ import annotations

from paddle_tpu_torch import layers

__all__ = ["simple_img_conv_pool", "sequence_conv_pool", "glu",
           "scaled_dot_product_attention", "img_conv_group"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max", use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   use_mkldnn=False):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def __extend_list__(obj):
        if not hasattr(obj, "__len__"):
            return [obj] * len(conv_num_filter)
        return obj

    conv_padding = __extend_list__(conv_padding)
    conv_filter_size = __extend_list__(conv_filter_size)
    param_attr = __extend_list__(param_attr)
    conv_with_batchnorm = __extend_list__(conv_with_batchnorm)
    conv_batchnorm_drop_rate = __extend_list__(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i],
                            act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split in half along dim, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    act_b = layers.sigmoid(x=b)
    return layers.elementwise_mul(x=a, y=act_b)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over dense [B, T, D] tensors
    (reference ``nets.py`` scaled_dot_product_attention): composed from
    ``matmul`` and a plain ``softmax``; the fused attention op of the
    Transformer model is ``layers.fused_attention``."""
    if not (len(queries.shape) == len(keys.shape) == len(values.shape) == 3):
        raise ValueError("inputs must be 3-D: [batch, time, dim]")
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if keys.shape[-2] != values.shape[-2]:
        raise ValueError("keys and values must have the same length")
    if queries.shape[-1] % num_heads != 0:
        raise ValueError("hidden size must be divisible by num_heads")

    def __split_heads(x, num_heads):
        if num_heads == 1:
            return x
        hidden_size = x.shape[-1]
        reshaped = layers.reshape(
            x, shape=[x.shape[0] if x.shape[0] > 0 else -1, x.shape[1],
                      num_heads, hidden_size // num_heads])
        return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])

    def __combine_heads(x):
        if len(x.shape) == 3:
            return x
        trans_x = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            trans_x, shape=[trans_x.shape[0] if trans_x.shape[0] > 0 else -1,
                            trans_x.shape[1],
                            trans_x.shape[2] * trans_x.shape[3]])

    q = __split_heads(queries, num_heads)
    k = __split_heads(keys, num_heads)
    v = __split_heads(values, num_heads)

    key_dim_per_head = keys.shape[-1] // num_heads
    scaled_q = layers.scale(x=q, scale=key_dim_per_head ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)

    weights = layers.reshape(
        x=layers.reshape(product, shape=[-1, product.shape[-1]],
                         act="softmax"),
        shape=product.shape)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return __combine_heads(ctx_multiheads)
