"""User-facing NN layers (reference ``python/paddle/fluid/layers/nn.py``,
3,680 LoC; the `fc:83` pattern: create params via LayerHelper, append op(s),
return the output Variable).
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.embedding import register_table
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "conv2d", "conv2d_transpose", "pool2d", "batch_norm",
    "layer_norm", "dropout", "softmax", "cross_entropy",
    "softmax_with_cross_entropy", "accuracy", "auc", "square_error_cost",
    "chunk_eval", "linear_chain_crf", "crf_decoding",
    "rank_loss", "huber_loss",
    "lrn", "l2_normalize", "matmul", "topk", "relu", "one_hot",
    "sigmoid_cross_entropy_with_logits", "smooth_l1", "label_smooth",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "clip", "clip_by_norm", "mean", "mul", "scale",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "concat", "cast", "split", "reshape", "transpose", "expand", "pad",
    "squeeze", "unsqueeze", "gather", "scatter", "slice", "shape",
    "prelu", "maxout", "nce", "im2sequence", "multiplex", "row_conv",
    "conv_shift", "pool3d", "unpool", "spp", "pool2d_with_index",
    "fused_attention",
    "autoincreased_step_counter", "cos_sim", "dot_product_attention",
    "beam_search", "beam_search_decode", "ring_attention",
    "conv3d", "conv3d_transpose", "warpctc", "ctc_greedy_decoder",
    "image_resize",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       use_mkldnn=False, act=None, is_test=False, name=None):
    """Fully-connected layer (reference ``nn.py:83``)."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        param_shape = [
            int(np.prod(input_shape[num_flatten_dims:]))
        ] + [size]
        w = helper.create_parameter(p_attr, shape=param_shape, dtype=dtype)
        tmp = helper.create_tmp_variable(dtype)
        helper.append_op(
            type="mul", inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (reference ``nn.py`` embedding); the table is
    registered with ``embedding.register_table``.  ``is_sparse`` makes
    its grad a SelectedRows of the looked-up rows."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype, is_bias=False)
    register_table(w.name, vocab=size[0], dim=size[1])
    tmp = helper.create_tmp_variable(dtype)
    padding_idx = -1 if padding_idx is None else \
        (padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx})
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    """2-D convolution, NCHW (reference ``nn.py`` conv2d)."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")

    def _pair(x):
        return [x, x] if isinstance(x, int) else list(x)

    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=init_mod.Normal(0.0, std))
    pre_bias = helper.create_tmp_variable(dtype)
    op_type = "depthwise_conv2d" if (groups == num_channels and
                                     num_filters == num_channels and
                                     groups > 1) else "conv2d"
    helper.append_op(
        type=op_type, inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
    pre_act = _append_channel_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def _append_channel_bias(helper, pre_bias):
    bias_attr = helper.kwargs.get("bias_attr")
    if bias_attr is False:
        return pre_bias
    attr = helper.bias_attr
    num_out = pre_bias.shape[1]
    b = helper.create_parameter(attr, shape=[num_out],
                                dtype=pre_bias.dtype, is_bias=True)
    tmp = helper.create_tmp_variable(pre_bias.dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": [pre_bias], "Y": [b]},
                     outputs={"Out": [tmp]}, attrs={"axis": 1})
    return tmp


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1

    def _pair(x):
        return [x, x] if isinstance(x, int) else list(x)

    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = _pair(output_size)
        h, w = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1]
    else:
        filter_size = _pair(filter_size)
    filter_shape = [num_channels, num_filters // groups] + filter_size
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
    pre_act = _append_channel_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None):
    if pool_type not in ("max", "avg"):
        raise ValueError("pool_type must be 'max' or 'avg'")
    helper = LayerHelper("pool2d", input=input, name=name)

    def _pair(x):
        return [x, x] if isinstance(x, int) else list(x)

    pool_size = _pair(pool_size)
    pool_stride = _pair(pool_stride)
    pool_padding = _pair(pool_padding)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "ceil_mode": ceil_mode})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False):
    """Batch normalization (reference ``nn.py`` batch_norm)."""
    helper = LayerHelper("batch_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    input_shape = input.shape
    if data_layout == "NCHW":
        channel_num = input_shape[1] if len(input_shape) > 1 else \
            input_shape[0]
    else:
        channel_num = input_shape[-1]
    param_shape = [channel_num]

    scale = helper.create_parameter(
        helper.param_attr, shape=param_shape, dtype=dtype,
        default_initializer=init_mod.Constant(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=param_shape,
                                   dtype=dtype, is_bias=True)

    mean = helper.create_global_variable(
        name=moving_mean_name or framework.unique_name(
            ".".join([helper.name, "mean"])),
        dtype=dtype, shape=param_shape, persistable=True)
    mean.stop_gradient = True
    helper.set_variable_initializer(mean, init_mod.Constant(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name or framework.unique_name(
            ".".join([helper.name, "variance"])),
        dtype=dtype, shape=param_shape, persistable=True)
    variance.stop_gradient = True
    helper.set_variable_initializer(variance, init_mod.Constant(1.0))

    saved_mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    saved_variance = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)

    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    input_shape = input.shape
    param_shape = [int(np.prod(input_shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=init_mod.Constant(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(helper.bias_attr, shape=param_shape,
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    variance_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [variance_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "fix_seed": seed is not None, "seed": seed or 0})
    return out


def softmax(input, use_cudnn=True, name=None, bias=None):
    """Last-axis softmax; ``bias`` optionally fuses an additive mask
    (broadcastable, e.g. [B,1,1,S] padding / [1,1,S,S] causal) into the
    op so attention scores need not materialize in f32 (see
    ops/nn_ops.py softmax_lower)."""
    helper = LayerHelper("softmax", name=name)
    out = helper.create_tmp_variable(input.dtype)
    inputs = {"X": [input]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op(type="softmax", inputs=inputs,
                     outputs={"Out": [out]})
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False):
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out], "Out": [out]},
                     attrs={"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def square_error_cost(input, label):
    """(input - label)^2 elementwise (reference layers)."""
    helper = LayerHelper("square_error_cost")
    minus_out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]})
    square_out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [square_out]})
    return square_out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_tmp_variable(x.dtype)
    loss = helper.create_tmp_variable(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma or 1.0})
    return loss


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (reference ``layers/metric.py`` accuracy)."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_tmp_variable(dtype=input.dtype)
    topk_indices = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_tmp_variable(dtype="float32")
    correct = correct or helper.create_tmp_variable(dtype="int64")
    total = total or helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=200):
    helper = LayerHelper("auc")
    auc_out = helper.create_tmp_variable(dtype="float32")
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1])
    helper.set_variable_initializer(stat_pos, init_mod.Constant(0.0))
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1])
    helper.set_variable_initializer(stat_neg, init_mod.Constant(0.0))
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(input.dtype)
    mid = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_tmp_variable(x.dtype)
    norm = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_tmp_variable(input.dtype)
    indices = helper.create_tmp_variable("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_tmp_variable("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"epsilon": epsilon})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=init_mod.Constant(0.25))
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(X.dtype)
    xnorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    ynorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None):
    """Noise-contrastive estimation loss (reference ``nn.py`` nce over
    ``operators/nce_op.h``); returns per-example cost / (num_neg + 1)."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr)
    dim = input.shape[1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                is_bias=False, dtype=input.dtype)
    bias_attr_ = helper.bias_attr
    b = None if bias_attr_ is None else helper.create_parameter(
        attr=bias_attr_, shape=[num_total_classes, 1], is_bias=True,
        dtype=input.dtype)
    cost = helper.create_tmp_variable(dtype=input.dtype)
    sample_logits = helper.create_tmp_variable(dtype=input.dtype,
                                               stop_gradient=True)
    sample_labels = helper.create_tmp_variable(dtype="int64",
                                               stop_gradient=True)
    num_neg_samples = 10 if num_neg_samples is None else int(num_neg_samples)
    inputs = {"Input": input, "Label": label, "Weight": w}
    if b is not None:
        inputs["Bias"] = b
    if sample_weight is not None:
        inputs["SampleWeight"] = sample_weight
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": cost, "SampleLogits": sample_logits,
                 "SampleLabels": sample_labels},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": num_neg_samples})
    return cost / (num_neg_samples + 1)


def rank_loss(left, right, label, name=None):
    """Pairwise rank loss (reference ``rank_loss_op.cc``)."""
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_tmp_variable(left.dtype)
    helper.append_op(type="rank_loss",
                     inputs={"Left": [left], "Right": [right],
                             "Label": [label]},
                     outputs={"Out": [out]})
    return out


def huber_loss(input, label, delta=1.0, name=None):
    """Huber regression loss (reference ``huber_loss_op.cc``)."""
    helper = LayerHelper("huber_loss", name=name)
    out = helper.create_tmp_variable(input.dtype)
    residual = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="huber_loss",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": delta})
    return out


def linear_chain_crf(input, label, param_attr=None):
    """Linear-chain CRF negative log-likelihood (reference ``nn.py``
    linear_chain_crf over ``linear_chain_crf_op.cc``); creates the
    [K+2, K] transition parameter (rows 0/1 = start/stop)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    log_likelihood = helper.create_tmp_variable(dtype=input.dtype)
    alpha = helper.create_tmp_variable(dtype=input.dtype,
                                       stop_gradient=True)
    emission_exps = helper.create_tmp_variable(dtype=input.dtype,
                                               stop_gradient=True)
    transition_exps = helper.create_tmp_variable(dtype=input.dtype,
                                                 stop_gradient=True)
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [transition],
                "Label": [label]},
        outputs={"LogLikelihood": [log_likelihood], "Alpha": [alpha],
                 "EmissionExps": [emission_exps],
                 "TransitionExps": [transition_exps]})
    return log_likelihood


def crf_decoding(input, param_attr=None, label=None):
    """Viterbi decode with the CRF transition parameter (reference
    ``nn.py`` crf_decoding over ``crf_decoding_op.cc``)."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    transition = helper.param_attr
    # reuse the trained transition parameter by name
    from paddle_tpu_torch.framework import default_main_program
    block = default_main_program().global_block()
    trans_var = block.var(transition.name) if transition and \
        transition.name and block.has_var(transition.name) else None
    if trans_var is None:
        size = input.shape[-1]
        trans_var = helper.create_parameter(
            attr=helper.param_attr, shape=[size + 2, size],
            dtype=input.dtype)
    viterbi_path = helper.create_tmp_variable(dtype="int32",
                                              stop_gradient=True)
    inputs = {"Emission": [input], "Transition": [trans_var]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [viterbi_path]})
    return viterbi_path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """NER chunk precision/recall/F1 (reference ``nn.py:1049`` over
    ``chunk_eval_op.h``); returns (precision, recall, f1, #infer, #label,
    #correct)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_tmp_variable(dtype="float32")
    recall = helper.create_tmp_variable(dtype="float32")
    f1_score = helper.create_tmp_variable(dtype="float32")
    num_infer_chunks = helper.create_tmp_variable(dtype="int64")
    num_label_chunks = helper.create_tmp_variable(dtype="int64")
    num_correct_chunks = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1_score],
                 "NumInferChunks": [num_infer_chunks],
                 "NumLabelChunks": [num_label_chunks],
                 "NumCorrectChunks": [num_correct_chunks]},
        attrs={"num_chunk_types": num_chunk_types,
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": excluded_chunk_types or []})
    return (precision, recall, f1_score, num_infer_chunks, num_label_chunks,
            num_correct_chunks)


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """Extract image patches as a LoD sequence (reference ``nn.py``
    im2sequence over ``im2sequence_op.h``)."""
    def _quad(v):
        if isinstance(v, int):
            return [v, v, v, v]
        if len(v) == 2:
            return [v[0], v[1], v[0], v[1]]
        return list(v)

    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)

    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": _pair(filter_size),
                            "strides": _pair(stride),
                            "paddings": _quad(padding)})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (reference ``nn.py`` row_conv over
    ``row_conv_op.cc``; DeepSpeech2-style streaming context)."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    dtype = input.dtype
    filter_shape = [future_context_size + 1, input.shape[1]]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def pool2d_with_index(input, pool_size, pool_stride=1, pool_padding=0,
                      global_pooling=False, name=None):
    """Max pooling that also returns the argmax mask (reference
    ``pool_with_index_op.cc``); the mask feeds ``unpool``."""
    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)

    helper = LayerHelper("pool2d_with_index", name=name)
    out = helper.create_tmp_variable(input.dtype)
    mask = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="pool2d_with_index", inputs={"X": [input]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling})
    return out, mask


def conv_shift(x, y, name=None):
    """Circular correlation (reference ``conv_shift_op.cc``; NTM
    addressing)."""
    helper = LayerHelper("conv_shift", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="conv_shift", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def pool3d(input, pool_size, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, ceil_mode=False, name=None):
    """3-D pooling over NCDHW input (reference ``pool_op.cc`` pool3d)."""
    def _triple(v):
        return [v, v, v] if isinstance(v, int) else list(v)

    helper = LayerHelper("pool3d", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="pool3d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _triple(pool_size),
                            "strides": _triple(pool_stride),
                            "paddings": _triple(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode})
    return out


def unpool(input, indices, unpool_size, unpool_stride=None,
           unpool_padding=0, name=None):
    """Max unpooling from pool_with_index indices (reference
    ``unpool_op.cc``)."""
    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)

    helper = LayerHelper("unpool", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="unpool",
                     inputs={"X": [input], "Indices": [indices]},
                     outputs={"Out": [out]},
                     attrs={"ksize": _pair(unpool_size),
                            "strides": _pair(unpool_stride or unpool_size),
                            "paddings": _pair(unpool_padding)})
    return out


def spp(input, pyramid_height, pool_type="max", name=None):
    """Spatial pyramid pooling (reference ``spp_op.h``)."""
    helper = LayerHelper("spp", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="spp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pyramid_height": pyramid_height,
                            "pooling_type": pool_type})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, name=None):
    """One beam-search pruning step over dense ``[B, K]`` beams (reference
    ``layers`` beam_search -> ``beam_search_op.cc``; see
    ops/beam_search_ops.py for the static-shape re-design).

    Returns (selected_ids, selected_scores, parent_idx), each [B, K].
    ``level`` is accepted for API parity (the LoD level has no dense
    equivalent).
    """
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_tmp_variable("int64")
    sel_scores = helper.create_tmp_variable("float32")
    parent = helper.create_tmp_variable("int64")
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "ids": [ids], "scores": [scores]},
        outputs={"selected_ids": [sel_ids],
                 "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "level": int(level)})
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, parent_idx, scores, max_len=None, name=None):
    """Backtrack per-step (ids, parent) TensorArrays into full hypotheses
    (reference ``beam_search_decode_op.cc``).  Returns
    (sentence_ids [B, K, T], sentence_scores [B, K])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_tmp_variable("int64")
    sent_scores = helper.create_tmp_variable("float32")
    attrs = {}
    if max_len is not None:
        attrs["max_len"] = int(max_len)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "ParentIdx": [parent_idx],
                "Scores": [scores]},
        outputs={"SentenceIds": [sent_ids],
                 "SentenceScores": [sent_scores]},
        attrs=attrs)
    return sent_ids, sent_scores


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Global step counter variable (reference nn.py)."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_global_variable(
        name=counter_name, dtype="int64", shape=[1], persistable=True)
    counter.stop_gradient = True
    helper.set_variable_initializer(
        counter, init_mod.Constant(float(begin - step)))
    helper.append_op(type="increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]}, attrs={"step": float(step)})
    return counter


def dot_product_attention(querys, keys, values):
    """Plain dot-product attention over dense tensors (reference
    ``nets.py`` scaled_dot_product_attention is the richer variant)."""
    product = matmul(x=querys, y=keys, transpose_y=True)
    weights = softmax(product)
    return matmul(weights, values), weights


# re-exported thin wrappers built on ops --------------------------------------

def _unary_layer(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out
    layer.__name__ = op_type
    return layer


def _binary_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _binary_layer("elementwise_add")
elementwise_sub = _binary_layer("elementwise_sub")
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")
elementwise_max = _binary_layer("elementwise_max")
elementwise_min = _binary_layer("elementwise_min")
elementwise_pow = _binary_layer("elementwise_pow")


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                     "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype":
                            framework.convert_np_dtype(dtype)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        n_out = num
    else:
        num = 0
        sections = list(num_or_sections)
        n_out = len(sections)
    outs = [helper.create_tmp_variable(input.dtype) for _ in range(n_out)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", act=act, name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def shape(input, name=None):
    helper = LayerHelper("shape", name=name)
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def ring_attention(q, k, v, causal=False, scale=None, seq_axis="seq",
                   name=None):
    """Sequence-parallel exact attention over [B, H, S, D] with S sharded
    over the mesh's ``seq_axis`` (ops/attention_ops.py ring_attention;
    single-device fallback when no sequence axis is populated)."""
    helper = LayerHelper("ring_attention", name=name)
    out = helper.create_tmp_variable(q.dtype)
    helper.append_op(type="ring_attention",
                     inputs={"Q": [q], "K": [k], "V": [v]},
                     outputs={"Out": [out]},
                     attrs={"causal": causal, "scale": scale,
                            "seq_axis": seq_axis})
    return out


def fused_attention(q, k, v, k_mask=None, causal=False, scale=1.0,
                    use_flash=True, name=None):
    """Fused scaled-dot-product attention over [B, H, S, D] tensors
    (Pallas flash kernel on TPU; see ops/attention_ops.py).  ``k_mask`` is
    [B, S_k] with 1 = attend."""
    helper = LayerHelper("scaled_dot_product_attention", name=name)
    out = helper.create_tmp_variable(q.dtype)
    # Lse: softmax log-normalizer residual saved by the flash kernel so the
    # backward op reuses it instead of re-running the forward
    lse = helper.create_tmp_variable("float32")
    lse.stop_gradient = True
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if k_mask is not None:
        inputs["KMask"] = [k_mask]
    helper.append_op(type="scaled_dot_product_attention", inputs=inputs,
                     outputs={"Out": [out], "Lse": [lse]},
                     attrs={"causal": causal, "scale": float(scale),
                            "use_flash": use_flash})
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           act=None, name=None):
    """3-D convolution, NCDHW (reference ``nn.py`` conv3d over
    ``conv3d_op``; same MXU lowering family as conv2d)."""
    helper = LayerHelper("conv3d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1

    def _triple(x):
        return [x, x, x] if isinstance(x, int) else list(x)

    filter_size = _triple(filter_size)
    stride = _triple(stride)
    padding = _triple(padding)
    dilation = _triple(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = num_channels * int(np.prod(filter_size))
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=init_mod.Normal(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv3d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Transposed 3-D convolution, NCDHW (reference ``nn.py``
    conv3d_transpose over ``conv_transpose_op.cc:314``); filter layout
    (C_in, C_out/groups, kd, kh, kw) like conv2d_transpose."""
    helper = LayerHelper("conv3d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1

    def _triple(x):
        return [x, x, x] if isinstance(x, int) else list(x)

    stride, padding, dilation = (_triple(stride), _triple(padding),
                                 _triple(dilation))
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = _triple(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1
            for i in range(3)]
    else:
        filter_size = _triple(filter_size)
    filter_shape = [num_channels, num_filters // groups] + filter_size
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv3d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss over ragged logits/labels (reference ``nn.py`` warpctc
    over ``warpctc_op.cc``); returns [B, 1] per-sequence losses."""
    helper = LayerHelper("warpctc")
    loss = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="warpctc",
        inputs={"Logits": [input], "Label": [label]},
        outputs={"Loss": [loss]},
        attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank=0):
    """Greedy CTC decode: per-row argmax, merge repeats, drop blanks
    (reference ``nn.py`` ctc_greedy_decoder over ``ctc_align_op``)."""
    from paddle_tpu_torch.layers.tensor import argmax
    helper = LayerHelper("ctc_align")
    ids = argmax(input, axis=-1)
    out = helper.create_tmp_variable(dtype="int32", stop_gradient=True)
    helper.append_op(type="ctc_align", inputs={"Input": [ids]},
                     outputs={"Output": [out]}, attrs={"blank": blank})
    return out


def image_resize(input, out_shape, method="bilinear", name=None,
                 align_corners=True):
    """Resize NCHW feature maps to ``out_shape`` = (H, W) by bilinear or
    nearest interpolation (reference gserver BilinearInterpLayer.cpp /
    UpsampleLayer.cpp). For bilinear, ``align_corners=True`` (the
    default) matches the reference's ``(in-1)/(out-1)`` sampling ratios
    and ``False`` uses the half-pixel convention of jax.image.resize;
    nearest always uses half-pixel (identical to the reference's
    pixel-duplication for integer upsample factors)."""
    helper = LayerHelper("image_resize", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="image_resize", inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"out_h": int(out_shape[0]), "out_w": int(out_shape[1]),
               "method": method, "align_corners": bool(align_corners)})
    return out
