"""Sequence & recurrent layers (the port of ``paddle_tpu.layers.sequence``;
reference ``layers/nn.py`` dynamic_lstm, dynamic_gru, sequence_*
wrappers).  They build the JAX package's IR; the ops are in
``ops/rnn_ops.py`` and ``ops/sequence_ops.py``."""

from __future__ import annotations

import copy

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
    "sequence_conv", "sequence_pool", "sequence_softmax",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
    "sequence_reshape", "sequence_concat", "lod_reset",
    "sequence_reverse", "sequence_slice", "sequence_erase",
]


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over a ragged batch; ``input`` is [N, 4H] pre-projected
    (reference ``layers/nn.py`` dynamic_lstm -> lstm_op.cc)."""
    helper = LayerHelper("lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 4 * size], dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = helper.create_parameter(helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="lstm",
        inputs={"Input": [input], "Weight": [weight], "Bias": [bias]},
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with recurrent projection (reference ``nn.py`` dynamic_lstmp
    over ``lstmp_op.h``); ``input`` is [N, 4H] pre-projected, returns
    (projection [N, P], cell [N, H])."""
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[proj_size, 4 * size],
                                     dtype=dtype)
    proj_weight = helper.create_parameter(
        copy.deepcopy(helper.param_attr) if helper.param_attr else None,
        shape=[size, proj_size], dtype=dtype)
    bias_size = [1, 7 * size] if use_peepholes else [1, 4 * size]
    bias = helper.create_parameter(helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    projection = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="lstmp",
        inputs={"Input": [input], "Weight": [weight],
                "ProjWeight": [proj_weight], "Bias": [bias]},
        outputs={"Projection": [projection], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[1, 3 * size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru", inputs=inputs, outputs={"Hidden": [hidden]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """Single GRU step (reference ``layers/nn.py`` gru_unit)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    size = size // 3
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=input.dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[1, 3 * size],
                                   dtype=input.dtype, is_bias=True)
    gate = helper.create_tmp_variable(input.dtype)
    reset_hidden_pre = helper.create_tmp_variable(input.dtype)
    updated_hidden = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden_pre],
                 "Hidden": [updated_hidden]},
        attrs={"activation": activation,
               "gate_activation": gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    filter_shape = [filter_size * input.shape[1], num_filters]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape,
                                           dtype=input.dtype)
    pre_bias = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    pool_out = helper.create_tmp_variable(input.dtype)
    max_index = helper.create_tmp_variable("int32")
    helper.append_op(
        type="sequence_pool", inputs={"X": [input]},
        outputs={"Out": [pool_out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()})
    if pool_type == "max":
        max_index.stop_gradient = True
    return pool_out


def sequence_first_step(input):
    return sequence_pool(input=input, pool_type="first")


def sequence_last_step(input):
    return sequence_pool(input=input, pool_type="last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"new_dim": new_dim})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op(type="sequence_concat",
                     inputs={"X": [v for v in input]},
                     outputs={"Out": [out]})
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset")
    out = helper.create_tmp_variable(x.dtype)
    if y is not None:
        helper.append_op(type="lod_reset", inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
    elif target_lod is not None:
        helper.append_op(type="lod_reset", inputs={"X": [x]},
                         outputs={"Out": [out]},
                         attrs={"target_lod": [int(v) for v in target_lod]})
    else:
        raise ValueError("lod_reset needs y or target_lod")
    return out


def sequence_reverse(x, name=None):
    """Reverse rows within each sequence (reference
    ``sequence_reverse_op.h``); LoD is preserved."""
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="sequence_reverse", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    """Per-sequence subsequence extraction (reference
    ``sequence_slice_op.cc``): ``offset``/``length`` are [B]-shaped."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_erase(input, tokens, name=None):
    """Remove the listed token ids from each sequence (reference
    ``sequence_erase_op.cc``)."""
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="sequence_erase", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"tokens": list(tokens)})
    return out
