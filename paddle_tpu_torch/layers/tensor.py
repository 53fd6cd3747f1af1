"""Tensor-creation layers (reference ``python/paddle/fluid/layers/tensor.py``)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import Variable, convert_np_dtype
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "create_tensor", "create_parameter", "create_global_var", "fill_constant",
    "fill_constant_batch_size_like", "ones", "zeros", "assign", "cast",
    "concat", "sums", "argmin", "argmax", "zeros_like",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from paddle_tpu_torch.param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr.to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from paddle_tpu_torch import initializer as init_mod
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(dtype=dtype, shape=shape,
                                        persistable=persistable, name=name)
    helper.set_variable_initializer(var, init_mod.Constant(value))
    return var


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": convert_np_dtype(dtype),
               "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": convert_np_dtype(dtype),
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if output is None:
        if isinstance(input, Variable):
            out_dtype = input.dtype
        elif isinstance(input, np.ndarray):
            out_dtype = convert_np_dtype(input.dtype)
        else:
            out_dtype = "float32"
        output = helper.create_tmp_variable(dtype=out_dtype)
    if isinstance(input, Variable):
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        dtype = convert_np_dtype(input.dtype)
        if dtype in ("float32", "float64"):
            values = [float(v) for v in input.flat]
            value_name = "fp32_values"
        else:
            values = [int(v) for v in input.flat]
            value_name = "int32_values"
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"dtype": dtype, "shape": list(input.shape),
                   value_name: values})
    else:
        raise TypeError("assign expects Variable or numpy.ndarray")
    return output


from paddle_tpu_torch.layers.nn import cast, concat  # noqa: E402,F401  (re-export)


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_tmp_variable(dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out
