"""LayerHelper — shared machinery for the layers DSL
(reference ``python/paddle/fluid/layer_helper.py``): creates parameters in
the startup+main programs, temp variables, bias/activation appendage.
"""

from __future__ import annotations

import copy

from paddle_tpu_torch import framework
from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.framework import (default_main_program,
                                  default_startup_program, unique_name)
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, framework.Variable):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError(f"{self.layer_type} needs exactly one input")
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [copy.deepcopy(attr) for _ in range(length)]
        if len(attr) != length:
            raise ValueError("param_attr length mismatch")
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        yield from zip(inputs, attrs)

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for x in inputs:
            if dtype is None:
                dtype = x.dtype
            elif dtype != x.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    # -- parameters --------------------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        assert isinstance(attr, ParamAttr)
        attr = copy.deepcopy(attr)
        if attr.name is None:
            attr.name = unique_name(".".join([self.name, "w"])) if not is_bias \
                else unique_name(".".join([self.name, "b"]))
        if default_initializer is None:
            if is_bias:
                attr.set_default_initializer(init_mod.Constant(0.0))
            else:
                attr.set_default_initializer(init_mod.Xavier())
        else:
            attr.set_default_initializer(default_initializer)

        # declare in startup program with its init op
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs(with_initializer=True))
        if attr.initializer is not None:
            attr.initializer(sp, startup_block)
        # declare in main program (no init op)
        return self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())

    def get_parameter(self, name):
        param = self.main_program.global_block().var(name)
        if not isinstance(param, framework.Parameter):
            raise ValueError(f"no parameter named {name}")
        return param

    # -- temp vars ---------------------------------------------------------
    def create_tmp_variable(self, dtype, stop_gradient=False, shape=None):
        return self.main_program.current_block().create_var(
            name=unique_name(".".join([self.name, "tmp"])), dtype=dtype,
            shape=shape, stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        assert isinstance(var, framework.Variable)
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, dtype=var.dtype, shape=var.shape,
                           persistable=True)
        initializer(sv, sb)
        return sv

    # -- bias / activation -------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr is None:
            return input_var
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
