"""Operator overloading on Variable (reference
``python/paddle/fluid/layers/math_op_patch.py``): ``a + b`` appends an
elementwise_add op, scalars become fill_constant, etc."""

from __future__ import annotations

from paddle_tpu_torch.framework import Variable, unique_name

__all__ = ["monkey_patch_variable"]


def monkey_patch_variable():
    def unique_tmp_name():
        return unique_name("tmp")

    def safe_get_dtype(var):
        return var.dtype

    def emit_block(var):
        """Emit into the program's CURRENT block, not the variable's
        owner block: an expression on an outer-block var inside a
        While/cond body must compute INSIDE the body — emitting into
        the owner block silently hoists it out of the loop, so the loop
        re-reads a stale pre-loop value (r5 bug: ``acc = acc + 1``
        in a While body incremented exactly once)."""
        try:
            return var.block.program.current_block()
        except Exception:
            return var.block

    def create_tensor(block, value, dtype, shape):
        value = float(value)
        tmp_name = unique_tmp_name()
        var = block.create_var(name=tmp_name, shape=shape, dtype=dtype)
        block.append_op(type="fill_constant", outputs={"Out": [var.name]},
                        attrs={"dtype": var.dtype, "shape": shape,
                               "value": value})
        var.stop_gradient = True
        return var

    def create_scalar(block, value, dtype):
        return create_tensor(block, value, dtype, shape=[1])

    def create_tensor_with_batchsize(ref_var, value, dtype):
        assert isinstance(ref_var, Variable)
        value = float(value)
        tmp_name = unique_tmp_name()
        blk = emit_block(ref_var)
        var = blk.create_var(name=tmp_name, dtype=dtype,
                             shape=ref_var.shape)
        var.stop_gradient = True
        blk.append_op(
            type="fill_constant_batch_size_like",
            outputs={"Out": [var.name]}, inputs={"Input": [ref_var.name]},
            attrs={"dtype": var.dtype, "shape": list(ref_var.shape),
                   "value": value})
        return var

    def astype(self, dtype):
        block = emit_block(self)
        out = block.create_var(name=unique_tmp_name(), dtype=dtype,
                               shape=self.shape)
        block.append_op(type="cast", inputs={"X": [self.name]},
                        outputs={"Out": [out.name]},
                        attrs={"in_dtype": self.dtype, "out_dtype": dtype})
        return out

    def _elemwise_method_creator_(method_name, op_type, reverse=False):
        def __impl__(self, other_var):
            block = emit_block(self)
            lhs_dtype = safe_get_dtype(self)
            if not isinstance(other_var, Variable):
                if reverse:
                    has_batch_size = any(d == -1 for d in (self.shape or ()))
                    if not has_batch_size:
                        other_var = create_tensor(block, other_var,
                                                  dtype=lhs_dtype,
                                                  shape=list(self.shape))
                    else:
                        other_var = create_tensor_with_batchsize(
                            self, other_var, lhs_dtype)
                else:
                    other_var = create_scalar(block, value=other_var,
                                              dtype=lhs_dtype)

            if reverse:
                tmp = self
                self, other_var = other_var, tmp

            out = block.create_var(name=unique_tmp_name(), dtype=lhs_dtype,
                                   shape=self.shape)
            block.append_op(type=op_type,
                            inputs={"X": [self.name],
                                    "Y": [other_var.name]},
                            outputs={"Out": [out.name]},
                            attrs={"axis": -1})
            return out

        __impl__.__name__ = method_name
        return __impl__

    Variable.astype = astype
    for method, op_type, reverse in (
            ("__add__", "elementwise_add", False),
            ("__radd__", "elementwise_add", True),
            ("__sub__", "elementwise_sub", False),
            ("__rsub__", "elementwise_sub", True),
            ("__mul__", "elementwise_mul", False),
            ("__rmul__", "elementwise_mul", True),
            ("__truediv__", "elementwise_div", False),
            ("__rtruediv__", "elementwise_div", True),
            ("__div__", "elementwise_div", False),
            ("__rdiv__", "elementwise_div", True),
            ("__pow__", "elementwise_pow", False),
            ("__rpow__", "elementwise_pow", True),
            ("__mod__", "elementwise_mod", False),
            ("__floordiv__", "elementwise_floordiv", False)):
        setattr(Variable, method, _elemwise_method_creator_(method, op_type,
                                                            reverse))

    def _cmp_method_creator_(method_name, op_type):
        def __impl__(self, other_var):
            block = emit_block(self)
            if not isinstance(other_var, Variable):
                other_var = create_scalar(block, other_var,
                                          safe_get_dtype(self))
            out = block.create_var(name=unique_tmp_name(), dtype="bool",
                                   shape=self.shape)
            block.append_op(type=op_type,
                            inputs={"X": [self.name],
                                    "Y": [other_var.name]},
                            outputs={"Out": [out.name]})
            return out
        __impl__.__name__ = method_name
        return __impl__

    for method, op_type in (("__lt__", "less_than"),
                            ("__le__", "less_equal"),
                            ("__gt__", "greater_than"),
                            ("__ge__", "greater_equal")):
        setattr(Variable, method, _cmp_method_creator_(method, op_type))

    def __neg__(self):
        block = emit_block(self)
        out = block.create_var(name=unique_tmp_name(), dtype=self.dtype,
                               shape=self.shape)
        block.append_op(type="scale", inputs={"X": [self.name]},
                        outputs={"Out": [out.name]},
                        attrs={"scale": -1.0, "bias": 0.0,
                               "bias_after_scale": True})
        return out

    Variable.__neg__ = __neg__


monkey_patch_variable()
