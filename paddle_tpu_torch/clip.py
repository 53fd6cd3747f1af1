"""Gradient clipping (reference ``python/paddle/fluid/clip.py``:
GradientClipByValue / ByNorm / ByGlobalNorm + error-clip hooks)."""

from __future__ import annotations

from paddle_tpu_torch import framework

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "append_gradient_clip_ops",
           "error_clip_callback", "set_gradient_clip"]


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


def error_clip_callback(block, op):
    # reference clip.py error_clip_callback: clip activation grads per var
    for grad_n in op.output_arg_names if hasattr(op, "output_arg_names") \
            else []:
        if not grad_n.endswith(framework.GRAD_SUFFIX):
            continue
        fwd_var_name = grad_n[:-len(framework.GRAD_SUFFIX)]
        try:
            fwd_var = block.var(fwd_var_name)
        except KeyError:
            continue
        error_clip = getattr(fwd_var, "error_clip", None)
        if error_clip is not None:
            error_clip.append_clip_op(block, grad_n)


class BaseGradientClipAttr:
    def process_context(self, context, param, grad):
        raise NotImplementedError

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        from paddle_tpu_torch.layers import nn
        new_grad = nn.clip(x=grad, min=self.min, max=self.max)
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        from paddle_tpu_torch.layers import nn
        new_grad = nn.clip_by_norm(x=grad, max_norm=self.clip_norm)
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError("all parameters in a group should share the "
                             "same clip norm")
        from paddle_tpu_torch.layers import nn
        block = grad.block
        sq = block.create_var(dtype=grad.dtype, shape=(1,))
        block.append_op(type="squared_l2_norm", inputs={"X": [grad]},
                        outputs={"Out": [sq]})
        context[self.group_name].append(sq)
        self.context = context

    def create_operators(self, param, grad):
        from paddle_tpu_torch.layers import nn, tensor, ops
        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm_var = tensor.sums(self.context[self.group_name])
            group_norm_var = ops.sqrt(group_norm_var)
            clip_var = tensor.fill_constant([1], group_norm_var.dtype,
                                            self.clip_norm)
            group_scale_var = nn.elementwise_div(
                x=clip_var,
                y=nn.elementwise_max(x=clip_var, y=group_norm_var))
            self.context[group_scale_name] = group_scale_var
        new_grad = nn.elementwise_mul(x=grad,
                                      y=self.context[group_scale_name])
        return param, new_grad


def set_gradient_clip(clip, param_list=None, program=None):
    from paddle_tpu_torch.framework import default_main_program
    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError("clip should be an instance of BaseGradientClipAttr")
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    context = {}
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        clip_attr.process_context(context=context, param=p, grad=g)
    res = []
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        res.append(clip_attr.create_operators(param=p, grad=g))
    return res


ClipByValue = GradientClipByValue
