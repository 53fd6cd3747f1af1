"""LR-decay schedules as graph ops (the port of ``paddle_tpu.layers.
learning_rate_scheduler``; reference ``python/paddle/fluid/layers/
learning_rate_scheduler.py``): the schedule is part of the program, driven
by the persistable int64 step counter ``@LR_DECAY_COUNTER@``, and its
result is the ``Variable`` an optimizer takes as its learning rate."""

from __future__ import annotations

import math

from paddle_tpu_torch.layers import nn, tensor
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay"]


def _decay_step_counter(begin=0):
    global_step = nn.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return nn.cast(global_step, "float32")


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference learning_rate_scheduler.py noam_decay)."""
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    lr_value = (d_model ** -0.5) * nn.elementwise_min(a, b)
    return lr_value


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        from paddle_tpu_torch.layers import ops
        div_res = ops.floor(div_res)
    return learning_rate * (decay_rate ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    from paddle_tpu_torch.layers import ops
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * ops.exp(-1.0 * decay_rate * div_res)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    from paddle_tpu_torch.layers import ops
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate / (1.0 + decay_rate * div_res)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from paddle_tpu_torch.layers import ops
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / decay_steps)
        # avoid zero division on step 0: ceil(0/n)=0 -> use max(div,1)
        div_res = nn.elementwise_max(
            div_res, tensor.fill_constant([1], "float32", 1.0))
        decay_steps_var = div_res * float(decay_steps)
        frac = global_step / decay_steps_var
    else:
        capped = nn.elementwise_min(
            global_step,
            tensor.fill_constant([1], "float32", float(decay_steps)))
        frac = capped / float(decay_steps)
    return (learning_rate - end_learning_rate) * \
        ((1.0 - frac) ** power) + end_learning_rate


def piecewise_decay(boundaries, values):
    """Piecewise-constant schedule via nested comparisons."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    global_step = _decay_step_counter()
    # fold from the right: lr = step < b_i ? values[i] : lr
    lr = tensor.fill_constant([1], "float32", float(values[-1]))
    for i in range(len(boundaries) - 1, -1, -1):
        b = tensor.fill_constant([1], "float32", float(boundaries[i]))
        cond = nn.cast(global_step < b, "float32")
        lr = lr * (1.0 - cond) + cond * float(values[i])
    return lr
