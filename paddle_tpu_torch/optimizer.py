"""Optimizers: build backward + update sub-graphs (the port of the
``Optimizer`` base, ``SGDOptimizer`` and ``AdamOptimizer`` of
``paddle_tpu.optimizer``; reference ``python/paddle/fluid/optimizer.py:34``,
``minimize:224`` = append_backward + clip + regularization + per-param
optimize ops + accumulator creation).  The other optimizers wait for
their update ops.
"""

from __future__ import annotations

from collections import defaultdict

from paddle_tpu_torch.framework import (Variable, default_main_program,
                                        default_startup_program,
                                        program_guard, unique_name)
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.regularizer import append_regularization_ops
from paddle_tpu_torch.clip import (append_gradient_clip_ops,
                                   error_clip_callback)

__all__ = ["SGD", "Adam", "SGDOptimizer", "AdamOptimizer", "Optimizer"]


class Optimizer:
    """Base optimizer (reference ``optimizer.py:34``)."""

    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate must be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None

    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._learning_rate_map.get(program)
        if lr is not None:
            return
        if isinstance(self._learning_rate, float):
            name = unique_name("learning_rate")
            var = self.helper.create_global_variable(
                name=name, persistable=True, dtype="float32", shape=[1])
            var.stop_gradient = True
            self.helper.set_variable_initializer(
                var, init_mod.Constant(float(self._learning_rate)))
            self._learning_rate_map[program] = var
        else:
            self._learning_rate_map[program] = self._learning_rate

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = getattr(param, "optimize_attr",
                           {"learning_rate": 1.0}).get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        from paddle_tpu_torch.layers import nn
        return nn.scale(base, scale=float(param_lr))

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        assert self.helper is not None
        var = self.helper.create_global_variable(
            name=unique_name(".".join([name, param.name])),
            persistable=True, dtype=dtype or param.dtype,
            shape=shape or param.shape)
        var.stop_gradient = True
        self.helper.set_variable_initializer(
            var, init_mod.Constant(float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _create_accumulators(self, block, parameters):
        pass

    # -- the main entry ----------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        with program_guard(program, startup_program or
                           default_startup_program()):
            self.helper = LayerHelper(self.__class__.__name__)
            self._create_global_learning_rate()
            self._create_accumulators(
                loss.block, [p for p, g in parameters_and_grads
                             if g is not None and p.trainable])
            optimize_ops = []
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None or \
                        not param_and_grad[0].trainable:
                    continue
                optimize_ops.append(
                    self._append_optimize_op(loss.block, param_and_grad))
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """reference ``optimizer.py:224``."""
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator(self._beta2_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        m1 = self._get_accumulator(self._moment1_acc_str, p)
        m2 = self._get_accumulator(self._moment2_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        b2p = self._get_accumulator(self._beta2_pow_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


# naming parity with the reference: both Foo and FooOptimizer exist
SGD = SGDOptimizer
Adam = AdamOptimizer
