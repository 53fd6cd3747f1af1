"""Optimizers: build backward + update sub-graphs (the port of
``paddle_tpu.optimizer``; reference
``python/paddle/fluid/optimizer.py:34``, ``minimize:224`` =
append_backward + clip + regularization + per-param optimize ops +
accumulator creation).  Same classes, accumulator names
and ops as the JAX package, so the two build the same IR; the learning
rate is a float or a ``Variable`` (a schedule of
``layers.learning_rate_scheduler``).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import (Variable, default_main_program,
                                  default_startup_program, program_guard,
                                  unique_name)
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.regularizer import append_regularization_ops
from paddle_tpu_torch.clip import append_gradient_clip_ops, error_clip_callback

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Adadelta", "RMSProp", "Ftrl", "SGDOptimizer", "MomentumOptimizer",
    "AdagradOptimizer", "AdamOptimizer", "AdamaxOptimizer",
    "DecayedAdagradOptimizer", "AdadeltaOptimizer", "RMSPropOptimizer",
    "FtrlOptimizer", "Optimizer", "ModelAverage",
]


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

    def _finish_update(self, block):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

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
                if param_and_grad[1] is None or not param_and_grad[0].trainable:
                    continue
                optimize_ops.append(
                    self._append_optimize_op(loss.block, param_and_grad))
            self._finish_update(loss.block)
        return optimize_ops

    def _create_accumulators(self, block, parameters):
        pass

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


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str,
                                             param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Velocity": [velocity_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity_acc]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Moment": [moment_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [moment_acc]},
            attrs={"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [b1p]},
            outputs={"ParamOut": [p], "MomentOut": [moment],
                     "InfNormOut": [inf_norm], "Beta1PowOut": [b1p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Moment": [moment_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [moment_acc]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        asg = self._get_accumulator(self._avg_squared_grad_acc_str,
                                    param_and_grad[0])
        asu = self._get_accumulator(self._avg_squared_update_acc_str,
                                    param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._momentum_acc_str,
                                             param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str,
                                                param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "Moment": [momentum_acc],
                    "MeanSquare": [mean_square_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [momentum_acc],
                     "MeanSquareOut": [mean_square_acc]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        squared_acc = self._get_accumulator(self._squared_acc_str,
                                            param_and_grad[0])
        linear_acc = self._get_accumulator(self._linear_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "SquaredAccumulator": [squared_acc],
                    "LinearAccumulator": [linear_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "SquaredAccumOut": [squared_acc],
                     "LinearAccumOut": [linear_acc]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class ModelAverage(Optimizer):
    """Running average of parameters (reference ``optimizer.py:811``).

    As in the JAX package: a sum accumulator and a count per parameter;
    ``apply()`` swaps averaged params in, ``restore()`` swaps back.
    """

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        # append accumulate ops for every parameter of the current main
        # program (reference appends average_accumulates ops per param)
        block = framework.default_main_program().global_block()
        self._avg_names = {}
        for param in block.all_parameters():
            self._append_average_accumulate_op(param)

    def _append_average_accumulate_op(self, param):
        helper = LayerHelper("model_average")
        sum_acc = helper.create_global_variable(
            name=param.name + "@SUM_ACC", shape=param.shape,
            dtype=param.dtype, persistable=True)
        cnt_acc = helper.create_global_variable(
            name=param.name + "@CNT_ACC", shape=(1,), dtype="float32",
            persistable=True)
        helper.set_variable_initializer(sum_acc, init_mod.Constant(0.0))
        helper.set_variable_initializer(cnt_acc, init_mod.Constant(0.0))
        helper.append_op(
            type="average_accumulates",
            inputs={"Param": [param], "Sum": [sum_acc], "Count": [cnt_acc]},
            outputs={"SumOut": [sum_acc], "CountOut": [cnt_acc]},
            attrs={"max_average_window": self.max_average_window})
        self._avg_names[param.name] = (sum_acc.name, cnt_acc.name)

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True):
        """Swap averaged parameter values in (reference ``optimizer.py:811``
        ModelAverage.apply context manager)."""
        from paddle_tpu_torch.convert import to_tensor
        from paddle_tpu_torch.scope import global_scope
        scope = global_scope()
        backups = {}
        for pname, (sname, cname) in self._avg_names.items():
            p = scope.find_var(pname)
            s = scope.find_var(sname)
            c = scope.find_var(cname)
            if p is None or s is None or c is None:
                continue
            p, s, c = (to_tensor(x, executor.device) for x in (p, s, c))
            cnt = float(c.reshape(-1)[0])
            if cnt <= 0:
                continue
            backups[pname] = p
            scope.set_var(pname, (s / cnt).to(p.dtype))
        self._backups = backups
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor=None):
        """Swap the pre-average parameter values back in (reference
        ``optimizer.py`` ModelAverage.restore); used after
        ``apply(need_restore=False)``."""
        from paddle_tpu_torch.scope import global_scope
        scope = global_scope()
        for pname, val in getattr(self, "_backups", {}).items():
            scope.set_var(pname, val)
        self._backups = {}


# naming parity with reference: both Foo and FooOptimizer exist
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
