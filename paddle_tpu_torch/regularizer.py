"""Weight-decay regularizers appended as grad-modifying ops
(reference ``python/paddle/fluid/regularizer.py``)."""

from __future__ import annotations

from paddle_tpu_torch import framework

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Add param*coeff (L2) or sign(param)*coeff (L1) into each grad
    (reference ``regularizer.py append_regularization_ops``)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        regularization_term = reg(param, grad, block)
        new_grad = block.create_var(
            name=framework.unique_name(grad.name + "@REGULARIZED"),
            dtype=param.dtype, shape=param.shape)
        new_grad.stop_gradient = True
        block.append_op(type="sum",
                        inputs={"X": [grad, regularization_term]},
                        outputs={"Out": [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
