"""Auto-generated thin layer wrappers over registered ops (reference
``python/paddle/fluid/layers/ops.py:76`` generates these from OpProtos)."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = []

_ACTIVATIONS = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
    "softshrink", "sqrt", "abs", "ceil", "floor", "round", "reciprocal",
    "log", "square", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "pow", "stanh", "hard_sigmoid", "swish",
    "hard_shrink", "thresholded_relu", "gelu", "sin", "cos",
]

# NOTE: softmax is NOT generated here — layers/nn.py defines the real
# wrapper (optional fused Bias input); generating it too would shadow
# that one through the star-import order in layers/__init__.py
_UNARY_OPS = _ACTIVATIONS + ["sign", "cumsum", "log_softmax"]


def _make_wrapper(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    layer.__doc__ = f"Elementwise `{op_type}` op wrapper."
    return layer


for _op in _UNARY_OPS:
    globals()[_op] = _make_wrapper(_op)
    __all__.append(_op)


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


__all__.append("clip_by_norm")


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    return out


__all__.append("uniform_random")


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    return out


__all__.append("gaussian_random")
