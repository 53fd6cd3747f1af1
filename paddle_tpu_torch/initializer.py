"""Initializers — append init ops to the startup program
(reference ``python/paddle/fluid/initializer.py``: Constant/Uniform/Normal/
Xavier/MSRA + force_init_on_cpu machinery, which has no TPU analog).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "MSRA", "Bilinear",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer", "MSRAInitializer", "force_init_on_cpu",
           "init_on_cpu"]

import contextlib


def force_init_on_cpu():
    return False


@contextlib.contextmanager
def init_on_cpu():
    yield


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """For upsampling conv_transpose filters (reference initializer.py)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("bilinear init needs a 4-D filter")
        c, _, h, w = shape
        f = np.ceil(w / 2.0)
        cc = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        grid = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        filt = (1 - np.abs(grid[0] / f - cc)) * (1 - np.abs(grid[1] / f - cc))
        for i in range(c):
            weight[i, min(i, shape[1] - 1)] = filt
        block.append_op(
            type="assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(shape), "dtype": var.dtype,
                   "fp32_values": weight.flatten().tolist()})


class NumpyArrayInitializer(Initializer):
    """Initialize a variable from a host numpy array (reference
    ``initializer.py`` NumpyArrayInitializer; used e.g. for sinusoid
    position encodings)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            type="assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                   "fp32_values": self.value.astype(np.float32)
                   .flatten().tolist()})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
NumpyArray = NumpyArrayInitializer
