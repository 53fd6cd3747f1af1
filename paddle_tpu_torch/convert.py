"""Carry-over between numpy, torch and the port's Scope.

Weights and state cross between the JAX package and the port as numpy
arrays (a bundle's ``__params__`` records, or a JAX scope read out with
``np.asarray``).  :func:`scope_from_numpy` turns such a name -> array
map into a port :class:`~paddle_tpu_torch.scope.Scope` on a place's
device.  bfloat16 arrays (numpy's ``ml_dtypes`` type, as JAX hands them
out) go through ``torch.bfloat16`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.framework import convert_np_dtype
from paddle_tpu_torch.place import torch_device
from paddle_tpu_torch.scope import Scope

__all__ = ["torch_dtype", "to_tensor", "to_numpy", "scope_from_numpy"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype):
    """``torch.dtype`` of an IR dtype name (``"float32"``, ``"int32"``...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[convert_np_dtype(dtype)]


def to_tensor(value, device, dtype=None):
    """``value`` (tensor, numpy array or scalar) as a tensor on ``device``,
    cast to ``dtype`` (a ``torch.dtype`` or IR name) when given."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(
                np.ascontiguousarray(arr).view(np.int16).copy()
            ).view(torch.bfloat16)
        else:
            arr = np.ascontiguousarray(arr)
            if not arr.flags.writeable:
                arr = arr.copy()
            t = torch.from_numpy(arr)
    if dtype is not None:
        dtype = torch_dtype(dtype)
        if t.dtype != dtype:
            t = t.to(dtype)
    return t.to(device)


def to_numpy(value):
    """Host numpy copy of a tensor (or array).  bfloat16 comes back as its
    raw ``uint16`` words (numpy has no bfloat16 of its own)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(value)


def scope_from_numpy(arrays, place=None):
    """A :class:`Scope` holding every ``name -> ndarray`` of ``arrays`` as
    a tensor on ``place``'s device (``None`` = ``cuda:0``; raises when that
    device is absent)."""
    device = torch_device(place)
    scope = Scope()
    for name, arr in arrays.items():
        scope.set_var(name, to_tensor(arr, device))
    return scope
