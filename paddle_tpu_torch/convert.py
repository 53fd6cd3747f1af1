"""Carry-over between numpy, torch and the port's Scope.

Weights and state cross between the JAX package and the port as numpy
arrays (a bundle's ``__params__`` records, or a JAX scope read out with
``np.asarray``).  :func:`scope_from_numpy` turns such a name -> array
map into a port :class:`~paddle_tpu_torch.scope.Scope` on a place's
device: a whole training scope (parameters, the learning rate, every
optimizer's accumulators by name: ``moment1_*`` / ``moment2_*`` /
``beta*_pow_acc_*``, ``velocity_*``, ``moment_*``, ``inf_norm_*``,
``_avg_squared_*``, ``mean_square_*``, ``squared_*`` / ``linear_*``,
ModelAverage's ``@SUM_ACC`` / ``@CNT_ACC``, and the int64 step counter
``@LR_DECAY_COUNTER@``, cast to its declared dtype) so that both
packages take the same steps from it.  bfloat16 arrays (numpy's
``ml_dtypes`` type, as JAX hands them out) go through ``torch.bfloat16``
bit for bit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from paddle_tpu_torch.framework import convert_np_dtype
from paddle_tpu_torch.place import torch_device
from paddle_tpu_torch.scope import Scope

__all__ = ["torch_dtype", "to_tensor", "to_numpy", "fetch_numpy",
           "persistable_names", "scope_from_numpy"]

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
    cast to ``dtype`` (a ``torch.dtype`` or IR name) when given.  A
    tensor made from a numpy array never shares its memory: ops update
    state in place (the sparse optimizer branches), which must not
    write into the caller's arrays."""
    if isinstance(value, torch.Tensor):
        t, host = value, None
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
        host = t.data_ptr()
    if dtype is not None:
        dtype = torch_dtype(dtype)
        if t.dtype != dtype:
            t = t.to(dtype)
    t = t.to(device)
    if host is not None and t.numel() and t.data_ptr() == host:
        t = t.clone()
    return t


def is_dtensor(value):
    """``value`` is a ``torch.distributed.tensor.DTensor`` (the state of
    ``ParallelExecutor``).  Such a tensor exists only once that module is
    imported, so a process that never forms a mesh does not import it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(value, mod.DTensor)


def shard_layout(tensors, dims):
    """``(mesh, placements)`` that DTensors ``tensors`` share when that
    layout splits ``dims`` only, else None (not all DTensors, or another
    layout)."""
    if not all(is_dtensor(t) for t in tensors):
        return None
    mesh, pl = tensors[0].device_mesh, tuple(tensors[0].placements)
    if any(t.device_mesh is not mesh or tuple(t.placements) != pl
           for t in tensors):
        return None
    if not all(p.is_replicate() or (p.is_shard() and p.dim in dims)
               for p in pl):
        return None
    return mesh, pl


def on_local_shards(fn, tensors, dims, shape):
    """``fn`` of the local shards of DTensors ``tensors`` that share one
    layout, split over ``dims`` only (dims along which ``fn`` works piece
    by piece), wrapped back with that layout as a DTensor of global
    ``shape``; None when :func:`shard_layout` finds no such layout, for
    DTensor's own rules.  For a torch call whose own DTensor rule is
    missing or refuses a view it makes."""
    layout = shard_layout(tensors, dims)
    if layout is None:
        return None
    from torch.distributed.tensor import DTensor
    out = fn(*(t.to_local() for t in tensors))
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, *layout, run_check=False, shape=shape,
                              stride=stride)


def to_numpy(value):
    """Host numpy copy of a tensor (or array), never a view of a CPU
    tensor that a later in-place update could change.  bfloat16 comes
    back as its raw ``uint16`` words (numpy has no bfloat16 of its
    own)."""
    if isinstance(value, torch.Tensor):
        if is_dtensor(value):
            # the global value (a collective: every rank of its mesh
            # calls this together)
            value = value.full_tensor()
        t = value.detach().cpu().contiguous()
        if t.data_ptr() == value.data_ptr():
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(value)


def fetch_numpy(value):
    """A fetched value on the host, as the user reads it: like
    :func:`to_numpy`, but bfloat16 is widened to float32 (exact), since
    numpy has no bfloat16 of its own.  This is where the port's fetches
    differ in dtype from the JAX package's, which hands out ml_dtypes
    bfloat16 arrays; the persist format keeps the raw words."""
    if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
        value = value.float()
    return to_numpy(value)


def persistable_names(program):
    """Names of the persistable variables ``program``'s global block
    reads or writes: its parameters and optimizer state."""
    block = program.global_block()
    names = []
    for op in block.ops:
        for n in op.input_arg_names + op.output_arg_names:
            v = block.vars.get(n)
            if v is not None and v.persistable and n not in names:
                names.append(n)
    return names


def scope_from_numpy(arrays, place=None, program=None):
    """A :class:`Scope` holding every ``name -> ndarray`` of ``arrays`` as
    a tensor on ``place``'s device (``None`` = ``cuda:0``; raises when that
    device is absent).  With ``program``, every persistable variable it
    uses must be in ``arrays`` with its declared shape, and is cast to its
    declared dtype; a missing or misshapen one raises."""
    device = torch_device(place)
    scope = Scope()
    declared = {}
    if program is not None:
        block = program.global_block()
        for n in persistable_names(program):
            if n not in arrays:
                raise KeyError(f"scope_from_numpy: {n!r} of the program is "
                               f"not among the arrays")
            declared[n] = block.vars[n]
    for name, arr in arrays.items():
        var = declared.get(name)
        if var is not None and var.shape is not None and \
                tuple(np.shape(arr)) != tuple(var.shape):
            raise ValueError(f"scope_from_numpy: {name!r} has shape "
                             f"{np.shape(arr)}, the program declares "
                             f"{tuple(var.shape)}")
        scope.set_var(name, to_tensor(arr, device,
                                      var.dtype if var is not None else None))
    return scope
