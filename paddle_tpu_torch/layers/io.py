"""Data-input layers (reference ``python/paddle/fluid/layers/io.py``
``data:28``).  The reader layers wait for the port's reader ops."""

from __future__ import annotations

from paddle_tpu_torch.framework import (default_main_program,
                                        default_startup_program)

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    """Declare an input variable (reference ``layers/io.py:28``)."""
    helper_block = default_main_program().global_block()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = helper_block.create_var(name=name, shape=shape, dtype=dtype,
                                  lod_level=lod_level, is_data=True)
    var.stop_gradient = stop_gradient
    # mirror into startup program for parity with reference behavior
    sb = default_startup_program().global_block()
    if not sb.has_var_local(name):
        sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                           lod_level=lod_level, is_data=True)
        sv.stop_gradient = stop_gradient
    return var
