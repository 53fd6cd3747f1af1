"""Data-input layers (the port's copy of ``paddle_tpu.layers.io``;
reference ``python/paddle/fluid/layers/io.py``: ``data:28``,
``open_recordio_file:281``, ``open_files:353``, the decorated readers and
``read_file``).  The programs they build equal the JAX package's."""

from __future__ import annotations

from paddle_tpu_torch.framework import (default_main_program,
                                        default_startup_program, unique_name)
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["data", "open_recordio_file", "open_files",
           "random_data_generator", "shuffle", "batch", "double_buffer",
           "multi_pass", "parallel", "read_file"]


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


# ---------------------------------------------------------------------------
# reader layers (reference layers/io.py:281-500); reader execution model is
# documented in paddle_tpu_torch/ops/reader_ops.py
# ---------------------------------------------------------------------------

def _monkey_patch_reader_methods(reader_var):
    from paddle_tpu_torch.scope import global_scope

    def _reader():
        # the executor pre-pass pins the runtime reader on the variable
        # (works for any scope); global scope is the fallback
        r = getattr(reader_var, "_reader_runtime", None)
        if r is None:
            r = global_scope().find_var(reader_var.name)
        if r is None:
            raise RuntimeError(
                f"reader {reader_var.name!r} not created yet — run the "
                f"program once (or the startup program) first")
        return r

    reader_var.reset = lambda: _reader().reset()
    reader_var.stop_gradient = True
    reader_var.persistable = True
    return reader_var


def _concat_shapes(shapes):
    shape_concat, ranks = [], []
    for shape in shapes:
        shape_concat.extend(int(d) for d in shape)
        ranks.append(len(shape))
    return shape_concat, ranks


def _create_reader(op_type, attrs, shapes=None, dtypes=None, lod_levels=None,
                   startup=True, underlying=None):
    var_name = unique_name(op_type)
    if shapes is not None:
        shape_concat, ranks = _concat_shapes(shapes)
        attrs = dict(attrs, shape_concat=shape_concat, ranks=ranks,
                     dtypes=[str(d) for d in (dtypes or [])],
                     lod_levels=list(lod_levels or []))
    blocks = []
    if startup:
        blocks.append(default_startup_program().current_block())
    blocks.append(default_main_program().current_block())
    var = None
    for blk in blocks:
        var = blk.create_var(name=var_name)
        var.persistable = True
        inputs = {}
        if underlying is not None:
            if not blk.has_var(underlying.name):
                uv = blk.create_var(name=underlying.name)
                uv.persistable = True
            inputs["UnderlyingReader"] = [underlying.name]
        blk.append_op(type=op_type, inputs=inputs,
                      outputs={"Out": [var_name]}, attrs=attrs)
    # carry the slot metadata on the python Variable (the reference stores
    # it in the reader VarDesc)
    main_var = default_main_program().current_block().var(var_name)
    src = underlying if shapes is None else None
    main_var._reader_shapes = (list(shapes) if shapes is not None
                               else list(src._reader_shapes))
    main_var._reader_dtypes = ([str(d) for d in dtypes] if shapes is not None
                               else list(src._reader_dtypes))
    main_var._reader_lod_levels = (list(lod_levels or [])
                                   if shapes is not None
                                   else list(src._reader_lod_levels))
    main_var._reader_batched = False if shapes is not None \
        else getattr(src, "_reader_batched", False)
    main_var._reader_batch_size = -1 if shapes is not None \
        else getattr(src, "_reader_batch_size", -1)
    return _monkey_patch_reader_methods(main_var)


def open_recordio_file(filename, shapes, lod_levels, dtypes, pass_num=1,
                       for_parallel=False):
    """Reader over one recordio file (reference ``layers/io.py:281``)."""
    reader = _create_reader("create_recordio_file_reader",
                            {"filename": filename},
                            shapes=shapes, dtypes=dtypes,
                            lod_levels=lod_levels)
    if pass_num > 1:
        reader = multi_pass(reader=reader, pass_num=pass_num)
    if for_parallel:
        reader = parallel(reader=reader)
    return reader


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=2,
               buffer_size=None, pass_num=1, for_parallel=False):
    """Multi-file threaded reader (reference ``layers/io.py:353``)."""
    if isinstance(filenames, str):
        filenames = [filenames]
    reader = _create_reader(
        "open_files",
        {"file_names": list(filenames), "thread_num": thread_num,
         "buffer_size": buffer_size or thread_num * 32},
        shapes=shapes, dtypes=dtypes, lod_levels=lod_levels)
    if pass_num > 1:
        reader = multi_pass(reader=reader, pass_num=pass_num)
    if for_parallel:
        reader = parallel(reader=reader)
    return reader


def random_data_generator(low, high, shapes, lod_levels, seed=0):
    """Endless uniform-random reader for tests/benchmarks (reference
    ``create_random_data_generator_op.cc``)."""
    return _create_reader("create_random_data_generator",
                          {"min": float(low), "max": float(high),
                           "seed": int(seed)},
                          shapes=shapes,
                          dtypes=["float32"] * len(shapes),
                          lod_levels=lod_levels)


def shuffle(reader, buffer_size, seed=0):
    return _create_reader("create_shuffle_reader",
                          {"buffer_size": int(buffer_size),
                           "seed": int(seed)},
                          startup=False, underlying=reader)


def batch(reader, batch_size):
    out = _create_reader("create_batch_reader",
                         {"batch_size": int(batch_size)},
                         startup=False, underlying=reader)
    out._reader_batched = True
    out._reader_batch_size = int(batch_size)
    return out


def double_buffer(reader, place=None, capacity=4):
    """Background-thread prefetch + host→device copy overlap; ``capacity``
    sizes the prefetch queue (>= the run_steps step count lets a whole
    device-loop's batches decode during the previous dispatch)."""
    return _create_reader("create_double_buffer_reader",
                          {"capacity": int(capacity)},
                          startup=False, underlying=reader)


def multi_pass(reader, pass_num):
    return _create_reader("create_multi_pass_reader",
                          {"pass_num": int(pass_num)},
                          startup=False, underlying=reader)


def parallel(reader):
    return _create_reader("create_threaded_reader", {},
                          startup=False, underlying=reader)


def read_file(file_obj):
    """Pop one batch from a reader into data variables (reference
    ``layers/io.py:489``; executed by the Executor's reader pre-pass)."""
    helper = LayerHelper("read_file")
    shapes = getattr(file_obj, "_reader_shapes", None)
    dtypes = getattr(file_obj, "_reader_dtypes", None)
    if shapes is None:
        raise ValueError("read_file: argument is not a reader variable")
    batched = getattr(file_obj, "_reader_batched", False)
    bs = getattr(file_obj, "_reader_batch_size", -1)
    out = []
    for shape, dtype in zip(shapes, dtypes):
        v = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
        v.shape = ((bs,) + tuple(shape)) if batched else tuple(shape)
        v.is_data = True
        out.append(v)
    helper.append_op(type="read", inputs={"Reader": [file_obj]},
                     outputs={"Out": out})
    return out[0] if len(out) == 1 else out
