"""Model save/load and inference-model export (the port's counterpart of
``paddle_tpu.io``; reference ``python/paddle/fluid/io.py``:
``save_vars:66``, ``save_persistables:145``, ``load_persistables:234``,
``save_inference_model:298``, ``load_inference_model:383``).

Persistence runs through programs, as in the reference: ``save_vars`` /
``load_vars`` build a program of one ``save_combine`` / ``load_combine``
op and run it.  The files are the JAX package's (``__model__`` JSON plus
the ``__params__`` records of ``ops/persist_ops.py``), so models cross
between the two packages.  Only the combined form (one ``filename``) is
ported; per-variable files and sharded checkpoints wait.
"""

from __future__ import annotations

import json
import os

import numpy as np

from paddle_tpu_torch.framework import (Program, Variable,
                                        default_main_program)
from paddle_tpu_torch.ops.persist_ops import read_record_names
from paddle_tpu_torch.scope import global_scope

__all__ = [
    "save_vars", "save_persistables", "load_vars", "load_persistables",
    "save_inference_model", "load_inference_model", "synth_feed_value",
    "infer_feed_specs",
]


def is_persistable(var):
    return var.persistable


def _persist_program(vars, for_load):
    """A fresh program whose global block mirrors ``vars`` (persistable),
    ready to host a save/load op over them."""
    prog = Program()
    prog.expect_host_ops = True
    block = prog.global_block()
    for var in vars:
        v = block.create_var(name=var.name, shape=var.shape,
                             dtype=var.dtype)
        v.persistable = True
        if for_load:
            v.stop_gradient = True
    return prog, block


def _need_filename(filename):
    if filename is None:
        raise NotImplementedError(
            "paddle_tpu_torch.io saves and loads the combined form only: "
            "pass a filename (per-variable files are not ported)")


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write the selected variables (sorted by name) into
    ``dirname/filename`` through one ``save_combine`` op."""
    _need_filename(filename)
    scope = global_scope()
    if vars is None:
        main_program = main_program or default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    vars = sorted((v for v in vars if scope.find_var(v.name) is not None),
                  key=lambda v: v.name)
    os.makedirs(dirname, exist_ok=True)
    prog, block = _persist_program(vars, for_load=False)
    if vars:
        block.append_op(
            type="save_combine", inputs={"X": [v.name for v in vars]},
            outputs={}, attrs={"file_path": os.path.join(dirname, filename)})
        executor.run(prog, feed={}, fetch_list=[])


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, None, is_persistable,
              filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Read ``dirname/filename`` into the scope through one
    ``load_combine`` op, matching records to the program's variables by
    their recorded names."""
    _need_filename(filename)
    if vars is None:
        main_program = main_program or default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    path = os.path.join(dirname, filename)
    recorded = read_record_names(path)
    by_name = {v.name: v for v in vars}
    if any(n is None for n in recorded):
        vars = sorted(vars, key=lambda v: v.name)  # files without names
    else:
        missing = [n for n in recorded if n not in by_name]
        if missing:
            raise ValueError(
                f"load_vars: {path!r} holds records for "
                f"{missing[:3]}... not present in the program")
        vars = [by_name[n] for n in recorded]
    prog, block = _persist_program(vars, for_load=True)
    if vars:
        block.append_op(
            type="load_combine", inputs={},
            outputs={"Out": [v.name for v in vars]},
            attrs={"file_path": path})
        executor.run(prog, feed={}, fetch_list=[])


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, None, is_persistable,
              filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune to ``target_vars``, record the feed/fetch names in
    ``__model__`` and the persistables in ``__params__``."""
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    inference_program = main_program.prune(target_vars).inference_optimize()
    fetch_var_names = [v.name for v in target_vars]
    model = {
        "program": inference_program.to_dict(),
        "feed_var_names": feeded_var_names,
        "fetch_var_names": fetch_var_names,
    }
    with open(os.path.join(dirname, model_filename or "__model__"),
              "w") as f:
        json.dump(model, f)
    save_persistables(executor, dirname, inference_program,
                      params_filename or "__params__")
    return fetch_var_names


def synth_feed_value(shape, dtype):
    """Zero-filled feed array for a declared signature (what
    ``Executor.warmup`` runs a signature on); bfloat16 feeds synthesize as
    float32 zeros, which the executor casts to the variable's dtype."""
    shape = tuple(int(d) for d in shape)
    if str(dtype) == "bfloat16":
        return np.zeros(shape, np.float32)
    return np.zeros(shape, np.dtype(str(dtype)))


def infer_feed_specs(program, feed_names):
    """Declared feed signatures of an inference program: ``name ->
    {"shape": tuple (None for dynamic dims), "dtype": str, "lod_level":
    int}`` — what a server needs to synthesize warmup batches
    (``serving.Predictor.warmup``) without seeing a real request."""
    block = program.global_block()
    specs = {}
    for name in feed_names:
        var = block.vars.get(name)
        if var is None:
            specs[name] = {"shape": None, "dtype": "float32",
                           "lod_level": 0}
            continue
        shape = None
        if var.shape is not None:
            shape = tuple(None if d is None or int(d) < 0 else int(d)
                          for d in var.shape)
        specs[name] = {"shape": shape,
                       "dtype": var.dtype or "float32",
                       "lod_level": getattr(var, "lod_level", 0) or 0}
    return specs


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Returns ``(program, feed_names, fetch_vars)`` with the persistables
    loaded into the current scope on the executor's device."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        model = json.load(f)
    program = Program.from_dict(model["program"])
    program._is_inference = True
    load_persistables(executor, dirname, program,
                      params_filename or "__params__")
    fetch_vars = [program.global_block().var(n)
                  for n in model["fetch_var_names"]]
    return program, model["feed_var_names"], fetch_vars
