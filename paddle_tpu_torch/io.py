"""Model save/load, inference-model export and training checkpoints (the
port's counterpart of ``paddle_tpu.io``; reference
``python/paddle/fluid/io.py``: ``save_vars:66``, ``save_persistables:145``,
``load_persistables:234``, ``save_inference_model:298``,
``load_inference_model:383``).

Persistence runs through programs, as in the reference: ``save_vars`` /
``load_vars`` build a program of ``save`` / ``load`` ops (one per
variable) or of one ``save_combine`` / ``load_combine`` op (when
``filename`` is given) and run it.  The files are the JAX package's
(``__model__`` JSON plus the records of ``ops/persist_ops.py``), so
models cross between the two packages.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``): the JAX
package's default format is orbax; the port always writes that
package's other format, the shard format of
:mod:`paddle_tpu_torch.fault.shard_ckpt` (one ``.npy`` a variable and a
topology record in ``MANIFEST.json``), which the JAX package's
``load_checkpoint`` reads, and reads it at any shard count.  An orbax
directory raises.  A mesh-sharded save (``mesh=``, ``shard_specs=``)
has each rank write the shards it owns and the mesh's first rank
commit; a restore onto a mesh (``mesh=``, ``shardings=``) places every
var as a DTensor, re-slicing the saved pieces for another world size.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from paddle_tpu_torch.framework import (Parameter, Program, Variable,
                                        default_main_program)
from paddle_tpu_torch.ops.persist_ops import read_record_names
from paddle_tpu_torch.place import torch_device
from paddle_tpu_torch.scope import global_scope

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "save_checkpoint", "load_checkpoint",
    "get_inference_program", "synth_feed_value", "infer_feed_specs",
    "atomic_write", "snapshot_state",
]


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def _var_path(dirname, name):
    return os.path.join(dirname, name.replace("/", "%2F"))


def _persist_program(vars, for_load):
    """A fresh program whose global block mirrors ``vars`` (persistable),
    ready to host save/load ops over them."""
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


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write the selected variables through one ``save`` op each into
    ``dirname/<name>``, or, with ``filename``, sorted by name through one
    ``save_combine`` op into ``dirname/filename``."""
    scope = global_scope()
    if vars is None:
        main_program = main_program or default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    # a reader variable is persistable too, but holds no tensor
    vars = [v for v in vars if hasattr(scope.find_var(v.name), "dtype")]
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        # combined records carry names, but the order is the contract:
        # both ends sort by name
        vars = sorted(vars, key=lambda v: v.name)
    prog, block = _persist_program(vars, for_load=False)
    if filename is not None:
        if vars:
            block.append_op(
                type="save_combine", inputs={"X": [v.name for v in vars]},
                outputs={},
                attrs={"file_path": os.path.join(dirname, filename)})
    else:
        for var in vars:
            block.append_op(
                type="save", inputs={"X": [var.name]}, outputs={},
                attrs={"file_path": _var_path(dirname, var.name)})
    if block.ops:
        executor.run(prog, feed={}, fetch_list=[])


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, None, is_parameter, filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, None, is_persistable,
              filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Read the selected variables into the scope: one ``load`` op a
    variable whose ``dirname/<name>`` exists, or, with ``filename``, one
    ``load_combine`` op matching records to the program's variables by
    their recorded names."""
    if vars is None:
        main_program = main_program or default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    if filename is not None:
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
        return
    vars = [v for v in vars if os.path.exists(_var_path(dirname, v.name))]
    prog, block = _persist_program(vars, for_load=True)
    for var in vars:
        block.append_op(
            type="load", inputs={}, outputs={"Out": [var.name]},
            attrs={"file_path": _var_path(dirname, var.name)})
    if block.ops:
        executor.run(prog, feed={}, fetch_list=[])


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, None, is_parameter, filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, None, is_persistable,
              filename)


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    pruned = main_program.prune(target_vars)
    return pruned.inference_optimize()


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


# ---------------------------------------------------------------------------
# checkpoint/resume: the whole training state (parameters and optimizer
# accumulators) in the shard format, committed crash-consistently
# (``fault.checkpoint.commit_checkpoint``)
# ---------------------------------------------------------------------------

def atomic_write(path, data):
    """Crash-safe small-file write (tmp + fsync + rename): a crash
    mid-write keeps the old file.  ``data`` may be str or bytes.  The
    idiom behind every pointer file the runtime commits (``latest``,
    ``last_good``).  The temp name is deterministic (single-writer
    protocol), so a crashed write's orphan is overwritten by the next
    attempt."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_latest(dirname, step):
    atomic_write(os.path.join(dirname, "latest"), str(int(step)))


def _persistable_state(main_program=None, scope=None):
    """The scope's persistable values, name -> the live tensor or array
    (no copy): what a blocking save copies straight to the host."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    state = {}
    for var in main_program.global_block().vars.values():
        if not is_persistable(var):
            continue
        v = scope.find_var(var.name)
        if v is not None and hasattr(v, "dtype"):
            state[var.name] = v
    return state


def snapshot_state(main_program=None, scope=None):
    """The persistable state a checkpoint captures, as a name -> tensor
    dict of clones, for a save that writes later on another thread
    (``CheckpointManager.save_async``).  The port's steps write the
    scope's tensors in place (a CUDA graph's write-back), so unlike the
    JAX package, whose arrays are immutable, the snapshot clones every
    tensor on the device and waits for the clones before it returns:
    the writer then serializes a consistent point-in-time view while
    the next steps run.  A blocking save copies the live tensors to the
    host instead and holds no second copy on the device."""
    state = {}
    devices = set()
    for name, v in _persistable_state(main_program, scope).items():
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
            v = v.detach().clone()
        else:
            v = np.array(v)
        state[name] = v
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    return state


def save_checkpoint(executor, dirname, main_program=None, step=0,
                    scope=None, extras=None, mesh=None, shard_specs=None,
                    state=None):
    """Save ALL persistable state (params + optimizer accumulators) as
    ``dirname/ckpt-<step>`` in the shard format, one ``.npy`` a
    variable, and swing the ``latest`` pointer.

    Crash-consistent: the state is written to a ``.tmp-`` dir, a
    checksummed ``MANIFEST.json`` (with the topology record) is added,
    and only then is the dir atomically renamed to ``ckpt-<step>``
    (``fault.checkpoint.commit_checkpoint``).

    ``extras``: optional ``filename -> bytes`` sidecar files (e.g. the
    serialized datapipe iterator state) written into the checkpoint dir
    BEFORE the commit, so they ride the same manifest/rename atomicity
    as the tensors.  ``state``: a pre-snapshotted :func:`snapshot_state`
    dict (the async-save path snapshots on the step path and writes
    later, on its writer thread); without it the scope's tensors are
    copied straight to the host.

    ``mesh`` (a ``DeviceMesh``; every rank of it calls this together):
    the mesh-sharded save of the JAX package.  ``shard_specs`` (name ->
    placement tuple, e.g. ``ZeroPlan.checkpoint_specs()``) names the vars
    cut over a mesh axis; each rank writes the shards it owns, and once
    every rank wrote the mesh's first rank commits and swings ``latest``
    (:class:`_MeshSave`); a failed write or commit raises on every rank."""
    from paddle_tpu_torch.fault import shard_ckpt

    if state is None:
        state = _persistable_state(main_program, scope)
    if mesh is not None:
        save = _MeshSave(dirname, step, state, mesh, shard_specs)
        save.write(extras)
        return save.commit()
    import shutil

    from paddle_tpu_torch.fault import chaos
    from paddle_tpu_torch.fault.checkpoint import commit_checkpoint
    from paddle_tpu_torch.obs.trace import span as _span

    os.makedirs(dirname, exist_ok=True)
    path = os.path.abspath(os.path.join(dirname, f"ckpt-{int(step)}"))
    tmp = os.path.abspath(os.path.join(dirname, f".tmp-ckpt-{int(step)}"))
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    chaos.fire("ckpt.save", step=step)
    with _span("ckpt.write", step=int(step), vars=len(state)):
        host = shard_ckpt.host_state(state)
        os.makedirs(tmp, exist_ok=True)
        topology = shard_ckpt.build_topology(host)
        shard_ckpt.write_state(tmp, host, topology, step=int(step))
        for name, blob in (extras or {}).items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
    commit_checkpoint(tmp, path, step=int(step),
                      extra={"topology": topology})
    _write_latest(dirname, step)
    return path


def _mesh_flag(mesh, ok, root=False):
    """``ok`` agreed on every rank: the mesh's first rank's (``root``
    True), else whether every rank's is."""
    import torch.distributed as dist
    device = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=device)
    if root:
        dist.broadcast(flag, int(mesh.mesh.flatten()[0]))
    else:
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


class _MeshSave:
    """A mesh-sharded save (every rank of ``mesh`` takes part) in three
    parts, so that every collective runs on the thread that runs the
    steps and only file writes may run on another
    (``CheckpointManager.save_async``):

    - the constructor (collectives): the mesh's first rank makes the
      temp dir, a barrier, then each var redistributed to its saved split
      and this rank's pieces taken (``shard_ckpt.mesh_pieces``; ``clone``
      copies them on the device, for a write after the next steps);
    - :meth:`write` (no collective): the pieces and ``extras`` written
      under the temp dir; a failure is kept for :meth:`commit`;
    - :meth:`commit` (collectives): whether every rank wrote, agreed on
      every rank; the first rank commits and swings ``latest``; its
      status shared, so a failure raises on every rank instead of leaving
      the others at a collective.  Returns the committed path."""

    def __init__(self, dirname, step, state, mesh, shard_specs=None,
                 clone=False):
        import shutil

        import torch.distributed as dist

        from paddle_tpu_torch.fault import chaos, shard_ckpt
        self.dirname, self.step, self.mesh = dirname, int(step), mesh
        self.coordinator = dist.get_rank() == int(mesh.mesh.flatten()[0])
        self.path = os.path.abspath(os.path.join(dirname,
                                                 f"ckpt-{self.step}"))
        # one temp path on every rank: each writes its shards into it,
        # the coordinator commits it
        self.tmp = os.path.abspath(os.path.join(dirname,
                                                f".tmp-ckpt-{self.step}"))
        if self.coordinator:
            os.makedirs(dirname, exist_ok=True)
            if os.path.exists(self.tmp):
                shutil.rmtree(self.tmp)
            os.makedirs(self.tmp)
        dist.barrier()
        chaos.fire("ckpt.save", step=self.step)
        self.vars = len(state)
        self.topology = shard_ckpt.build_mesh_topology(mesh, state,
                                                       shard_specs)
        self.pieces = shard_ckpt.mesh_pieces(state, self.topology, mesh,
                                             clone=clone)
        self.error = None

    def write(self, extras=None):
        from paddle_tpu_torch.fault import shard_ckpt
        from paddle_tpu_torch.obs.trace import span as _span
        try:
            with _span("ckpt.write", step=self.step, vars=self.vars):
                shard_ckpt.write_pieces(self.tmp, self.pieces, self.step)
                for name, blob in (extras or {}).items():
                    with open(os.path.join(self.tmp, name), "wb") as f:
                        f.write(blob)
                        f.flush()
                        os.fsync(f.fileno())
        except BaseException as e:
            self.error = e
        self.pieces = None
        return self.tmp

    def commit(self):
        from paddle_tpu_torch.fault.checkpoint import commit_checkpoint
        # every rank's shards and extras land before the manifest walk
        written = _mesh_flag(self.mesh, self.error is None)
        if self.error is not None:
            raise self.error
        if not written:
            raise RuntimeError(f"checkpoint step {self.step}: a rank "
                               f"failed to write its shards")
        commit_error = None
        if self.coordinator:
            try:
                commit_checkpoint(self.tmp, self.path, step=self.step,
                                  extra={"topology": self.topology})
                _write_latest(self.dirname, self.step)
            except BaseException as e:
                commit_error = e
        # no rank returns before the commit
        ok = _mesh_flag(self.mesh, commit_error is None, root=True)
        if commit_error is not None:
            raise commit_error
        if not ok:
            raise RuntimeError(f"checkpoint commit for step {self.step} "
                               f"failed on the coordinator rank")
        return self.path


def _restored_tensor(arr, dtype, device):
    """A checkpoint array as a tensor on ``device``: bfloat16 words
    re-viewed, anything else as its numpy dtype."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def load_checkpoint(executor, dirname, main_program=None, step=None,
                    scope=None, shardings=None, mesh=None):
    """Restore ``dirname/ckpt-<step>`` (default: the ``latest`` pointer's
    step) into the scope, every variable a tensor on the executor's
    device (no executor: the default place's, ``cuda:0``); returns the
    step.  Reads the shard format at any shard count
    (a var's shards concatenated along its saved axis), whether written
    by the port or by the JAX package with ``mesh=``.  The scope
    is only changed after every var loaded.  An orbax checkpoint (the
    JAX package's default format) raises.

    ``mesh``: the mesh the restoring run trains on (every rank of it
    calls this).  ``shard_ckpt.plan_restore`` maps the saved topology
    onto it, and proves the plan, before any shard is read; each var
    becomes a DTensor at its planned placement, the saved pieces
    re-sliced for the new mesh (a dp4 checkpoint restores on dp2).
    ``shardings``: name -> ``P`` partition spec, placing the named vars
    over ``mesh`` (default: the default mesh) and the rest whole, as the
    JAX package's ``shardings`` place the named arrays."""
    from paddle_tpu_torch.fault import chaos, shard_ckpt

    scope = scope or global_scope()
    if step is None:
        with open(os.path.join(dirname, "latest")) as f:
            step = int(f.read().strip())
    path = os.path.abspath(os.path.join(dirname, f"ckpt-{int(step)}"))
    manifest = shard_ckpt.read_manifest(path)
    topology = (manifest or {}).get("topology")
    if topology is None:
        raise ValueError(
            f"{path} has no shard-format manifest (an orbax checkpoint of "
            f"the JAX package, or a torn one?): the port reads the shard "
            f"format only")
    plan = None
    if mesh is not None:
        # plan (and prove) BEFORE touching data
        plan = shard_ckpt.plan_restore(topology, mesh)
    elif shardings:
        from paddle_tpu_torch.parallel.mesh import default_mesh
        mesh = default_mesh()
        plan = {n: tuple(spec) for n, spec in shardings.items()}
    # the restore boundary: restores never mutate committed checkpoints
    chaos.fire("ckpt.restore", step=int(step))
    state = shard_ckpt.read_state(path, topology)
    if executor is not None:
        device = executor.device
    elif mesh is not None:
        device = torch.device("cpu") if mesh.device_type == "cpu" else \
            torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch_device(None)
    tensors = {name: _restored_tensor(arr, dtype, device)
               for name, (arr, dtype) in state.items()}
    if plan is not None:
        from torch.distributed.tensor import distribute_tensor

        from paddle_tpu_torch.parallel.mesh import P, placements
        tensors = {name: distribute_tensor(
            t, mesh, placements(P(*(plan.get(name) or ())), mesh),
            src_data_rank=None) for name, t in tensors.items()}
    for name, value in tensors.items():
        scope.set_var(name, value)
    return int(step)
