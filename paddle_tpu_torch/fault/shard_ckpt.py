"""The per-shard checkpoint format (the port's copy of
``paddle_tpu.fault.shard_ckpt``): every persistable tensor is written as
one ``.npy`` file per shard (``shards/<var>/shard-<k>-of-<N>``), and the
manifest carries a **topology record** (mesh shape, axis names, and a
per-var shard map) so a later boot reads the checkpoint's geometry
without loading a tensor.

Without a mesh the port writes this format at world size 1: one shard
a variable, a mesh of one device (``mesh_shape [1]``, axis ``"dp"``),
so the JAX package's ``io.load_checkpoint`` reads it.  With a mesh
(:func:`build_mesh_topology`, :func:`mesh_pieces`) a var named in
``shard_specs`` is cut along its first split dim into as many shards as
that mesh axis has ranks, and each rank writes the shards it owns (the
rank at coordinate 0 of every other axis; a replicated var the mesh's
first rank).  It reads the format at any shard count: the pieces of a
var are concatenated along its saved axis, and :func:`plan_restore`
proves a restore onto another mesh before any shard is read.

bfloat16 has no numpy dtype of its own here: a bfloat16 tensor is
written as its 16-bit words under the ``.npy`` descr ``'<V2'`` (the bytes
``np.save`` writes for an ml_dtypes bfloat16 array in the JAX package)
and restored by the topology's ``dtype`` record.

The commit discipline is the JAX package's: shards land in the
``.tmp-`` dir and ride the manifest → fsync → rename atomic commit
(``fault.checkpoint.commit_checkpoint``), each shard file SHA-256'd in
the manifest.  The ``ckpt.shard.write`` failpoint fires before every
shard write.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from paddle_tpu_torch.fault import chaos

__all__ = ["ReshardError", "SHARD_DIR", "TOPOLOGY_FORMAT",
           "build_topology", "write_state", "read_state",
           "validate_topology", "shard_relpath", "read_manifest",
           "host_state", "build_mesh_topology", "mesh_pieces",
           "write_pieces",
           "plan_restore", "owns_shard"]

SHARD_DIR = "shards"
TOPOLOGY_FORMAT = 1
_BF16_DESCR = "<V2"


class ReshardError(RuntimeError):
    """A checkpoint's shards cannot be reassembled into the shapes its
    topology declares, or a restore plan cannot map the saved topology
    onto the target mesh.  Raised before the scope is touched."""

    retryable = True


def _quote(name):
    return name.replace("/", "%2F")


def shard_relpath(name, k, n):
    """Checkpoint-relative path of shard ``k`` of ``n`` of ``name``."""
    return os.path.join(SHARD_DIR, _quote(name), f"shard-{k}-of-{n}")


def _shard_axis(spec):
    """(axis_index, axis_name) of the first sharded dim, or (None, None)
    for a replicated placement."""
    for d, ax in enumerate(spec or ()):
        if ax is not None:
            return d, ax
    return None, None


def build_topology(state):
    """The manifest topology record for ``state`` (name -> host array,
    bfloat16 as its ``uint16`` words under a ``"bfloat16"`` entry of
    ``dtypes``, see :func:`host_state`) saved at world size 1: every var
    one replicated shard on a one-device ``"dp"`` mesh."""
    arrays, dtypes = state
    shards = {}
    for name in sorted(arrays):
        shards[name] = {
            "shape": [int(d) for d in arrays[name].shape],
            "dtype": dtypes[name],
            "spec": [],
            "axis": None,
            "num_shards": 1,
            "shard_ranks": [0],
        }
    return {
        "format": TOPOLOGY_FORMAT,
        "mesh_shape": [1],
        "axis_names": ["dp"],
        "processes": 1,
        "shards": shards,
    }


def host_state(state):
    """``(arrays, dtypes)`` of a ``name -> tensor or array`` state: host
    numpy copies (bfloat16 as ``uint16`` words) and each one's dtype
    name."""
    from paddle_tpu_torch.convert import to_numpy
    import torch
    arrays, dtypes = {}, {}
    for name, value in state.items():
        bf16 = isinstance(value, torch.Tensor) and \
            value.dtype == torch.bfloat16
        arr = to_numpy(value)
        if arr.dtype.name == "bfloat16":
            arr, bf16 = arr.view(np.uint16), True
        arrays[name] = arr
        dtypes[name] = "bfloat16" if bf16 else str(arr.dtype)
    return arrays, dtypes


def _save_npy(f, piece, dtype):
    """``np.save`` of ``piece``; a bfloat16 var's words under the descr
    the JAX package's ``np.save`` of a bfloat16 array writes."""
    if dtype != "bfloat16":
        np.save(f, piece, allow_pickle=False)
        return
    piece = np.ascontiguousarray(piece)
    np.lib.format.write_array_header_1_0(f, {
        "descr": _BF16_DESCR, "fortran_order": False,
        "shape": piece.shape})
    f.write(piece.tobytes())


def _write_one(path, piece, dtype, name, k, n, step):
    chaos.fire("ckpt.shard.write", var=name, shard=k, step=step)
    from paddle_tpu_torch import profiler as _profiler
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        _save_npy(f, piece, dtype)
        f.flush()
        os.fsync(f.fileno())
    dt = time.perf_counter() - t0
    _profiler.runtime_metrics.inc("ckpt.shard.writes")
    _profiler.runtime_metrics.inc("ckpt.shard.bytes", piece.nbytes)
    _profiler.runtime_metrics.observe("ckpt.shard.write_seconds", dt)
    from paddle_tpu_torch.obs.trace import record_span
    record_span("ckpt.shard.write", t0, dt, var=name, shard=k, of=n)


def write_state(tmp_path, state, topology, step=None):
    """Write ``state`` (``(arrays, dtypes)`` of :func:`host_state`) under
    ``tmp_path/shards/``, one file a variable (the port's topology has
    one shard each), concurrently.  Returns the number of files."""
    arrays, dtypes = state
    jobs = []
    for name in topology["shards"]:
        path = os.path.join(tmp_path, shard_relpath(name, 0, 1))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jobs.append((path, arrays[name], dtypes[name], name, 0, 1))
    if not jobs:
        return 0
    workers = min(8, len(jobs), os.cpu_count() or 1)
    if workers <= 1:
        for job in jobs:
            _write_one(*job, step)
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(_write_one, *job, step) for job in jobs]
            for f in futs:
                f.result()   # surface the first failure (incl. chaos)
    return len(jobs)


def _dtype_name(t):
    """The topology's dtype record of a tensor or array."""
    import torch
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=t.dtype).numpy().dtype)
    return "bfloat16" if t.dtype.name == "bfloat16" else str(t.dtype)


def build_mesh_topology(mesh, state, shard_specs=None):
    """The manifest topology record of ``state`` (name -> tensor, a
    DTensor's global shape) saved on ``mesh`` (a ``DeviceMesh``), the JAX
    package's ``build_topology``: ``shard_specs`` maps names to
    placement tuples (``ZeroPlan.checkpoint_specs()``); unlisted vars,
    and vars whose split dim does not divide, are one replicated
    shard."""
    import torch.distributed as dist
    shard_specs = shard_specs or {}
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shards = {}
    for name in sorted(state):
        value = state[name]
        shape = tuple(int(d) for d in value.shape)
        spec = tuple(shard_specs.get(name) or ())
        axis, axis_name = _shard_axis(spec)
        n = int(axis_sizes.get(axis_name, 1)) if axis_name else 1
        if axis is None or n <= 1 or len(shape) <= axis or \
                shape[axis] % n != 0:
            spec, axis, n = (), None, 1
        shards[name] = {
            "shape": list(shape),
            "dtype": _dtype_name(value),
            "spec": [a if a is None else str(a) for a in spec],
            "axis": axis,
            "num_shards": n,
            "shard_ranks": list(range(n)),
        }
    return {
        "format": TOPOLOGY_FORMAT,
        "mesh_shape": [int(d) for d in mesh.shape],
        "axis_names": [str(a) for a in mesh.mesh_dim_names],
        "processes": dist.get_world_size() if dist.is_initialized() else 1,
        "shards": shards,
    }


def owns_shard(mesh, axis_name=None):
    """``(owner, k)``: whether this rank writes its piece of a var split
    over ``axis_name`` (None: replicated), and that piece's index.  The
    owner is the rank at coordinate 0 of every other mesh axis."""
    coord = mesh.get_coordinate()
    if coord is None:
        return False, 0
    names = list(mesh.mesh_dim_names)
    k = 0 if axis_name is None else coord[names.index(axis_name)]
    owner = all(c == 0 for i, c in enumerate(coord)
                if axis_name is None or names[i] != axis_name)
    return owner, k


def mesh_pieces(state, topology, mesh, clone=False):
    """This rank's owned pieces of ``state`` (name -> tensor or DTensor)
    under ``topology``: ``[(name, k, n, dtype, piece)]``, each piece a
    tensor or array.  A DTensor is first redistributed to its saved split
    (a collective: every rank of the mesh takes part, var by var in name
    order, so it runs on the thread that runs the steps); a plain tensor
    is the whole value and is sliced here.  ``clone``: each piece is
    copied on its device (and the copies waited for) so that it outlives
    the next step's in-place writes, for a write on another thread."""
    import torch
    from torch.distributed.tensor import DTensor
    from paddle_tpu_torch.parallel.mesh import P, placements
    pieces = []
    devices = set()
    for name in sorted(topology["shards"]):
        rec = topology["shards"][name]
        n, axis = rec["num_shards"], rec["axis"]
        axis_name = None if axis is None else rec["spec"][axis]
        owner, k = owns_shard(mesh, axis_name)
        value = state[name]
        if isinstance(value, DTensor):
            spec = [None] * len(rec["shape"])
            if axis is not None:
                spec[axis] = axis_name
            value = value.redistribute(
                mesh, placements(P(*spec), mesh)).to_local()
        elif axis is not None:
            size = rec["shape"][axis] // n
            value = value.narrow(axis, k * size, size) \
                if hasattr(value, "narrow") else \
                np.take(value, range(k * size, (k + 1) * size), axis=axis)
        if not owner:
            continue
        if clone:
            if isinstance(value, torch.Tensor):
                if value.is_cuda:
                    devices.add(value.device)
                value = value.detach().clone()
            else:
                value = np.array(value)
        pieces.append((name, k, n, rec["dtype"], value))
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    return pieces


def write_pieces(tmp_path, pieces, step=None):
    """Write :func:`mesh_pieces` under ``tmp_path/shards/``, concurrently:
    host copies and files only, no collective, so it may run on a writer
    thread.  Returns the number of files written."""
    from paddle_tpu_torch.convert import to_numpy
    jobs = []
    for name, k, n, dtype, value in pieces:
        piece = to_numpy(value)
        if piece.dtype.name == "bfloat16":
            piece = piece.view(np.uint16)
        path = os.path.join(tmp_path, shard_relpath(name, k, n))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jobs.append((path, piece, dtype, name, k, n))
    if not jobs:
        return 0
    workers = min(8, len(jobs), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = [pool.submit(_write_one, *job, step) for job in jobs]
        for f in futs:
            f.result()   # surface the first failure (incl. chaos)
    return len(jobs)


def plan_restore(topology, mesh):
    """Map a saved topology onto ``mesh``: the restore plan, name ->
    placement tuple, statically verified against the new mesh (axis
    exists, dims divide) through the PTA016 facts
    (``analysis.distributed._validate_spec``) BEFORE any shard is read;
    raises :class:`ReshardError` with every violation (the JAX package's
    ``plan_restore``, ``paddle_tpu/fault/shard_ckpt.py:266``)."""
    chaos.fire("ckpt.reshard", mesh_shape=[int(d) for d in mesh.shape])
    from paddle_tpu_torch.analysis.distributed import _validate_spec
    axis_sizes = {str(a): int(s) for a, s in
                  zip(mesh.mesh_dim_names, mesh.shape)}
    plan = {}
    diags = []
    resliced = 0
    for name, rec in sorted(topology["shards"].items()):
        spec = tuple(a if a is None else str(a)
                     for a in rec.get("spec") or ())
        shape = tuple(int(d) for d in rec.get("shape") or ())
        _validate_spec(name, spec, shape, axis_sizes, diags,
                       program="restore-plan")
        plan[name] = spec
        _, axis_name = _shard_axis(spec)
        if axis_name is not None and \
                axis_sizes.get(axis_name) != rec.get("num_shards"):
            resliced += 1
    if diags:
        raise ReshardError(
            "restore plan does not map the saved topology "
            f"(mesh {topology.get('mesh_shape')} "
            f"{topology.get('axis_names')}) onto the target mesh "
            f"({[int(d) for d in mesh.shape]} "
            f"{list(mesh.mesh_dim_names)}):\n"
            + "\n".join(d.format() for d in diags))
    from paddle_tpu_torch import profiler as _profiler
    _profiler.runtime_metrics.inc("reshard.plans")
    _profiler.runtime_metrics.inc("reshard.vars", resliced)
    return plan


def _load_npy(path, dtype):
    """A shard's array; a bfloat16 var's as its ``uint16`` words (written
    by either package: descr ``'<V2'``, or words)."""
    arr = np.load(path, allow_pickle=False)
    if dtype == "bfloat16" and arr.dtype != np.uint16:
        if arr.dtype.itemsize != 2:
            raise ReshardError(f"{path}: a bfloat16 shard of "
                               f"{arr.dtype} elements")
        arr = arr.view(np.uint16)
    return arr


def read_state(path, topology, names=None):
    """Reassemble host arrays from a committed shard checkpoint: the
    shards of each var concatenated along its saved axis.  Returns
    ``name -> (array, dtype name)``, bfloat16 as ``uint16`` words.
    Reads only: callers commit to the scope after every var loaded."""
    out = {}
    for name, rec in topology["shards"].items():
        if names is not None and name not in names:
            continue
        n, axis = rec["num_shards"], rec["axis"]
        dtype = rec.get("dtype")
        pieces = [_load_npy(os.path.join(path, shard_relpath(name, k, n)),
                            dtype)
                  for k in rec["shard_ranks"]]
        arr = pieces[0] if axis is None else np.concatenate(pieces,
                                                            axis=axis)
        want = tuple(rec["shape"])
        if arr.shape != want:
            raise ReshardError(
                f"checkpoint var `{name}` reassembles to {arr.shape} "
                f"but the topology declares {want}")
        out[name] = (arr, dtype)
    return out


def validate_topology(manifest):
    """Self-consistency problems of a manifest's topology record, as a
    list of strings (empty = consistent).  Cross-checks the record
    against the manifest's own file table: every declared shard file
    must be checksummed, shard counts must match the saved mesh axis
    they ride, and shapes must slice evenly."""
    problems = []
    topo = manifest.get("topology")
    if not isinstance(topo, dict):
        return ["manifest has no topology record"]
    if topo.get("format") != TOPOLOGY_FORMAT:
        problems.append(f"topology format must be {TOPOLOGY_FORMAT}, "
                        f"got {topo.get('format')!r}")
    mesh_shape = topo.get("mesh_shape")
    axis_names = topo.get("axis_names")
    if not isinstance(mesh_shape, list) or not mesh_shape or \
            not all(isinstance(d, int) and d > 0 for d in mesh_shape):
        problems.append(f"mesh_shape must be positive ints, "
                        f"got {mesh_shape!r}")
        mesh_shape = []
    if not isinstance(axis_names, list) or \
            len(axis_names) != len(mesh_shape):
        problems.append(f"axis_names {axis_names!r} do not label "
                        f"mesh_shape {mesh_shape!r}")
        axis_names = []
    axis_sizes = dict(zip(axis_names, mesh_shape))
    files = manifest.get("files", {})
    shards = topo.get("shards")
    if not isinstance(shards, dict):
        return problems + ["topology.shards must be an object"]
    for name, rec in sorted(shards.items()):
        where = f"shards[{name!r}]"
        n = rec.get("num_shards")
        axis = rec.get("axis")
        shape = rec.get("shape") or []
        spec = rec.get("spec") or []
        if not isinstance(n, int) or n < 1:
            problems.append(f"{where}: bad num_shards {n!r}")
            continue
        if rec.get("shard_ranks") != list(range(n)):
            problems.append(f"{where}: shard_ranks must be "
                            f"0..{n - 1}, got {rec.get('shard_ranks')!r}")
        if axis is not None:
            if not isinstance(axis, int) or not \
                    (0 <= axis < len(shape)):
                problems.append(f"{where}: axis {axis!r} out of range "
                                f"for shape {shape}")
            elif shape[axis] % n != 0:
                problems.append(f"{where}: dim {axis} of {shape[axis]} "
                                f"does not slice into {n} shards")
            _, axis_name = _shard_axis(spec)
            if axis_name is not None and \
                    axis_sizes.get(axis_name) not in (None, n):
                problems.append(
                    f"{where}: {n} shards ride mesh axis "
                    f"`{axis_name}` of size {axis_sizes[axis_name]}")
        elif n != 1:
            problems.append(f"{where}: replicated var with {n} shards")
        for k in range(n):
            rel = shard_relpath(name, k, n)
            if rel not in files:
                problems.append(f"{where}: shard file {rel!r} missing "
                                f"from the manifest file table")
    # the reverse direction: a shard file the topology does not declare
    declared = {shard_relpath(name, k, rec["num_shards"])
                for name, rec in shards.items()
                if isinstance(rec.get("num_shards"), int)
                for k in range(max(rec["num_shards"], 0))}
    for rel in files:
        if rel.startswith(SHARD_DIR + os.sep) and rel not in declared:
            problems.append(f"undeclared shard file {rel!r}")
    return problems


def read_manifest(path):
    """The committed manifest of checkpoint dir ``path`` (or None when
    absent/unreadable) — the cheap format probe restore uses."""
    from paddle_tpu_torch.fault.checkpoint import MANIFEST_NAME
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
