"""Forming the world of ranks (the port's counterpart of
``paddle_tpu.parallel.distributed``, which calls
``jax.distributed.initialize``).

Every rank runs the same program; :func:`init_parallel_env` joins it to
a ``torch.distributed`` process group: NCCL on ``cuda:<local rank>``, or
gloo for a ``CPUPlace()``.  Without CUDA and without ``CPUPlace()`` it
raises, as ``Executor`` does.  Each field resolves in the JAX package's
order: the explicit argument, then the reference's environment
(``PADDLE_COORDINATOR`` or the first host of ``PADDLE_INIT_PSERVERS``
at port 8357, ``PADDLE_INIT_TRAINER_ID`` / ``PADDLE_TRAINER_ID`` /
``TRAINER_ID``, ``PADDLE_INIT_NUM_GRADIENT_SERVERS`` /
``PADDLE_TRAINERS`` / ``TRAINERS``), then torch's own (``MASTER_ADDR``
and ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).  With none of them set
the world is this one process, rendezvousing on a free local port.

Unlike the JAX package, whose single-host branch swallows every
exception of the initialization (``paddle_tpu/parallel/distributed.py``),
a failed ``init_process_group`` raises here.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from paddle_tpu_torch.place import CPUPlace, CUDAPlace

__all__ = ["init_parallel_env", "destroy_parallel_env", "get_rank",
           "get_world_size", "global_mesh", "local_rank"]


def _env(*names):
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _coordinator():
    addr = _env("PADDLE_COORDINATOR")
    if addr is None:
        pservers = _env("PADDLE_INIT_PSERVERS")
        if pservers:
            addr = pservers.split(",")[0] + ":8357"
    if addr is None and _env("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:" \
               f"{os.environ.get('MASTER_PORT', '29500')}"
    return addr


def local_rank(process_id=0, local_device_ids=None):
    """The card index of this rank: ``local_device_ids[0]``, else
    ``LOCAL_RANK``, else the rank modulo the cards present."""
    if local_device_ids:
        return int(local_device_ids[0])
    lr = _env("LOCAL_RANK")
    if lr is not None:
        return int(lr)
    n = torch.cuda.device_count()
    return int(process_id) % n if n else 0


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None, local_device_ids=None, place=None,
                      init_method=None, timeout_s=300):
    """Join this process to the world (reference analog: trainer startup
    with NCCL init).  ``place``: ``CPUPlace()`` for a gloo world on the
    CPU; otherwise NCCL on ``cuda:<local rank>``.  ``init_method``: a
    ``torch.distributed`` URL (``file://...`` for a rendezvous through a
    file) in place of the coordinator's ``tcp://`` address.  A second
    call is a no-op.  Returns the rank."""
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes is None:
        t = _env("PADDLE_INIT_NUM_GRADIENT_SERVERS", "PADDLE_TRAINERS",
                 "TRAINERS", "WORLD_SIZE")
        num_processes = int(t) if t else None
    if process_id is None:
        t = _env("PADDLE_INIT_TRAINER_ID", "PADDLE_TRAINER_ID",
                 "TRAINER_ID", "RANK")
        process_id = int(t) if t else None
    if coordinator_address is None and init_method is None:
        coordinator_address = _coordinator()
    if coordinator_address is None and init_method is None:
        if num_processes not in (None, 1):
            raise RuntimeError(
                f"init_parallel_env: {num_processes} processes but no "
                f"coordinator address (PADDLE_COORDINATOR or MASTER_ADDR)")
        coordinator_address = f"127.0.0.1:{_free_port()}"
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if init_method is None:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if isinstance(place, CPUPlace):
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: CUDA is not available (pass "
                "place=CPUPlace() for a gloo world on the CPU)")
        backend = "nccl"
        if place is None:
            place = CUDAPlace(local_rank(rank, local_device_ids))
        device = place.torch_device()
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **kwargs)
    return rank


def destroy_parallel_env():
    """Leave the world (``destroy_process_group``) and forget the default
    mesh, so that a process exits cleanly or forms another world."""
    from paddle_tpu_torch.parallel import mesh as _mesh
    _mesh.set_default_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(mesh_shape=None, axis_names=None):
    """Mesh over every rank of the world; 1-D data parallel by default."""
    from paddle_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(mesh_shape, axis_names)
