"""Multi-rank execution on ``torch.distributed`` (the port's counterpart
of ``paddle_tpu.parallel``): NCCL between cards, gloo on the CPU.

  * ``ParallelExecutor`` (reference ``parallel_executor.cc:53``): the
    executor's op walk on DTensors over a device mesh, the global step
    with data, tensor and ZeRO parallelism (``parallel_executor``).
  * ``DistributeTranspiler``: the pserver rewrite as partition specs
    (``distribute_transpiler``).
  * the ``c_*`` collective IR ops and their helpers (``collective``;
    the ops live in ``ops/collective_ops.py``).
  * ring attention over a ``seq`` axis (``ring_attention``).
  * GPipe over a ``pipe`` axis (``pipeline``: ``gpipe``,
    ``stack_stage_params``) and the pipeline transpiler that splits a
    Program into stages (``pipeline_transpiler``), imported from their
    modules as in the JAX package.
  * the world's bootstrap (``distributed``) and meshes (``mesh``).
  * the Go master's fault-tolerant task dispatch and the serving fleet's
    replica leases (``master``: ``MasterService``, ``MasterServer``,
    ``MasterClient``, ``partition_files``).
"""

from paddle_tpu_torch.parallel.mesh import (P, default_mesh, device_count,
                                            make_mesh, set_default_mesh)
from paddle_tpu_torch.parallel.parallel_executor import ParallelExecutor
from paddle_tpu_torch.parallel.distribute_transpiler import (
    DistributeTranspiler, DistributedSpec)
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel.ring_attention import ring_attention
from paddle_tpu_torch.parallel.distributed import (destroy_parallel_env,
                                                   get_rank, get_world_size,
                                                   global_mesh,
                                                   init_parallel_env)
from paddle_tpu_torch.parallel.zero import ZeroPlan, zero_plan
from paddle_tpu_torch.parallel.master import (MasterClient, MasterServer,
                                              MasterService,
                                              partition_files)

__all__ = ["ParallelExecutor", "default_mesh", "make_mesh", "device_count",
           "set_default_mesh", "DistributeTranspiler", "DistributedSpec",
           "collective", "ring_attention", "init_parallel_env", "get_rank",
           "get_world_size", "global_mesh", "ZeroPlan", "zero_plan", "P",
           "destroy_parallel_env", "MasterService", "MasterServer",
           "MasterClient", "partition_files"]
