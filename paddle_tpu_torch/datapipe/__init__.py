"""paddle_tpu_torch.datapipe: the async sharded input pipeline with
device prefetch and checkpointable iterators (the port's counterpart of
``paddle_tpu.datapipe``; docs/data_pipeline.md).

Compose stages fluently from a sharded source::

    import paddle_tpu_torch.datapipe as dp

    pipe = (dp.InMemorySource(samples, num_shards=4, shard_index=rank)
              .shuffle(buffer_size=1024, seed=7)
              .map(decode, workers=4)
              .batch(32, pad_to_bucket=True)
              .prefetch(depth=2))            # onto cuda:0

    for batch in pipe:            # one epoch; iterate again for the next
        exe.run(main, feed=batch, fetch_list=[loss])

or drive it with ``Executor.run_pipeline``.  ``pipe.state_dict()`` /
``pipe.load_state_dict()`` capture the exact mid-epoch position (shard
offsets, shuffle RNG + buffer, in-flight samples), in the JAX package's
format: a state either package writes loads in the other.  Hand the
pipeline to ``fault.CheckpointManager(datapipe=pipe)`` and a killed
trainer resumes with the identical sample sequence.  Every stage reports
``datapipe.*`` throughput/stall/queue-depth metrics into
``profiler.runtime_metrics``.  ``prefetch`` places batches on
``cuda:0`` unless given ``device="cpu"`` (or a ``CPUPlace``), and
raises without CUDA.
"""

from paddle_tpu_torch.datapipe.core import Stage, PipelineStateError, stats
from paddle_tpu_torch.datapipe.sources import (Source, InMemorySource,
                                               FileSource, RecordIOSource)
from paddle_tpu_torch.datapipe.stages import (Shuffle, ParallelMap, Batch,
                                              ShardIds, default_collate)
from paddle_tpu_torch.datapipe.prefetch import DevicePrefetch

__all__ = [
    "Stage", "PipelineStateError", "stats",
    "Source", "InMemorySource", "FileSource", "RecordIOSource",
    "Shuffle", "ParallelMap", "Batch", "ShardIds", "default_collate",
    "DevicePrefetch",
]
