"""Continuous-batching autoregressive generation runtime: the two-entry
predictor over a generation bundle and the iteration-level scheduler
that admits and evicts requests between decode steps.  HTTP streaming
lives in ``paddle_tpu_torch/serving.py`` (``/generate``).

``QueueFull``, ``BatcherCrashed`` and ``DeadlineExceeded`` are the
serving module's classes, re-exported: the scheduler and the server
raise the same ones."""

from paddle_tpu_torch.serving import (BatcherCrashed, DeadlineExceeded,
                                      QueueFull)
from paddle_tpu_torch.gen.predictor import GenPredictor, is_gen_bundle
from paddle_tpu_torch.gen.scheduler import (GenScheduler, GenStream,
                                            SchedulerDraining,
                                            StreamMigrated)

__all__ = ["GenPredictor", "GenScheduler", "GenStream",
           "SchedulerDraining", "StreamMigrated", "QueueFull",
           "BatcherCrashed", "DeadlineExceeded", "is_gen_bundle"]
