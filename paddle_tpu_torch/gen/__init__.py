"""Continuous-batching autoregressive generation runtime: the two-entry
predictor over a generation bundle and the iteration-level scheduler
that admits and evicts requests between decode steps."""

from paddle_tpu_torch.gen.predictor import GenPredictor, is_gen_bundle
from paddle_tpu_torch.gen.scheduler import (BatcherCrashed,
                                            DeadlineExceeded, GenScheduler,
                                            GenStream, QueueFull)

__all__ = ["GenPredictor", "GenScheduler", "GenStream", "QueueFull",
           "BatcherCrashed", "DeadlineExceeded", "is_gen_bundle"]
