"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The same Program IR and layers DSL as the JAX package, an Executor that
runs a block op by op on torch tensors, and hand-written CUDA kernels
for Hopper where the JAX package had Pallas kernels for the TPU.  Entry
points run on ``cuda:0`` unless the caller passes ``CPUPlace()``.  This
package imports neither JAX nor ``paddle_tpu``.
"""

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import (
    Program, Block, Operator, Variable, Parameter,
    default_main_program, default_startup_program, program_guard,
    switch_main_program, switch_startup_program, unique_name,
)
from paddle_tpu_torch.place import CPUPlace, CUDAPlace, default_place
from paddle_tpu_torch.scope import Scope, global_scope, scope_guard
from paddle_tpu_torch import ops  # registers the op lowerings
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.ops.reader_ops import EOFException
from paddle_tpu_torch import memory_optimization_transpiler
from paddle_tpu_torch.memory_optimization_transpiler import (memory_optimize,
                                                             release_memory)
from paddle_tpu_torch import concurrency
from paddle_tpu_torch.concurrency import (Go, Select, make_channel,
                                          channel_send, channel_recv,
                                          channel_close)
from paddle_tpu_torch.channel import (Channel as CSPChannel,
                                      ChannelClosedError)
from paddle_tpu_torch.backward import append_backward, calc_gradient
from paddle_tpu_torch import initializer
from paddle_tpu_torch.param_attr import ParamAttr, WeightNormParamAttr
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.optimizer import (
    SGD, Momentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp,
    Ftrl, SGDOptimizer, MomentumOptimizer, AdagradOptimizer, AdamOptimizer,
    AdamaxOptimizer, DecayedAdagradOptimizer, AdadeltaOptimizer,
    RMSPropOptimizer, FtrlOptimizer, ModelAverage,
)
from paddle_tpu_torch import regularizer
from paddle_tpu_torch import clip
from paddle_tpu_torch import nets
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch import io
from paddle_tpu_torch.io import (
    save_vars, save_params, save_persistables, load_vars, load_params,
    load_persistables, save_inference_model, load_inference_model,
)
from paddle_tpu_torch import reader
from paddle_tpu_torch import fault
from paddle_tpu_torch import metrics
from paddle_tpu_torch import evaluator
from paddle_tpu_torch import dataset
from paddle_tpu_torch import datapipe
from paddle_tpu_torch import obs

__version__ = "0.1.0"

Tensor = Variable  # convenience alias


def __getattr__(name):
    # the deprecated alias imports (and warns) only on first touch, so a
    # plain `import paddle_tpu_torch` stays warning-free
    import importlib
    if name == "debuger":
        return importlib.import_module("paddle_tpu_torch.debuger")
    # the multi-rank plane imports torch.distributed.tensor: only a
    # process that asks for it pays for that import
    if name == "parallel":
        return importlib.import_module("paddle_tpu_torch.parallel")
    if name == "ParallelExecutor":
        return importlib.import_module(
            "paddle_tpu_torch.parallel").ParallelExecutor
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")
