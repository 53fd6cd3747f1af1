"""Layers DSL (reference ``python/paddle/fluid/layers/``): the parts the
ported slices build their programs with."""

from paddle_tpu_torch.layers import math_op_patch  # applies Variable overloading
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.layers.ops import *  # noqa: F401,F403
from paddle_tpu_torch.layers.io import *  # noqa: F401,F403
from paddle_tpu_torch.layers.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.layers import control_flow  # noqa: F401
from paddle_tpu_torch.layers.sequence import *  # noqa: F401,F403
from paddle_tpu_torch.layers import sequence  # noqa: F401
from paddle_tpu_torch.layers import learning_rate_scheduler  # noqa: F401
from paddle_tpu_torch.layers.learning_rate_scheduler import *  # noqa: F401,F403
from paddle_tpu_torch.layers.detection import *  # noqa: F401,F403
from paddle_tpu_torch.layers import detection  # noqa: F401
from paddle_tpu_torch.layers import nn  # noqa: F401
from paddle_tpu_torch.layers import tensor  # noqa: F401
from paddle_tpu_torch.layers import ops  # noqa: F401
from paddle_tpu_torch.layers import io  # noqa: F401
