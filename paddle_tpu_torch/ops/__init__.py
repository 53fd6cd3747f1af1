"""Op registry + the op lowerings of the ported slices.

Importing this package registers every op type the port lowers (the
counterpart of ``paddle_tpu.ops``).
"""

from paddle_tpu_torch.ops import registry  # noqa: F401
from paddle_tpu_torch.ops import (  # noqa: F401
    math_ops,
    tensor_ops,
    activation_ops,
    nn_ops,
    persist_ops,
    attention_ops,
    loss_ops,
    optimizer_ops,
)
