"""Op registry + the op lowerings of the ported slices.

Importing this package registers every op type the port lowers (the
counterpart of ``paddle_tpu.ops``).
"""

from paddle_tpu_torch.ops import registry  # noqa: F401
from paddle_tpu_torch.ops import (  # noqa: F401
    math_ops,
    tensor_ops,
    activation_ops,
    logic_ops,
    nn_ops,
    persist_ops,
    attention_ops,
    loss_ops,
    metric_ops,
    optimizer_ops,
    sparse_ops,
    rnn_ops,
    sequence_ops,
    control_flow_ops,
    io_ops,
    reader_ops,
    beam_search_ops,
    fused_ops,
    crf_ops,
    ctc_ops,
    detection_ops,
    csp_ops,
)
