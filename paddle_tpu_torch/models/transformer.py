"""The part of ``paddle_tpu.models.transformer`` the serving slice uses:
the sinusoid position table.  The Transformer itself is a training
program and waits for the training slice."""

from __future__ import annotations

import numpy as np

__all__ = ["position_encoding_init"]


def position_encoding_init(n_position, d_model):
    """Sinusoid position encoding table."""
    position = np.arange(n_position)[:, None].astype("float64")
    div = np.exp(np.arange(0, d_model, 2).astype("float64")
                 * -(np.log(10000.0) / d_model))
    table = np.zeros((n_position, d_model))
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div[: d_model // 2])
    return table.astype("float32")
