"""Length buckets (the part of ``paddle_tpu.lod`` the generation runtime
uses): prompts are padded up to a bucket edge, and a bundle declares the
edges it serves."""

from __future__ import annotations

import numpy as np

__all__ = ["next_bucket", "row_bucket", "bucket_edges", "pad_to_bucket"]

_MIN_BUCKET = 8


def next_bucket(n):
    """Smallest power-of-two bucket >= n (min 8)."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def row_bucket(n, edges=None):
    """Round a row count up to a bucket: the smallest of ``edges`` (a
    sorted iterable) that holds it, else the power-of-two ladder."""
    n = max(int(n), 1)
    if edges:
        for e in edges:
            if n <= int(e):
                return int(e)
    return next_bucket(n)


def bucket_edges(lo, hi, edges=None):
    """The distinct buckets covering row counts in [lo, hi]."""
    out = []
    for n in range(max(int(lo), 1), max(int(hi), 1) + 1):
        b = row_bucket(n, edges)
        if not out or b != out[-1]:
            out.append(b)
    return out


def pad_to_bucket(value, bucket, axis=0):
    """Zero-pad ``value`` along ``axis`` up to ``bucket`` entries (a
    no-op when already that size)."""
    value = np.asarray(value)
    n = value.shape[axis]
    if n > bucket:
        raise ValueError(
            f"cannot pad {n} entries down into a bucket of {bucket}")
    if n == bucket:
        return value
    shape = list(value.shape)
    shape[axis] = bucket - n
    return np.concatenate(
        [value, np.zeros(shape, value.dtype)], axis=axis)
