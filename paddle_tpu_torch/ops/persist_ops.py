"""``save`` / ``load`` / ``save_combine`` / ``load_combine``: persistence
as IR ops (the port's counterpart of ``paddle_tpu.ops.persist_ops``;
reference ``save_op.cc:1-130``, ``load_op.cc:1-87``,
``save_load_combine_op_test.cc``).

The on-disk record format is the JAX package's, re-implemented here with
numpy and torch so bundles cross between the two packages unchanged:

  record := magic b"PTT0" | u32 header_len | JSON header | raw bytes
  header := {"dtype": str, "shape": [int], "lod": [[int]], "name": str}

Data is little-endian C-order; bfloat16 is stored as uint16 words with
dtype "bfloat16" in the header.  A combined file holds one record per
variable, in the order of the X/Out slots; ``save`` / ``load`` one
record a file, its LoD written from, and read into, the run's LoD map
(as the JAX package's ``save`` / ``load`` do).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.ops.registry import register_op

MAGIC = b"PTT0"


def write_tensor(f, value, lod=None, name=None):
    """Append one tensor record (a tensor or numpy array) to an open
    binary file."""
    bf16 = isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16
    arr = to_numpy(value)
    if arr.dtype.name == "bfloat16":
        arr, bf16 = arr.view(np.uint16), True
    hdr = {
        "dtype": "bfloat16" if bf16 else str(arr.dtype),
        "shape": list(arr.shape),
        "lod": [list(map(int, level)) for level in (lod or [])],
    }
    if name is not None:
        hdr["name"] = str(name)
    header = json.dumps(hdr).encode("utf-8")
    f.write(MAGIC)
    f.write(struct.pack("<I", len(header)))
    f.write(header)
    f.write(np.ascontiguousarray(arr).tobytes())


def _read_header(f):
    magic = f.read(4)
    if magic != MAGIC:
        raise ValueError(
            f"bad tensor file: magic {magic!r} != {MAGIC!r} (wrong file "
            f"or unsupported version)")
    (hdr_len,) = struct.unpack("<I", f.read(4))
    header = json.loads(f.read(hdr_len).decode("utf-8"))
    shape = tuple(header["shape"])
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    itemsize = 2 if header["dtype"] == "bfloat16" else \
        np.dtype(header["dtype"]).itemsize
    return header, shape, n, itemsize


def read_tensor(f):
    """Read one record; returns ``(tensor on the CPU, lod-list)``."""
    header, shape, n, itemsize = _read_header(f)
    raw = f.read(itemsize * n)
    if header["dtype"] == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        t = torch.from_numpy(words).view(torch.bfloat16)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(header["dtype"]))
        t = torch.from_numpy(arr.reshape(shape).copy())
    return t, header.get("lod", [])


def read_record_names(path):
    """Recorded names of a combined file, in order (payloads are seeked
    over, not read)."""
    names = []
    with open(path, "rb") as f:
        while f.read(4):
            f.seek(-4, 1)
            header, _, n, itemsize = _read_header(f)
            names.append(header.get("name"))
            f.seek(n * itemsize, 1)
    return names


def _prepare_path(path, overwrite):
    if os.path.exists(path) and not overwrite:
        raise RuntimeError(
            f"save: {path!r} exists and overwrite is disabled "
            f"(reference save_op.cc PADDLE_ENFORCE)")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _lod_of(ctx, name):
    lod = ctx.aux.get("lod", {}).get(name)
    return lod if isinstance(lod, list) else None


@register_op("save", no_gradient=True, eager_only=True)
def save_lower(ctx):
    """One variable -> one file (reference ``save_op.cc:1-130``)."""
    path = ctx.attr("file_path")
    _prepare_path(path, ctx.attr("overwrite", True))
    name = ctx.op.input("X")[0]
    with open(path, "wb") as f:
        write_tensor(f, ctx.env[name], _lod_of(ctx, name), name=name)


@register_op("load", no_gradient=True, eager_only=True)
def load_lower(ctx):
    """One file -> one variable on the run's device (reference
    ``load_op.cc:1-87``)."""
    with open(ctx.attr("file_path"), "rb") as f:
        t, lod = read_tensor(f)
    name = ctx.op.output("Out")[0]
    ctx.outputs[name] = t.to(ctx.device)
    if lod:
        ctx.aux.setdefault("lod", {})[name] = lod


@register_op("save_combine", no_gradient=True,
             eager_only=True)
def save_combine_lower(ctx):
    """All X inputs, in slot order, into one file."""
    path = ctx.attr("file_path")
    _prepare_path(path, ctx.attr("overwrite", True))
    with open(path, "wb") as f:
        for name in ctx.op.input("X"):
            write_tensor(f, ctx.env[name], name=name)


@register_op("load_combine", no_gradient=True,
             eager_only=True)
def load_combine_lower(ctx):
    """One file -> all Out outputs, in slot order, on the run's device."""
    with open(ctx.attr("file_path"), "rb") as f:
        for name in ctx.op.output("Out"):
            t, _ = read_tensor(f)
            ctx.outputs[name] = t.to(ctx.device)
