"""Embedding-table registry and row-ownership geometry (the port of
``paddle_tpu.embedding.tables``).

Two facts every layer of a sharded-embedding stack must agree on:

* **which parameters are embedding tables**: ``layers.embedding``
  registers every table it creates here;
* **which shard owns a row**: sharding the vocab dim is *block*
  sharding (shard ``k`` holds the contiguous rows ``[k*V/N,
  (k+1)*V/N)``), so ownership is ``id // rows_per_shard``, a divide,
  not a hash.

The JAX package's ``register_table`` also sets the ``embedding.tables``
gauge of its profiler's runtime metrics; the port has no profiler yet,
so it keeps no gauge.  Sharded tables (``sharded_table.py``) wait for
the port's multi-GPU training.
"""

from __future__ import annotations

import numpy as np

__all__ = ["register_table", "registered_tables", "is_table",
           "table_meta", "rows_per_shard", "owner_of", "local_row"]

# name -> {"vocab": int|None, "dim": int|None}; process-wide like the
# op registry: table identity is a property of the program family, not
# of one Program instance
_TABLES = {}


def register_table(name, vocab=None, dim=None):
    """Record ``name`` as an embedding-table parameter (idempotent;
    later registrations may fill in geometry the first one lacked)."""
    meta = _TABLES.setdefault(str(name), {"vocab": None, "dim": None})
    if vocab is not None:
        meta["vocab"] = int(vocab)
    if dim is not None:
        meta["dim"] = int(dim)
    return meta


def registered_tables():
    return {k: dict(v) for k, v in _TABLES.items()}


def is_table(name):
    return str(name) in _TABLES


def table_meta(name):
    meta = _TABLES.get(str(name))
    return dict(meta) if meta else None


def rows_per_shard(vocab, num_shards):
    """Rows each shard holds under block sharding (the vocab must
    divide evenly)."""
    vocab, num_shards = int(vocab), int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if vocab % num_shards != 0:
        raise ValueError(
            f"vocab {vocab} is not divisible by {num_shards} shards: the "
            f"block layout requires it")
    return vocab // num_shards


def owner_of(ids, vocab, num_shards):
    """Owning shard of each id under the block layout (array in, array
    out; scalars work too)."""
    return np.asarray(ids) // rows_per_shard(vocab, num_shards)


def local_row(ids, vocab, num_shards):
    """Row index of each id within its owning shard's block."""
    return np.asarray(ids) % rows_per_shard(vocab, num_shards)
