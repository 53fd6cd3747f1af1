"""Embedding tables (the port of ``paddle_tpu.embedding`` on one
device): the table registry that ``layers.embedding`` fills and the
block row-ownership geometry (``tables``)."""

from paddle_tpu_torch.embedding.tables import (
    register_table, registered_tables, is_table, table_meta,
    rows_per_shard, owner_of, local_row)

__all__ = ["register_table", "registered_tables", "is_table",
           "table_meta", "rows_per_shard", "owner_of", "local_row"]
