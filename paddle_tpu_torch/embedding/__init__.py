"""Embedding tables (the port of ``paddle_tpu.embedding``): the table
registry that ``layers.embedding`` fills, the block row-ownership
geometry (``tables``), and row-sharded tables over a mesh, proven by the
PTA016/PTA017 pass (``sharded_table``)."""

from paddle_tpu_torch.embedding.tables import (
    register_table, registered_tables, is_table, table_meta,
    rows_per_shard, owner_of, local_row)
from paddle_tpu_torch.embedding.sharded_table import (
    ShardedTablePlan, plan_sharded_tables, sharded_gather,
    sharded_scatter_add)

__all__ = ["register_table", "registered_tables", "is_table",
           "table_meta", "rows_per_shard", "owner_of", "local_row",
           "ShardedTablePlan", "plan_sharded_tables", "sharded_gather",
           "sharded_scatter_add"]
