"""Reader creators/decorators (the port's copy of ``paddle_tpu.reader``;
reference ``python/paddle/reader/``)."""

from paddle_tpu_torch.reader.decorator import (
    map_readers, buffered, compose, chain, shuffle, firstn, xmap_readers,
    cache)
from paddle_tpu_torch.reader import creator
from paddle_tpu_torch.reader import decorator

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "creator", "decorator"]
