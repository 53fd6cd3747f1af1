"""Device-performance reports (the part of ``paddle_tpu.obs.perf`` the
serving front needs): the :class:`WarmupReport` that ``Executor.warmup``
returns.  The HBM census and the MFU gauge are not ported yet."""

from __future__ import annotations

__all__ = ["WarmupReport"]


class WarmupReport(int):
    """``Executor.warmup``'s return value: the number of kernel sources
    compiled during the warmup (an ``int``), plus a per-bucket
    ``buckets`` list: ``{"signature": {name: shape}, "compiles": n,
    "seconds": s, "cache": "cold" | "persistent-hit" | "warm"}`` —
    ``cold`` when ``nvcc`` compiled a kernel source for that signature,
    ``persistent-hit`` when a kernel library was loaded from the build
    directory, ``warm`` when nothing new was needed.  Surfaced per bucket
    in serving ``/stats``."""

    def __new__(cls, compiles, buckets=()):
        obj = super().__new__(cls, int(compiles))
        obj.buckets = list(buckets)
        return obj

    @staticmethod
    def merge(*reports, **tags):
        """Concatenate reports; ``labels=("prefill", "decode")`` stamps
        ``program: <label>`` onto every bucket of the report at that
        position."""
        labels = tags.pop("labels", None)
        buckets = []
        for i, rep in enumerate(reports):
            for b in getattr(rep, "buckets", ()):
                b = dict(b)
                if labels is not None:
                    b["program"] = labels[i]
                buckets.append(b)
        return WarmupReport(sum(int(r) for r in reports), buckets)
