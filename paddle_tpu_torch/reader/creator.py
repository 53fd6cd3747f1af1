"""Reader creators (the port's copy of ``paddle_tpu.reader.creator``;
reference ``python/paddle/reader/creator.py``)."""

from __future__ import annotations

__all__ = ["np_array", "text_file", "recordio", "cloud_reader"]


def np_array(x):
    def reader():
        if x.ndim < 1:
            yield x
        for e in x:
            yield e
    return reader


def text_file(path):
    def reader():
        with open(path) as f:
            for l in f:
                yield l.rstrip("\n")
    return reader


def recordio(paths, buf_size=100):
    """Read pickled samples from recordio files (native scanner)."""
    import pickle

    from paddle_tpu_torch.recordio_writer import RecordIOScanner

    def reader():
        if isinstance(paths, str):
            path_list = paths.split(",")
        else:
            path_list = list(paths)
        for path in path_list:
            for rec in RecordIOScanner(path):
                yield pickle.loads(rec)
    return reader


def cloud_reader(master_addr, pass_num=1, timeout=30.0):
    """Fault-tolerant cluster reader over the master service's task
    leases (``paddle_tpu/reader/creator.py:46``).  It needs the fleet
    master (``parallel/master.py``), which the port lacks."""
    raise NotImplementedError(
        "reader.creator.cloud_reader needs the fleet master "
        "(parallel/master.py), not ported yet: ROADMAP queue 1 item 8")
