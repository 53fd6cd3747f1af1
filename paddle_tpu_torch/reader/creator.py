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
    """Fault-tolerant cluster reader: lease record-file tasks from the
    master service, read them, report completion (reference
    ``python/paddle/v2/reader/creator.py`` cloud_reader over the etcd
    master client, ``v2/master/client.py:29``).  A task whose read fails
    is reported failed and will be re-leased (to this or another
    trainer) up to the master's failure_max."""
    import pickle
    import time

    from paddle_tpu_torch.parallel.master import MasterClient
    from paddle_tpu_torch.recordio_writer import RecordIOScanner

    def reader():
        client = MasterClient(master_addr, timeout=timeout)
        try:
            for pass_idx in range(pass_num):
                if pass_idx > 0:
                    # re-seed the drained queue (single-coordinator pass
                    # semantics: this reader drives the epoch boundary)
                    client.reset_pass()
                while True:
                    task = client.get_task()
                    if task is None:
                        if client.all_done():
                            break
                        time.sleep(0.05)  # tasks may return via timeout
                        continue
                    try:
                        for path in task.chunks:
                            for rec in RecordIOScanner(path):
                                yield pickle.loads(rec)
                    except GeneratorExit:
                        raise
                    except Exception:
                        # report + continue: the master re-leases the task
                        # (up to failure_max) to this or another trainer
                        client.task_failed(task.id, task.epoch)
                        continue
                    client.task_finished(task.id, task.epoch)
        finally:
            client.close()
    return reader
