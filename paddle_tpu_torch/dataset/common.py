"""Dataset plumbing (the port of ``paddle_tpu.dataset.common``;
reference ``python/paddle/dataset/common.py``:
DATA_HOME cache, md5-checked download, ``cluster_files_reader``,
``convert``)."""

from __future__ import annotations

import hashlib
import os
import pickle
import glob
import shutil

import numpy as np

__all__ = ["DATA_HOME", "download", "md5file", "split", "cluster_files_reader",
           "convert", "synthetic_rng"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Resolve a dataset file: local DATA_HOME cache first (md5-checked,
    reference ``dataset/common.py:download``); when the caller opts in
    (``PADDLE_TPU_DATASET_ONLINE=1``) fetch + verify + cache like the
    reference; otherwise raise so callers fall back to their synthetic
    generators."""
    dirname = os.path.join(DATA_HOME, module_name)
    must_mkdirs(dirname)
    filename = os.path.join(
        dirname, url.split("/")[-1] if save_name is None else save_name)
    if os.path.exists(filename) and (not md5sum or
                                     md5file(filename) == md5sum):
        return filename
    if os.environ.get("PADDLE_TPU_DATASET_ONLINE"):
        import urllib.request
        tmp = filename + ".part"
        try:
            # stream with a connect/read timeout so a stalled connection
            # raises (and the caller falls back to the synthetic
            # generator) instead of hanging the resolver forever
            timeout = float(os.environ.get(
                "PADDLE_TPU_DATASET_TIMEOUT", "60"))
            with urllib.request.urlopen(url, timeout=timeout) as resp, \
                    open(tmp, "wb") as out_f:
                shutil.copyfileobj(resp, out_f)
            # a mid-body connection close returns normally from
            # copyfileobj; catch truncation before publishing (matters
            # when md5sum is falsy and the md5 gate below is skipped)
            want = resp.headers.get("Content-Length")
            if want is not None and os.path.getsize(tmp) != int(want):
                raise IOError(
                    f"truncated download of {url}: got "
                    f"{os.path.getsize(tmp)} of {want} bytes")
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)  # no stale partials in the cache
            raise
        if md5sum and md5file(tmp) != md5sum:
            os.remove(tmp)
            raise RuntimeError(
                f"md5 mismatch downloading {url} (expected {md5sum})")
        os.replace(tmp, filename)  # atomic publish into the cache
        return filename
    raise RuntimeError(
        f"dataset file {filename} not in local cache and downloads are "
        f"disabled (set PADDLE_TPU_DATASET_ONLINE=1 to fetch); synthetic "
        f"fallback will be used")


def synthetic_rng(module_name, split_name="train"):
    """Deterministic per-dataset RNG for synthetic fallbacks."""
    seed = int(hashlib.md5(
        f"{module_name}/{split_name}".encode()).hexdigest()[:8], 16)
    return np.random.RandomState(seed)


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """reference common.py split: chunk a reader into pickle files."""
    indx_f = 0
    lines = []
    for i, d in enumerate(reader()):
        lines.append(d)
        if i >= line_count and i % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
                lines = []
                indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """reference common.py: each trainer reads its modulo-slice of files."""

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        my_file_list = [fn for i, fn in enumerate(file_list)
                        if i % trainer_count == trainer_id]
        for fn in my_file_list:
            with open(fn, "rb") as f:
                lines = loader(f)
                for line in lines:
                    yield line
    return reader


def convert(output_path, reader, line_count, name_prefix):
    """Convert a reader to recordio files (reference common.py convert)."""
    from paddle_tpu_torch.recordio_writer import RecordIOWriter
    indx_f = 0
    lines = []

    def write_data(indx_f, lines):
        filename = "%s/%s-%05d" % (output_path, name_prefix, indx_f)
        with RecordIOWriter(filename) as writer:
            for l in lines:
                writer.write(pickle.dumps(l))

    for i, d in enumerate(reader()):
        lines.append(d)
        if i % line_count == 0 and i >= line_count:
            write_data(indx_f, lines)
            lines = []
            indx_f += 1
    if lines:
        write_data(indx_f, lines)
