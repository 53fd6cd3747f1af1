"""LoD (level of detail): ragged batches fed flat as ``[N, ...]`` with
their row splits beside them (the port of ``paddle_tpu.lod``'s static
part; reference ``paddle/fluid/framework/lod_tensor.h``).

A LoD is host metadata: a list of levels, each a list of row splits
(``[0, 3, 5, 9]`` = three sequences of 3, 2 and 4 rows), the last level
indexing rows.  Sequence and RNN lowerings turn it into index tables
(segment ids, flat <-> padded ``[T, B]`` gathers) with :func:`tables`,
which builds each table once per LoD per run on the run's device and
caches it in the run's ``aux``: the auto-vjp recompute of a grad op and
every later op of the step reuse it, and no lowering reads a device
tensor back to the host to learn a size.

Length buckets: prompts are padded up to a bucket edge, and a bundle
declares the edges it serves.  The bucketed dynamic-LoD mode of the JAX
package (``DynLoD``, ``bucket_ragged_feed``) is not ported: the port's
executor raises on it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["next_bucket", "row_bucket", "bucket_edges",
           "select_bucket_edges", "pad_to_bucket", "validate_lod",
           "freeze", "tables", "SegmentTables", "PadTables",
           "segment_tables", "pad_tables", "gather_index", "take_rows"]

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


def select_bucket_edges(counts, max_edges=4, cost_of=None):
    """Cost-optimal bucket edges for an observed size distribution.

    ``counts``: observed row counts / lengths (repeats = frequency).
    ``cost_of(edge) -> cost`` prices one dispatch padded to ``edge``
    (default: the padded size itself).  Chooses at most ``max_edges``
    edges, each an observed value, minimizing ``sum_n freq(n) *
    cost_of(edge(n))`` by interval dynamic programming; returns them
    sorted, for :func:`row_bucket` / :func:`bucket_edges`."""
    freq = {}
    for n in counts:
        n = max(int(n), 1)
        freq[n] = freq.get(n, 0) + 1
    if not freq:
        return []
    values = sorted(freq)
    cost_of = cost_of or (lambda e: float(e))
    k = min(int(max_edges), len(values))
    # pad[i][j]: every observation in values[i..j] padded to values[j];
    # best[j][e]: least cost covering values[0..j] with e edges, the last
    # at values[j]
    m = len(values)
    pad = [[0.0] * m for _ in range(m)]
    for j in range(m):
        c = float(cost_of(values[j]))
        acc = 0.0
        for i in range(j, -1, -1):
            acc += freq[values[i]] * c
            pad[i][j] = acc
    inf = float("inf")
    best = [[inf] * (k + 1) for _ in range(m)]
    choice = [[None] * (k + 1) for _ in range(m)]
    for j in range(m):
        best[j][1] = pad[0][j]
    for e in range(2, k + 1):
        for j in range(e - 1, m):
            for i in range(e - 2, j):
                c = best[i][e - 1] + pad[i + 1][j]
                if c < best[j][e]:
                    best[j][e] = c
                    choice[j][e] = i
    e = min(range(1, k + 1), key=lambda e: best[m - 1][e])
    edges = []
    j = m - 1
    while e >= 1:
        edges.append(values[j])
        prev = choice[j][e]
        if e == 1 or prev is None:
            break
        j, e = prev, e - 1
    return sorted(edges)


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


# ---------------------------------------------------------------------------
# static LoD: validation and the index tables the ops share
# ---------------------------------------------------------------------------

def validate_lod(name, lod, rows):
    """A fed LoD as lists of ints, checked against the value's ``rows``:
    every level starts at 0 and never decreases, each upper level ends at
    the sequence count of the level below, and the last level ends at
    ``rows``.  Raises ``ValueError`` naming the feed otherwise."""
    levels = [[int(s) for s in level] for level in lod]
    if not levels:
        raise ValueError(f"feed {name!r}: empty LoD")
    for i, sp in enumerate(levels):
        if not sp or sp[0] != 0 or any(b < a for a, b in zip(sp, sp[1:])):
            raise ValueError(
                f"feed {name!r}: LoD level {i} {sp} must start at 0 and "
                f"never decrease")
        last = i == len(levels) - 1
        below = rows if last else len(levels[i + 1]) - 1
        if sp[-1] != below:
            raise ValueError(
                f"feed {name!r}: LoD level {i} ends at {sp[-1]}, but "
                f"{'the value has' if last else 'the next level holds'} "
                f"{below} rows")
    return levels


def freeze(lod):
    """A LoD as nested tuples (a cache key)."""
    return tuple(tuple(int(s) for s in level) for level in lod)


def tables(aux, kind, lod, device, build, *params):
    """The ``kind`` table of ``lod`` (and ``params``) on ``device``:
    ``build()`` once per run, then the cached one (``aux["lod_tables"]``;
    ``aux`` is the run's, so a new step with a new LoD builds afresh)."""
    cache = aux.setdefault("lod_tables", {})
    key = (kind, freeze(lod), str(device)) + params
    t = cache.get(key)
    if t is None:
        t = cache[key] = build()
    return t


def gather_index(idx, n):
    """Row indices as a gather over ``n`` rows reads them in the JAX
    package: a negative index counts from the end, then every index is
    clamped into ``[0, n)`` (so a ``splits``-based read of an empty
    sequence picks a neighbour's row, as the reference does, instead of
    faulting on the card).  Returns ``(indices, clamped)``: ``clamped``
    marks the indices that were out of range (their rows take no grad:
    the reference's scatter-add drops them), None when none was."""
    idx = np.asarray(idx, np.int64)
    idx = np.where(idx < 0, idx + n, idx)
    clamped = (idx < 0) | (idx >= n)
    return (np.clip(idx, 0, max(n - 1, 0)),
            clamped if clamped.any() else None)


def take_rows(x, idx, clamped=None):
    """``x[idx]`` on device index tables from :func:`gather_index`: a row
    read through a clamped index keeps its value but passes no grad back,
    as in the JAX package."""
    out = x.index_select(0, idx)
    if clamped is not None:
        out = torch.where(clamped.view((-1,) + (1,) * (out.ndim - 1)),
                          out.detach(), out)
    return out


class SegmentTables:
    """One LoD level on a device: ``seg`` ``[N]`` (the sequence of each
    row), ``lengths`` ``[B]``, ``first`` and ``last`` (each sequence's
    first and last row, ``(indices, clamped)`` for :func:`take_rows`, read
    as :func:`gather_index` reads them), and the host-side ``num`` (B),
    ``splits`` and ``lens``."""

    def __init__(self, lod, level, device):
        splits = np.asarray(lod[level], np.int64)
        lens = np.diff(splits)
        n = int(splits[-1])
        self.num = len(lens)
        self.splits = splits
        self.lens = lens
        self.seg = torch.as_tensor(np.repeat(np.arange(self.num), lens),
                                   device=device)
        self.lengths = torch.as_tensor(lens, device=device)
        self.first, self.last = (
            tuple(None if t is None else torch.as_tensor(t, device=device)
                  for t in gather_index(rows, n))
            for rows in (splits[:-1], splits[1:] - 1))


def segment_tables(aux, lod, device, level=-1):
    """:class:`SegmentTables` of ``lod``'s ``level``, cached for the run."""
    level = level % len(lod)
    return tables(aux, "segments", lod, device,
                  lambda: SegmentTables(lod, level, device), level)


class PadTables:
    """Flat ragged ``[N, ...]`` <-> time-major padded ``[T, B, ...]``
    (the last LoD level; ``T`` = the longest sequence, at least 1):

    * ``gather`` ``[T, B]``: the flat row at step t of sequence b, or N
      (a zero row appended below the flat rows) past its end; with
      ``is_reverse`` step t reads row ``len_b - 1 - t`` of sequence b,
      so each sequence reverses inside its own length;
    * ``scatter`` ``[N]``: each flat row's slot ``t * B + b`` in the
      padded rows;
    * ``live`` ``[T, B, 1]`` bool: step t is inside sequence b."""

    def __init__(self, lod, is_reverse, device):
        splits = np.asarray(lod[-1], np.int64)
        lens = np.diff(splits)
        B, N = len(lens), int(splits[-1])
        T = max(int(lens.max()) if B else 0, 1)
        t = np.arange(T)[:, None]                          # [T, 1]
        live = t < lens[None, :]                           # [T, B]
        off = (lens[None, :] - 1 - t) if is_reverse else \
            np.broadcast_to(t, (T, B))
        gather = np.where(live, splits[:-1][None, :] + off, N)
        scatter = np.zeros(N, np.int64)
        slots = t * B + np.arange(B)[None, :]
        scatter[gather[live]] = slots[live]
        self.B, self.T, self.N = B, T, N
        self.lens = lens
        self.gather = torch.as_tensor(gather, device=device)
        self.scatter = torch.as_tensor(scatter, device=device)
        self.live = torch.as_tensor(live[:, :, None], device=device)


def pad_tables(aux, lod, device, is_reverse=False):
    """:class:`PadTables` of ``lod``, cached for the run."""
    return tables(aux, "pad", lod, device,
                  lambda: PadTables(lod, bool(is_reverse), device),
                  bool(is_reverse))
