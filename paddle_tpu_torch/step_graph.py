"""The executor's step as one CUDA graph per signature (the port's
counterpart of the JAX package's ``jax.jit`` of the step,
``paddle_tpu/executor.py:1271``).

A :class:`StepGraph` is the ``fn`` of a :class:`~paddle_tpu_torch.
executor._CompiledBlock` on the card.  Its first call runs the step
eagerly as a real step (kernels are built, cuBLAS handles made, the
allocator warmed) and records the random draws it made; its second
call captures the step into a ``torch.cuda.CUDAGraph`` and replays it;
every later call replays.  So a startup program, or a signature seen
once, never pays a capture.

* **Buffers.**  The graph reads the scope's own state tensors (captured
  by address) and static feed buffers (allocated outside the capture;
  each call copies its feeds in).  The new values of the written state
  are ``copy_``'d into the state tensors as the graph's last nodes (the
  reference donates those buffers to its jit), skipped where the new
  value is the buffer itself (``paged_attention`` updates the pool in
  place); a new value or a fetch that shares storage with a written
  buffer is cloned first, so no copy reads what another wrote.  Under
  ``check_nan_inf`` or a sentinel the copies run after the replay
  instead, once the check passed; a guarded step's sparse optimizer
  branches also copy out the rows they are about to write in place, and
  a check that fails puts them back (:func:`undoer`), so the scope keeps
  its pre-step state.  Before a replay, a state whose scope tensor is no
  longer the captured one (a user's ``set_var``, a load, the
  predictor's pool restore) is copied in and the scope pointed back at
  the buffer; one of another shape or dtype raises.  ``ParallelExecutor``'s
  state is DTensors: the graph reads and writes their local shards, and
  a new value is written back only at its buffer's placement.
* **Memory.**  Every graph of one executor captures into one pool
  (``torch.cuda.graph_pool_handle``).  The executor serializes replays,
  and no pool tensor outlives one: the executor clones or converts the
  fetches before the next replay and the state is copied out.
* **Randomness.**  Each random draw of the step takes its own device
  generator (``registry.LowerContext.generator``).  The graph keeps one
  generator per draw of its eager run, registered with it
  (``register_generator_state``), and before each replay seeds each with
  the value the eager step would give it (``manual_seed`` also puts its
  offset back to 0, where a fresh generator starts), so a graphed step
  draws the eager step's masks bit for bit.
* **Launch counts.**  A kernel launched during the capture is tallied
  for the graph (``kernels.build.capture_launches``), not counted; each
  replay adds the tally to the kernels' ``launches``.
* **Failures.**  A capture runs in ``capture_error_mode="thread_local"``
  (server threads touch the card meanwhile); a lowering that fails under
  it raises naming the op (``executor.lower_block``).  Nothing retries
  eagerly.  The step's device fault word (``registry.record_fault``) is
  a graph output like the fetches: the eager first run raises on it
  before its write-back, a replay hands it to the executor with its
  capture's stats (trips, no host read), to read after the replay.

Each capture is observed as ``compile.backend_seconds`` with
``compile.events``, the names of the JAX package's compile listeners.
"""

from __future__ import annotations

import ctypes
import time

import torch

from paddle_tpu_torch import profiler as _profiler
from paddle_tpu_torch.convert import is_dtensor, to_tensor
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.obs import perf as _perf
from paddle_tpu_torch.ops.registry import raise_fault, slot_seed

__all__ = ["GeneratorTable", "StepGraph", "graph_node_count", "undoer",
           "checked"]


def undoer(entries):
    """A ``restore()`` that puts back, once, the rows a guarded step wrote
    in place: ``entries`` are its ``(tensor, rows, old_rows)`` in write
    order (``aux["undo"]``, filled by the sparse optimizer branches), put
    back in reverse.  Under a graph the rows and old values are the
    capture's buffers, holding the last replay's."""
    done = []

    def restore():
        if entries and not done:
            done.append(True)
            with torch.no_grad():
                for target, rows, old in reversed(entries):
                    target.index_copy_(0, rows, old)
    return restore


def _seed_of(key, rng_seed):
    """The seed a draw keyed ``key`` takes in a run seeded ``rng_seed``."""
    kind, value = key
    return value if kind == "fixed" else slot_seed(rng_seed, value)


class GeneratorTable:
    """The device generators of one run's random draws, in draw order
    (``aux["generators"]``).  Without ``generators`` each draw gets a
    fresh generator seeded for this run (the eager step); with them (a
    capture), the i-th draw gets the i-th, which must be keyed as the
    eager run's i-th draw was.  ``keys`` records the draws."""

    def __init__(self, rng_seed, expected=None, generators=None):
        self.rng_seed = rng_seed
        self.keys = []
        self._expected = expected
        self._generators = generators

    def generator(self, device, key):
        i = len(self.keys)
        self.keys.append(key)
        if self._generators is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed_of(key, self.rng_seed))
            return gen
        if i >= len(self._generators) or self._expected[i] != key:
            raise RuntimeError(
                f"random draw {i} ({key}) under the capture differs from "
                f"the eager run's draws {list(self._expected)}")
        return self._generators[i]


def _local(t):
    """The tensor whose memory the graph reads and writes: a DTensor's
    local shard (``ParallelExecutor``'s state), any other tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _storage(t):
    return _local(t).untyped_storage().data_ptr()


def _is_buffer(value, buf):
    """``value`` is ``buf`` itself, or a view of the same elements."""
    if value is buf:
        return True
    value, buf = _local(value), _local(buf)
    return (value.data_ptr() == buf.data_ptr() and value.shape == buf.shape
            and value.stride() == buf.stride() and value.dtype == buf.dtype)


_libcuda = None


def graph_node_count(graph):
    """Nodes of a ``torch.cuda.CUDAGraph(keep_graph=True)``'s captured
    ``cudaGraph_t`` (``cuGraphGetNodes`` of ``libcuda``)."""
    global _libcuda
    raw = graph.raw_cuda_graph()
    if _libcuda is None:
        # libcuda is present wherever a card is
        _libcuda = ctypes.CDLL("libcuda.so.1")
        _libcuda.cuGraphGetNodes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
        _libcuda.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    code = _libcuda.cuGraphGetNodes(ctypes.c_void_p(raw), None,
                                    ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {code})")
    return int(n.value)


class StepGraph:
    """``fn`` of one compiled signature on the card (see the module
    docstring).  ``step(feeds, rng_seed, generators, capturing)`` is the
    prepared eager step (``Executor._prepare``), returning ``(fetches,
    new_state, state_in, stats)``; ``state_names`` the names it may read
    from or write to the scope; ``shared()`` gives the executor's graph
    pool handle and capture stream (one each per executor: a stream of
    its own would leave a cuBLAS workspace behind at every capture);
    ``label`` names the graph in :meth:`stats`; ``record`` is the
    signature's cost record (its first run and capture are noted there).
    Calls are serialized by the executor."""

    def __init__(self, step, scope, device, state_names, shared, label,
                 writeback_in_graph=True, record=None):
        self.step = step
        self.scope = scope
        self.device = device
        self.state_names = tuple(state_names)
        self._shared = shared
        self.label = label
        self.writeback_in_graph = writeback_in_graph
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.nodes = None
        self.pool_gib = 0.0
        self.graph = None
        self._runs = 0
        self._gen_keys = ()
        self._gens = ()
        self._feeds = {}
        self._buffers = {}
        self._fetches = []
        self._new_state = {}
        self._copies = []
        self._tally = {}
        self._stats = {}
        self._undo = None
        self._record = record

    # ------------------------------------------------------------------
    def __call__(self, feeds, rng_seed, check):
        """One step: ``(fetches, stats, owned)``.  ``owned`` is False
        when the fetches (and the stats' fault word) are the graph's
        outputs, valid until the next replay of any graph of the pool
        (clone or convert them first)."""
        if self.graph is None:
            self._runs += 1
            if self._runs == 1:
                return self._eager(feeds, rng_seed, check)
            self._capture(feeds, rng_seed)
        else:
            self._sync_state()
        return self._replay(feeds, rng_seed, check), self._stats, False

    def _eager(self, feeds, rng_seed, check):
        """The signature's first run: a real eager step, recording its
        random draws for the capture."""
        table = GeneratorTable(rng_seed)
        first = _perf.FirstRun(self._record, self.device)
        fetches, new_state, state_in, stats = self.step(feeds, rng_seed,
                                                        table, False)
        first.done(feeds, state_in, fetches, new_state)
        self._gen_keys = tuple(table.keys)
        raise_fault(stats["fault"], stats["fault_sites"])
        if check is not None:
            fetches, new_state = checked(check, fetches, new_state,
                                         undoer(stats.get("undo")))
        for n, v in new_state.items():
            self.scope.set_var(n, v)
        return fetches, stats, True

    # ------------------------------------------------------------------
    def _normalize_state(self):
        """Before a capture: every state value in the scope a device
        tensor (a host copy inside the capture would be refused), and no
        two names sharing storage (their write-backs would collide)."""
        seen = set()
        for n in self.state_names:
            v = self.scope.find_var(n)
            if v is None:
                continue
            if not isinstance(v, torch.Tensor) or v.device != self.device:
                v = to_tensor(v, self.device)
                self.scope.set_var(n, v)
            if _storage(v) in seen:
                v = v.clone()
                self.scope.set_var(n, v)
            seen.add(_storage(v))

    def _capture(self, feeds, rng_seed):
        # the eager run's freed blocks are released first, so the pool
        # does not stand beside them
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        self._normalize_state()
        self._feeds = {n: t.clone() for n, t in feeds.items()}
        self._gens = []
        for key in self._gen_keys:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_seed_of(key, rng_seed))
            self._gens.append(gen)
        # kept after the capture, to count its nodes
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self._gens:
            graph.register_generator_state(gen)
        table = GeneratorTable(rng_seed, self._gen_keys, self._gens)
        pool, stream = self._shared()
        reserved0 = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with build.capture_launches() as tally, torch.cuda.stream(stream):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                fetches, new_state, state_in, stats = self.step(
                    self._feeds, rng_seed, table, True)
                if len(table.keys) != len(self._gen_keys):
                    raise RuntimeError(
                        f"the capture drew {len(table.keys)} random "
                        f"streams, the eager run {len(self._gen_keys)}")
                self._plan_write_back(fetches, new_state, state_in)
                if self.writeback_in_graph:
                    for dst, src in self._copies:
                        dst.copy_(src)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # an invalidated capture: the cause is raised
                raise
            graph.capture_end()
        self.nodes = graph_node_count(graph)
        graph.instantiate()
        dt = time.perf_counter() - t0
        self.graph = graph
        self._tally = dict(tally)
        self._undo = stats.get("undo")
        self._stats = dict(stats, host_reads=0)
        self.captures += 1
        self.capture_seconds += dt
        self.pool_gib = (torch.cuda.memory_reserved(self.device)
                         - reserved0) / 2 ** 30
        _profiler.runtime_metrics.observe("compile.backend_seconds", dt)
        _profiler.runtime_metrics.inc("compile.events")
        _perf.note_capture(self._record, dt)

    def _plan_write_back(self, fetches, new_state, state_in):
        """(Under the capture.)  The buffers the graph reads and writes
        (``_buffers``), the ``(buffer, value)`` copies of the write-back,
        and the graph's outputs; values and fetches sharing storage with
        a written buffer are cloned first."""
        self._buffers = dict(state_in)
        for n in self.state_names:
            v = self.scope.find_var(n)
            if n not in self._buffers and isinstance(v, torch.Tensor):
                self._buffers[n] = v
        dests = {}
        for n, v in new_state.items():
            buf = self._buffers.get(n)
            if not isinstance(v, torch.Tensor) or buf is None or \
                    v.shape != buf.shape or v.dtype != buf.dtype or \
                    getattr(v, "placements", None) != \
                    getattr(buf, "placements", None):
                raise RuntimeError(
                    f"state {n!r} cannot be written back under a CUDA "
                    f"graph: the step gives "
                    f"{getattr(v, 'shape', type(v).__name__)} "
                    f"{getattr(v, 'placements', '')}, the scope holds "
                    f"{getattr(buf, 'shape', None)} "
                    f"{getattr(buf, 'placements', '')}")
            if not _is_buffer(v, buf):
                dests[n] = (buf, v)
        written = {_storage(buf) for buf, _ in dests.values()}
        # DTensors of one placement copy shard to shard
        self._copies = [(_local(buf), _local(v).clone()
                         if _storage(v) in written else _local(v))
                        for buf, v in dests.values()]
        self._new_state = new_state
        outs = []
        for f in fetches:
            if not isinstance(f, torch.Tensor):
                raise RuntimeError(
                    f"a fetch of type {type(f).__name__} cannot leave a "
                    f"CUDA graph")
            outs.append(f.clone() if _storage(f) in written else f)
        self._fetches = outs

    # ------------------------------------------------------------------
    def _sync_state(self):
        """Point the scope back at the captured state tensors, copying in
        a value that replaced one (of the same shape and dtype: the graph
        holds no other)."""
        for n, buf in self._buffers.items():
            cur = self.scope.find_var(n)
            if cur is buf:
                continue
            if cur is None:
                raise RuntimeError(
                    f"variable {n!r} is not initialized in the scope — "
                    f"run the startup program first")
            if not isinstance(cur, torch.Tensor) or \
                    cur.device != self.device:
                cur = to_tensor(cur, self.device)
            if cur.shape != buf.shape or cur.dtype != buf.dtype:
                raise ValueError(
                    f"variable {n!r} was replaced by a {tuple(cur.shape)} "
                    f"{cur.dtype} tensor; its CUDA graph ({self.label}) "
                    f"holds {tuple(buf.shape)} {buf.dtype}")
            if not _is_buffer(cur, buf):
                buf.copy_(cur)
            self.scope.set_var(n, buf)

    def _replay(self, feeds, rng_seed, check):
        for n, t in feeds.items():
            self._feeds[n].copy_(t)
        for gen, key in zip(self._gens, self._gen_keys):
            gen.manual_seed(_seed_of(key, rng_seed))
        self.graph.replay()
        self.replays += 1
        for kernel, n in self._tally.items():
            kernel.add_launches(n)
        if not self.writeback_in_graph:
            if check is not None:
                # a poisoned copy the check returns is never written: a
                # poison always trips it
                checked(check, self._fetches, self._new_state,
                        undoer(self._undo))
            if self._copies:
                # one multi-tensor copy for the whole write-back
                torch._foreach_copy_([d for d, _ in self._copies],
                                     [s for _, s in self._copies])
        return self._fetches

    def stats(self):
        """One ``{"graphs": [...]}`` entry: the signature's label,
        captures, replays, capture seconds, graph nodes and the pool's
        growth at capture (GiB reserved)."""
        return {"signature": self.label, "captures": self.captures,
                "replays": self.replays, "seconds": self.capture_seconds,
                "nodes": self.nodes, "pool_gib": self.pool_gib,
                "random_streams": len(self._gen_keys),
                "launches": {k.name: n for k, n in self._tally.items()}}


def checked(check, fetches, new_state, restore):
    """Run ``check`` before a write-back; a check that raises puts back
    the step's in-place rows first."""
    try:
        return check(fetches, new_state, restore)
    except BaseException:
        restore()
        raise
