"""GenPredictor: the two-entry (prefill + decode) inference handle over an
exported generation bundle (the port of ``paddle_tpu.gen.predictor``;
bundles from ``models/gen_lm.export_gen_model`` of either package).

* :meth:`prefill` runs one prompt (padded to a length bucket) through the
  full causal forward and returns the next-token logits plus the
  per-layer K/V rows that seed a cache slot.
* :meth:`decode_step` advances EVERY slot of the cache pool by one token.
  The cache tensors are persistable state in the predictor's scope: they
  live on the device across steps and the decode program updates them in
  place.
* :meth:`write_slot` / :meth:`clear_slot` seed and reclaim a slot's cache
  rows, in place on the device pool.

PAGED bundles (the default export) keep the pool as ``[num_pages,
page_len, H*D]`` pages addressed through a host-side per-slot page
table.  The predictor owns the page allocator (:meth:`alloc_slot_pages` /
:meth:`free_slot_pages`, driven by the scheduler's admit/evict) and
slices the page-table feed to a declared ``page_buckets`` edge each step.

On the card each program runs as CUDA graphs of the executor
(``step_graph.py``): the prefill one graph per prompt bucket, the paged
decode one per page bucket (the table feed is sliced to a bucket, so a
bucket is a signature), the dense decode its one signature.
:meth:`warmup` runs every prompt bucket and the decode step at every
declared page bucket (or the one dense signature) on zero feeds through
``Executor.warmup``, so every kernel of the path is built and loaded and
every graph captured before a server reports ready: the first real
request replays.  A prefill's K/V tensors are the caller's (the
executor clones a graph's outputs), so :meth:`write_slot` may read them
after the lock is released.  The bundle is checked against its meta at
load (``analysis.check_gen_bundle``).

The cost-model planners (``prefill_cost``, ``plan_prompt_buckets``,
``plan_page_buckets``) price a prefill with ``analysis.cost``'s static
model, as the JAX package's do.
"""

from __future__ import annotations

import json
import os
import threading
import weakref

import numpy as np
import torch

from paddle_tpu_torch.convert import to_numpy, to_tensor
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.fault import chaos
from paddle_tpu_torch.io import load_inference_model
from paddle_tpu_torch.obs import perf as _perf
from paddle_tpu_torch.lod import pad_to_bucket, row_bucket
from paddle_tpu_torch.obs.trace import span as _span
from paddle_tpu_torch.place import default_place
from paddle_tpu_torch.profiler import runtime_metrics
from paddle_tpu_torch.scope import Scope, scope_guard

__all__ = ["GenPredictor", "is_gen_bundle", "META_FILENAME"]

META_FILENAME = "gen_meta.json"


def is_gen_bundle(model_dir):
    """True when ``model_dir`` is a generation bundle (prefill + decode
    programs + ``gen_meta.json``)."""
    return os.path.isfile(os.path.join(model_dir, META_FILENAME))


class GenPredictor:
    """Load-once handle over a generation bundle on ``place`` (default
    ``cuda:0``; raises when CUDA is absent and no ``CPUPlace()`` was
    given).  One internal lock serializes executor access."""

    def __init__(self, model_dir, place=None):
        with open(os.path.join(model_dir, META_FILENAME)) as f:
            self.meta = json.load(f)
        self.num_slots = int(self.meta["num_slots"])
        self.max_len = int(self.meta["max_len"])
        self.vocab_size = int(self.meta["vocab_size"])
        self.eos_id = int(self.meta.get("eos_id", -1))
        self.cache_vars = list(self.meta["cache_vars"])
        self.prompt_buckets = [int(b) for b in self.meta["prompt_buckets"]]
        self.max_prompt_len = min(self.prompt_buckets[-1], self.max_len)
        self.paged = "page_len" in self.meta
        if self.paged:
            self.page_len = int(self.meta["page_len"])
            self.num_pages = int(self.meta["num_pages"])
            self.page_buckets = [int(b)
                                 for b in self.meta["page_buckets"]]
            self.pages_per_slot = -(-self.max_len // self.page_len)
            # host-side page allocator state (all mutated under _lock):
            # the device only ever sees the bucketed table SLICE
            self._page_table = np.zeros(
                (self.num_slots, self.pages_per_slot), np.int32)
            self._slot_pages = {}
            self._free_list = list(range(self.num_pages))

        self.place = place if place is not None else default_place()
        self._scope = Scope()
        self._lock = threading.Lock()
        with scope_guard(self._scope):
            self._exe = Executor(self.place)
            (self._pre_prog, self._pre_feeds,
             self._pre_fetch) = load_inference_model(
                os.path.join(model_dir, "prefill"), self._exe)
            (self._dec_prog, self._dec_feeds,
             self._dec_fetch) = load_inference_model(
                os.path.join(model_dir, "decode"), self._exe)
        # load-time contract check: a bundle whose prefill/decode pair
        # drifted from its meta fails here, before a server reports ready
        from paddle_tpu_torch.analysis import (AnalysisResult,
                                               check_gen_bundle)
        AnalysisResult(check_gen_bundle(
            (self._pre_prog, self._pre_feeds, self._pre_fetch),
            (self._dec_prog, self._dec_feeds, self._dec_fetch),
            self.meta)).raise_on_errors(where="gen.GenPredictor")
        # decode steps feed gen.decode_mfu (not train.mfu): the executor
        # reads the gauge off this program attribute
        self._dec_prog._mfu_gauge = "gen.decode_mfu"
        if self.paged:
            dec_block = self._dec_prog.global_block()
            self._hd = int(dec_block.var(self.cache_vars[0]).shape[-1])
        # HBM census: the KV pool is a collection of its own, ``kv_pages``
        # for a paged bundle and ``kv_cache`` for the dense layout (the
        # host page table is no device memory); weakly referenced, so a
        # dropped predictor is released
        ref = weakref.ref(self)

        def _kv_buffers():
            p = ref()
            if p is None:
                return ()
            return [v for v in (p._scope.find_var(n)
                                for n in p.cache_vars) if v is not None]

        self._hbm_token = _perf.register_hbm_provider(
            "kv_pages" if self.paged else "kv_cache", _kv_buffers)
        weakref.finalize(self, _perf.unregister_hbm_provider,
                         self._hbm_token)
        # static prefill cost per (bucket[, pages]) and the cost model's
        # fits, built lazily; consumed by GenScheduler's admission budget
        self._prefill_cost = {}
        self._length_cost_fn = None
        self._page_cost_fn = None
        self.device = self._exe.device
        # per-bucket constant prefill feeds (causal bias template)
        self._tri = {}
        #: runs of the prefill and decode programs (counted, not timed)
        self.prefills = 0
        self.decode_steps = 0

    def cache(self, name):
        """The device tensor of cache variable ``name`` (the pool itself,
        not a copy)."""
        return self._scope.find_var(name)

    # -- prefill -----------------------------------------------------------
    def _bucket(self, prompt_len):
        return min(row_bucket(prompt_len, edges=self.prompt_buckets),
                   self.max_len)

    def _prefill_feed(self, prompt, bucket):
        p = len(prompt)
        ids = pad_to_bucket(
            np.asarray(prompt, np.int32).reshape(1, p), bucket, axis=1)
        pos = np.arange(bucket, dtype=np.int32).reshape(1, bucket)
        mask = pad_to_bucket(np.ones((1, p), np.float32), bucket, axis=1)
        tri = self._tri.get(bucket)
        if tri is None:
            tri = np.triu(np.full((bucket, bucket), -1e9, np.float32), 1)
            self._tri[bucket] = tri
        bias = tri[None, None] + (mask * 1e9 - 1e9)[:, None, None, :]
        last = np.zeros((1, bucket), np.float32)
        last[0, p - 1] = 1.0
        return {"gen_ids": ids, "gen_pos": pos, "gen_mask": mask,
                "gen_attn_bias": bias.astype(np.float32), "gen_last": last}

    def _cost_fn(self):
        """``flops(prompt_bucket)`` from the static cost model over the
        bundle's own prefill program (``cost.row_cost_fn``).  Takes the
        predictor lock: the fit probes the prefill program by rewriting
        its feed var's length dim for a moment, which must never
        interleave with another fit or a run."""
        with self._lock:
            if self._length_cost_fn is None:
                from paddle_tpu_torch.analysis import cost as _cost
                probe = (self.prompt_buckets[0],
                         max(self.prompt_buckets[-1],
                             self.prompt_buckets[0] + 1))
                self._length_cost_fn = _cost.row_cost_fn(
                    self._pre_prog, batch_var=self._pre_feeds[0],
                    dim=1, probe_rows=probe)
            return self._length_cost_fn

    def _page_write_cost(self, prompt_len):
        """Flop-equivalent of seeding a paged slot: every allocated
        prompt page is written whole (k + v, per layer) — the page
        dimension admission budgets must see on top of the prefill
        forward."""
        pages = -(-max(int(prompt_len), 1) // self.page_len)
        return (2.0 * float(self.meta.get("n_layer", 1)) *
                pages * self.page_len * self._hd)

    def prefill_cost(self, prompt_len):
        """Static FLOPs of prefilling a prompt of ``prompt_len`` tokens,
        priced at its padded bucket (what the device runs); a paged
        bundle adds the slot's page-seeding writes, so the memo key
        grows a page dimension.  The :class:`GenScheduler` weighs
        admissions with this.  Cheap after the first call per (bucket,
        pages); the fit is warmed by the scheduler's constructor."""
        prompt_len = int(prompt_len)
        bucket = self._bucket(prompt_len)
        if self.paged:
            pages = -(-max(prompt_len, 1) // self.page_len)
            key = (bucket, pages)
        else:
            key = bucket
        hit = self._prefill_cost.get(key)
        if hit is None:
            hit = float(self._cost_fn()(bucket))
            if self.paged:
                hit += self._page_write_cost(prompt_len)
            self._prefill_cost[key] = hit
        return hit

    def plan_prompt_buckets(self, observed_lengths, max_edges=4):
        """Cost-optimal prompt buckets for an observed length
        distribution: ``lod.select_bucket_edges`` weighted by the
        prefill program's static FLOPs per bucket (plus, for paged
        bundles, the candidate length's page-seeding writes).  Returns a
        sorted edge list (capped at the bundle's ``max_len``) to bake
        into the next export's ``gen_meta.json``."""
        from paddle_tpu_torch.lod import select_bucket_edges
        lengths = [min(max(int(n), 1), self.max_len)
                   for n in observed_lengths]
        cost_of = self._cost_fn()
        if self.paged:
            base = cost_of

            def cost_of(n):
                return float(base(n)) + self._page_write_cost(n)
        return select_bucket_edges(lengths, max_edges=max_edges,
                                   cost_of=cost_of)

    def plan_page_buckets(self, observed_lengths, max_edges=4):
        """Cost-optimal page-count bucket edges for an observed
        prefix-length distribution: ``lod.select_bucket_edges`` over
        live page counts, priced by the decode program's static cost as
        a function of the page-table width (``cost.row_cost_fn`` probing
        that dim — the ``paged_attention`` cost rule makes it carry the
        pages actually read).  Returns a sorted edge list to bake into
        the next export's ``page_buckets``."""
        if not self.paged:
            raise ValueError("plan_page_buckets needs a paged bundle")
        from paddle_tpu_torch.lod import select_bucket_edges
        counts = [min(max(-(-int(n) // self.page_len), 1),
                      self.pages_per_slot) for n in observed_lengths]
        with self._lock:
            if self._page_cost_fn is None:
                from paddle_tpu_torch.analysis import cost as _cost
                self._page_cost_fn = _cost.row_cost_fn(
                    self._dec_prog, batch_var="gen_page_table", dim=1,
                    probe_rows=(1, max(self.pages_per_slot, 2)))
            fn = self._page_cost_fn
        return select_bucket_edges(counts, max_edges=max_edges,
                                   cost_of=fn)

    def can_resume(self, total_len):
        """True when a stream of ``total_len`` tokens (prompt + tokens
        already emitted) still fits a prefill bucket."""
        return 0 < int(total_len) <= self.max_prompt_len

    def prefill(self, prompt):
        """Run one prompt (list/array of token ids); returns
        ``(logits [V] numpy, kv)`` where ``kv`` is the per-layer masked
        K/V list ``[k_0, v_0, ...]``, each a ``[1, bucket, H*D]`` tensor
        on the predictor's device (zeros on pad rows)."""
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the bundle's "
                f"max prompt length {self.max_prompt_len}")
        feed = self._prefill_feed(prompt, self._bucket(len(prompt)))
        with self._lock:
            with scope_guard(self._scope):
                with _span("gen.prefill", tokens=len(prompt)):
                    outs = self._exe.run(self._pre_prog, feed=feed,
                                         fetch_list=self._pre_fetch,
                                         return_numpy=False)
            self.prefills += 1
        return to_numpy(outs[0])[0], outs[1:]

    # -- page allocator (paged bundles; driven by the scheduler) -----------
    @property
    def free_pages(self):
        """Unallocated pool pages (paged bundles; 0 for dense)."""
        if not self.paged:
            return 0
        with self._lock:
            return len(self._free_list)

    def pages_needed(self, prompt_len, max_new_tokens=1):
        """Pages a request must hold to decode to its length horizon
        WITHOUT mid-request allocation."""
        horizon = min(self.max_len,
                      int(prompt_len) + max(int(max_new_tokens), 1))
        return -(-max(horizon, 1) // self.page_len)

    def alloc_slot_pages(self, slot, n):
        """Assign ``n`` pool pages to ``slot`` (prefix order).  Raises
        ``RuntimeError`` when the pool cannot cover it."""
        n = max(1, min(int(n), self.pages_per_slot))
        with self._lock:
            if slot in self._slot_pages:
                raise ValueError(f"slot {slot} already holds pages")
            if len(self._free_list) < n:
                raise RuntimeError(
                    f"page pool exhausted: slot {slot} needs {n} "
                    f"page(s), {len(self._free_list)} free")
            pages = [self._free_list.pop(0) for _ in range(n)]
            self._slot_pages[slot] = pages
            self._page_table[slot, :] = 0
            self._page_table[slot, :n] = pages
            return list(pages)

    def free_all_pages(self):
        """Return EVERY slot's pages to the pool (the scheduler's
        crash-reset path); returns the number of pages freed."""
        if not self.paged:
            return 0
        with self._lock:
            slots = list(self._slot_pages)
        return sum(self.free_slot_pages(s) for s in slots)

    def free_slot_pages(self, slot):
        """Return ``slot``'s pages to the free list (idempotent); returns
        the number freed."""
        if not self.paged:
            return 0
        with self._lock:
            pages = self._slot_pages.pop(slot, None)
            if not pages:
                return 0
            self._free_list.extend(pages)
            self._page_table[slot, :] = 0
            return len(pages)

    # -- cache-slot lifecycle (per request) --------------------------------
    def write_slot(self, slot, kv, prompt_len):
        """Seed cache slot ``slot`` with a prefill's K/V rows, the rest of
        the slot zeroed, in place on the device pool (``index_copy_``).
        Paged bundles write the slot's allocated pages.  ``kv`` entries
        may be tensors or numpy arrays ``[1, T, H*D]``."""
        with self._lock:
            if self.paged:
                pages = self._slot_pages.get(slot)
                if pages is None:
                    raise RuntimeError(
                        f"write_slot({slot}) before alloc_slot_pages")
                idx = torch.tensor(pages, dtype=torch.long,
                                   device=self.device)
                cap = len(pages) * self.page_len
                for name, arr in zip(self.cache_vars, kv):
                    cache = self._scope.find_var(name)
                    arr = to_tensor(arr, self.device, cache.dtype)
                    rows = min(arr.shape[1], self.max_len, cap)
                    buf = torch.zeros(cap, cache.shape[2],
                                      dtype=cache.dtype, device=self.device)
                    buf[:rows] = arr[0, :rows]
                    cache.index_copy_(0, idx, buf.view(
                        len(pages), self.page_len, cache.shape[2]))
                return
            idx = torch.tensor([slot], dtype=torch.long, device=self.device)
            for name, arr in zip(self.cache_vars, kv):
                cache = self._scope.find_var(name)
                arr = to_tensor(arr, self.device, cache.dtype)
                rows = min(arr.shape[1], self.max_len)
                row = torch.zeros(1, self.max_len, cache.shape[2],
                                  dtype=cache.dtype, device=self.device)
                row[0, :rows] = arr[0, :rows]
                cache.index_copy_(0, idx, row)

    def clear_slot(self, slot):
        """Zero a reclaimed slot's cache rows (``index_fill_`` in place on
        the device pool)."""
        with self._lock:
            if self.paged:
                pages = self._slot_pages.get(slot)
                if not pages:
                    return
                idx = torch.tensor(pages, dtype=torch.long,
                                   device=self.device)
            else:
                idx = torch.tensor([slot], dtype=torch.long,
                                   device=self.device)
            for name in self.cache_vars:
                self._scope.find_var(name).index_fill_(0, idx, 0.0)

    # -- decode ------------------------------------------------------------
    def decode_step(self, tokens, positions, pos_onehot=None,
                    attn_mask=None, lens=None):
        """One decode iteration over the whole slot pool.

        ``tokens``/``positions``: int32 ``[S]`` (zeros for free slots).
        Dense bundles take ``pos_onehot`` f32 ``[S, L]`` (write mask) and
        ``attn_mask`` f32 ``[S, L]``.  Paged bundles take ``lens`` int32
        ``[S]``: prefix rows INCLUDING the current token (0 = free slot);
        the page-table feed is sliced to the smallest declared page
        bucket covering ``max(lens)``.  Returns logits ``[S, V]`` numpy.

        The ``gen.decode.stall`` failpoint fires inside the lock: a
        ``delay`` models per-iteration device time serialized per
        replica, an ``error`` a device fault in the decode step.
        """
        S = self.num_slots
        feed = {
            "gen_token": np.asarray(tokens, np.int32).reshape(S, 1),
            "gen_pos": np.asarray(positions, np.int32).reshape(S, 1),
        }
        if self.paged:
            if lens is None:
                raise ValueError("paged decode_step needs lens")
            feed.update(self._paged_decode_feed(
                np.asarray(lens, np.int32).reshape(S, 1)))
        else:
            feed["gen_pos_onehot"] = np.asarray(pos_onehot, np.float32)
            feed["gen_attn_mask"] = np.asarray(attn_mask, np.float32)
        with self._lock:
            chaos.fire("gen.decode.stall", slots=S)
            with scope_guard(self._scope):
                with _span("gen.decode_step"):
                    (logits,) = self._exe.run(self._dec_prog, feed=feed,
                                              fetch_list=self._dec_fetch)
            self.decode_steps += 1
        return logits

    def _paged_decode_feed(self, lens):
        """Page-table + lens feed for one paged step: the table sliced to
        the smallest declared page bucket covering the longest live
        prefix (clamped to ``pages_per_slot``)."""
        live = lens[:, 0] > 0
        need = 1
        if live.any():
            need = int(-(-int(lens[live, 0].max()) // self.page_len))
        P = min(row_bucket(max(need, 1), edges=self.page_buckets),
                self.pages_per_slot)
        touched = int(np.sum(-(-lens[live, 0] // self.page_len)))
        runtime_metrics.observe("gen.paged.pages_touched", float(touched))
        if touched:
            occupancy = (100.0 * float(lens[live, 0].sum()) /
                         (touched * self.page_len))
            runtime_metrics.bucket("gen.paged.page_occupancy",
                                   int(occupancy))
        with self._lock:
            table = np.ascontiguousarray(self._page_table[:, :P])
        return {"gen_page_table": table, "gen_lens": lens}

    # -- warmup ------------------------------------------------------------
    def warmup(self):
        """Run every prompt bucket's prefill and the decode step (one
        signature per declared page bucket, or the one dense signature)
        on zero feeds, building and loading every kernel they reach and,
        on the card, capturing each signature's CUDA graph
        (``Executor.warmup``), so the first real ``/generate`` pays no
        build and no capture.  The KV pool keeps its bytes, as under the
        JAX package's compile-only warmup: zero ``lens`` write nothing
        into the paged pool, and the dense pool's tensors are put back
        after the steps (its add-write of a zero one-hot would turn a
        ``-0.0`` into ``+0.0``; the next decode step copies them into its
        graph's buffers).  Returns a
        :class:`~paddle_tpu_torch.obs.perf.WarmupReport` whose buckets are
        tagged ``program: prefill|decode``."""
        from paddle_tpu_torch.obs.perf import WarmupReport
        sigs = []
        for b in self.prompt_buckets:
            if b > self.max_len:
                continue
            sigs.append({"gen_ids": (1, b), "gen_pos": (1, b),
                         "gen_mask": (1, b), "gen_attn_bias": (1, 1, b, b),
                         "gen_last": (1, b)})
        S, L = self.num_slots, self.max_len
        if self.paged:
            dec_sigs = [{"gen_token": (S, 1), "gen_pos": (S, 1),
                         "gen_page_table": (S, int(P)),
                         "gen_lens": (S, 1)}
                        for P in self.page_buckets
                        if P <= self.pages_per_slot]
        else:
            dec_sigs = [{"gen_token": (S, 1), "gen_pos": (S, 1),
                         "gen_pos_onehot": (S, L),
                         "gen_attn_mask": (S, L)}]
        with self._lock:
            with scope_guard(self._scope):
                pre = self._exe.warmup(
                    self._pre_prog, sigs, fetch_list=self._pre_fetch,
                    scope=self._scope)
                # the decode step writes its cache tensors: declare
                # exactly those as intended state updates, and put the
                # pool's own tensors back (the step writes new ones)
                pool = [self._scope.find_var(n) for n in self.cache_vars]
                dec = self._exe.warmup(
                    self._dec_prog, dec_sigs,
                    fetch_list=self._dec_fetch, scope=self._scope,
                    allow_state_updates=self.cache_vars)
                for n, t in zip(self.cache_vars, pool):
                    self._scope.set_var(n, t)
        return WarmupReport.merge(pre, dec, labels=("prefill", "decode"))
