"""Crash-consistent checkpoint commits + managed retention/recovery (the
port's copy of ``paddle_tpu.fault.checkpoint``).

The reference pserver checkpoints with a CRC32 over the serialized state
(``go/pserver/service.go:346``) and recovers by validating it on load.
Same discipline here, at directory granularity: a checkpoint is written
to a temp dir, a ``MANIFEST.json`` with per-file SHA-256 checksums is
added, everything is fsynced, and only then is the dir atomically
renamed to its final ``ckpt-<step>`` name.  A crash at ANY point leaves
either the previous committed checkpoint or a ``.tmp-``/renamed-away dir
that :meth:`CheckpointManager.restore_latest` ignores or quarantines —
never a half-written checkpoint that loads garbage.

The port runs at world size 1: it is its own coordinator, so the JAX
package's multi-host barriers and per-process sidecar names reduce to the
single-host case.  Its checkpoints are in the shard format
(:mod:`paddle_tpu_torch.fault.shard_ckpt`), which the JAX package reads.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
from concurrent.futures import Future

import torch.distributed as dist

from paddle_tpu_torch.fault import chaos
from paddle_tpu_torch.obs.trace import span as _span

__all__ = ["CheckpointManager", "CorruptCheckpoint", "MANIFEST_NAME",
           "DATAPIPE_STATE_NAME", "LEDGER_STATE_NAME", "write_manifest",
           "verify_checkpoint", "commit_checkpoint"]

MANIFEST_NAME = "MANIFEST.json"
DATAPIPE_STATE_NAME = "datapipe_state.pkl"
LEDGER_STATE_NAME = "ledger_state.pkl"
GOOD_POINTER_NAME = "last_good"


def _rank():
    """This process's rank in the world (0 outside one): rank 0 alone
    commits, collects and points in a shared checkpoint directory."""
    return dist.get_rank() if dist.is_initialized() else 0


def _datapipe_state_name(rank=None, processes=None):
    """Per-host sidecar name: each trainer's iterator position is
    host-local state (its own input shard), so multi-host runs save one
    file per process; single-host keeps the unsuffixed legacy name.
    ``rank``/``processes`` override the live process coordinates (the
    topology-changed restore derives rank 0's saved name through the
    same formatter that wrote it)."""
    if processes is None:
        processes = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = _rank()
    if processes == 1:
        return DATAPIPE_STATE_NAME
    return f"datapipe_state.{rank}.pkl"
MANIFEST_FORMAT = 1
_TMP_PREFIX = ".tmp-"
_QUARANTINE_SUFFIX = ".corrupt"


class CorruptCheckpoint(RuntimeError):
    """A checkpoint failed manifest/checksum verification."""


def _sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _walk_files(root):
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            p = os.path.join(dirpath, n)
            yield os.path.relpath(p, root), p


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_manifest(path, step=None, extra=None):
    """Checksum every file under ``path`` into ``MANIFEST.json``
    (fsynced).  ``extra``: additional top-level manifest entries — the
    shard checkpoint writer records its mesh ``topology`` here, inside
    the same fsynced commit as the checksums."""
    files = {}
    for rel, abs_p in _walk_files(path):
        if rel == MANIFEST_NAME:
            continue
        files[rel] = {"sha256": _sha256(abs_p),
                      "size": os.path.getsize(abs_p)}
    manifest = {"format": MANIFEST_FORMAT, "step": step, "files": files}
    for key, value in (extra or {}).items():
        manifest[key] = value
    mpath = os.path.join(path, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    return manifest


def verify_checkpoint(path):
    """Validate ``path`` against its manifest.

    Returns the manifest dict; raises :class:`CorruptCheckpoint` on a
    missing/unreadable manifest, a missing file, a size mismatch, or a
    checksum mismatch.  (Pre-manifest legacy checkpoints fail here — the
    manager treats only manifested dirs as verifiable and leaves legacy
    dirs to explicit ``load_checkpoint`` calls.)
    """
    mpath = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpoint(
            f"{path}: unreadable manifest ({e})") from e
    for rel, want in manifest.get("files", {}).items():
        abs_p = os.path.join(path, rel)
        if not os.path.exists(abs_p):
            raise CorruptCheckpoint(f"{path}: missing file {rel!r}")
        size = os.path.getsize(abs_p)
        if size != want["size"]:
            raise CorruptCheckpoint(
                f"{path}: {rel!r} size {size} != manifest {want['size']}")
        if _sha256(abs_p) != want["sha256"]:
            raise CorruptCheckpoint(f"{path}: {rel!r} checksum mismatch")
    if "topology" in manifest:
        # shard-format checkpoint: the topology record must also be
        # SELF-consistent (every declared shard file checksummed, shard
        # counts matching the saved mesh axis, shapes slicing evenly) —
        # per-file hashes prove bytes, this proves the geometry
        from paddle_tpu_torch.fault import shard_ckpt
        problems = shard_ckpt.validate_topology(manifest)
        if problems:
            raise CorruptCheckpoint(
                f"{path}: inconsistent topology record: "
                + "; ".join(problems))
    return manifest


def commit_checkpoint(tmp_path, final_path, step=None, extra=None):
    """Manifest + fsync + atomic rename: the commit point of a save.

    The ``ckpt.commit`` failpoint sits after the full temp write and
    before the rename — a kill there must leave the previous committed
    checkpoint as the restore target.
    """
    with _span("ckpt.manifest", step=step):
        write_manifest(tmp_path, step=step, extra=extra)
        _fsync_dir(tmp_path)
    chaos.fire("ckpt.commit", step=step)
    with _span("ckpt.rename", step=step):
        displaced = None
        if os.path.exists(final_path):
            # overwriting a committed step (rollback + retrain): displace
            # it by ATOMIC rename rather than rmtree, so a crash in this
            # window still leaves a complete dir on disk (restore falls
            # back to an earlier step; the displaced dir is swept by the
            # next GC)
            displaced = os.path.join(
                os.path.dirname(final_path),
                _TMP_PREFIX + "old-" + os.path.basename(final_path))
            if os.path.exists(displaced):
                shutil.rmtree(displaced)
            os.rename(final_path, displaced)
        os.rename(tmp_path, final_path)
        _fsync_dir(os.path.dirname(final_path) or ".")
        if displaced is not None:
            shutil.rmtree(displaced, ignore_errors=True)
    return final_path


def manager_from_env(executor=None, main_program=None, scope=None):
    """Build a :class:`CheckpointManager` from the ``PADDLE_TPU_CKPT_DIR``
    / ``PADDLE_TPU_CKPT_KEEP`` env vars (exported by ``python -m
    paddle_tpu_torch train --checkpoint-dir D [--keep-checkpoints N]``,
    as by the JAX package's ``train``); returns None when unset.
    Training scripts call this once and checkpoint/resume only when the
    operator asked for it."""
    dirname = os.environ.get("PADDLE_TPU_CKPT_DIR")
    if not dirname:
        return None
    keep = int(os.environ.get("PADDLE_TPU_CKPT_KEEP", "5"))
    return CheckpointManager(dirname, keep=keep, executor=executor,
                             main_program=main_program, scope=scope)


class _MeshPending:
    """An async save on a mesh: its writer thread's file writes
    (``writing``), and the commit that :meth:`commit` runs on the calling
    thread.  ``future`` is what ``save_async`` returned: it resolves at
    the commit, and its ``result()`` commits first when the save is
    still pending."""

    def __init__(self, manager, save, writing):
        self.manager, self.save, self.writing = manager, save, writing
        self.future = _CommitOnResult(manager)

    def commit(self):
        try:
            # the writes end; a failure in them is kept for the commit,
            # which every rank must reach
            self.writing.result()
            with _span("ckpt.save", step=self.save.step):
                path = self.save.commit()
                self.manager._committed_step(self.save.step)
        except BaseException as e:
            self.future.set_exception(e)
            raise
        self.future.set_result(path)
        return path


class _CommitOnResult(Future):
    """The future of an async save on a mesh: ``result()`` on a pending
    one runs the manager's :meth:`CheckpointManager.wait_pending` (the
    commit's collectives) on the calling thread."""

    def __init__(self, manager):
        super().__init__()
        self._manager = manager

    def result(self, timeout=None):
        if not self.done():
            self._manager.wait_pending()
        return super().result(timeout)


class CheckpointManager:
    """Keep-N managed checkpoints over ``io.save_checkpoint`` /
    ``io.load_checkpoint`` with corruption-tolerant recovery.

    ``save(step)`` commits crash-consistently (the io layer routes
    through :func:`commit_checkpoint`) and garbage-collects all but the
    newest ``keep`` committed steps.  ``restore_latest()`` walks
    committed steps newest-first, verifies each manifest, quarantines
    (renames to ``ckpt-N.corrupt``) anything torn or corrupt, and
    restores the newest checkpoint that passes — returning its step, or
    None when nothing is restorable.

    ``datapipe``: an optional ``datapipe`` pipeline (any stage with
    ``state_dict``/``load_state_dict``).  Its iterator position is
    serialized into every checkpoint (same atomic commit as the
    tensors) and restored alongside them, so a killed trainer resumes
    mid-epoch with the exact sample sequence it would have seen.

    ``mesh`` + ``shard_specs``: a mesh-sharded save (each rank writes
    the shards it owns, rank 0 commits) and an elastic restore onto
    another mesh (:func:`paddle_tpu_torch.io.load_checkpoint`).  Without
    a mesh every save writes the shard format at one shard a variable.
    ``save_async`` moves the write off the step path: the state snapshot
    is taken synchronously (a device clone, as the port's steps update
    the scope's tensors in place), the host copy and shard writes run on
    a background thread, and so does the atomic commit without a mesh
    (on a mesh it waits for the calling thread: :meth:`save_async`); a
    blocking ``save``
    copies the live tensors to the host and clones nothing.  A restore
    puts the state on ``executor``'s device, without one on the default
    place's (``cuda:0``).
    """

    def __init__(self, dirname, keep=5, executor=None, main_program=None,
                 scope=None, datapipe=None, mesh=None, shard_specs=None,
                 ledger=None):
        self.dirname = str(dirname)
        self.keep = keep
        self.executor = executor
        self.main_program = main_program
        self.scope = scope
        self.datapipe = datapipe
        # optional obs.ledger.RunLedger: its resume cursor rides every
        # checkpoint (same atomic commit) exactly like datapipe state,
        # and every restore rewinds it — no duplicated/missing step rows
        # across kill→restore or sentinel rollback
        self.ledger = ledger
        self.mesh = mesh
        self.shard_specs = dict(shard_specs or {})
        self._async_pool = None       # lazily-built single writer thread
        self._pending = None          # in-flight async save future
        self._committed = set()       # every step saved by this process
        self._verified = set()        # steps read-verified this process
        self._verify_failed = set()   # ...and ones that failed, so a
        # corrupt newer checkpoint is not re-hashed on EVERY save's GC
        # pin scan for as long as it stays in the directory
        self.last_committed_step = None   # most recent save() by THIS
        # process — unlike latest_step() it ignores other runs' leftovers
        # in the directory, so a restarted trainer renumbering from 0
        # still observes its own commits (and reading it costs no I/O)
        self.last_restore_rewound = False   # last restore moved the pipe
        os.makedirs(self.dirname, exist_ok=True)

    # -- introspection -----------------------------------------------------
    def steps(self):
        """Committed (fully renamed) checkpoint steps, ascending."""
        steps = []
        for name in os.listdir(self.dirname):
            if not name.startswith("ckpt-") or name.endswith(
                    _QUARANTINE_SUFFIX):
                continue
            suffix = name[len("ckpt-"):]
            if suffix.isdigit():
                steps.append(int(suffix))
        return sorted(steps)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def quarantined(self):
        return sorted(n for n in os.listdir(self.dirname)
                      if n.endswith(_QUARANTINE_SUFFIX))

    def path(self, step):
        return os.path.join(self.dirname, f"ckpt-{int(step)}")

    # -- save --------------------------------------------------------------
    def save(self, step):
        """Commit the current training state as ``ckpt-<step>`` (plus the
        datapipe iterator position, when a pipeline is attached)."""
        self.wait_pending()   # one writer: never overlap an async save
        state, extras = self._snapshot(clone=False)
        return self._save_committed(step, state, extras)

    def save_async(self, step):
        """Commit ``ckpt-<step>`` OFF the step path: the state is
        snapshotted now, as device clones on the current stream (the
        next step writes the scope's tensors in place; the datapipe
        position is captured at the same point), then the copy to the
        host, shard writes, and the atomic commit run on a background
        writer thread.  Returns a
        ``concurrent.futures.Future`` resolving to the committed path;
        saves are serialized on one writer thread (single-writer
        directory protocol), and a pending save is drained before any
        synchronous :meth:`save`, any restore, or
        :meth:`wait_pending`.

        On a mesh the save's collectives stay on the calling thread,
        whose steps issue their own on the same process group (two
        threads would order them differently on different ranks): the
        redistribution of each var to its saved split and the clones of
        this rank's pieces run here, the writer thread writes files
        only, and the commit (every rank's writes agreed on, the first
        rank's rename) runs at the next :meth:`wait_pending` (or save,
        restore, or the future's ``result()``) on the calling thread."""
        from concurrent.futures import ThreadPoolExecutor
        self.wait_pending()
        if self._async_pool is None:
            self._async_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-async")
        if self.mesh is not None:
            return self._save_async_mesh(step)
        state, extras = self._snapshot(clone=True)
        self._pending = self._async_pool.submit(
            self._save_committed, step, state, extras)
        return self._pending

    def _save_async_mesh(self, step):
        from paddle_tpu_torch import io
        state, extras = self._snapshot(clone=False)
        self._drop_good_pointer(step)
        with _span("ckpt.save", step=step):
            save = io._MeshSave(self.dirname, step, state, self.mesh,
                                self.shard_specs, clone=True)
        writing = self._async_pool.submit(save.write, extras)
        self._pending = _MeshPending(self, save, writing)
        return self._pending.future

    def wait_pending(self):
        """Block until the in-flight async save (if any) committed;
        re-raises its failure.  Returns the committed path or None."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        if isinstance(pending, _MeshPending):
            return pending.commit()
        return pending.result()

    def _snapshot(self, clone):
        """The state to commit and its sidecars.  ``clone``: device
        clones (:func:`io.snapshot_state`) for a write on the writer
        thread; else the live tensors, which a blocking save copies
        straight to the host."""
        from paddle_tpu_torch import io
        state = (io.snapshot_state if clone else io._persistable_state)(
            self.main_program, self.scope)
        extras = {}
        if self.datapipe is not None:
            extras[_datapipe_state_name()] = pickle.dumps(
                self.datapipe.state_dict(), protocol=4)
        if self.ledger is not None:
            extras[LEDGER_STATE_NAME] = pickle.dumps(
                self.ledger.state_dict(), protocol=4)
        return state, extras or None

    def _save_committed(self, step, state, extras):
        from paddle_tpu_torch import io
        self._drop_good_pointer(step)
        with _span("ckpt.save", step=step):
            path = io.save_checkpoint(self.executor, self.dirname,
                                      main_program=self.main_program,
                                      step=step, scope=self.scope,
                                      extras=extras, mesh=self.mesh,
                                      shard_specs=self.shard_specs,
                                      state=state)
            self._committed_step(step)
        return path

    def _drop_good_pointer(self, step):
        if _rank() == 0 and self.last_good_step() == int(step):
            # re-saving the anchor's step displaces the PROMOTED state
            # with one that has not yet earned its clean checks (the
            # restart-renumbering pattern) — drop the pointer before
            # the overwrite; the sentinel re-promotes after N clean
            # checks.  Before, not after: a crash mid-commit must not
            # leave the pointer naming an unpromoted checkpoint.
            try:
                os.remove(self._good_pointer())
            except OSError:
                pass

    def _committed_step(self, step):
        self._committed.add(int(step))
        self._verified.discard(int(step))   # content just changed
        self._verify_failed.discard(int(step))
        self.last_committed_step = int(step)
        with _span("ckpt.gc", step=step):
            self._gc(fresh=int(step))

    def _gc(self, fresh=None):
        # GC mirrors the commit protocol: only the coordinator rank
        # mutates the shared directory (the others would sweep
        # .tmp-ckpt-<step> out from under rank 0's manifest and rename)
        if _rank() != 0:
            return
        steps = self.steps()
        victims = steps[:-self.keep] if self.keep else []
        if victims:
            # rotation must never leave only corrupt checkpoints behind:
            # pin the newest step that actually verifies (plus the
            # known-good pointer target), regardless of keep-N.  `fresh`
            # names the step this very save just committed — trusted
            # without a re-hash; everything else re-verifies, so
            # externally-torn newer checkpoints cannot shadow the one
            # restorable copy out of existence.
            protect = set()
            if fresh is not None:
                # the step this save just committed: under restart
                # renumbering it can sort BELOW older checkpoints and
                # land in the victim window while "latest" names it
                protect.add(fresh)
            good = self.last_good_step()
            if good is not None:
                protect.add(good)
            pinned = self._newest_verified(steps, fresh=fresh)
            if pinned is not None:
                protect.add(pinned)
            for step in victims:
                if step in protect:
                    continue
                shutil.rmtree(self.path(step), ignore_errors=True)
        # stale temp dirs from crashed saves are torn garbage by
        # definition — sweep them too.  (A checkpoint dir has ONE
        # writer: the trainer committing steps.  Concurrent savers into
        # the same dir already race the final rename and are
        # unsupported.)
        for name in os.listdir(self.dirname):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.dirname, name),
                              ignore_errors=True)

    def _newest_verified(self, steps, fresh=None):
        """Newest committed step that passes manifest verification
        (``fresh`` — the step committed microseconds ago by this very
        save — is trusted without a re-hash).  Returns None when nothing
        verifies.  Cost: verifies newest-first until one passes, so a
        healthy directory pays at most one full verify per GC."""
        for step in reversed(steps):
            if fresh is not None and step == fresh:
                return step
            if step in self._verified:
                # read-verified earlier by this process: don't re-hash
                # the same foreign newest on EVERY save (restart
                # renumbering keeps it newest for a long time).
                # NOTE: _committed is deliberately NOT trusted here —
                # the pin exists to catch post-commit external
                # corruption of exactly those steps.
                return step
            if step in self._verify_failed:
                continue
            try:
                verify_checkpoint(self.path(step))
            except CorruptCheckpoint:
                # remember the failure: a torn multi-GB checkpoint must
                # not add a full re-hash to every subsequent save until
                # it rotates out (save() clears this if rewritten)
                self._verify_failed.add(step)
                continue
            self._verified.add(step)
            return step
        return None

    # -- known-good promotion (the sentinel's rollback anchor) -------------
    def _good_pointer(self):
        return os.path.join(self.dirname, GOOD_POINTER_NAME)

    def last_good_step(self):
        """Step named by the ``last_good`` pointer, or None when the
        pointer is absent/unreadable or its checkpoint dir is gone."""
        try:
            with open(self._good_pointer()) as f:
                step = int(f.read().strip())
        except (OSError, ValueError):
            return None
        if not os.path.isdir(self.path(step)):
            return None
        return step

    def mark_good(self, step=None, verify=True):
        """Promote ``ckpt-<step>`` (default: newest committed) to
        *known-good* — the sentinel's rollback target.  The pointer
        write is atomic (tmp + rename) and ``_gc`` never collects the
        step it names.  ``verify=True`` re-checks the manifest first so
        a torn checkpoint can never become the rollback anchor; raises
        :class:`CorruptCheckpoint` on failure.  Returns the step, or
        None when there is nothing committed."""
        # promoting the step an in-flight save_async is still writing
        # must wait for its commit — otherwise the dir does not exist
        # yet and the promotion silently returns None
        self.wait_pending()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        step = int(step)
        if not os.path.isdir(self.path(step)):
            # keep-N rotation got there before the promotion did (the
            # clean-check lag): nothing to anchor — the caller must NOT
            # treat this as forward progress
            return None
        if verify and step not in self._committed:
            # steps this process committed were hashed at write time;
            # anything else (resume after restart) re-verifies — a torn
            # checkpoint must never become the rollback anchor.  (The
            # rollback itself re-verifies in restore_last_good either
            # way.)
            verify_checkpoint(self.path(step))
        if _rank() == 0:
            from paddle_tpu_torch.io import atomic_write
            atomic_write(self._good_pointer(), str(step))
        from paddle_tpu_torch import profiler as _profiler
        _profiler.runtime_metrics.inc("ckpt.marked_good")
        return step

    def restore_last_good(self, shardings=None, mesh=None):
        """Restore the last known-good checkpoint (params + datapipe
        position) — the rollback rung of the sentinel's escalation
        ladder.  A corrupt/vanished known-good is quarantined and the
        restore falls back to :meth:`restore_latest` (newest verifiable
        wins).  Returns the restored step or None.

        ``shardings`` / ``mesh``: the sharded and elastic restores of
        :func:`paddle_tpu_torch.io.load_checkpoint`.  ``mesh`` defaults
        to the manager's own."""
        from paddle_tpu_torch import io
        self.wait_pending()
        mesh = mesh if mesh is not None else self.mesh
        step = self.last_good_step()
        if step is not None:
            path = self.path(step)
            try:
                verify_checkpoint(path)
            except CorruptCheckpoint:
                self._quarantine(path)
                step = None
        if step is None:
            try:
                os.remove(self._good_pointer())
            except OSError:
                pass
            return self.restore_latest(shardings=shardings, mesh=mesh)
        got = io.load_checkpoint(self.executor, self.dirname,
                                 main_program=self.main_program,
                                 step=step, scope=self.scope,
                                 shardings=shardings, mesh=mesh)
        self._point_latest(step)
        self._restore_datapipe(step)
        self._restore_ledger(step)
        return got

    # -- restore -----------------------------------------------------------
    def verify(self, step):
        return verify_checkpoint(self.path(step))

    def restore(self, step, shardings=None, mesh=None):
        """Verify + restore one specific step (no fallback); ``mesh``
        as in :meth:`restore_last_good`."""
        from paddle_tpu_torch import io
        self.wait_pending()
        verify_checkpoint(self.path(step))
        got = io.load_checkpoint(self.executor, self.dirname,
                                 main_program=self.main_program, step=step,
                                 scope=self.scope, shardings=shardings,
                                 mesh=mesh if mesh is not None
                                 else self.mesh)
        self._restore_datapipe(step)
        self._restore_ledger(step)
        return got

    def _restore_datapipe(self, step):
        """Load the iterator position saved next to ``ckpt-<step>`` into
        the attached pipeline (no-op without one; a checkpoint written
        before a pipeline existed leaves the pipeline untouched).
        ``last_restore_rewound`` records the outcome so a caller acting
        on a restore (the sentinel rollback) can tell a rewound stream
        from a params-only restore."""
        self.last_restore_rewound = False
        if self.datapipe is None:
            return False
        p = os.path.join(self.path(step), _datapipe_state_name())
        if not os.path.exists(p):
            # topology-changed fallback: a shrink/grow restore may not
            # find this host's own sidecar — rank 0's position (all
            # ranks checkpoint at the same step boundary, so their
            # strides agree) or the unsuffixed single-host legacy name
            # still repositions exactly; the stride sources remap the
            # offsets to the restoring degree on load
            for cand in (_datapipe_state_name(rank=0, processes=1),
                         _datapipe_state_name(rank=0, processes=2)):
                p = os.path.join(self.path(step), cand)
                if os.path.exists(p):
                    break
            else:
                return False
        with open(p, "rb") as f:
            self.datapipe.load_state_dict(pickle.load(f))
        self.last_restore_rewound = True
        return True

    def _restore_ledger(self, step):
        """Rewind the attached run ledger to the cursor saved next to
        ``ckpt-<step>`` (no-op without a ledger or for checkpoints
        written before one was attached — those rows simply stay)."""
        if self.ledger is None:
            return False
        p = os.path.join(self.path(step), LEDGER_STATE_NAME)
        if not os.path.exists(p):
            return False
        with open(p, "rb") as f:
            self.ledger.load_state_dict(pickle.load(f))
        return True

    def restore_latest(self, shardings=None, mesh=None):
        """Restore the newest restorable checkpoint; returns its step or
        None.  Corrupt/partial candidates are quarantined and skipped.
        ``mesh`` as in :meth:`restore_last_good`."""
        from paddle_tpu_torch import io
        self.wait_pending()
        mesh = mesh if mesh is not None else self.mesh
        for step in reversed(self.steps()):
            path = self.path(step)
            if os.path.exists(os.path.join(path, MANIFEST_NAME)):
                try:
                    verify_checkpoint(path)
                except CorruptCheckpoint:
                    self._quarantine(path)
                    continue
                # checksums passed: a load failure now is environmental
                # (bad shardings arg, FS flake, OOM) — propagate it
                # rather than quarantining a valid checkpoint
            else:
                # pre-manifest legacy checkpoint: unverifiable but very
                # possibly valid — try it, and on failure SKIP without
                # quarantining (the dir stays for explicit
                # load_checkpoint / forensics)
                try:
                    got = io.load_checkpoint(
                        self.executor, self.dirname,
                        main_program=self.main_program, step=step,
                        scope=self.scope, shardings=shardings,
                        mesh=mesh)
                except Exception:
                    continue
                self._point_latest(step)
                self._restore_datapipe(step)
                self._restore_ledger(step)
                return got
            got = io.load_checkpoint(
                self.executor, self.dirname,
                main_program=self.main_program, step=step,
                scope=self.scope, shardings=shardings, mesh=mesh)
            # re-point ``latest`` in case it referenced a checkpoint we
            # just quarantined (load_checkpoint(step=None) keeps working)
            self._point_latest(step)
            self._restore_datapipe(step)
            self._restore_ledger(step)
            return got
        # nothing restorable: drop a ``latest`` pointer that would now
        # name a quarantined dir (load_checkpoint(step=None) then fails
        # with a clear missing-pointer error, not a phantom ckpt path)
        try:
            os.remove(os.path.join(self.dirname, "latest"))
        except OSError:
            pass
        return None

    def _point_latest(self, step):
        """Swing ``latest`` to a restored step: the coordinator rank's
        write only (the ranks share the directory)."""
        from paddle_tpu_torch import io
        if _rank() == 0:
            io._write_latest(self.dirname, step)

    def _quarantine(self, path):
        if _rank() != 0:
            return      # the coordinator rank moves it; the others skip it
        target = path + _QUARANTINE_SUFFIX
        if os.path.exists(target):
            shutil.rmtree(target, ignore_errors=True)
        try:
            os.rename(path, target)
        except OSError:
            shutil.rmtree(path, ignore_errors=True)
