"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library that
``ctypes`` loads: no PyTorch headers, so a build takes seconds.  The
libraries go to ``_build/`` beside this file, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source rebuilds and an unchanged one is reused.  :func:`build_all`
starts one ``nvcc`` per source, all at once.  Nothing here runs at
import: the first CUDA launch of a kernel builds (or finds) its library.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "CudaKernel",
           "find_nvcc", "build_all", "library_path", "load_library",
           "counts", "capture_launches"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every kernel source of the port, by file name under ``csrc/``
SOURCES = ("paged_decode.cu", "bias_softmax.cu", "flash_attention.cu",
           "smalls_attention.cu", "conv3x3.cu", "bshd_attention.cu")

_lock = threading.Lock()
_libs = {}
_count_lock = threading.Lock()
#: this process's kernel builds: ``compiled`` counts sources ``nvcc``
#: compiled, ``loaded`` libraries loaded that were already in the build
#: directory (``Executor.warmup`` reports each signature's provenance
#: from them; ``chip_smoke.py`` checks that a server builds nothing
#: after it is ready)
counts = {"compiled": 0, "loaded": 0}


def _count(key):
    with _count_lock:
        counts[key] += 1


# launches made while this thread captures a CUDA graph: tallied for the
# graph (which adds them to ``launches`` at each replay), not counted
_capturing = threading.local()


@contextlib.contextmanager
def capture_launches():
    """Collect this thread's kernel launches into a ``Counter`` (kernel
    -> launches) instead of their ``launches``: a launch under a CUDA
    graph capture runs only when the graph replays
    (``step_graph.StepGraph`` adds the tally at each replay)."""
    tally = collections.Counter()
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally
    try:
        yield tally
    finally:
        _capturing.tally = outer


def find_nvcc():
    """Path of ``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``), or None."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


def library_path(source):
    """Where the library of ``source`` (a file name under ``csrc/``) is
    built: keyed by a hash of the source text, of the headers beside it
    (``csrc/*.cuh``) and of the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_all(sources=SOURCES):
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns ``{source: compiler log}`` of
    the sources compiled now (``-Xptxas -v`` prints each kernel's
    registers and shared memory).  Raises with the compiler's output when
    a build fails."""
    nvcc = find_nvcc()
    todo = [s for s in sources if not os.path.isfile(library_path(s))]
    if todo and nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for s in todo:
        out = library_path(s)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for s, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[s] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {s} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        _count("compiled")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load_library(source):
    """The ``ctypes`` library of ``source``, built first if missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = library_path(source)
            if os.path.isfile(path):
                _count("loaded")
            else:
                build_all((source,))
            lib = ctypes.CDLL(path)
            _libs[source] = lib
        return lib


class CudaKernel:
    """One hand-written kernel: its source, its C entry point and how many
    times it ran (``launches``, a plain count that ``chip_smoke.py`` reads
    to prove the main path went through it: a wrapper's launch, or a
    replay of a CUDA graph that captured one, :func:`capture_launches`)."""

    def __init__(self, name, source, replaces):
        self.name = name
        self.source = source
        #: ``file:line`` of the TPU kernel this one replaces
        self.replaces = replaces
        self.launches = 0
        self._entries = {}
        # wrappers launch from server, batcher and scheduler threads
        self._count_lock = threading.Lock()

    def _entry(self, symbol, argtypes):
        hit = self._entries.get(symbol)
        if hit is None:
            lib = load_library(self.source)
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            hit = self._entries[symbol] = (fn, err)
        return hit

    def launch(self, symbol, argtypes, *args):
        """Call C entry ``symbol`` (which launches the kernel and returns
        ``cudaGetLastError()``); raise if the launch was refused, else
        count it (into the capture's tally while this thread captures a
        CUDA graph)."""
        fn, err = self._entry(symbol, argtypes)
        code = fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch of {symbol} failed: "
                f"{err(code).decode()} (error {code})")
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[self] += 1
        else:
            self.add_launches(1)

    def add_launches(self, n):
        """Count ``n`` runs of the kernel (a graph replay adds its
        captured tally)."""
        with self._count_lock:
            self.launches += n
