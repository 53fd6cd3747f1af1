"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library that
``ctypes`` loads: no PyTorch headers, so a build takes seconds.  The
libraries go to ``_build/`` beside this file, named by a hash of the
source and the flags, so a changed source rebuilds and an unchanged one
is reused.  :func:`build_all` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import: the first CUDA launch of a kernel
builds (or finds) its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "CudaKernel",
           "find_nvcc", "build_all", "library_path"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every kernel source of the port, by file name under ``csrc/``
SOURCES = ("paged_decode.cu", "bias_softmax.cu", "flash_attention.cu")

_lock = threading.Lock()
_libs = {}


def find_nvcc():
    """Path of ``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``), or None."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


def library_path(source):
    """Where the library of ``source`` (a file name under ``csrc/``) is
    built: keyed by a hash of the source text and the flags."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
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
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def _load(source):
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = library_path(source)
            if not os.path.isfile(path):
                build_all((source,))
            lib = ctypes.CDLL(path)
            _libs[source] = lib
        return lib


class CudaKernel:
    """One hand-written kernel: its source, its C entry point and how many
    times a wrapper launched it (``launches``, a plain count that
    ``chip_smoke.py`` reads to prove the main path went through it)."""

    def __init__(self, name, source, replaces):
        self.name = name
        self.source = source
        #: ``file:line`` of the TPU kernel this one replaces
        self.replaces = replaces
        self.launches = 0
        self._entries = {}

    def _entry(self, symbol, argtypes):
        hit = self._entries.get(symbol)
        if hit is None:
            lib = _load(self.source)
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
        count it."""
        fn, err = self._entry(symbol, argtypes)
        code = fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch of {symbol} failed: "
                f"{err(code).decode()} (error {code})")
        self.launches += 1
