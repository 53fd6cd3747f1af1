"""Native (host C++) runtime components, bound via ctypes (the port of
``paddle_tpu/native/__init__.py``): the recordio codec of
``recordio.cpp`` and the C inference ABI of ``capi.cpp``.

Each shared library is built with ``g++`` at its first use, never at
import, into ``native/_build/``.  Where no toolchain can build the codec,
:func:`load` returns None and the readers and writers of
:mod:`paddle_tpu_torch.recordio_writer` run the pure-Python codec, which
writes and reads the same bytes; :func:`codec` says which one runs.

The C inference ABI (:func:`load_capi`) keeps the JAX package's
``pd_tpu_*`` names and signatures and embeds CPython to run the port's
``serving.Predictor`` (``serving._capi_create`` / ``_capi_feed_names`` /
``_capi_run``).  One departure: ``pd_tpu_create(model_dir)`` makes a
predictor on ``cuda:0``, and fails (NULL, the reason in
``pd_tpu_last_error``) where CUDA is absent; a caller that wants the CPU
says so with ``pd_tpu_create_on(model_dir, "cpu")`` (a place string as
the CLI's ``--place`` takes it: ``cpu`` or ``cuda[:N]``).  The library
is built with ``-Wl,-Bsymbolic`` and loaded ``RTLD_LOCAL``, so that the
JAX package's library (loaded ``RTLD_GLOBAL``, the same symbol names) in
the same process is never called by mistake.  It links ``libpython``
where the running interpreter uses the shared one; otherwise (a static
interpreter) the symbols come from the process that loads it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

__all__ = ["load", "codec", "load_capi"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "recordio.cpp")
# a directory that is no package: a library beside ``__init__.py`` would
# be found by ``pkgutil`` as a module of the package
_BUILD = os.path.join(_DIR, "_build")
_LIB = os.path.join(_BUILD, "libpaddletpu_torch_native.so")

_lock = threading.Lock()
_lib = None
_build_error = None


def _build(src=_SRC, lib=_LIB, flags=("-lz", "-lpthread")):
    """Compile ``src`` into a temporary file and rename it into place as
    ``lib``, so that processes building at once never load a
    half-written library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        out = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                              src, "-o", tmp, *flags], capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(f"g++ failed on {os.path.basename(src)}: "
                               f"{out.stderr.strip()}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """Build (if needed) and load the native library; returns None when
    no toolchain can build it (callers then run the pure-Python
    codec)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if (not os.path.exists(_LIB) or
                    os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB)
        except Exception as e:  # toolchain missing
            _build_error = e
            return None
        lib.recio_writer_open.restype = ctypes.c_void_p
        lib.recio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                          ctypes.c_uint32]
        lib.recio_writer_write.restype = ctypes.c_int
        lib.recio_writer_write.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p,
                                           ctypes.c_uint32]
        lib.recio_writer_close.restype = ctypes.c_int
        lib.recio_writer_close.argtypes = [ctypes.c_void_p]
        lib.recio_scanner_open.restype = ctypes.c_void_p
        lib.recio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.recio_scanner_next.restype = ctypes.c_int
        lib.recio_scanner_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.recio_scanner_close.argtypes = [ctypes.c_void_p]
        lib.recio_loader_open.restype = ctypes.c_void_p
        lib.recio_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32]
        lib.recio_loader_next.restype = ctypes.c_int
        lib.recio_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.recio_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def codec():
    """``"native"`` when the C++ library loads (building it if need be),
    else ``"python"``: the codec recordio files are read and written
    with."""
    return "native" if load() is not None else "python"


# ---------------------------------------------------------------------------
# capi: the embeddable C inference ABI (capi.cpp), built apart from the
# codec since it embeds CPython
# ---------------------------------------------------------------------------

_CAPI_SRC = os.path.join(_DIR, "capi.cpp")
_CAPI_LIB = os.path.join(_BUILD, "libpaddletpu_torch_capi.so")
_capi_lib = None


def _python_flags():
    """The compiler's include flag and, where the interpreter runs on
    the shared ``libpython``, the link flags for it."""
    import sysconfig
    flags = ["-I" + sysconfig.get_path("include"), "-Wl,-Bsymbolic"]
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        ver = sysconfig.get_config_var("LDVERSION") or \
            sysconfig.get_config_var("VERSION")
        flags += ["-L" + sysconfig.get_config_var("LIBDIR"), f"-lpython{ver}"]
    return flags


def load_capi():
    """Build (if needed) and load the C inference ABI, with its
    ``argtypes`` and ``restype`` declared.  Raises where it cannot be
    built (no ``g++``, no Python headers): the error names the cause."""
    global _capi_lib
    with _lock:
        if _capi_lib is not None:
            return _capi_lib
        if (not os.path.exists(_CAPI_LIB) or
                os.path.getmtime(_CAPI_LIB) < os.path.getmtime(_CAPI_SRC)):
            _build(_CAPI_SRC, _CAPI_LIB, _python_flags())
        lib = ctypes.CDLL(_CAPI_LIB, mode=ctypes.RTLD_LOCAL)
        c_ll, c_ll_p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
        for name, restype, argtypes in (
                ("pd_tpu_init", ctypes.c_int, []),
                ("pd_tpu_last_error", ctypes.c_char_p, []),
                ("pd_tpu_create", ctypes.c_void_p, [ctypes.c_char_p]),
                ("pd_tpu_create_on", ctypes.c_void_p,
                 [ctypes.c_char_p, ctypes.c_char_p]),
                ("pd_tpu_num_feeds", ctypes.c_int, [ctypes.c_void_p]),
                ("pd_tpu_feed_name", ctypes.c_char_p,
                 [ctypes.c_void_p, ctypes.c_int]),
                ("pd_tpu_run", ctypes.c_void_p,
                 [ctypes.c_void_p, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_char_p),
                  ctypes.POINTER(ctypes.c_void_p), c_ll_p,
                  ctypes.POINTER(c_ll_p), ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_char_p)]),
                ("pd_tpu_result_count", ctypes.c_int, [ctypes.c_void_p]),
                ("pd_tpu_result_data", ctypes.c_void_p,
                 [ctypes.c_void_p, ctypes.c_int, c_ll_p]),
                ("pd_tpu_result_rank", ctypes.c_int,
                 [ctypes.c_void_p, ctypes.c_int]),
                ("pd_tpu_result_dim", c_ll,
                 [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]),
                ("pd_tpu_result_dtype", ctypes.c_char_p,
                 [ctypes.c_void_p, ctypes.c_int]),
                ("pd_tpu_free_result", None, [ctypes.c_void_p]),
                ("pd_tpu_destroy", None, [ctypes.c_void_p])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _capi_lib = lib
        return _capi_lib
