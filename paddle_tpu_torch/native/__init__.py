"""Native (host C++) runtime components, bound via ctypes: the recordio
codec of ``recordio.cpp`` (the port's copy of
``paddle_tpu/native/__init__.py``'s recordio part; the C inference ABI,
``capi.cpp``, is not ported).

The shared library is built with ``g++`` at its first use, never at
import, into ``native/_build/``.  Where no toolchain can build it,
:func:`load` returns None and the readers and writers of
:mod:`paddle_tpu_torch.recordio_writer` run the pure-Python codec, which
writes and reads the same bytes; :func:`codec` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

__all__ = ["load", "codec"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "recordio.cpp")
# a directory that is no package: a library beside ``__init__.py`` would
# be found by ``pkgutil`` as a module of the package
_BUILD = os.path.join(_DIR, "_build")
_LIB = os.path.join(_BUILD, "libpaddletpu_torch_native.so")

_lock = threading.Lock()
_lib = None
_build_error = None


def _build():
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
                        "-o", tmp, "-lz", "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB)
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
