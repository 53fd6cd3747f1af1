"""recordio: Python API over the native chunked record format (the
port's copy of ``paddle_tpu.recordio_writer``; reference
``paddle/fluid/recordio/`` + ``python/paddle/fluid/recordio_writer.py``).
The pure-Python codec keeps the same on-disk layout when no C++
toolchain is present (``native.codec()`` says which one runs); files
cross between the two packages byte for byte."""

from __future__ import annotations

import ctypes
import struct
import zlib

from paddle_tpu_torch import native

__all__ = ["RecordIOWriter", "RecordIOScanner", "RecordIOLoader",
           "convert_reader_to_recordio_file"]

_MAGIC = 0x0DEA11ED
_RAW, _ZLIB = 0, 1
_HDR = struct.Struct("<6I")


class RecordIOWriter:
    def __init__(self, path, compressor=_ZLIB, max_num_records=1000):
        self._lib = native.load()
        self.path = path
        if self._lib:
            self._w = self._lib.recio_writer_open(
                path.encode(), compressor, max_num_records)
            if not self._w:
                raise IOError(f"cannot open {path!r}")
        else:  # pure-python fallback
            self._f = open(path, "wb")
            self._compressor = compressor
            self._max = max_num_records
            self._buf = []
            self._n = 0

    def write(self, data: bytes):
        if isinstance(data, str):
            data = data.encode()
        if self._lib:
            rc = self._lib.recio_writer_write(self._w, data, len(data))
            if rc != 0:
                raise IOError("recordio write failed")
        else:
            self._buf.append(struct.pack("<I", len(data)) + data)
            self._n += 1
            if self._n >= self._max:
                self._flush()

    def _flush(self):
        if not self._n:
            return
        raw = b"".join(self._buf)
        payload = zlib.compress(raw) if self._compressor == _ZLIB else raw
        self._f.write(_HDR.pack(_MAGIC, self._compressor, self._n,
                                len(payload), len(raw),
                                zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self._buf, self._n = [], 0

    def close(self):
        if self._lib:
            self._lib.recio_writer_close(self._w)
        else:
            self._flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOScanner:
    """Sequential record iterator (native when available)."""

    def __init__(self, path):
        self._lib = native.load()
        self.path = path

    def __iter__(self):
        if self._lib:
            s = self._lib.recio_scanner_open(self.path.encode())
            if not s:
                raise IOError(f"cannot open {self.path!r}")
            try:
                ptr = ctypes.POINTER(ctypes.c_uint8)()
                ln = ctypes.c_uint32()
                while True:
                    rc = self._lib.recio_scanner_next(
                        s, ctypes.byref(ptr), ctypes.byref(ln))
                    if rc == 0:
                        return
                    if rc < 0:
                        raise IOError("corrupt recordio chunk")
                    yield ctypes.string_at(ptr, ln.value)
            finally:
                self._lib.recio_scanner_close(s)
        else:
            with open(self.path, "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        return
                    magic, comp, n, plen, rlen, crc = _HDR.unpack(hdr)
                    if magic != _MAGIC:
                        raise IOError("bad recordio magic")
                    payload = f.read(plen)
                    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                        raise IOError("recordio crc mismatch")
                    raw = zlib.decompress(payload) if comp == _ZLIB \
                        else payload
                    pos = 0
                    for _ in range(n):
                        (ln,) = struct.unpack_from("<I", raw, pos)
                        pos += 4
                        yield raw[pos:pos + ln]
                        pos += ln


class RecordIOLoader:
    """Multi-file threaded prefetch loader (native reader threads; the
    analog of the reference's open_files + double-buffer reader ops)."""

    def __init__(self, paths, n_threads=2, capacity=256):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native loader requires a C++ toolchain")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._l = lib.recio_loader_open(arr, len(paths), n_threads,
                                        capacity)

    def __iter__(self):
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint32()
        while True:
            rc = self._lib.recio_loader_next(self._l, ctypes.byref(ptr),
                                             ctypes.byref(ln))
            if rc == 0:
                return
            yield ctypes.string_at(ptr, ln.value)

    def close(self):
        if self._l:
            self._lib.recio_loader_close(self._l)
            self._l = None


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=_ZLIB,
                                    max_num_records=1000):
    """Serialize a python reader's samples (numpy-pickled) into a recordio
    file (reference ``recordio_writer.py:22``)."""
    import pickle
    count = 0
    with RecordIOWriter(filename, compressor, max_num_records) as w:
        for sample in reader_creator():
            w.write(pickle.dumps(sample, protocol=4))
            count += 1
    return count
