"""The port's npz codec on the host: ctypes bindings of ``csrc/shardio.cc``
(port of ``opticalflowfromdepth_tpu/data/native_io.py``, written anew).

- :func:`load_npz` decodes an npz file (entries stored or deflated, NPY
  1.0-3.0, C or Fortran order, every CRC-32 checked) on the calling
  thread; the interpreter lock is released for the whole decode.
- :class:`Prefetcher` decodes on a pool of C++ threads: ``submit`` a path,
  ``take`` its arrays by ticket.
- :class:`ShardEncoder` writes npz files from deduplicated blobs: each
  array object is packed, CRC'd and deflated (or stored) once, however
  many files hold it, on a pool of C++ threads; :func:`save_npz` writes
  one file.

The library is built on first use with ``g++ -O3 -std=c++17 ... -lz
-lpthread`` into ``build/native/`` (``_build.py``). If it does not build,
every entry point here raises: nothing falls back to ``np.load`` or
``np.savez``. Files written here load with ``np.load``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Dict, Iterable, Tuple

import numpy as np

from .. import _build

_LOCK = threading.Lock()
_MAX_DIMS = 64          # numpy's limit on an array's rank
_I64 = ctypes.c_int64
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("shardio")
    sigs = {
        "ofd_npz_load": (_P, [ctypes.c_char_p]),
        "ofd_npz_error": (ctypes.c_char_p, [_P]),
        "ofd_npz_count": (ctypes.c_int, [_P]),
        "ofd_npz_entry": (ctypes.c_int, [
            _P, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(_I64), ctypes.c_int, ctypes.POINTER(_I64)]),
        "ofd_npz_copy": (None, [_P, ctypes.c_int, _P]),
        "ofd_npz_free": (None, [_P]),
        "ofd_pool_new": (_P, [ctypes.c_int]),
        "ofd_pool_submit": (_I64, [_P, ctypes.c_char_p]),
        "ofd_pool_take": (_P, [_P, _I64]),
        "ofd_pool_free": (None, [_P]),
        "ofd_enc_new": (_P, [ctypes.c_int]),
        "ofd_enc_blob": (_I64, [
            _P, _P, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_I64),
            ctypes.POINTER(_I64), _I64, ctypes.c_int, ctypes.c_int]),
        "ofd_enc_file": (_I64, [_P, ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_char_p),
                                ctypes.POINTER(_I64)]),
        "ofd_enc_drain": (_I64, [_P, ctypes.c_char_p, _I64]),
        "ofd_enc_busy_s": (ctypes.c_double, [_P]),
        "ofd_enc_free": (None, [_P]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _lib() -> ctypes.CDLL:
    """The codec's library, built and loaded once (threads that ask at
    once wait for one build)."""
    with _LOCK:
        return _library()


def available() -> bool:
    """True iff the codec builds and loads on this host."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _unpack(lib: ctypes.CDLL, handle: int, path: str) -> Dict[str, np.ndarray]:
    """The arrays of a decoded file; frees the handle."""
    try:
        err = lib.ofd_npz_error(handle)
        if err:
            raise IOError(f"npz decode failed: {path}: {err.decode()}")
        name, descr = ctypes.c_char_p(), ctypes.c_char_p()
        fortran, nbytes = ctypes.c_int(), _I64()
        shape = (_I64 * _MAX_DIMS)()
        out: Dict[str, np.ndarray] = {}
        for i in range(lib.ofd_npz_count(handle)):
            ndim = lib.ofd_npz_entry(handle, i, ctypes.byref(name),
                                     ctypes.byref(descr),
                                     ctypes.byref(fortran), shape, _MAX_DIMS,
                                     ctypes.byref(nbytes))
            key = name.value.decode()
            try:
                dtype = np.dtype(descr.value.decode())
            except TypeError as e:
                raise IOError(f"npz decode failed: {path}: {key}: {e}") \
                    from None
            if ndim > _MAX_DIMS or dtype.hasobject:
                raise IOError(f"npz decode failed: {path}: {key}: "
                              f"unsupported array ({ndim} axes, {dtype})")
            dims = tuple(shape[:ndim])
            arr = np.empty(dims[::-1] if fortran.value else dims, dtype)
            if arr.nbytes != nbytes.value:
                raise IOError(f"npz decode failed: {path}: {key}: "
                              f"{nbytes.value} payload bytes for shape "
                              f"{dims} of {dtype}")
            if arr.nbytes:
                lib.ofd_npz_copy(handle, i, arr.ctypes.data)
            out[key] = arr.T if fortran.value else arr
        return out
    finally:
        lib.ofd_npz_free(handle)


def load_npz(path) -> Dict[str, np.ndarray]:
    """Decode an npz file into a dict of arrays (``np.load``'s keys and
    arrays). A bad, truncated or unsupported file raises ``IOError``."""
    lib = _lib()
    path = os.fspath(path)
    return _unpack(lib, lib.ofd_npz_load(os.fsencode(path)), path)


class Prefetcher:
    """Decodes npz files on ``num_threads`` C++ threads: ``submit(path)``
    returns a ticket, ``take(ticket)`` waits for that file's arrays (in any
    order). One thread uses an instance; ``close`` (or leaving a ``with``
    block) stops the pool, and any call after it raises ``RuntimeError``."""

    _pool = None

    def __init__(self, num_threads: int = 4):
        self._lib = _lib()
        self._pool = self._lib.ofd_pool_new(num_threads)
        self._paths: Dict[int, str] = {}

    def _handle(self) -> int:
        if self._pool is None:
            raise RuntimeError("the Prefetcher is closed")
        return self._pool

    def submit(self, path) -> int:
        pool = self._handle()
        path = os.fspath(path)
        ticket = self._lib.ofd_pool_submit(pool, os.fsencode(path))
        self._paths[ticket] = path
        return ticket

    def take(self, ticket: int) -> Dict[str, np.ndarray]:
        """The arrays of ``ticket``'s file; ``IOError`` if it did not decode,
        ``KeyError`` for a ticket not handed out or taken already."""
        handle = self._lib.ofd_pool_take(self._handle(), ticket)
        if not handle:
            raise KeyError(f"ticket {ticket} was not submitted or was taken")
        return _unpack(self._lib, handle, self._paths.pop(ticket))

    def close(self) -> None:
        if self._pool is not None:
            self._lib.ofd_pool_free(self._pool)
            self._pool = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


class ShardEncoder:
    """Writes npz files from deduplicated blobs on ``threads`` C++ threads.

    ``file(path, entries)`` queues one file of ``(key, array)`` entries;
    ``blob(array)`` registers an array once: the same array object in many
    files (the synthesis schema repeats each parent image, depth and flow
    in ~12 of an image's 61 files) is packed into C order, CRC'd and
    deflated or stored once. u8 and other integer entries are deflated at
    ``level``; float entries are stored when ``store_floats`` is set (f16
    bits barely deflate). The C++ side reads the arrays in place, so every
    array given stays referenced here until ``drain``, which waits for all
    queued files and raises ``IOError`` if any failed (the count and the
    last error). One thread uses an instance. ``close`` finishes the queued
    work and frees the pool; any call after it raises ``RuntimeError``.

    ``blobs`` and ``entries`` count the blobs registered and the entries
    queued since the encoder was made; ``busy_s`` is the seconds its
    threads spent working, summed over them."""

    _enc = None

    def __init__(self, threads: int = 0, level: int = 1,
                 store_floats: bool = True):
        self._lib = _lib()
        self._enc = self._lib.ofd_enc_new(threads if threads > 0
                                          else (os.cpu_count() or 1))
        self.level = level
        self.store_floats = store_floats
        self._keep: list = []               # arrays read by C++ until drain
        self._ids: Dict[int, int] = {}      # id(array) -> blob id
        self.blobs = 0
        self.entries = 0
        self._busy_s = 0.0

    def _handle(self) -> int:
        if self._enc is None:
            raise RuntimeError("the ShardEncoder is closed")
        return self._enc

    def blob(self, arr) -> int:
        """The blob id of ``arr``: the same id for the same object until
        ``drain``."""
        enc = self._handle()
        got = self._ids.get(id(arr))
        if got is not None:
            return got
        a = np.asarray(arr)
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise ValueError(f"cannot encode an array of dtype {a.dtype}")
        # keep the original too: its id() is the key, and a freed object's
        # id could be reused by a new array and alias this blob
        self._keep.append((arr, a))
        shape = (_I64 * max(a.ndim, 1))(*a.shape)
        strides = None if a.flags.c_contiguous else \
            (_I64 * a.ndim)(*a.strides)    # packed on the C++ threads
        deflate = a.dtype.kind != "f" or not self.store_floats
        bid = self._lib.ofd_enc_blob(
            enc, a.ctypes.data, a.dtype.str.encode(), a.ndim, shape, strides,
            a.itemsize, 8 if deflate else 0, self.level)
        self._ids[id(arr)] = bid
        self.blobs += 1
        return bid

    def file(self, path, entries: Iterable[Tuple[str, object]]) -> None:
        """Queue one npz file of ``(key, array)`` entries."""
        enc = self._handle()
        names, ids = [], []
        for key, arr in entries:
            names.append(key.encode())
            ids.append(self.blob(arr))
        n = len(names)
        if self._lib.ofd_enc_file(enc, os.fsencode(os.fspath(path)), n,
                                  (ctypes.c_char_p * n)(*names),
                                  (_I64 * n)(*ids)) < 0:
            raise ValueError(f"{path}: a blob id the encoder does not know")
        self.entries += n

    def drain(self) -> None:
        """Wait until every queued file is written; then release the
        arrays. Raises ``IOError`` if any file failed."""
        enc = self._handle()
        err = ctypes.create_string_buffer(4096)
        fails = self._lib.ofd_enc_drain(enc, err, len(err))
        self._keep.clear()
        self._ids.clear()
        if fails:
            raise IOError(f"npz encode: {fails} file(s) failed (last error: "
                          f"{err.value.decode(errors='replace')})")

    @property
    def busy_s(self) -> float:
        if self._enc is None:
            return self._busy_s
        return self._lib.ofd_enc_busy_s(self._enc)

    def close(self) -> None:
        """Finish the queued work (unreported: ``drain`` reports) and free
        the pool."""
        if self._enc is not None:
            self._busy_s = self._lib.ofd_enc_busy_s(self._enc)
            self._lib.ofd_enc_free(self._enc)   # joins after the queues
            self._enc = None
            self._keep.clear()
            self._ids.clear()

    def __enter__(self) -> "ShardEncoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def save_npz(path, arrays: Dict[str, np.ndarray], level: int = 1,
             store_floats: bool = True) -> None:
    """Write one npz file (``np.load`` reads it) through a
    :class:`ShardEncoder`."""
    with ShardEncoder(threads=min(max(len(arrays), 1), os.cpu_count() or 1),
                      level=level, store_floats=store_floats) as enc:
        enc.file(path, arrays.items())
        enc.drain()
