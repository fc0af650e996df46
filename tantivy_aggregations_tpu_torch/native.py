"""ctypes bridge to the native ingestion kernels (native/tat_native.cpp).

Auto-builds the shared library on first use (make -C native) and falls back
to pure-NumPy implementations if the toolchain is unavailable — results are
identical either way; native is purely a throughput win for the host-side
indexing path (SURVEY.md §2.2 T3/T5 rebuild column)."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from .utils.stats import log

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO, "native", "libtat_native.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-s", "-C",
                            os.path.join(_REPO, "native")],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tat_encode_terms.restype = ctypes.c_void_p
        lib.tat_encode_terms.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64]
        lib.tat_dict_size.restype = ctypes.c_uint64
        lib.tat_dict_size.argtypes = [ctypes.c_void_p]
        lib.tat_dict_bytes.restype = ctypes.c_uint64
        lib.tat_dict_bytes.argtypes = [ctypes.c_void_p]
        lib.tat_fill.restype = None
        lib.tat_fill.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.tat_free.restype = None
        lib.tat_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # toolchain missing etc. -> NumPy fallback
        log.warning("native ingestion unavailable (%s); using NumPy", e)
        _lib = None
    return _lib


def encode_terms(strings: List[str]) -> Tuple[List[str], np.ndarray]:
    """(sorted unique terms, uint32 ordinal per input string)."""
    lib = _load()
    n = len(strings)
    if lib is None or n == 0:
        return _encode_terms_numpy(strings)
    blobs = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(n + 1, np.uint64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    payload = b"".join(blobs)
    h = lib.tat_encode_terms(
        payload, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_uint64(n))
    try:
        d = int(lib.tat_dict_size(h))
        db = int(lib.tat_dict_bytes(h))
        ords = np.empty(n, np.uint32)
        dict_bytes = ctypes.create_string_buffer(max(db, 1))
        dict_offsets = np.empty(d + 1, np.uint64)
        lib.tat_fill(h, ords.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                     dict_bytes,
                     dict_offsets.ctypes.data_as(
                         ctypes.POINTER(ctypes.c_uint64)))
    finally:
        lib.tat_free(h)
    raw = dict_bytes.raw[:db]
    terms = [raw[int(dict_offsets[i]):int(dict_offsets[i + 1])]
             .decode("utf-8") for i in range(d)]
    return terms, ords


def _encode_terms_numpy(strings: List[str]) -> Tuple[List[str], np.ndarray]:
    if not strings:
        return [], np.zeros(0, np.uint32)
    arr = np.asarray(strings, dtype=object)
    terms, ords = np.unique(arr, return_inverse=True)
    return list(terms), ords.astype(np.uint32)
