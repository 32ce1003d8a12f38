"""ctypes binding to the native C++ chunk parsers (``native/`` at repo root).

A copy of the parser half of ``wormhole_tpu/data/native.py``: it loads the
same ``native/build/libwormhole_data.so`` (building it with ``make -C
native`` on first use where a compiler exists). The Python parsers in
parsers.py are the reference implementations; the C++ library is the hot
path for streaming throughput. ``get_parser`` returns None when the shared
library is absent so everything degrades gracefully; ``available`` says
whether it loaded.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Optional

import numpy as np

from wormhole_tpu_torch.data.rowblock import RowBlock

_LIB = None
_TRIED = False

_LIB_NAMES = ("libwormhole_data.so",)


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [os.path.join(here, "native", "build", n) for n in _LIB_NAMES]
    candidates += [os.path.join(here, "native", n) for n in _LIB_NAMES]
    env = os.environ.get("WORMHOLE_NATIVE_LIB")
    if env:
        candidates.insert(0, env)
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def _try_build() -> Optional[str]:
    """Best-effort one-shot `make` of the native library (a fresh checkout
    has no build/ — the hot path should not silently fall back to Python
    parsing on machines that have a toolchain). A file lock serializes
    concurrent build processes (multi-process launches on a fresh
    checkout would otherwise clobber each other's half-written .so)."""
    import subprocess
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ndir = os.path.join(here, "native")
    if not os.path.exists(os.path.join(ndir, "Makefile")):
        return None
    try:
        import fcntl
        with open(os.path.join(ndir, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)   # waits for a peer's build
            found = _find_lib()
            if found:                          # a peer built it first
                return found
            subprocess.run(["make", "-C", ndir], capture_output=True,
                           timeout=120, check=True)
    except Exception as e:
        import logging
        logging.getLogger("wormhole_tpu_torch.native").warning(
            "native build failed (%s); falling back to Python parsers", e)
        return None
    return _find_lib()


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("WORMHOLE_DISABLE_NATIVE"):
        return None
    path = _find_lib() or _try_build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    # int wh_parse(const char* fmt, const char* buf, int64 len,
    #              ParseOut* out);  see native/parse.cc for the ABI
    lib.wh_parse_count.restype = ctypes.c_int64
    lib.wh_parse_count.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]  # out: rows, nnz
    lib.wh_parse_fill.restype = ctypes.c_int
    lib.wh_parse_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),   # offsets (rows+1)
        ctypes.POINTER(ctypes.c_float),   # labels  (rows)
        ctypes.POINTER(ctypes.c_uint64),  # index   (nnz)
        ctypes.POINTER(ctypes.c_float),   # values  (nnz)
        ctypes.POINTER(ctypes.c_int)]     # has_value flag out
    _LIB = lib
    return _LIB


def get_parser(fmt: str) -> Optional[Callable[[bytes], RowBlock]]:
    lib = _load()
    if lib is None:
        return None
    if fmt not in ("libsvm", "criteo", "adfea"):
        return None
    cfmt = fmt.encode()

    def parse(chunk: bytes) -> RowBlock:
        counts = (ctypes.c_int64 * 2)()
        rc = lib.wh_parse_count(cfmt, chunk, len(chunk), counts)
        if rc < 0:
            raise ValueError(f"native parse_count failed for {fmt}")
        rows, nnz = counts[0], counts[1]
        offsets = np.empty(rows + 1, np.int64)
        labels = np.empty(rows, np.float32)
        index = np.empty(max(nnz, 1), np.uint64)
        values = np.empty(max(nnz, 1), np.float32)
        has_val = ctypes.c_int(0)
        rc = lib.wh_parse_fill(
            cfmt, chunk, len(chunk),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            index.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(has_val))
        if rc != 0:
            raise ValueError(f"native parse_fill failed for {fmt}")
        return RowBlock(
            offset=offsets,
            label=labels,
            index=index[:nnz],
            value=values[:nnz] if has_val.value else None,
        )

    return parse


def available() -> bool:
    return _load() is not None
