"""The native (C++) host data plane, bound with ctypes (the port of
``tpudml/native``).

Builds its own copy of ``dataplane.cpp`` with ``g++ -O3 -shared -fPIC`` at
first use into ``tpudml_torch/_build/`` (rebuilt when the source is newer)
and exposes numpy wrappers: the row gather of f32 and uint8 rows, the
fused gather + dequantize-normalize of uint8 rows, the int32 label gather
and the in-place byte swap of IDX payloads. There is no quiet fallback: a
failed build raises, and so does an array the library has no kernel for
(another dtype, a non-contiguous layout). numpy indexing runs instead only
when asked for, by the JAX package's own switch ``TPUDML_NO_NATIVE=1``
(``available()`` is then False), so tests can hold the two paths equal.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "dataplane.cpp"
_BUILD_DIR = _HERE.parent / "_build"
_LIB_PATH = _BUILD_DIR / "libtpudml_torch_dataplane.so"

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> ctypes.CDLL:
    """Compile (when missing or stale) and load the library; raises
    ``RuntimeError`` with the compiler's output if g++ fails."""
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _LIB_PATH.with_suffix(f".tmp{os.getpid()}.so")
        try:
            out = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                                 capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build the native data plane: {e}") from e
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{out.stderr}")
        os.replace(tmp, _LIB_PATH)  # atomic: processes that build at once race safely
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.tpudml_torch_gather_rows_f32.argtypes = [_f32p, _i64p, ctypes.c_int64,
                                                 ctypes.c_int64, _f32p]
    lib.tpudml_torch_gather_rows_u8.argtypes = [_u8p, _i64p, ctypes.c_int64, ctypes.c_int64,
                                                _u8p]
    lib.tpudml_torch_gather_normalize_u8.argtypes = [
        _u8p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float, _f32p]
    lib.tpudml_torch_gather_i32.argtypes = [_i32p, _i64p, ctypes.c_int64, _i32p]
    lib.tpudml_torch_byteswap.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    lib.tpudml_torch_byteswap.restype = ctypes.c_int
    for fn in ("gather_rows_f32", "gather_rows_u8", "gather_normalize_u8", "gather_i32"):
        getattr(lib, f"tpudml_torch_{fn}").restype = None
    return lib


def _get() -> ctypes.CDLL | None:
    """The loaded library, built at first use; None when
    ``TPUDML_NO_NATIVE`` asks for numpy."""
    global _lib
    if os.environ.get("TPUDML_NO_NATIVE"):
        return None
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _build()
    return _lib


def available() -> bool:
    """True when the C++ data plane is built and loaded (it is built here
    if need be; a failed build raises); False only under
    ``TPUDML_NO_NATIVE``."""
    return _get() is not None


def _native_rows(src: np.ndarray, dtypes: tuple) -> None:
    if src.dtype not in dtypes or not src.flags.c_contiguous:
        raise TypeError(
            f"the native gather takes C-contiguous {'/'.join(str(np.dtype(d)) for d in dtypes)} "
            f"arrays, got {src.dtype} (contiguous: {src.flags.c_contiguous}); set "
            "TPUDML_NO_NATIVE=1 for numpy indexing")


def _prep_idx(idx: np.ndarray, n: int) -> np.ndarray:
    """Validated int64 indices: the C++ kernels do raw pointer arithmetic,
    so an index outside [-n, n) raises here. Negative indices count from
    the end, as numpy's do."""
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError(f"gather index out of range: [{lo}, {hi}] vs {n} rows")
        if lo < 0:
            idx = np.ascontiguousarray(np.where(idx < 0, idx + n, idx))
    return idx


def _flat(a: np.ndarray) -> np.ndarray:
    return a.reshape(len(a), -1) if a.ndim != 2 else a


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = src[idx[i]] for row-major [N, ...] float32/uint8 arrays."""
    idx = _prep_idx(idx, len(src))
    lib = _get()
    if lib is None:
        return src[idx]
    _native_rows(src, (np.float32, np.uint8))
    out = np.empty((len(idx), *src.shape[1:]), src.dtype)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    fn = lib.tpudml_torch_gather_rows_f32 if src.dtype == np.float32 \
        else lib.tpudml_torch_gather_rows_u8
    fn(_flat(src), idx, len(idx), row, out.reshape(len(idx), row))
    return out


def gather_normalize(src: np.ndarray, idx: np.ndarray, scale: float,
                     bias: float = 0.0) -> np.ndarray:
    """out[i] = src[idx[i]] * scale + bias for uint8 [N, ...] -> float32."""
    idx = _prep_idx(idx, len(src))
    lib = _get()
    if lib is None:
        return src[idx].astype(np.float32) * scale + bias
    _native_rows(src, (np.uint8,))
    out = np.empty((len(idx), *src.shape[1:]), np.float32)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    lib.tpudml_torch_gather_normalize_u8(_flat(src), idx, len(idx), row, scale, bias,
                                         out.reshape(len(idx), row))
    return out


def gather_labels(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = src[idx[i]] for int32 labels [N]."""
    idx = _prep_idx(idx, len(src))
    lib = _get()
    if lib is None:
        return src[idx]
    _native_rows(src, (np.int32,))
    out = np.empty(len(idx), np.int32)
    lib.tpudml_torch_gather_i32(src, idx, len(idx), out)
    return out


def byteswap_inplace(arr: np.ndarray) -> np.ndarray:
    """In-place endian swap of 2-, 4- or 8-byte elements (IDX payloads are
    big-endian); returns ``arr``."""
    width = arr.dtype.itemsize
    if width == 1:
        return arr
    if not arr.flags.writeable:
        # The C++ path writes through the raw pointer.
        raise ValueError("byteswap_inplace requires a writeable array")
    lib = _get()
    if lib is None:
        arr[...] = arr.byteswap()
        return arr
    if not arr.flags.c_contiguous:
        raise TypeError("the native byte swap takes a C-contiguous array; set "
                        "TPUDML_NO_NATIVE=1 for numpy's")
    if lib.tpudml_torch_byteswap(arr.ctypes.data_as(ctypes.c_void_p), arr.size, width) != 0:
        raise ValueError(f"no byte swap for {width}-byte elements")
    return arr
