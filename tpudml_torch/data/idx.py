"""IDX (MNIST) binary format reader and writer (the port of
``tpudml/data/idx.py``): the on-disk format torchvision's MNIST reads.

Format: big-endian; 2 zero bytes, 1 dtype byte, 1 ndim byte, then ndim
uint32 dims, then the row-major payload. ``.gz`` files are (de)compressed
transparently. Multi-byte payloads are swapped in place by the native
data plane (``tpudml_torch.native.byteswap_inplace``).
"""

from __future__ import annotations

import gzip
import struct
import sys
from pathlib import Path

import numpy as np

from tpudml_torch import native

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.int16,
    0x0C: np.int32,
    0x0D: np.float32,
    0x0E: np.float64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _IDX_DTYPES.items()}


def read_idx(path: str | Path) -> np.ndarray:
    """Decode an IDX file (``.gz`` transparently)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    if len(data) < 4 or data[0] != 0 or data[1] != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic {data[:4]!r})")
    dtype_code, ndim = data[2], data[3]
    if dtype_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, dtype=_IDX_DTYPES[dtype_code], count=int(np.prod(dims)),
                        offset=4 + 4 * ndim).reshape(dims).copy()
    if arr.dtype.itemsize > 1 and sys.byteorder == "little":
        native.byteswap_inplace(arr)
    return arr


def write_idx(path: str | Path, arr: np.ndarray) -> None:
    """Encode ``arr`` to IDX (``.gz`` by the suffix)."""
    path = Path(path)
    dtype = np.dtype(arr.dtype)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {dtype} not representable in IDX")
    header = bytes([0, 0, _DTYPE_CODES[dtype], arr.ndim]) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    payload = np.ascontiguousarray(arr).astype(dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(header + payload)
