"""Host-side native code of the port (counterpart of ``tpuframe/native``'s
checksum): CRC-32C (Castagnoli) of the checkpoint shard files.

:func:`crc32c` runs ``csrc/crc32c.cc`` (slicing-by-8, a copy of the JAX
package's ``tf_crc32c``), built with ``g++`` into ``_build/`` at first use
and called through ``ctypes``, which releases the GIL for the call.  A
failed build raises with the compiler's output: a checkpoint of 1.6 GB
checksummed by a Python loop would take minutes and hide the fault, so
there is no fallback.  :func:`crc32c_py` is the plain twin the tests hold
it to.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpuframe_torch import _build

_POLY = 0x82F63B78      # 0x1EDC6F41 reflected
_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load_host("crc32c")
        lib.tf_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_uint32]
        lib.tf_crc32c.restype = ctypes.c_uint32
        _LIB = lib
    return _LIB


def loaded() -> bool:
    """Whether the native library is loaded in this process."""
    return _LIB is not None


def _bytes_view(data) -> np.ndarray:
    """``data`` (bytes, bytearray, memoryview or an array) as a contiguous
    uint8 array, without a copy where it already is one."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def crc32c(data, seed: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``seed`` (the CRC of the bytes
    before it)."""
    buf = _bytes_view(data)
    return int(_lib().tf_crc32c(buf.ctypes.data if buf.size else None,
                                buf.size, seed & 0xFFFFFFFF))


_TABLE: list[int] | None = None


def crc32c_py(data, seed: int = 0) -> int:
    """The same checksum, a byte at a time in Python (the plain twin)."""
    global _TABLE
    if _TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
            table.append(crc)
        _TABLE = table
    crc = ~seed & 0xFFFFFFFF
    for b in _bytes_view(data).tobytes():
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return (~crc) & 0xFFFFFFFF
