"""ctypes bindings of the port's copy of the JAX package's native loader
(``dataloader.cc``: libjpeg decode fused with a bilinear resize to the
staging square, the JPEG-quality re-encode, CRC32C).

Port of ``yoloret_tpu/native/__init__.py``, every entry point. The
library is built on first use, never at import, by ``ops/_build.py``
into ``build/yoloret_tpu_torch/`` with the JAX package's ``g++`` flags.
Where it cannot be built (no ``g++``, no ``jpeglib.h``), ``available()``
is False after one warning that names the build error, and the callers
decode with PIL, as the JAX package does in the same case.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from typing import List, Optional, Tuple

import numpy as np

from yoloret_tpu_torch.ops import _build

_u8p, _f32p, _ip = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_float, ctypes.c_int))
_cp, _ci, _u64 = ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64
_PROTOTYPES = {
    "yt_crc32c": ([_cp, _u64], ctypes.c_uint32),
    "yt_masked_crc": ([_cp, _u64], ctypes.c_uint32),
    "yt_decode_resize_file": ([_cp, _ci, _f32p, _ip, _ip], _ci),
    "yt_decode_resize_mem": ([_cp, _u64, _ci, _f32p, _ip, _ip], _ci),
    "yt_decode_resize_file_u8": ([_cp, _ci, _u8p, _ip, _ip], _ci),
    "yt_decode_resize_mem_u8": ([_cp, _u64, _ci, _u8p, _ip, _ip], _ci),
    "yt_decode_resize_q_file_u8": ([_cp, _ci, _ci, _u8p, _ip, _ip], _ci),
    "yt_decode_resize_q_mem_u8": ([_cp, _u64, _ci, _ci, _u8p, _ip, _ip], _ci),
    "yt_decode_resize_batch": ([ctypes.POINTER(_cp), _ci, _ci, _f32p, _ip, _ci], _ci),
}

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None where it cannot be built
    (warned about once, with the compiler's message)."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _build.load("native", _PROTOTYPES)
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
                warnings.warn("yoloret_tpu_torch.native: the JPEG loader did not build, so "
                              f"images are decoded with PIL: {_build_error}", RuntimeWarning,
                              stacklevel=2)
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None if it built or was not tried)."""
    return _build_error


def _need() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return lib


def crc32c(data: bytes) -> int:
    lib = get_lib()
    if lib is None:
        from yoloret_tpu_torch.data.tfrecord import crc32c as py_crc

        return py_crc(data)
    return int(lib.yt_crc32c(data, len(data)))


def _call(fn, lead: tuple, staging: int, dtype, what: str
          ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """``fn(*lead, out, &h, &w)`` into a new [staging, staging, 3] array of
    ``dtype``; raises IOError on a nonzero return code."""
    out = np.empty((staging, staging, 3), dtype)
    h, w = ctypes.c_int(), ctypes.c_int()
    ptr = _f32p if dtype == np.float32 else _u8p
    rc = fn(*lead, out.ctypes.data_as(ptr), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"native JPEG decode failed ({rc}){what}")
    return out, (h.value, w.value)


def decode_resize(path: str, staging: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """JPEG file -> ([staging, staging, 3] f32 in [0,1], (orig_h, orig_w)).
    Raises IOError on decode failure."""
    return _call(_need().yt_decode_resize_file, (path.encode(), staging), staging, np.float32,
                 f" for {path!r}")


def decode_resize_u8(path: str, staging: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """JPEG file -> ([S, S, 3] uint8, (orig_h, orig_w))."""
    return _call(_need().yt_decode_resize_file_u8, (path.encode(), staging), staging, np.uint8,
                 f" for {path!r}")


def decode_resize_q_u8(path: str, staging: int, quality: int
                       ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """JPEG file -> resize to staging -> re-encode at ``quality`` (none at
    0) -> decode: the random-JPEG-quality augmentation fused into the
    loader, at staging scale as in the reference (code/yolo3/utils.py:
    228-231)."""
    return _call(_need().yt_decode_resize_q_file_u8, (path.encode(), staging, int(quality)),
                 staging, np.uint8, f" for {path!r}")


def decode_resize_q_bytes_u8(data: bytes, staging: int, quality: int
                             ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """In-memory JPEG bytes variant of :func:`decode_resize_q_u8`."""
    return _call(_need().yt_decode_resize_q_mem_u8, (data, len(data), staging, int(quality)),
                 staging, np.uint8, "")


def decode_resize_bytes_u8(data: bytes, staging: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """In-memory JPEG bytes -> ([S, S, 3] uint8, (orig_h, orig_w))."""
    return _call(_need().yt_decode_resize_mem_u8, (data, len(data), staging), staging,
                 np.uint8, "")


def decode_resize_bytes(data: bytes, staging: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """In-memory JPEG bytes -> ([S, S, 3] f32, (orig_h, orig_w))."""
    return _call(_need().yt_decode_resize_mem, (data, len(data), staging), staging,
                 np.float32, "")


def decode_resize_batch(paths: List[str], staging: int, threads: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Threaded batch decode. Returns (images [N, S, S, 3] f32,
    hw [N, 2] int32, n_failures); failed slots are zeroed."""
    lib = _need()
    n = len(paths)
    out = np.empty((n, staging, staging, 3), np.float32)
    hw = np.empty((n, 2), np.int32)
    arr = (_cp * n)(*[p.encode() for p in paths])
    failures = lib.yt_decode_resize_batch(arr, n, staging, out.ctypes.data_as(_f32p),
                                          hw.ctypes.data_as(_ip), threads)
    return out, hw, int(failures)
