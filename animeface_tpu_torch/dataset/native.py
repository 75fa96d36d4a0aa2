'''ctypes binding to the native decode pipeline (`native/libanimeface_io.so`).

Counterpart of `animeface_tpu/dataset/native.py`, against the same
committed library: JPEG/PNG decode, shorter-edge resize, center crop,
random hflip and [-1, 1] normalization in native threads, returning an
NHWC float32 batch. The library is never built here. `available()` is
False when it is absent or does not load (it links `libjpeg.so.62` and
`libpng16.so.16`), and the datasets then decode with PIL.
'''

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SO_PATH = os.environ.get(
    'ANIMEFACE_NATIVE_IO',
    os.path.join(_REPO_ROOT, 'native', 'libanimeface_io.so'))

_lib = None
_tried = False
_lock = threading.Lock()


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.af_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        lib.af_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_batch(paths, size: int, resize_scale: float = 1.,
               hflip_mask=None) -> tuple[np.ndarray, np.ndarray] | None:
    '''Decode a batch in parallel native threads.

    Returns (batch [N,size,size,3] float32 in [-1,1], fail [N] uint8) or
    None when the native library is unavailable. Failed samples are
    zero-filled and flagged.
    '''
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), dtype=np.float32)
    fail = np.zeros((n,), dtype=np.uint8)
    if hflip_mask is None:
        mask = np.zeros((n,), dtype=np.uint8)
    else:
        mask = np.ascontiguousarray(np.asarray(hflip_mask, dtype=np.uint8))
        if mask.shape != (n,):
            raise ValueError(f'hflip_mask has shape {mask.shape}, want ({n},)')
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.af_load_batch(
        c_paths, n, size, float(resize_scale),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, fail
