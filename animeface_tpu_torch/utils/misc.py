'''Small utilities: attribute dicts, image grids and image files.

Counterpart of `animeface_tpu/utils/misc.py` (`EasyDict`, `make_image_grid`,
`save_image`). Images are numpy NHWC arrays in [-1, 1], as in the JAX
package. A `.png` is written by the stdlib encoder below (8-bit RGB or
gray, `zlib` and `struct` only), so sample grids need no imaging library;
any other suffix (the trainer's `running.jpg`) goes through PIL when it
imports, and is skipped with a warning when it does not.
'''

from __future__ import annotations

import struct
import warnings
import zlib
from typing import Any

import numpy as np


class EasyDict(dict):
    '''dict with attribute-style access.'''

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


def make_image_grid(*image_tensors, num_images: int | None = None):
    '''Interleave several [N,H,W,C] batches into one [M,H,W,C] batch,
    round-robin over the inputs, stopping after `num_images` rounds.'''
    arrays = [np.asarray(t) for t in image_tensors]
    out = []
    for index, image_set in enumerate(zip(*[list(a) for a in arrays])):
        out.extend(image_set)
        if num_images is not None and index == num_images - 1:
            break
    return np.stack(out, axis=0)


def _grid_uint8(images, nrow: int, denormalize: bool) -> np.ndarray:
    '''A batch [N,H,W,C] tiled `nrow` to a row with 2-pixel white borders,
    as uint8 [H', W', C] (`[H', W']` for one channel).'''
    a = np.asarray(images, dtype=np.float32)
    if a.ndim == 3:
        a = a[None]
    n, h, w, c = a.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    pad = 2
    grid = np.ones((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), dtype=np.float32)
    if denormalize:
        a = a * 0.5 + 0.5
        a = np.clip(a, 0.0, 1.0)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        top, left = pad + r * (h + pad), pad + col * (w + pad)
        grid[top:top + h, left:left + w] = a[idx]
    arr = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return arr[..., 0] if c == 1 else arr


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    '''uint8 [H, W] (gray) or [H, W, 3] (RGB) as PNG bytes: no filter on
    any row, one zlib stream.'''
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f'PNG needs [H, W] or [H, W, 3] uint8, got {arr.shape}')
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', header)
            + _png_chunk(b'IDAT', zlib.compress(raw, 6)) + _png_chunk(b'IEND', b''))


def save_image(images, filename, nrow: int = 8, denormalize: bool = True) -> None:
    '''Save a batch [N,H,W,C] as a tiled grid image (torchvision.save_image
    layout). PNG by the encoder above; other formats by PIL, or skipped
    with a warning when PIL is absent.'''
    arr = _grid_uint8(images, nrow, denormalize)
    filename = str(filename)
    if filename.lower().endswith('.png'):
        with open(filename, 'wb') as f:
            f.write(encode_png(arr))
        return
    try:
        from PIL import Image
    except ImportError:
        warnings.warn(f'PIL is not installed; not writing {filename}')
        return
    Image.fromarray(arr).save(filename)
