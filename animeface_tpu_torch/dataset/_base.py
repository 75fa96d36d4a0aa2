'''Dataset base classes and the loader.

Counterpart of `animeface_tpu/dataset/_base.py` for the `image` task:
`make_default_transform`, `_default_collate`, `_quantize_images`,
`DataLoader`, `WrappedDataset` and `Image`. Batches are numpy float32 NHWC
in [-1, 1] (or uint8 with `transfer_dtype='uint8'`); the accelerator
copies them to the device and makes them NCHW. One process loads, so the
JAX loader's per-host sharding has no counterpart (multi-GPU is ROADMAP
Queue 1 item 9). PIL is imported only by the file-backed datasets that
decode with it.
'''

from __future__ import annotations

import os
import queue as _queue
import random as _random
import threading
from collections.abc import Callable

import numpy as np

DATA_ROOT = os.environ.get('ANIMEFACE_DATA_ROOT', '/usr/src/data')


def set_data_root(root: str) -> None:
    global DATA_ROOT
    DATA_ROOT = root


def data_path(*parts) -> str:
    return os.path.join(DATA_ROOT, *parts)


def pil_image():
    '''`PIL.Image`, with truncated files allowed (as the JAX package sets at
    import); raises ImportError without PIL.'''
    from PIL import Image as pilImage, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return pilImage


def pil_available() -> bool:
    try:
        pil_image()
    except ImportError:
        return False
    return True


# ---------------- transforms (PIL -> numpy HWC float32) ----------------

def _resize(img, size: int):
    '''torchvision T.Resize semantics: `size` is the SHORTER edge.'''
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return img.resize((nw, nh), pil_image().BILINEAR)


def _center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _to_array(img, normalize: bool = True) -> np.ndarray:
    a = np.asarray(img, dtype=np.float32) / 255.0
    if a.ndim == 2:
        a = a[..., None]
    if normalize:
        a = a * 2.0 - 1.0
    return a


def make_default_transform(image_size: int, resize_scale: float = 1.,
                           hflip: bool = True, normalize: bool = True) -> Callable:
    '''Resize(shorter=size*scale) -> CenterCrop -> [RandomHFlip] -> [-1,1] HWC.'''

    def transform(img) -> np.ndarray:
        img = _resize(img, int(image_size * resize_scale))
        img = _center_crop(img, image_size)
        a = _to_array(img, normalize)
        if hflip and _random.random() > 0.5:
            a = a[:, ::-1].copy()
        return a

    # the parameters, so that a dataset can decode through the native
    # pipeline (dataset/native.py) when it computes the same thing
    transform.native_cfg = dict(image_size=image_size,
                                resize_scale=resize_scale,
                                hflip=hflip) if normalize else None
    return transform


# ---------------- loader ----------------

def _default_collate(samples):
    if isinstance(samples[0], (tuple, list)):
        return tuple(_default_collate([s[i] for s in samples])
                     for i in range(len(samples[0])))
    return np.stack(samples, axis=0)


def _quantize_images(batch):
    '''[-1,1] float image batches -> uint8 [0,255] for the host-to-device
    copy (the exact inverse of the accelerator's dequantization). Non-image
    leaves pass through untouched.'''
    if isinstance(batch, (tuple, list)):
        return tuple(_quantize_images(b) for b in batch)
    if batch.ndim == 4 and batch.dtype == np.float32:
        return np.clip(np.rint((batch + 1.0) * 127.5),
                       0, 255).astype(np.uint8)
    return batch


class DataLoader:
    '''Epoch-based loader yielding numpy NHWC batches.

    Each epoch visits the dataset in the order of
    `np.random.default_rng(seed + epoch).permutation` (or in order without
    `shuffle`); with `num_workers > 1` one producer thread assembles the
    batches ahead into a queue of `prefetch`.
    '''

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int | None = None,
                 seed: int = 0, prefetch: int = 4, transfer_dtype: str = 'float32'):
        if batch_size < 1:
            raise ValueError(f'batch_size must be positive, got {batch_size}')
        if transfer_dtype not in ('float32', 'uint8'):
            raise ValueError(f'transfer_dtype must be float32 or uint8, got {transfer_dtype}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers if num_workers is not None
                               else (os.cpu_count() or 1))
        self.seed = seed
        self.prefetch = prefetch
        self.transfer_dtype = transfer_dtype
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self._epoch).permutation(n)
        return np.arange(n)

    def __iter__(self):
        idx = self._epoch_indices()
        self._epoch += 1
        nb = len(self)

        # the native pipeline decodes whole batches on its own threads, so
        # one producer thread suffices either way
        batch_fn = getattr(self.dataset, 'load_native_batch', None)
        if batch_fn is not None and not self.dataset.native_ok():
            batch_fn = None
        if batch_fn is None:
            def batch_fn(chunk):
                return _default_collate([self.dataset[int(i)] for i in chunk])

        if self.transfer_dtype == 'uint8':
            inner_fn = batch_fn

            def batch_fn(chunk):
                return _quantize_images(inner_fn(chunk))

        if self.num_workers <= 1:
            for b in range(nb):
                yield batch_fn(idx[b * self.batch_size:(b + 1) * self.batch_size])
            return

        out_q: _queue.Queue = _queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            '''Queue `item` unless the consumer has gone.'''
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    pass
            return False

        def producer():
            try:
                for b in range(nb):
                    if not put(batch_fn(idx[b * self.batch_size:(b + 1) * self.batch_size])):
                        return
                put(None)
            except BaseException as e:  # surfaced to the consumer, which re-raises
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


class WrappedDataset:
    '''Base dataset: `_load` lists the samples.'''

    def _load(self):
        raise NotImplementedError()

    def __len__(self) -> int:
        raise NotImplementedError()


class Image(WrappedDataset):
    '''Single-image datasets of files, decoded by the native pipeline when
    it loads, else by PIL.'''

    def __init__(self, transform: Callable) -> None:
        self.images = self._load()
        self.transform = transform

    def __getitem__(self, index) -> np.ndarray:
        image = pil_image().open(self.images[index]).convert('RGB')
        return self.transform(image)

    def native_ok(self) -> bool:
        return _native_cfg_ok(self.transform, self.images)

    def load_native_batch(self, indices) -> np.ndarray:
        return _native_decode(self.images, indices, self.transform.native_cfg,
                              lambda i: self[i])

    def __len__(self) -> int:
        return len(self.images)


def _native_cfg_ok(transform, paths) -> bool:
    from animeface_tpu_torch.dataset import native
    cfg = getattr(transform, 'native_cfg', None)
    return cfg is not None and native.available() and len(paths) > 0 \
        and isinstance(paths[0], (str, os.PathLike))


def _native_decode(paths, indices, cfg, fallback):
    '''Batch-decode `paths[indices]` through the native pipeline; files it
    cannot decode fall back to the per-sample PIL path via `fallback(i)`.'''
    from animeface_tpu_torch.dataset import native
    sel = [str(paths[int(i)]) for i in indices]
    mask = (np.random.rand(len(sel)) > 0.5).astype(np.uint8) \
        if cfg['hflip'] else None
    batch, fail = native.load_batch(sel, cfg['image_size'],
                                    cfg['resize_scale'], mask)
    for i in np.nonzero(fail)[0]:
        batch[i] = fallback(int(indices[int(i)]))
    return batch
