'''Dataset base classes and the loader.

Counterpart of `animeface_tpu/dataset/_base.py`: `make_default_transform`,
`_default_collate`, `_quantize_images`, `DataLoader`, `WrappedDataset` and
the task bases `Image`, `ImageImage`, `LRHR`, `ImageXDoG`, `ImageGray`,
`ImageLabel` and `ImageOnehot`. Batches are numpy float32 NHWC in [-1, 1]
(or uint8 with `transfer_dtype='uint8'`); the accelerator copies them to
the device and makes them NCHW. One process loads, so the JAX loader's
per-host sharding has no counterpart (multi-GPU is ROADMAP Queue 1 item 9).
PIL is imported only by the file-backed datasets that decode with it, and
sklearn not at all: the label encoders are numpy copies of sklearn's
`LabelEncoder` and `OneHotEncoder`, and the gray task's hue jitter goes
through numpy copies of PIL's 8-bit RGB <-> HSV conversions.
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


class ImageImage(WrappedDataset):
    '''Two-domain datasets for unpaired I2I.'''

    def __init__(self, transform: Callable) -> None:
        self.images1, self.images2 = self._load()
        self.transform = transform

    def __getitem__(self, index):
        image1 = pil_image().open(self.images1[index]).convert('RGB')
        image2 = pil_image().open(self.images2[index]).convert('RGB')
        return self.transform(image1), self.transform(image2)

    def native_ok(self) -> bool:
        return _native_cfg_ok(self.transform, self.images1) \
            and _native_cfg_ok(self.transform, self.images2)

    def load_native_batch(self, indices):
        cfg = self.transform.native_cfg
        return tuple(
            _native_decode(paths, indices, cfg,
                           lambda i, paths=paths: self.transform(
                               pil_image().open(paths[i]).convert('RGB')))
            for paths in (self.images1, self.images2))

    def __len__(self) -> int:
        return len(self.images1)


class LRHR(WrappedDataset):
    '''Paired low-res / high-res dataset for SR (shared random hflip).'''

    def __init__(self, image_size: int, scale: float = 2.,
                 resize_scale: float = 1.) -> None:
        self.images = self._load()
        self.image_size = image_size
        self.resize_scale = resize_scale
        self.scale = scale

    def __getitem__(self, index):
        image = pil_image().open(self.images[index]).convert('RGB')
        return self.transform(image)

    def transform(self, img):
        return self._default_transform(img)

    def _default_transform(self, img):
        lr_size = int(self.image_size // self.scale)
        sr = _center_crop(_resize(img, int(self.image_size * self.resize_scale)),
                          self.image_size)
        lr = _center_crop(_resize(img, int(lr_size * self.resize_scale)), lr_size)
        sr = _to_array(sr)
        lr = _to_array(lr)
        if _random.random() > 0.5:
            sr = sr[:, ::-1].copy()
            lr = lr[:, ::-1].copy()
        return lr, sr

    def __len__(self) -> int:
        return len(self.images)


class ImageXDoG(WrappedDataset):
    '''Image + XDoG line-art pairs (sketch colorization).'''

    def __init__(self, transform: Callable) -> None:
        self.images, self.xdogs = self._load()
        self.transform = transform

    def __getitem__(self, index):
        image = pil_image().open(self.images[index]).convert('RGB')
        xdog = pil_image().open(self.xdogs[index]).convert('L')
        return self.transform(image), self.transform(xdog)

    def native_ok(self) -> bool:
        return _native_cfg_ok(self.transform, self.images) \
            and _native_cfg_ok(self.transform, self.xdogs)

    def load_native_batch(self, indices):
        cfg = self.transform.native_cfg
        imgs = _native_decode(
            self.images, indices, cfg,
            lambda i: self.transform(pil_image().open(self.images[i]).convert('RGB')))
        # the line art decodes to r == g == b: keep one channel
        lines = _native_decode(
            self.xdogs, indices, cfg,
            lambda i: np.repeat(self.transform(
                pil_image().open(self.xdogs[i]).convert('L')), 3, axis=-1))
        return imgs, lines[..., :1]

    def shuffle_xdog(self) -> None:
        _random.shuffle(self.xdogs)

    def __len__(self) -> int:
        return len(self.images)


# ---------------- PIL's 8-bit HSV, in numpy ----------------
#
# PIL's `convert('HSV')` and back (libImaging/Convert.c, rgb2hsv_row and
# hsv2rgb) with their own roundings: float32 ratios, double hue and scale
# arithmetic, truncation to bytes one way and C's round the other. The
# pairs below give PIL's bytes for every one of the 2^24 byte triples.

def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    '''uint8 [..., 3] RGB -> uint8 [..., 3] HSV, as PIL's `convert('HSV')`.'''
    r, g, b = (np.asarray(rgb)[..., i].astype(np.int32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    gray = maxc == minc
    cr = np.where(gray, 1, maxc - minc).astype(np.float32)
    s = (maxc - minc).astype(np.float32) / np.maximum(maxc, 1).astype(np.float32)
    rc, gc, bc = ((maxc - c).astype(np.float32) / cr for c in (r, g, b))
    f64 = np.float64
    h = np.where(r == maxc, (bc - gc).astype(f64),
                 np.where(g == maxc, 2.0 + rc.astype(f64) - bc,
                          4.0 + gc.astype(f64) - rc)).astype(np.float32)
    h = np.fmod(h.astype(f64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.where(gray, 0, np.clip((h.astype(f64) * 255.0).astype(np.int64), 0, 255))
    us = np.where(gray, 0, np.clip((s.astype(f64) * 255.0).astype(np.int64), 0, 255))
    return np.stack([uh, us, maxc], -1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    '''uint8 [..., 3] HSV -> uint8 [..., 3] RGB, as PIL's `convert('RGB')`
    of an 'HSV' image.'''
    h, s, v = (np.asarray(hsv)[..., i].astype(np.int32) for i in range(3))
    hf = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(hf).astype(np.int32)
    f = (hf - i).astype(np.float32).astype(np.float64)
    fs = (s / 255.0).astype(np.float32).astype(np.float64)

    def byte(x):                       # C's round (half away from 0) of x >= 0
        return np.clip(np.floor(v * x + 0.5), 0, 255).astype(np.int32)
    p, q, t = byte(1.0 - fs), byte(1.0 - fs * f), byte(1.0 - fs * (1.0 - f))
    k = i % 6
    rgb = np.stack([np.choose(k, [v, q, p, p, t, v]), np.choose(k, [t, v, v, q, p, p]),
                    np.choose(k, [p, p, t, v, v, q])], -1)
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.uint8)


def shift_hue(rgb: np.ndarray, delta: float) -> np.ndarray:
    '''uint8 RGB with its 8-bit hue moved by `delta` turns, as the JAX
    `ImageGray._jitter_hue` does through PIL's HSV.'''
    hsv = rgb_to_hsv(rgb)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(round(delta * 255))) % 256
    return hsv_to_rgb(hsv)


class ImageGray(WrappedDataset):
    '''RGB + on-the-fly grayscale pairs: gray is the ITU-R 601 luminance of
    the un-jittered crop; the rgb target gets a random hue shift of +-0.1
    turns (`shift_hue`).'''

    _LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)

    def __init__(self, transform: Callable) -> None:
        self.images = self._load()
        self.transform = transform

    def __getitem__(self, index):
        image = pil_image().open(self.images[index]).convert('RGB')
        gray = (self.transform(image) @ self._LUMA)[..., None]
        rgb = self.transform(self._jitter_hue(image))
        return rgb, gray.astype(np.float32)

    @staticmethod
    def _jitter_hue(img):
        delta = (_random.random() - 0.5) / 5            # turns in [-0.1, 0.1]
        return pil_image().fromarray(shift_hue(np.asarray(img), delta), 'RGB')

    def __len__(self) -> int:
        return len(self.images)


class LabelEncoder:
    '''sklearn's `LabelEncoder`: the sorted distinct labels are `classes_`,
    a label's code its index there.'''

    def fit_transform(self, labels) -> np.ndarray:
        self.classes_, codes = np.unique(np.asarray(labels), return_inverse=True)
        return codes.reshape(-1)

    def inverse_transform(self, codes) -> np.ndarray:
        codes = np.asarray(codes).reshape(-1)
        if codes.size and (codes.min() < 0 or codes.max() >= len(self.classes_)):
            raise ValueError(f'codes outside 0..{len(self.classes_) - 1}: {codes}')
        return self.classes_[codes]


class OneHotEncoder:
    '''sklearn's `OneHotEncoder` on one column: `categories_[0]` the sorted
    distinct labels, a label a float64 row with 1 at its index (dense, as
    sklearn's `.toarray()`); a row decodes to the label of its largest
    entry, and an all-zero row raises.'''

    def fit_transform(self, labels) -> np.ndarray:
        classes, codes = np.unique(np.asarray(labels).reshape(-1), return_inverse=True)
        self.categories_ = [classes]
        return np.eye(len(classes))[codes.reshape(-1)]

    def inverse_transform(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        if np.any(rows.sum(axis=1) == 0):
            raise ValueError('an all-zero row has no label')
        return self.categories_[0][rows.argmax(axis=1)].reshape(-1, 1)


class ImageLabel(WrappedDataset):
    '''Image + integer label (`LabelEncoder`).'''

    def __init__(self, transform: Callable) -> None:
        self.images, labels = self._load()
        self.transform = transform
        self._make_label(labels)

    def _make_label(self, labels) -> None:
        self.encoder = LabelEncoder()
        self.labels = self.encoder.fit_transform(np.array(labels).reshape(-1))
        self.num_classes = len(self.encoder.classes_)

    def __getitem__(self, index):
        image = pil_image().open(self.images[index]).convert('RGB')
        return self.transform(image), np.int32(self.labels[index])

    def inverse_transform(self, label):
        return self.encoder.inverse_transform(np.asarray(label).reshape(-1))

    def __len__(self) -> int:
        return len(self.images)


class ImageOnehot(ImageLabel):
    '''Image + one-hot label (`OneHotEncoder`).'''

    def _make_label(self, labels) -> None:
        self.encoder = OneHotEncoder()
        self.labels = self.encoder.fit_transform(
            np.array(labels).reshape(-1, 1)).astype(np.float32)
        self.num_classes = len(self.encoder.categories_[0])

    def __getitem__(self, index):
        image = pil_image().open(self.images[index]).convert('RGB')
        return self.transform(image), self.labels[index]

    def inverse_transform(self, label):
        return self.encoder.inverse_transform(np.asarray(label).reshape(1, -1))
