'''Procedural synthetic datasets, one for each task.

Counterpart of `animeface_tpu/dataset/synthetic.py`: anime-face-like
compositions (a skin disc, a hair crescent and fringe, eyes, a mouth) with
geometry and palette from `np.random.default_rng(seed * 1_000_003 +
index)`, and the paired stand-ins built on them (two domains, LR/HR, line
art, gray, labels), so the same seed gives bitwise the same arrays as the
JAX package.
'''

from __future__ import annotations

import numpy as np

from animeface_tpu_torch.dataset._base import WrappedDataset


def _face_image(rng: np.random.Generator, size: int) -> np.ndarray:
    '''One procedural face, HWC float32 in [-1, 1].'''
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size  # [0,1]
    img = np.empty((size, size, 3), np.float32)
    # background
    bg = rng.uniform(0.6, 1.0, size=3).astype(np.float32)
    img[:] = bg
    # face disc
    cx = 0.5 + rng.uniform(-0.05, 0.05)
    cy = 0.55 + rng.uniform(-0.05, 0.05)
    rx = rng.uniform(0.26, 0.34)
    ry = rx * rng.uniform(1.0, 1.15)
    face = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) < 1.0
    skin = np.array([0.99, 0.87, 0.80], np.float32) * rng.uniform(0.9, 1.05)
    img[face] = np.clip(skin, 0, 1)
    # hair: crescent above the face
    hair_color = rng.uniform(0.05, 0.95, size=3).astype(np.float32)
    hr = rx * rng.uniform(1.15, 1.35)
    hair = ((((xx - cx) / hr) ** 2 + ((yy - (cy - 0.08)) / hr) ** 2) < 1.0) \
        & (yy < cy + rng.uniform(-0.05, 0.1))
    img[hair & ~face] = hair_color
    # fringe over the forehead
    fringe = hair & face & (yy < cy - ry * rng.uniform(0.35, 0.6))
    img[fringe] = hair_color
    # eyes
    eye_color = rng.uniform(0.0, 0.8, size=3).astype(np.float32)
    er = rx * rng.uniform(0.12, 0.2)
    for sx in (-1.0, 1.0):
        ex = cx + sx * rx * 0.45
        ey = cy + ry * 0.05
        eye = (((xx - ex) / er) ** 2 + ((yy - ey) / (er * 1.4)) ** 2) < 1.0
        img[eye] = eye_color
    # mouth
    mw = rx * rng.uniform(0.15, 0.3)
    mouth = (np.abs(xx - cx) < mw) & (np.abs(yy - (cy + ry * 0.5)) < 0.012)
    img[mouth] = np.array([0.8, 0.3, 0.3], np.float32)
    return img * 2.0 - 1.0


class SyntheticImage(WrappedDataset):
    '''Procedural single-image dataset; `image_size`, `num_images`, `seed`.

    Samples are memoized as uint8 (the precision of a decoded dataset), so
    each index pays the procedural cost once, up to about 8 GB; past that,
    cold indices are made again on each visit.'''

    _CACHE_BYTES_MAX = 8 << 30

    def __init__(self, image_size: int, num_images: int = 2048,
                 seed: int = 0, channels: int = 3) -> None:
        self.image_size = image_size
        self.num_images = num_images
        self.seed = seed
        self.channels = channels
        self._cache: dict[int, np.ndarray] = {}
        per_img = image_size * image_size * channels
        self._cache_max = max(1, self._CACHE_BYTES_MAX // max(1, per_img))

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, index) -> np.ndarray:
        idx = int(index)
        q = self._cache.get(idx)
        if q is None:
            rng = np.random.default_rng(self.seed * 1_000_003 + idx)
            img = _face_image(rng, self.image_size)
            if self.channels == 1:
                img = img.mean(axis=-1, keepdims=True)
            q = np.round((img + 1.0) * 127.5).astype(np.uint8)
            if len(self._cache) < self._cache_max:
                self._cache[idx] = q
        return q.astype(np.float32) / 127.5 - 1.0


class SyntheticImageImage(WrappedDataset):
    '''Unpaired two-domain stand-in: faces vs color-inverted faces.'''

    def __init__(self, image_size: int, num_images: int = 2048, seed: int = 0) -> None:
        self.a = SyntheticImage(image_size, num_images, seed)
        self.b = SyntheticImage(image_size, num_images, seed + 7777)

    def __len__(self) -> int:
        return len(self.a)

    def __getitem__(self, index):
        return self.a[index], -self.b[index]


class SyntheticLRHR(WrappedDataset):
    '''Paired SR stand-in: box-downsampled LR + full-res HR.'''

    def __init__(self, image_size: int, scale: float = 2., num_images: int = 2048,
                 seed: int = 0) -> None:
        self.hr = SyntheticImage(image_size, num_images, seed)
        self.scale = int(scale)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.hr)

    def __getitem__(self, index):
        sr = self.hr[index]
        s = self.scale
        h = self.image_size // s * s
        lr = sr[:h, :h].reshape(h // s, s, h // s, s, 3).mean(axis=(1, 3))
        return lr, sr


class SyntheticImageGray(WrappedDataset):
    '''Colorization stand-in: image + its ITU-R 601 luminance channel.'''

    _LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)

    def __init__(self, image_size: int, num_images: int = 2048, seed: int = 0) -> None:
        self.base = SyntheticImage(image_size, num_images, seed)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index):
        img = self.base[index]
        gray = (img @ self._LUMA)[..., None]
        return img, gray.astype(np.float32)


class SyntheticImageXDoG(WrappedDataset):
    '''Sketch-colorization stand-in: image + gradient-magnitude "line art".'''

    def __init__(self, image_size: int, num_images: int = 2048, seed: int = 0) -> None:
        self.base = SyntheticImage(image_size, num_images, seed)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index):
        img = self.base[index]
        g = img.mean(axis=-1)
        gy = np.abs(np.diff(g, axis=0, prepend=g[:1]))
        gx = np.abs(np.diff(g, axis=1, prepend=g[:, :1]))
        edges = np.clip((gx + gy) * 4.0, 0, 1)
        xdog = (1.0 - edges)[..., None] * 2.0 - 1.0  # white bg, dark lines
        return img, xdog.astype(np.float32)


class SyntheticImageLabel(WrappedDataset):
    '''Labeled stand-in: label = hair-color bucket (num_classes buckets).'''

    def __init__(self, image_size: int, num_images: int = 2048,
                 num_classes: int = 10, seed: int = 0) -> None:
        self.base = SyntheticImage(image_size, num_images, seed)
        self.num_classes = num_classes

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index):
        rng = np.random.default_rng(int(index) * 999_983 + 17)
        return self.base[index], np.int32(rng.integers(self.num_classes))

    def inverse_transform(self, label):
        return [f'class_{int(v)}' for v in np.asarray(label).reshape(-1)]


class SyntheticImageOnehot(SyntheticImageLabel):
    def __getitem__(self, index):
        img, label = super().__getitem__(index)
        onehot = np.zeros((self.num_classes,), np.float32)
        onehot[int(label)] = 1.0
        return img, onehot
